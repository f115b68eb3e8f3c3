"""Benchmark: dual-stream 640x512 frames/s on one card, the flagship model.

    python -m double_yolo_kaist_torch.bench [--bf16 | --int8] \\
        [--model <zoo name or cfg>] [--weights <weights>] [--batch 16]

The port's counterpart of the JAX package's ``bench.py``: BN-folded forward
+ head decode, no NMS (the reference's evaluate.py:70-74 FPS), on
Double-YOLOv4-Fshare-Global-CSE3 at batch 16, in bf16 and in int8 chain PTQ
(calibrated on one seeded batch of 8). It prints one JSON line with the
JAX bench's keys: ``metric``, ``value`` (the int8 fps when that leg runs,
else bf16), ``unit``, ``vs_baseline`` (against the reference's published
bs-1 FPS), ``repeats`` (min / mean / max fps of the three repeats) and,
with both legs, ``bf16_fps`` and ``bf16_repeats``; plus ``device``.

Timing: one forward is captured as a CUDA graph and replayed ``--iters``
times between two CUDA events, three times; fps is from the fastest
repeat (the counterpart of the JAX bench's in-device ``fori_loop``). On
the CPU (``--device cpu``) the forwards run eagerly on the host clock.

Weights: ``--weights`` (a checkpoint directory, ``.pt`` or darknet
``.weights``), else :func:`seeded_variables` (kernels of graph.init's range
times a gain, and BN statistics that are not the identity, so that the
folded forward does real work on every layer).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .config.ir import GraphIR
from .models.zoo import FLAGSHIP, MODELS, reference_fps

# kaiming-uniform kernels times this gain keep the flagship's heads input-
# dependent and finite through its 185 convs (tests/test_torch_slice.py)
FLAGSHIP_GAIN = 2.2


def seeded_variables(ir: GraphIR, seed: int, gain: float = FLAGSHIP_GAIN):
    """The port's variables for ``ir`` drawn from numpy: conv kernels
    U(+-gain * sqrt(1 / fan_in)), BN statistics in the ranges of
    tests/test_torch_slice._perturb_bn, SE and head biases U(+-sqrt(1 /
    fan_in)) with graph.init's obj / cls prior on the heads, weighted
    shortcuts at 0 (graph.init's)."""
    rng = np.random.default_rng(seed)

    def uniform(bound, shape):
        return torch.from_numpy(rng.uniform(-bound, bound, shape)
                                .astype(np.float32))

    def normal(std, n):
        return torch.from_numpy(rng.normal(0, std, n).astype(np.float32))

    params, state = {}, {}
    for node in ir.nodes:
        key = f"l{node.index}"
        if node.kind == "conv":
            fan_in = node.in_ch // node.groups * node.kernel ** 2
            p = {"w": uniform(gain * math.sqrt(1 / fan_in),
                              (node.out_ch, node.in_ch // node.groups,
                               node.kernel, node.kernel))}
            if node.bn:
                c = node.out_ch
                p["bn"] = {"scale": torch.from_numpy(
                    rng.uniform(0.5, 1.5, c).astype(np.float32)),
                    "bias": normal(0.2, c)}
                state[key] = {"mean": normal(0.2, c), "var": torch.from_numpy(
                    rng.uniform(0.5, 2.0, c).astype(np.float32))}
            else:
                p["b"] = uniform(math.sqrt(1 / fan_in), (node.out_ch,))
            params[key] = p
        elif node.kind == "se":
            c, sq = node.in_ch, node.squeeze_ch
            params[key] = {
                "fc1": {"w": uniform(math.sqrt(1 / c), (sq, c, 1, 1)),
                        "b": uniform(math.sqrt(1 / c), (sq,))},
                "fc2": {"w": uniform(math.sqrt(1 / sq), (c, sq, 1, 1)),
                        "b": uniform(math.sqrt(1 / sq), (c,))}}
        elif node.kind == "shortcut" and node.weighted:
            params[key] = {"w": torch.zeros(len(node.inputs) + 1)}
        elif node.kind in ("dwconv", "inception"):
            raise ValueError(f"no seeded init for {node.kind}")
    for yi in ir.yolo_indices:              # graph.init's smart bias
        head, pred = ir.nodes[yi], ir.nodes[yi - 1]
        b = params[f"l{pred.index}"]["b"].reshape(len(head.anchors), -1)
        b[:, 4] -= 4.5
        b[:, 5:] += math.log(0.6 / (head.nc - 0.99))
    return {"params": params, "state": state}


def make_forward(ir: GraphIR, variables: dict, args, int8: bool, device):
    """BN-fold (and, for int8, calibrate on one seeded batch of 8 and
    quantize), place on ``device``; returns forward(xv, xl) -> the decoded
    heads, bf16 compute."""
    from .models import graph
    from .models import quantize as Q
    bf16 = torch.bfloat16
    folded = graph.fold_batchnorm(ir, variables)
    placed = graph.place_folded(ir, folded, device, bf16)
    if not int8:
        return lambda xv, xl: graph.apply_folded(ir, placed, xv, xl,
                                                 compute_dtype=bf16)[0]
    rng = np.random.default_rng(1)
    cal = torch.from_numpy(rng.random((8, args.height, args.width, 3),
                                      dtype=np.float32)).to(device, bf16)
    stats = Q.calibrate(ir, placed, [(cal, cal)], compute_dtype=bf16)
    qvars = Q.place_quantized(
        ir, Q.quantize(ir, folded, stats, mode=args.int8_mode), device, bf16)
    return lambda xv, xl: Q.apply_quantized(
        ir, qvars, xv, xl, compute_dtype=bf16, mode=args.int8_mode)[0]


def _seconds(run, iters: int, device) -> float:
    """Seconds for ``iters`` calls of ``run``: CUDA events on a card, the
    host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return time.perf_counter() - t0


@torch.inference_mode()
def measure_fps(ir: GraphIR, variables: dict, args, int8: bool, device):
    """(fps from the fastest of three repeats, {min, mean, max} fps of the
    repeats)."""
    from .serving import capture
    t = time.perf_counter()
    fwd = make_forward(ir, variables, args, int8, device)
    rng = np.random.default_rng(0)
    shape = (args.batch, args.height, args.width, 3)
    xv = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(
        device, torch.bfloat16)
    xl = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(
        device, torch.bfloat16)
    if device.type == "cuda":
        cuda_graph, io, _ = capture(lambda: fwd(xv, xl), device)
        run = cuda_graph.replay
    else:
        io = fwd(xv, xl)

        def run():
            fwd(xv, xl)
    for _ in range(args.warmup):
        run()
    if not bool(torch.isfinite(io).all()):
        raise FloatingPointError("the forward gave non-finite heads")
    print(f"# {'int8' if int8 else 'bf16'} ready in "
          f"{time.perf_counter() - t:.1f}s", file=sys.stderr, flush=True)
    times = [_seconds(run, args.iters, device) for _ in range(3)]
    frames = args.batch * args.iters
    per_repeat = sorted(frames / s for s in times)
    spread = {"min": round(per_repeat[0], 2),
              "mean": round(float(np.mean(per_repeat)), 2),
              "max": round(per_repeat[-1], 2)}
    return frames / min(times), spread


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=FLAGSHIP,
                    help="zoo name or cfg path")
    ap.add_argument("--weights", default="",
                    help="checkpoint dir, .pt or darknet .weights; default: "
                         "weights drawn from a seed (seeded_variables)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--int8", action="store_true",
                    help="int8 PTQ path only (skip the bf16 leg)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 path only (skip the int8 leg)")
    ap.add_argument("--int8-mode", default="chain",
                    choices=("seed", "chain", "all", "edge", "spine",
                             "spineall"),
                    help="PTQ plan: 3x3-only / int8 chains / all convs")
    ap.add_argument("--check-ap", action="store_true",
                    help="synthetic-data AP check (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)

    if args.check_ap:
        raise NotImplementedError(
            "--check-ap runs tools/overfit_check.py, which is not ported "
            "yet (ROADMAP.md, queue 1 item 16)")
    device = resolve_device(args.device)
    from .common import build_model, resolve_cfg
    from .config.ir import compile_cfg
    if args.weights:
        ir, variables = build_model(args.model, args.weights)
    else:
        ir = compile_cfg(resolve_cfg(args.model))
        variables = seeded_variables(ir, 0)
    # --int8 / --bf16 each select one leg; both or neither run both
    both = args.int8 == args.bf16
    fps_bf16 = sp_bf16 = fps_int8 = sp_int8 = None
    if both or args.bf16:
        fps_bf16, sp_bf16 = measure_fps(ir, variables, args, False, device)
        print(f"# bf16 {fps_bf16:.1f} fps (repeats {sp_bf16['min']}/"
              f"{sp_bf16['mean']}/{sp_bf16['max']})", file=sys.stderr,
              flush=True)
    if both or args.int8:
        fps_int8, sp_int8 = measure_fps(ir, variables, args, True, device)
        print(f"# int8[{args.int8_mode}] {fps_int8:.1f} fps (repeats "
              f"{sp_int8['min']}/{sp_int8['mean']}/{sp_int8['max']})",
              file=sys.stderr, flush=True)

    ref = reference_fps(args.model) if args.model in MODELS else None
    label = (f"int8 PTQ {args.int8_mode}" if fps_int8 is not None
             else "bf16")
    fps = fps_int8 if fps_int8 is not None else fps_bf16
    out = {
        "metric": f"dual-stream {args.width}x{args.height} frames/sec/card "
                  f"({args.model}, {label}, batch {args.batch})",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": None if ref is None else round(fps / ref, 2),
        "repeats": sp_int8 if fps_int8 is not None else sp_bf16,
    }
    if fps_int8 is not None and fps_bf16 is not None:
        out["bf16_fps"] = round(fps_bf16, 2)
        out["bf16_repeats"] = sp_bf16
    out["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
