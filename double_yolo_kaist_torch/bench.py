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

``--check-ap`` times nothing: it runs the synthetic overfit check with
its int8 gate (:mod:`.overfit_check`) and prints its JSON line (AP, the
worst int8 mode's AP).

Weights: ``--weights`` (a checkpoint directory, ``.pt`` or darknet
``.weights``), else :func:`seeded_variables` (kernels of graph.init's range
times the gain of the model's family, :func:`seeded_gain`, and BN
statistics that are not the identity, so that the folded forward does real
work on every layer and its heads move with the input on every zoo model).
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
# the gain of each family of stacks (seeded_gain), measured on every zoo
# model at seed 0 (tests/test_torch_bench_seeded.py)
DARKNET53_GAIN = 1.8
MOBILENET_GAIN = 2.5


def seeded_gain(ir: GraphIR) -> float:
    """The kernel gain of :func:`seeded_variables`, chosen by the family of
    the stack, because one gain does not fit all three: below a family's
    gain the heads stop moving with the input (the BN biases drown the
    signal), above it the residual stacks blow up. Raw head values at seed
    0, fp32, 64x96 (max |head|, max change when one frame changes; about
    4.6 of each max is the obj prior):

    * a mish stack (CSPDarknet53: the YOLOv4 Darknet family and the
      flagship): :data:`FLAGSHIP_GAIN`, 2.2; the YOLOv4 models give max
      6.7-19.5, change 0.28-1.06. Their decode is sigmoid-only, so larger
      heads stay finite;
    * a stack of depthwise-separable blocks (MobileNetv2 / v3, relu6 and
      hard-swish): 2.5; at 2.2 MNv3 dual's heads change by only 0.006, at
      2.5 max 6.5-8.9, change 0.98-1.72;
    * otherwise the leaky Darknet53 stacks of the YOLOv3 family: 1.8; at
      2.2 Visible-YOLOv3-Normal's heads reach 924 (exp() of the wh terms
      overflows), at 2.0 80; at 1.8 max 5.2-11.1, change 0.016-0.28 (and
      at 256x320 max 6.5-26.3, change 0.026-0.66), within exp()'s range.
    """
    if any(node.act == "mish" for node in ir.nodes):
        return FLAGSHIP_GAIN
    if any(node.kind == "dwconv" for node in ir.nodes):
        return MOBILENET_GAIN
    return DARKNET53_GAIN


def seeded_variables(ir: GraphIR, seed: int, gain: float | None = None):
    """The port's variables for ``ir`` drawn from numpy, in graph.init's
    tree (the same keys, shapes and dtypes): conv kernels (each conv of a
    depthwise-separable block and of an inception branch too)
    U(+-gain * sqrt(1 / fan_in)), fan_in = in_ch / groups * kernel ** 2,
    ``gain`` by default :func:`seeded_gain`; BN statistics in the ranges
    of tests/test_torch_slice._perturb_bn; SE and head biases U(+-sqrt(1 /
    fan_in)) with graph.init's obj / cls prior on the heads; weighted
    shortcuts at 0 (graph.init's). The draws of a graph of convs, SEs and
    shortcuts (the flagship's) are those the function has always made."""
    if gain is None:
        gain = seeded_gain(ir)
    rng = np.random.default_rng(seed)

    def uniform(bound, shape):
        return torch.from_numpy(rng.uniform(-bound, bound, shape)
                                .astype(np.float32))

    def normal(std, n):
        return torch.from_numpy(rng.normal(0, std, n).astype(np.float32))

    def conv(kernel, in_ch, out_ch, groups=1, bn=True):
        """(params, BN state or None) of one conv."""
        fan_in = in_ch // groups * kernel ** 2
        p = {"w": uniform(gain * math.sqrt(1 / fan_in),
                          (out_ch, in_ch // groups, kernel, kernel))}
        if not bn:
            p["b"] = uniform(math.sqrt(1 / fan_in), (out_ch,))
            return p, None
        p["bn"] = {"scale": torch.from_numpy(
            rng.uniform(0.5, 1.5, out_ch).astype(np.float32)),
            "bias": normal(0.2, out_ch)}
        return p, {"mean": normal(0.2, out_ch), "var": torch.from_numpy(
            rng.uniform(0.5, 2.0, out_ch).astype(np.float32))}

    params, state = {}, {}
    for node in ir.nodes:
        key = f"l{node.index}"
        if node.kind == "conv":
            params[key], s = conv(node.kernel, node.in_ch, node.out_ch,
                                  node.groups, node.bn)
            if s is not None:
                state[key] = s
        elif node.kind == "dwconv":         # graph.init's dw, then pw
            c = node.in_ch
            dw, s_dw = conv(node.kernel, c, c, groups=c)
            pw, s_pw = conv(1, c, node.out_ch)
            params[key] = {"dw": dw, "pw": pw}
            state[key] = {"dw": s_dw, "pw": s_pw}
        elif node.kind == "inception":
            icp, c = node.icp, node.in_ch
            params[key], state[key] = {}, {}
            for name, (k, ci, co) in {
                    "b1_1": (1, c, icp["n1x1"]),
                    "b2_1": (1, c, icp["n3x3_reduce"]),
                    "b2_2": (3, icp["n3x3_reduce"], icp["n3x3"]),
                    "b3_1": (1, c, icp["n5x5_reduce"]),
                    "b3_2": (3, icp["n5x5_reduce"], icp["n5x5"]),
                    "b3_3": (3, icp["n5x5"], icp["n5x5"]),
                    "b4_1": (1, c, icp["pool_proj"])}.items():
                params[key][name], state[key][name] = conv(k, ci, co)
        elif node.kind == "se":
            c, sq = node.in_ch, node.squeeze_ch
            params[key] = {
                "fc1": {"w": uniform(math.sqrt(1 / c), (sq, c, 1, 1)),
                        "b": uniform(math.sqrt(1 / c), (sq,))},
                "fc2": {"w": uniform(math.sqrt(1 / sq), (c, sq, 1, 1)),
                        "b": uniform(math.sqrt(1 / sq), (c,))}}
        elif node.kind == "shortcut" and node.weighted:
            params[key] = {"w": torch.zeros(len(node.inputs) + 1)}
    for yi in ir.yolo_indices:              # graph.init's smart bias
        head, pred = ir.nodes[yi], ir.nodes[yi - 1]
        b = params[f"l{pred.index}"]["b"].reshape(len(head.anchors), -1)
        b[:, 4] -= 4.5
        b[:, 5:] += math.log(0.6 / (head.nc - 0.99))
    return {"params": params, "state": state}


def calibration_stats(ir: GraphIR, placed: dict, args, device) -> dict:
    """int8 calibration statistics of the placed bf16 fold ``placed`` on
    one seeded batch of 8 frames of ``args.height`` x ``args.width``."""
    from .models import quantize as Q
    bf16 = torch.bfloat16
    rng = np.random.default_rng(1)
    cal = torch.from_numpy(rng.random((8, args.height, args.width, 3),
                                      dtype=np.float32)).to(device, bf16)
    return Q.calibrate(ir, placed, [(cal, cal if ir.dual_stream else None)],
                       compute_dtype=bf16)


def strip_int8_stems(qvars: dict) -> dict:
    """Quantized variables without the int8 stem pairs' leaves
    (``amax_in``, ``amax_mid``, ``stem_q``): the stems then run in the
    compute dtype (JAX tools/int8_ab.py:42-46)."""
    return {"params": {k: {kk: vv for kk, vv in v.items()
                           if kk not in ("amax_in", "amax_mid", "stem_q")}
                       for k, v in qvars["params"].items()}}


def int8_forward(ir: GraphIR, folded: dict, stats: dict, mode: str, device,
                 hw: tuple, strip_stems: bool = False):
    """Quantize the fp32 fold ``folded`` with ``stats`` in ``mode`` for the
    deployment size ``hw`` (as JAX bench.py:99-106 does) and place it on
    ``device``; ``strip_stems`` drops the int8 stem pairs' leaves
    (``int8_ab``'s ``+fpstem``). Returns forward(xv, xl) -> the decoded
    heads, bf16 compute."""
    from .models import quantize as Q
    bf16 = torch.bfloat16
    qvars = Q.quantize(ir, folded, stats, mode=mode, hw=hw)
    if strip_stems:
        qvars = strip_int8_stems(qvars)
    qvars = Q.place_quantized(ir, qvars, device, bf16)
    return lambda xv, xl: Q.apply_quantized(
        ir, qvars, xv, xl, compute_dtype=bf16, mode=mode)[0]


def make_forward(ir: GraphIR, variables: dict, args, int8: bool, device):
    """BN-fold (and, for int8, calibrate on one seeded batch of 8 and
    quantize), place on ``device``; returns forward(xv, xl) -> the decoded
    heads, bf16 compute."""
    from .models import graph
    bf16 = torch.bfloat16
    folded = graph.fold_batchnorm(ir, variables)
    placed = graph.place_folded(ir, folded, device, bf16)
    if not int8:
        return lambda xv, xl: graph.apply_folded(ir, placed, xv, xl,
                                                 compute_dtype=bf16)[0]
    stats = calibration_stats(ir, placed, args, device)
    return int8_forward(ir, folded, stats, args.int8_mode, device,
                        (args.height, args.width))


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
    repeats). ``args``: ``batch``, ``height``, ``width``, ``iters``,
    ``warmup`` and ``int8_mode``. A single-stream model gets its visible
    frames only."""
    from .serving import capture
    t = time.perf_counter()
    fwd = make_forward(ir, variables, args, int8, device)
    rng = np.random.default_rng(0)
    shape = (args.batch, args.height, args.width, 3)
    xv = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(
        device, torch.bfloat16)
    xl = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(
        device, torch.bfloat16)
    if not ir.dual_stream:          # a visible-only model takes one stream
        xl = None
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
                    help="synthetic-data AP check instead of fps: overfit "
                         "the tiny model (python -m double_yolo_kaist_torch."
                         "overfit_check --int8) and report the final AP@0.5, "
                         "fp and through every int8 mode")
    ap.add_argument("--check-ap-epochs", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.check_ap:
        from . import overfit_check

        final_ap, int8_aps = overfit_check.main(args.check_ap_epochs,
                                                int8=True, device=device)
        print(json.dumps({
            "metric": "synthetic overfit AP@0.5 (tiny dual-stream model; "
                      f"int8 APs "
                      f"{'/'.join(f'{v:.2f}' for v in int8_aps.values())})",
            "value": round(final_ap, 4),
            "unit": "AP",
            "vs_baseline": round(final_ap / 0.5, 2),   # gate: must exceed 0.5
            "int8_worst_ap": round(min(int8_aps.values()), 4),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
        }))
        return
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
