"""Paired A/B of int8 PTQ plan modes in one process.

    python -m double_yolo_kaist_torch.int8_ab [--model <zoo name or cfg>] \\
        [--modes edge chain] [--rounds 4] [--batch 16] [--height 512] \\
        [--width 640] [--iters 20] [--device cuda]

The port's counterpart of the JAX package's ``tools/int8_ab.py``. The model
(the flagship by default) is drawn by :func:`.bench.seeded_variables`,
BN-folded and calibrated once on one seeded batch of 8; each mode of
``--modes`` is quantized and placed once and its forward (int8 convs,
head decode) captured once as a CUDA graph. The modes are then timed in
alternating rounds (A, B, A, B, ...), ``--iters`` replays between two CUDA
events a leg, so that every mode sees the same state of the card; each
round prints every mode's fps, and the end the fps of each mode's fastest
round. On the CPU (``--device cpu``) the forwards run eagerly on the host
clock.

A mode may carry JAX's ``+fpstem`` suffix: quantize as the base mode,
then drop the int8 stem pairs' leaves (``amax_in``, ``amax_mid``,
``stem_q``), so that the stems run in bf16 (JAX ``tools/int8_ab.py``:
every mode is quantized for ``--height`` x ``--width``, without int8
stems). ``+qgemm`` / ``-qgemm`` flip the JAX package's Pallas 1x1-GEMM
gate and are refused: on the card kernel K4 (``ops/qgemm.py``) always runs
the int8 1x1 convs and has no plain version on the device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def check_mode(mode: str) -> str:
    """``mode`` if the port runs it (a mode of ``quantize``, or one with
    ``+fpstem``), else SystemExit naming why not."""
    from .models import quantize as Q

    if "qgemm" in mode:
        raise SystemExit(
            f"{mode}: '+qgemm' / '-qgemm' flip the JAX package's Pallas "
            f"1x1-GEMM gate; on the card kernel K4 (ops/qgemm.py) always "
            f"runs the int8 1x1 convs and has no plain version on the "
            f"device, so there is nothing to flip")
    if mode.removesuffix("+fpstem") not in Q.MODES:
        raise SystemExit(f"unknown int8 mode {mode!r}; known: {Q.MODES}, "
                         f"each also with '+fpstem'")
    return mode


class _Leg:
    """One mode's forward ``forward(xv, xl)`` on fixed inputs, ready to
    run: on the card a replay of its CUDA graph (``cuda_graphs.replay``
    counts the launches the graph holds), on the CPU the eager forward. Its
    closure holds the quantized variables for as long as it lives."""

    def __init__(self, mode: str, forward, xv, xl, device):
        from .cuda_graphs import capture

        self.fwd = lambda: forward(xv, xl)
        self.graph, self.held = None, {}
        if device.type == "cuda":
            self.graph, self.io, self.held = capture(self.fwd, device)
        else:
            self.io = self.fwd()
        self()
        if not bool(torch.isfinite(self.io).all()):
            raise FloatingPointError(f"{mode}: the forward gave non-finite "
                                     f"heads")

    def __call__(self) -> None:
        from .cuda_graphs import replay

        if self.graph is None:
            self.io = self.fwd()
        else:
            replay(self.graph, self.held)


@torch.inference_mode()
def main(argv=None) -> dict:
    """Runs the A/B; returns {mode: fps of its fastest round}."""
    from . import resolve_device
    from .bench import (_seconds, calibration_stats, int8_forward,
                        seeded_variables)
    from .common import card_label, resolve_cfg
    from .config.ir import compile_cfg
    from .models import graph
    from .models.zoo import FLAGSHIP

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=FLAGSHIP, help="zoo name or cfg")
    ap.add_argument("--modes", nargs="+", default=["edge", "chain"])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)
    modes = [check_mode(m) for m in args.modes]
    device = resolve_device(args.device)
    label = card_label(device)
    bf16 = torch.bfloat16

    ir = compile_cfg(resolve_cfg(args.model))
    t = time.perf_counter()
    folded = graph.fold_batchnorm(ir, seeded_variables(ir, 0))
    placed = graph.place_folded(ir, folded, device, bf16)
    stats = calibration_stats(ir, placed, args, device)
    del placed
    print(f"# init+fold+cal {time.perf_counter() - t:.1f}s", flush=True)

    rng = np.random.default_rng(0)
    shape = (args.batch, args.height, args.width, 3)
    xv = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device,
                                                                   bf16)
    xl = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(
        device, bf16) if ir.dual_stream else None
    runs = {}
    for m in modes:
        t = time.perf_counter()
        fwd = int8_forward(ir, folded, stats, m.removesuffix("+fpstem"),
                           device, (args.height, args.width),
                           strip_stems=m.endswith("+fpstem"))
        runs[m] = _Leg(m, fwd, xv, xl, device)
        print(f"# build[{m}] {time.perf_counter() - t:.1f}s", flush=True)

    frames = args.batch * args.iters
    times = {m: [] for m in modes}
    for r in range(args.rounds):
        for m in modes:
            times[m].append(_seconds(runs[m], args.iters, device))
        line = " ".join(f"{m}={frames / times[m][-1]:.1f}" for m in modes)
        print(f"# round {r}: {line} fps", flush=True)

    best = {}
    for m in modes:
        dt = min(times[m])
        best[m] = frames / dt
        print(f"{m}: {best[m]:.1f} fps (dt {dt / args.iters * 1e3:.2f} ms a "
              f"forward of {args.batch}) on {label}", flush=True)
    return best


if __name__ == "__main__":
    main()
