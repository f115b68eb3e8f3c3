"""Zoo-wide throughput sweep: every published model through ``bench``.

    python -m double_yolo_kaist_torch.zoo_bench [--int8] \\
        [--models A B ...] [--batch 16] [--height 512] [--width 640] \\
        [--iters 20] [--out zoo_bench.jsonl] [--device cuda]

The port's counterpart of the JAX package's ``tools/zoo_bench.py``: each
model of :data:`.models.zoo.MODELS` (all 16 by default) goes through
:func:`.bench.measure_fps` on :func:`.bench.seeded_variables` (one CUDA
graph of the folded forward + head decode replayed ``--iters`` times
between CUDA events, the fastest of three repeats), in bf16 and, with
``--int8``, in int8 PTQ (``--int8-mode``, chain by default). A model whose
int8 plan is empty (the MobileNet family in chain mode) has no int8 leg:
its int8 forward would be its bf16 forward, so the row says so
(``int8_plan: "empty"``) and carries no int8 figure.

Each model's row streams to ``--out`` as one JSON line with the JAX tool's
keys (``model``, ``batch``, ``hw``, ``bf16_fps``, ``bf16_repeats``,
``int8_fps``, ``int8_repeats``, ``ref_fps``, ``vs_ref``, ``wall_s``, and
``error`` on a failure) plus ``device``: the card's name and power limit
(:func:`.common.card_label`). ``ref_fps`` is the reference's published
bs-1 figure on a Quadro RTX 6000, so ``vs_ref`` compares batched card
throughput with single-frame latency on another card, not two runs of one
protocol. A failed model gets its ``error`` row and the sweep goes on; the
process then exits 1. The markdown table of the JAX tool ends the output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
import traceback

import torch

from . import resolve_device
from .bench import measure_fps, seeded_variables
from .common import card_label
from .config.ir import compile_cfg
from .models import quantize as Q
from .models.zoo import MODELS, cfg_path, reference_fps

WARMUP = 3                    # replays before each timed repeat


def bench_model(name: str, args, device, label: str) -> dict:
    """One model's row (``error`` set on a failure)."""
    row = {"model": name, "batch": args.batch,
           "hw": [args.height, args.width], "device": label}
    t0 = time.perf_counter()
    try:
        ir = compile_cfg(cfg_path(name))
        variables = seeded_variables(ir, 0)
        fps, spread = measure_fps(ir, variables, args, False, device)
        row["bf16_fps"] = round(fps, 1)
        row["bf16_repeats"] = spread
        if args.int8:
            if Q.plan_quantization(ir, args.int8_mode)[0]:
                fps, spread = measure_fps(ir, variables, args, True, device)
                row["int8_fps"] = round(fps, 1)
                row["int8_repeats"] = spread
            else:
                row["int8_plan"] = "empty"
        ref = reference_fps(name)
        row["ref_fps"] = ref
        row["vs_ref"] = round(row.get("int8_fps", row["bf16_fps"]) / ref, 1)
    except Exception:                      # noqa: BLE001 — a row, then on
        row["error"] = traceback.format_exc(limit=3)
    row["wall_s"] = round(time.perf_counter() - t0, 1)
    gc.collect()                           # each model's graphs and pools
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def table(rows: list, int8: bool) -> str:
    """The JAX tool's markdown table of ``rows``."""
    lines = ["| Model | bf16 fps | " + ("int8 fps | " if int8 else "")
             + "ref GPU fps | speedup |",
             "|---|---|" + ("---|" if int8 else "") + "---|---|"]
    for r in rows:
        # on error keep any leg that did measure and pad every column
        cells = [r["model"], str(r.get("bf16_fps", "ERROR"))]
        if int8:
            cells.append(str(r.get("int8_fps", "ERROR" if "error" in r else
                                   "bf16 (empty plan)"
                                   if r.get("int8_plan") else "")))
        cells += [str(r.get("ref_fps", "")),
                  f"{r['vs_ref']}x" if "vs_ref" in r else ""]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="*", default=list(MODELS),
                    help="subset of zoo model names (default: all 16)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--int8", action="store_true",
                    help="also measure the int8 PTQ leg per model")
    ap.add_argument("--int8-mode", default="chain", choices=Q.MODES)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "zoo_bench.jsonl"))
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)
    args.warmup = WARMUP                   # bench.measure_fps's default
    device = resolve_device(args.device)
    label = card_label(device)
    print(f"# zoo_bench on {label}: batch {args.batch}, {args.height}x"
          f"{args.width}, {args.iters} iters", file=sys.stderr, flush=True)

    rows = []
    with open(args.out, "a") as f:
        for name in args.models:
            row = bench_model(name, args, device, label)
            print(json.dumps(row), file=f, flush=True)
            rows.append(row)
            msg = row.get("error", "").splitlines()[-1:] or [
                f"bf16 {row.get('bf16_fps')}"
                + (f" int8 {row['int8_fps']}" if "int8_fps" in row else "")
                + (" int8 plan empty" if row.get("int8_plan") else "")
                + f" fps on {label} ({row['wall_s']}s)"]
            print(f"# {name}: {msg[0]}", file=sys.stderr, flush=True)

    print(f"\nbatch {args.batch}, {args.height}x{args.width}, on {label}; "
          f"ref: the reference's bs-1 fps on a Quadro RTX 6000")
    print(table(rows, args.int8))
    failed = [r["model"] for r in rows if "error" in r]
    if failed:
        print(f"# zoo_bench: {len(failed)} model(s) failed: {failed}",
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
