"""Serving-path throughput: the whole ``serving.Predictor`` request (host
uint8 frames in -> letterbox -> forward -> NMS -> boxes out) on one card.

    python -m double_yolo_kaist_torch.serving_bench [--model <zoo name or
        cfg>] [--batch 16] [--n 10] [--int8] [--exported <artifact.zip>] \\
        [--device cuda]

The port's counterpart of the JAX package's ``tools/serving_bench.py``.
Unlike ``bench`` (forward + decode only), this times what a deployed
server delivers per card, pre- and post-processing and the host <-> device
copies included: ms per batch and img/s, on the host clock around ``--n``
synchronised ``Predictor.__call__``s (each returns host numpy), after the
warm-up and, under ``--int8``, after the calibration request has
finished. On the card each request is one CUDA-graph replay of its bucket
(``serving.Predictor``) plus the pinned staging and one fetch.

Weights come from :func:`.bench.seeded_variables`, whose heads depend on
the frames, so that NMS gets real candidates. ``--exported`` times an
artifact of ``python -m double_yolo_kaist_torch.export_model`` through
:class:`.export.ExportedPredictor` instead: its batch and source frame size
are the artifact's.

Frames are KAIST's 512x640, letterboxed to 512, as in the JAX tool. Under
``--int8`` a model whose chain plan is empty (the MobileNet family) is
served in bf16, and the printed mode says so. Every printed rate names the
card and its power limit.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from . import resolve_device
from .common import card_label


SRC_HW = (512, 640)           # KAIST's frames
IMG_SIZE = 512
CAL_BATCHES = 1               # int8: requests calibrated before serving


def build_predictor(args, device):
    """(predictor, model label, (h, w), int8) for ``args``; ``int8`` is
    False where the model's chain plan is empty or the artifact decides."""
    if args.exported:
        from .export import ExportedPredictor

        if args.int8:
            raise SystemExit("--int8 with --exported: precision is baked "
                             "into the artifact (meta['int8']); drop the "
                             "flag")
        pred = ExportedPredictor(args.exported, device=device)
        if args.batch != pred.batch:
            print(f"# --batch {args.batch} ignored: artifact compiled for "
                  f"batch {pred.batch}", flush=True)
        if tuple(pred.src_hw) != SRC_HW:
            print(f"# artifact src_hw {pred.src_hw} (not the KAIST "
                  f"512x640)", flush=True)
        args.batch = pred.batch
        return (pred, os.path.basename(args.exported), tuple(pred.src_hw),
                False)
    from .bench import seeded_variables
    from .common import resolve_cfg
    from .config.ir import compile_cfg
    from .models import quantize as Q
    from .serving import Predictor

    ir = compile_cfg(resolve_cfg(args.model))
    int8 = bool(args.int8 and Q.plan_quantization(ir, "chain")[0])
    pred = Predictor(ir, seeded_variables(ir, 0), img_size=IMG_SIZE,
                     batch_buckets=(args.batch,), int8=int8,
                     calibration_batches=CAL_BATCHES, device=device)
    return pred, args.model, SRC_HW, int8


def main(argv=None) -> dict:
    """Runs the benchmark; returns {"ms", "img_s", "mode", "batch"}."""
    from .models.zoo import FLAGSHIP

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=FLAGSHIP,
                    help="zoo name or cfg path")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n", type=int, default=10, help="timed batches")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--exported", default="",
                    help="time an artifact of python -m double_yolo_kaist_"
                         "torch.export_model instead of a live Predictor; "
                         "its batch replaces --batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    pred, model, (h, w), int8 = build_predictor(args, device)
    rng = np.random.default_rng(0)
    v = rng.integers(0, 255, (args.batch, h, w, 3), dtype=np.uint8)
    l = rng.integers(0, 255, (args.batch, h, w, 3), dtype=np.uint8)

    for _ in range(CAL_BATCHES + 1):       # (int8 calibration,) capture
        out = pred(v, l)                   # and warm the final graph
    if int8 and pred.qvars is None:
        raise RuntimeError("int8 calibration did not finish")
    t0 = time.perf_counter()
    for _ in range(args.n):
        out = pred(v, l)
    dt = (time.perf_counter() - t0) / args.n
    assert len(out) == args.batch
    fps = args.batch / dt
    if args.exported:
        mode = ("int8" if pred.meta.get("int8") else "bf16") + " exported"
    else:
        mode = ("int8" if int8 else "bf16 (int8 plan empty)" if args.int8
                else "bf16")
    replay = ("; one CUDA-graph replay a request"
              if device.type == "cuda" else "")
    print(f"serving e2e ({model}, {mode}, bs{args.batch}): "
          f"{dt * 1e3:.1f} ms/batch = {fps:.1f} img/s "
          f"(decode excluded; letterbox+forward+NMS+fetch included"
          f"{replay}) on {card_label(device)}", flush=True)
    return {"ms": dt * 1e3, "img_s": fps, "mode": mode, "batch": args.batch}


if __name__ == "__main__":
    main()
