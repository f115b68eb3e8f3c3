"""Offline int8 calibration: write the activation-scale artifact, and the
finished quantized variables, that a fleet of servers shares.

    python -m double_yolo_kaist_torch.calibrate --cfg <cfg or zoo name> \\
        --weights <checkpoint dir, .pt or .weights> --data m.data \\
        [--split valid] [--img-size 512] [--batches 8] [--batch-size 8] \\
        [--pct 100.0] [--fp32] --out calib.npz \\
        [--quantized-out qvars.npz --int8-mode chain] [--device cuda]

The counterpart of the JAX package's ``tools/calibrate.py``, with its flags
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
Representative frames of a split, letterboxed as the evaluation letterboxes
them, run through the BN-folded model; the statistics every int8 mode reads
go to ``--out`` (:func:`.models.quantize.save_calibration`). With
``--quantized-out`` the variables of ``--int8-mode``, quantized for the
serving size ``(img-size, img-size)``, go there too
(:func:`.models.quantize.save_quantized`): ``serve --int8-qvars`` and
``evaluate --int8-qvars`` then load them without calibrating or quantizing.
Both files are in the JAX package's format. The variables are quantized from
the fp32 fold, as a Predictor quantizes them in process, so a server that
loads them serves what one that quantized itself would.
"""

from __future__ import annotations

import argparse

import torch

from . import resolve_device
from .common import build_model
from .config.parser import parse_data_cfg
from .data.dataset import KaistDataset
from .data.pipeline import eval_batches
from .models import graph
from .models import quantize as Q


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", required=True,
                   help="model cfg path or zoo name")
    p.add_argument("--weights", default="")
    p.add_argument("--data", required=True)
    p.add_argument("--split", default="valid",
                   choices=("train", "valid", "test"))
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--batches", type=int, default=8,
                   help="calibration batches (max-abs only ever grows)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pct", type=float, default=100.0,
                   help="percentile max-abs clipping; 100 = exact max-abs")
    p.add_argument("--fp32", action="store_true",
                   help="measure in float32 (default bf16)")
    p.add_argument("--out", required=True, help="calibration artifact .npz")
    p.add_argument("--quantized-out", default="",
                   help="also write the finished quantized variables (.npz) "
                        "that serve / evaluate --int8-qvars load")
    p.add_argument("--int8-mode", default="chain", choices=Q.MODES,
                   help="int8 plan baked into --quantized-out")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch path")
    opt = p.parse_args(argv)

    dev = resolve_device(opt.device)
    dtype = torch.float32 if opt.fp32 else torch.bfloat16
    ir, variables = build_model(opt.cfg, opt.weights)
    folded = graph.fold_batchnorm(ir, variables)
    placed = graph.place_folded(ir, folded, dev, dtype)

    split_txt = parse_data_cfg(opt.data)[opt.split]
    ds = KaistDataset(split_txt, img_size=opt.img_size,
                      batch_size=opt.batch_size, rect=True)

    def frames():
        for i, (xv, xl, _idx, _rp) in enumerate(
                eval_batches(ds, opt.batch_size, device=dev)):
            if i >= opt.batches:
                return
            yield xv.to(dtype), xl.to(dtype)

    stats = Q.calibrate(ir, placed, frames(), compute_dtype=dtype,
                        pct=opt.pct)
    Q.save_calibration(opt.out, stats, pct=opt.pct)
    n_vec = sum(1 for v in stats.values() if getattr(v, "ndim", 0))
    n_batches = min(opt.batches, -(-len(ds) // opt.batch_size))
    print(f"calibration: {len(stats)} stats ({n_vec} per-channel vectors) "
          f"from {n_batches} batches @pct={opt.pct} -> {opt.out}",
          flush=True)

    if opt.quantized_out:
        hw = (opt.img_size, opt.img_size)
        qvars = Q.quantize(ir, folded, stats, mode=opt.int8_mode, hw=hw)
        Q.save_quantized(opt.quantized_out, qvars, mode=opt.int8_mode,
                         hw=hw)
        print(f"quantized variables (mode={opt.int8_mode}, hw={hw}) -> "
              f"{opt.quantized_out}", flush=True)


if __name__ == "__main__":
    main()
