"""Export a one-file serving artifact for a model.

    python -m double_yolo_kaist_torch.export_model --cfg <cfg or zoo name> \
        --weights <ckpt dir, .pt or .weights> --src-hw 512 640 --batch 8 \
        --out flagship.zip [--device cuda]
    # int8: the quantization must exist (an artifact is deterministic)
    python -m double_yolo_kaist_torch.export_model ... --int8 \
        --int8-qvars q.npz

The counterpart of the JAX package's ``tools/export_model.py``, with its
flags; ``--device`` (default ``cuda``; ``cpu`` for a CPU artifact) takes
the place of ``--platforms``, as a program is exported for the device it
runs on. The model is built through :func:`.common.build_model`; the file
(:func:`.export.export_serving_artifact`) is served by ``python -m
double_yolo_kaist_torch.serve --exported <file>`` or
:class:`.export.ExportedPredictor`, with no model code on that host.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--conf-thres", type=float, default=0.1)
    p.add_argument("--iou-thres", type=float, default=0.5)
    p.add_argument("--src-hw", type=int, nargs=2, default=(512, 640),
                   metavar=("H", "W"),
                   help="native frame size the artifact is exported for "
                        "(KAIST default 512 640)")
    p.add_argument("--batch", type=int, default=1,
                   help="exported batch size (partial batches pad)")
    p.add_argument("--out", type=str, required=True, help="artifact path")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--int8-mode", default="chain",
                   choices=("seed", "chain", "all", "edge", "spine",
                            "spineall"))
    p.add_argument("--int8-calib", default="",
                   help="calibration artifact (python -m "
                        "double_yolo_kaist_torch.calibrate --out) — "
                        "required with --int8 unless --int8-qvars exists")
    p.add_argument("--int8-qvars", default="",
                   help="finished quantized-variables artifact")
    p.add_argument("--device", default="cuda",
                   help="torch device the program is exported for")
    opt = p.parse_args(argv)

    from .common import build_model
    from .export import export_serving_artifact
    from .serving import Predictor

    ir, variables = build_model(opt.cfg, opt.weights)
    predictor = Predictor(
        ir, variables, img_size=opt.img_size, conf_thres=opt.conf_thres,
        iou_thres=opt.iou_thres, batch_buckets=(opt.batch,),
        int8=opt.int8, int8_mode=opt.int8_mode,
        calibration=opt.int8_calib or None,
        quantized=opt.int8_qvars or None, device=opt.device)
    meta = export_serving_artifact(predictor, tuple(opt.src_hw), opt.batch,
                                   opt.out)
    size_mb = os.path.getsize(opt.out) / 1e6
    print(f"wrote {opt.out} ({size_mb:.1f} MB): "
          f"platforms={meta['platforms']} src_hw={meta['src_hw']} "
          f"batch={meta['batch']} int8={meta['int8']}", flush=True)
    return meta


if __name__ == "__main__":
    main()
