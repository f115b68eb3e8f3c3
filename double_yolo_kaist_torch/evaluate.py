"""Offline evaluation entry point: COCO stats + VOC-AP@0.5 + LAMR + fps on a
KAIST split (the reference's evaluate.py:126-145 surface).

    python -m double_yolo_kaist_torch.evaluate --cfg <model.cfg or zoo name> \\
        --weights <checkpoint dir, reference .pt or darknet .weights> \\
        --data <split.data> \\
        [--test-type test] [--img-size 512] [--batch-size 32] [--fp32 | --int8]

The flags and printed lines are those of the JAX package's
``cli/evaluate.py``, plus ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch path).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .common import DEFAULT_HYP, build_model
from .config.parser import load_hyp, parse_data_cfg
from .data.dataset import KaistDataset
from .eval.coco_map import summarize
from .eval.evaluator import evaluate_dataset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default="data/kaist_data.data")
    p.add_argument("--test-type", type=str, default="test",
                   choices=["test", "day_test", "night_test", "valid"])
    p.add_argument("--hyp", type=str, default=DEFAULT_HYP)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--npy-path", type=str, default="")
    p.add_argument("--conf-thres", type=float, default=0.01)
    p.add_argument("--iou-thres", type=float, default=0.6)
    p.add_argument("--merge-nms", action="store_true",
                   help="merge-NMS (weighted box fusion) variant")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="selective post-training int8 inference")
    p.add_argument("--calibration-pct", type=float, default=100.0,
                   help="int8 calibration percentile (100 = exact max-abs)")
    p.add_argument("--int8-mode", default="chain",
                   choices=("seed", "chain", "all", "edge", "spine", "spineall"),
                   help="quantization plan: 3x3-only / int8 chains / all convs")
    p.add_argument("--int8-calib", default="",
                   help="calibration artifact (.npz): evaluate with its "
                        "frozen scales; if missing, this run's stats are "
                        "saved there")
    p.add_argument("--int8-qvars", default="",
                   help="quantized-variables artifact (.npz, python -m "
                        "double_yolo_kaist_torch.calibrate --quantized-out): "
                        "evaluate the literal int8 model serving loads")
    p.add_argument("--cache-images", choices=("ram", "disk"), default=None,
                   help="cache decoded pairs in RAM or as .npy files")
    p.add_argument("--device-cache", choices=("auto", "on", "off"),
                   default="auto",
                   help="keep the split's u8 pairs resident (device memory if "
                        "it fits DYK_DEVICE_CACHE_GB, else pinned host "
                        "memory) and gather batches there instead of "
                        "copying them each time")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch path")
    opt = p.parse_args(argv)

    data_dict = parse_data_cfg(opt.data)
    ds = KaistDataset(data_dict[opt.test_type], opt.img_size, opt.batch_size,
                      hyp=load_hyp(opt.hyp) if os.path.exists(opt.hyp) else {},
                      rect=True, cache_images=opt.cache_images)
    ir, variables = build_model(opt.cfg, opt.weights)
    res = evaluate_dataset(
        ir, variables, ds, batch_size=opt.batch_size,
        conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
        compute_dtype=torch.float32 if opt.fp32 else torch.bfloat16,
        int8=opt.int8, int8_mode=opt.int8_mode, merge=opt.merge_nms,
        calibration_pct=opt.calibration_pct,
        calibration=opt.int8_calib or None,
        quantized=opt.int8_qvars or None,
        device_cache={"auto": None, "on": True, "off": False}[opt.device_cache],
        progress=True, device=opt.device)

    print(summarize(res["coco_stats"]))
    print(f"VOC Average Precision (VOC-AP)@[IoU = 0.5] = {res['ap'] * 100:.2f}%")
    print(f"Log Average Miss Rate (LAMR)@[IoU = 0.5] = {res['lamr'] * 100:.2f}%")
    print(f"average detecting fps: {res['fps']:.2f} "
          "(forward+NMS+fetch; reference evaluate.py times forward-only)")
    if opt.npy_path:
        np.save(opt.npy_path, {**res["curves"], "ap": res["ap"],
                               "lamr": res["lamr"]})


if __name__ == "__main__":
    main()
