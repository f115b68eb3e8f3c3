"""Detection on image pairs (the reference's detect.py:26-169 surface): take
``*_visible.jpg`` paths, find each LWIR sibling, run the dual-stream model
and NMS (conf 0.1, IoU 0.5, multi-label), draw a 3-panel figure (visible
with boxes, LWIR with boxes, visible as it is), and report the average fps
and the miss rate (the share of images with no detection).

    python -m double_yolo_kaist_torch.detect --cfg <model.cfg or zoo name> \\
        --weights <checkpoint dir, .pt or darknet .weights> \\
        --source <image, glob or directory of *_visible.jpg> [--no-figure]

The flags and printed lines are those of the JAX package's
``cli/detect.py``, plus ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch path). Each pair is letterboxed to a multiple of 64 in one
stage and served by :class:`.serving.Predictor` with one bucket of one
frame, so on CUDA every image replays one CUDA graph per frame size; the
first image of each size captures it, outside the timed calls.
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import time

import numpy as np


def get_pair_paths(path: str):
    """One path of either modality -> (visible, lwir)
    (reference detect.py:51-56)."""
    if "_visible" in path:
        return path, path.replace("_visible", "_lwir")
    if "_lwir" in path:
        return path.replace("_lwir", "_visible"), path
    return (path.replace(".jpg", "_visible.jpg"),
            path.replace(".jpg", "_lwir.jpg"))


def _figure(path, v0, l0, boxes, scores, classes, conf_thres):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .utils.draw import draw_boxes

    v_drawn = draw_boxes(np.ascontiguousarray(v0), boxes, scores, classes,
                         ["person"], conf_thres)
    l_drawn = draw_boxes(np.ascontiguousarray(l0), boxes, scores, classes,
                         ["person"], conf_thres)
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    for ax, im, title in zip(axes, (v_drawn, l_drawn, v0),
                             ("visible", "lwir", "original")):
        ax.imshow(im)
        ax.set_title(title)
        ax.axis("off")
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--source", type=str, required=True,
                   help="image path, glob, or directory of *_visible.jpg")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--conf-thres", type=float, default=0.1)
    p.add_argument("--iou-thres", type=float, default=0.5)
    p.add_argument("--merge-nms", action="store_true",
                   help="merge-NMS (weighted box fusion) variant")
    p.add_argument("--max-images", type=int, default=40)
    p.add_argument("--out-dir", type=str, default="runs/detect")
    p.add_argument("--no-figure", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch path")
    opt = p.parse_args(argv)

    import cv2
    import torch

    from .common import build_model
    from .serving import Predictor

    if os.path.isdir(opt.source):
        paths = sorted(glob.glob(os.path.join(opt.source, "*_visible.jpg")))
    else:
        paths = sorted(glob.glob(opt.source))
    random.Random(0).shuffle(paths)
    paths = paths[:opt.max_images]
    if not paths:
        raise FileNotFoundError(f"no images match {opt.source}")

    ir, variables = build_model(opt.cfg, opt.weights)
    pred = Predictor(ir, variables, img_size=opt.img_size,
                     conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
                     batch_buckets=(1,), compute_dtype=torch.bfloat16,
                     merge=opt.merge_nms, device=opt.device)
    if not opt.no_figure:
        os.makedirs(opt.out_dir, exist_ok=True)
    ready = set()
    n_missed, total_time = 0, 0.0
    for path in paths:
        vp, lp = get_pair_paths(path)
        v0 = cv2.imread(vp)[:, :, ::-1]
        l0 = cv2.imread(lp)[:, :, ::-1]
        src_hw = v0.shape[:2]
        if src_hw not in ready:          # capture outside the timed calls
            pred.warmup(src_hw)
            ready.add(src_hw)
        t0 = time.perf_counter()
        (boxes, scores, classes), = pred(v0[None], l0[None])
        total_time += time.perf_counter() - t0
        if len(boxes) == 0:
            n_missed += 1
        if not opt.no_figure:
            _figure(os.path.join(opt.out_dir, os.path.basename(vp).replace(
                "_visible", "_det")), v0, l0, boxes, scores, classes,
                opt.conf_thres)
        print(f"{os.path.basename(vp)}: {len(boxes)} detections")

    fps = len(paths) / total_time if total_time else 0.0
    print(f"average fps: {fps:.2f}")
    print(f"miss rate (no-detection fraction): {n_missed / len(paths):.3f}")


if __name__ == "__main__":
    main()
