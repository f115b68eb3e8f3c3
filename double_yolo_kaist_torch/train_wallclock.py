"""Measured end-to-end training wall clock: a real multi-epoch ``Trainer``
on a synthetic KAIST-shaped split.

    python -m double_yolo_kaist_torch.train_wallclock [--images 1024] \\
        [--epochs 50] [--batch 32] [--img-size 512] [--model <zoo name>] \\
        [--spd 4] [--remat 6] [--fit [--val-images 2106] \\
        [--resume auto|<dir>]] [--device cuda]

The port's counterpart of the JAX package's ``tools/train_wallclock.py``:
``--images`` native 512x640 pairs written as JPEGs under
``--root`` (reused when present), decoded once into the disk cache, and a
``train.trainer.Trainer`` (SGD, the tool's hyperparameters, ``--spd``
steps a dispatch: on the card one CUDA graph of the step replayed that
many times, ``train/step.py::CapturedSteps``; ``--remat`` checkpointed
segments) runs ``--epochs`` bare epochs. It prints each of the first two
epochs' and the last one's seconds, the total, the steady img/s (the
median epoch after the first two; of two epochs, the second) and the
full-KAIST (7989-image) epoch those imply, scaled by steps. ``--fit``
runs ``Trainer.fit`` instead (the in-train evaluation on a
``--val-images`` split, results.txt, the best checkpoint), optionally
resumed from ``--resume``. Every time names the card and its power
limit.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

HYP = {"lr0": 1e-3, "lrf": 0.1, "momentum": 0.937, "weight_decay": 5e-4,
       "box": 3.54, "obj": 102.88, "cls": 0.468, "cls_pw": 1.0,
       "obj_pw": 1.0, "iou_t": 0.2, "fl_gamma": 0.0, "ciou": 1.0,
       "hsv_h": 0.0138, "hsv_s": 0.678, "hsv_v": 0.36,
       "degrees": 0.0, "translate": 0.0, "scale": 0.0, "shear": 0.0}

KAIST_TRAIN_IMAGES = 7989   # the reference's data/kaist_data.data train split


def make_dataset(root: str, n: int, hw=(512, 640)) -> str:
    """``n`` seeded pairs of ``hw`` with one box each under ``root``;
    returns the split file (reused when it already lists ``n`` pairs)."""
    import cv2

    img_dir = os.path.join(root, "images", "set00")
    lab_dir = os.path.join(root, "labels", "set00")
    split = os.path.join(root, "train.txt")
    if os.path.exists(split):          # reuse across runs
        lines = open(split).read().splitlines()
        if len(lines) == n and all(
                os.path.exists(p.replace(".jpg", "_visible.jpg"))
                for p in lines[:2]):
            first = cv2.imread(lines[0].replace(".jpg", "_visible.jpg"))
            if first is not None and first.shape[:2] == tuple(hw):
                return split
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    logical = []
    for i in range(n):
        v = rng.integers(0, 256, tuple(hw) + (3,), dtype=np.uint8)
        stem = f"I{i:05d}"
        cv2.imwrite(os.path.join(img_dir, f"{stem}_visible.jpg"), v)
        cv2.imwrite(os.path.join(img_dir, f"{stem}_lwir.jpg"), v)
        cx, cy = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7)
        with open(os.path.join(lab_dir, f"{stem}.txt"), "w") as f:
            f.write(f"0 {cx:.4f} {cy:.4f} 0.1 0.3\n")
        logical.append(os.path.join(img_dir, f"{stem}.jpg"))
    with open(split, "w") as f:
        f.write("\n".join(logical) + "\n")
    return split


def main(argv=None) -> dict:
    """Runs the measurement; returns {"epoch_s": [...], "img_s", ...}
    (bare epochs) or {"total_s", "best"} (``--fit``)."""
    from .models.zoo import FLAGSHIP

    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=1024)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--img-size", type=int, default=512)
    ap.add_argument("--model", default=FLAGSHIP, help="zoo name or cfg")
    ap.add_argument("--spd", type=int, default=4,
                    help="steps per dispatch (one CUDA graph on the card)")
    ap.add_argument("--remat", type=int, default=6)
    ap.add_argument("--root", default=os.path.join(
        tempfile.gettempdir(), "dyk_torch_train_wallclock"))
    ap.add_argument("--fit", action="store_true",
                    help="the whole production loop (Trainer.fit: in-train "
                         "eval each epoch, TB scalars, results.txt, best "
                         "checkpoint) instead of bare train epochs")
    ap.add_argument("--val-images", type=int, default=2106,
                    help="--fit validation split size (KAIST val = 2106)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir to Trainer.load() before --fit "
                         "('auto' = <root>/runs/exp/last, falling back to "
                         "best): extends a finished run toward --epochs")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)

    from . import resolve_device
    from .common import card_label, resolve_cfg
    from .config.ir import compile_cfg
    from .data.dataset import KaistDataset
    from .train.trainer import Trainer

    device = resolve_device(args.device)
    label = card_label(device)
    split = make_dataset(args.root, args.images)
    ds = KaistDataset(split, args.img_size, args.batch, augment=True,
                      hyp=HYP, cache_images="disk")
    val_ds = ds
    if args.fit and args.val_images != args.images:
        vsplit = make_dataset(os.path.join(args.root, "val"),
                              args.val_images)
        val_ds = KaistDataset(vsplit, args.img_size, args.batch,
                              augment=False, hyp=HYP, cache_images="disk",
                              rect=True)
    ir = compile_cfg(resolve_cfg(args.model))
    tr = Trainer(ir, HYP, epochs=args.epochs, batch_size=args.batch,
                 img_size=args.img_size, train_dataset=ds,
                 val_dataset=val_ds, sgd=True,
                 steps_per_dispatch=args.spd, remat_segments=args.remat,
                 out_dir=os.path.join(args.root, "runs"), device=device)
    setting = (f"bs{args.batch}, {args.img_size}px, spd={args.spd}, "
               f"remat={args.remat}")

    if args.fit:
        if args.resume:
            path = args.resume
            if path == "auto":
                base = os.path.join(args.root, "runs", "exp")
                path = os.path.join(base, "last")
                if not os.path.isdir(path):
                    path = os.path.join(base, "best")
            tr.load(path)
            print(f"[wallclock] resumed {path}: start_epoch="
                  f"{tr.start_epoch} best_map={tr.best_map:.4f}", flush=True)
        t0 = time.perf_counter()
        best = tr.fit(save_best=True)
        total = time.perf_counter() - t0
        print(f"[wallclock] FULL fit: {args.epochs} epochs x "
              f"{args.images} imgs ({setting}, val={args.val_images}): "
              f"total {total / 3600:.2f} h wall on {label}; best "
              f"mAP@[.5:.95]={best:.4f}; artifacts in "
              f"{os.path.join(args.root, 'runs')}", flush=True)
        return {"total_s": total, "best": best}

    t0 = time.perf_counter()
    epoch_times = []
    for epoch in range(args.epochs):
        te = time.perf_counter()
        tr.train_one_epoch(epoch, print_freq=1000)
        epoch_times.append(time.perf_counter() - te)
        if epoch in (0, 1) or epoch == args.epochs - 1:
            print(f"[wallclock] epoch {epoch}: {epoch_times[-1]:.1f}s on "
                  f"{label}", flush=True)
    total = time.perf_counter() - t0

    steps_per_epoch = max(args.images // args.batch, 1)
    # the first epoch pays the capture and the decode cache: steady is the
    # median after the first two (JAX's), or after the first of two
    steady = float(np.median(epoch_times[2:] or epoch_times[1:]
                             or epoch_times))
    img_s = args.images / steady
    kaist_epoch = steady * (KAIST_TRAIN_IMAGES // args.batch) / \
        steps_per_epoch
    print(f"[wallclock] {args.epochs} epochs x {args.images} imgs "
          f"({setting}): total {total / 60:.1f} min (epoch0 "
          f"{epoch_times[0]:.0f}s incl. capture+decode-cache) on {label}")
    print(f"[wallclock] steady-state {img_s:.1f} img/s -> KAIST "
          f"{KAIST_TRAIN_IMAGES}-img epoch = {kaist_epoch:.0f}s, 50 epochs "
          f"= {50 * kaist_epoch / 3600:.2f} h on {label}", flush=True)
    return {"epoch_s": epoch_times, "img_s": img_s,
            "kaist_epoch_s": kaist_epoch}


if __name__ == "__main__":
    main()
