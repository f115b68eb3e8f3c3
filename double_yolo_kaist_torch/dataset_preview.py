"""Visual check of the augmentation pipeline: augmented visible / LWIR
pairs with their transformed boxes, written as one PNG.

    python -m double_yolo_kaist_torch.dataset_preview --data <m.data> \\
        [--img-size 512] [--snow] [--n 4] [--seed 0] \\
        [--out dataset_preview.png] [--device cuda]

The port's counterpart of the JAX package's ``tools/dataset_preview.py``
(reference dataset_test.py:42-81): one batch of ``--n`` pairs of the
split's ``train`` list through :func:`.data.pipeline.train_batches`
(mosaic, affine, HSV, flip; the snowflake cutout with ``--snow``) on
``--device``, each drawn with its labels by
:func:`.utils.draw.draw_boxes`, to check that the boxes stay on the
pedestrians. It needs matplotlib, and exits naming it where it is absent.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def preview_arrays(batch) -> tuple:
    """(visible uint8, LWIR uint8, [(boxes in pixels x1y1x2y2, classes)]
    an image) of a train batch: what the tool draws."""
    def u8(x):
        return (x.float().cpu().numpy() * 255).astype(np.uint8)

    v, l = u8(batch["v"]), u8(batch["l"])
    t = batch["targets"].cpu().numpy()
    m = batch["tmask"].cpu().numpy()
    s = v.shape[1]
    boxes = []
    for i in range(len(v)):
        lab = t[i][m[i]]
        b = np.stack([(lab[:, 1] - lab[:, 3] / 2) * s,
                      (lab[:, 2] - lab[:, 4] / 2) * s,
                      (lab[:, 1] + lab[:, 3] / 2) * s,
                      (lab[:, 2] + lab[:, 4] / 2) * s], 1) \
            if len(lab) else np.zeros((0, 4))
        boxes.append((b, lab[:, 0]))
    return v, l, boxes


def main(argv=None) -> str:
    """Writes the PNG; returns its path."""
    from .common import DEFAULT_HYP, pyplot

    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--hyp", default=DEFAULT_HYP)
    ap.add_argument("--img-size", type=int, default=512)
    ap.add_argument("--snow", action="store_true")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="dataset_preview.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the augment; cpu runs the plain "
                         "PyTorch path")
    args = ap.parse_args(argv)
    plt = pyplot("dataset_preview")

    from . import resolve_device
    from .config.parser import load_hyp, parse_data_cfg
    from .data.dataset import KaistDataset
    from .data.pipeline import train_batches
    from .utils.draw import draw_boxes

    device = resolve_device(args.device)
    hyp = load_hyp(args.hyp) if os.path.exists(args.hyp) else {
        "hsv_h": 0.0138, "hsv_s": 0.678, "hsv_v": 0.36,
        "degrees": 0, "translate": 0, "scale": 0, "shear": 0}
    dd = parse_data_cfg(args.data)
    ds = KaistDataset(dd["train"], args.img_size, args.n, augment=True,
                      hyp=hyp, snowflake=args.snow)
    batch, _ = next(iter(train_batches(
        ds, args.n, args.seed, img_size=args.img_size, hyp=hyp,
        snowflake=args.snow, seed_epoch=args.seed,
        device=device)))

    v, l, drawn = preview_arrays(batch)
    n = len(v)
    fig, axes = plt.subplots(n, 2, figsize=(10, 5 * n))
    axes = np.atleast_2d(axes)
    for i, (boxes, cls) in enumerate(drawn):
        scores = np.ones(len(boxes))
        axes[i, 0].imshow(draw_boxes(v[i], boxes, scores, cls, ["person"],
                                     0.0))
        axes[i, 1].imshow(draw_boxes(l[i], boxes, scores, cls, ["person"],
                                     0.0))
        axes[i, 0].set_title(f"visible ({len(boxes)} boxes)")
        axes[i, 1].set_title("lwir")
        for ax in axes[i]:
            ax.axis("off")
    fig.savefig(args.out, bbox_inches="tight", dpi=100)
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
