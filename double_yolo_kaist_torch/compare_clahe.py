"""Visual comparison of CLAHE with the original image: the frame before
and after the port's batched CLAHE (``data/clahe.py``, clip 1.0, 4x4
tiles), with their channel histograms, written as one PNG.

    python -m double_yolo_kaist_torch.compare_clahe <visible.jpg> \\
        [out.png] [--device cuda]

The port's counterpart of the JAX package's ``tools/compare_clahe.py``
(the reference's imgs/compare_hist_clahe.py); like it, it crops the frame
to the 4x4 tile grid first. A third column shows
``cv2.createCLAHE(clipLimit=1.0, tileGridSize=(4, 4))`` applied per
channel, the reference's own CLAHE (snowflake.py:46-51), with the share of
pixels where it differs from the port's. The tool needs OpenCV (it also
reads the image) and matplotlib, and exits naming either where it is
absent.
"""

from __future__ import annotations

import argparse

import numpy as np


def clahe_arrays(img, device):
    """(the frame cropped to the 4x4 tile grid, as the JAX tool crops it;
    the port's CLAHE of it on ``device``; cv2's per-channel CLAHE of it)
    for an RGB uint8 frame."""
    import cv2
    import torch

    from .data.clahe import clahe_batch

    h, w = img.shape[:2]
    img = np.ascontiguousarray(img[:h - h % 4, :w - w % 4])
    eq = clahe_batch(torch.from_numpy(img[None]).to(device))[0].cpu().numpy()
    cl = cv2.createCLAHE(clipLimit=1.0, tileGridSize=(4, 4))
    ref = np.stack([cl.apply(np.ascontiguousarray(img[..., c]))
                    for c in range(3)], -1)
    return img, eq, ref


def main(argv=None) -> str:
    """Writes the PNG; returns its path."""
    from .common import pyplot

    ap = argparse.ArgumentParser()
    ap.add_argument("image")
    ap.add_argument("out", nargs="?", default="clahe_compare.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the CLAHE; cpu runs the plain "
                         "PyTorch path")
    args = ap.parse_args(argv)
    plt = pyplot("compare_clahe")
    try:
        import cv2
    except ImportError:
        raise SystemExit("compare_clahe reads the image with OpenCV (cv2), "
                         "which is not installed here") from None
    from . import resolve_device

    img = cv2.imread(args.image)
    if img is None:
        raise SystemExit(f"cannot read {args.image}")
    img, eq, ref = clahe_arrays(img[:, :, ::-1], resolve_device(args.device))
    differ = float((ref != eq).any(-1).mean())

    cols = ((img, "original"), (eq, "CLAHE (clip 1.0, 4x4 tiles)"),
            (ref, f"cv2 CLAHE per channel ({differ * 100:.2f}% of pixels "
                  f"differ)"))
    fig, axes = plt.subplots(2, 3, figsize=(18, 8))
    for (im, title), top, bottom in zip(cols, axes[0], axes[1]):
        top.imshow(im)
        top.set_title(title)
        top.axis("off")
        for c, color in enumerate("rgb"):
            bottom.hist(im[..., c].ravel(), bins=64, histtype="step",
                        color=color)
        bottom.set_xlim(0, 255)
    fig.savefig(args.out, bbox_inches="tight", dpi=110)
    plt.close(fig)
    print(f"wrote {args.out} (cv2 differs on {differ * 100:.2f}% of pixels)")
    return args.out


if __name__ == "__main__":
    main()
