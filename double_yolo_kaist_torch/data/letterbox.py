"""Letterbox preprocessing in plain torch.

Counterparts of the JAX package's ``data/augment.py::resize_bilinear``
(cv2 INTER_LINEAR with half-pixel centres) and ``data/pipeline.py::
make_letterbox_fn`` (the single-stage detect-flow letterbox, reference
img_utils.py:5-53 math, with its optional CLAHE). Images are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .clahe import clahe_batch


def resize_bilinear(img, out_h: int, out_w: int):
    """cv2.INTER_LINEAR-compatible bilinear resize, half-pixel centres.
    img: (..., H, W, C) float or uint8 -> fp32."""
    x = img.float()
    h, w = x.shape[-3], x.shape[-2]
    sy, sx = h / out_h, w / out_w
    dev = x.device
    yc = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * sy - 0.5
    xc = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * sx - 0.5
    y0 = torch.clamp(torch.floor(yc), 0, h - 1)
    x0 = torch.clamp(torch.floor(xc), 0, w - 1)
    wy = torch.clamp(yc - y0, 0.0, 1.0)
    wx = torch.clamp(xc - x0, 0.0, 1.0)
    y0i, x0i = y0.long(), x0.long()
    y1i = torch.clamp_max(y0i + 1, h - 1)
    x1i = torch.clamp_max(x0i + 1, w - 1)

    rows0, rows1 = x[..., y0i, :, :], x[..., y1i, :, :]
    top = rows0[..., :, x0i, :] * (1 - wx)[:, None] \
        + rows0[..., :, x1i, :] * wx[:, None]
    bot = rows1[..., :, x0i, :] * (1 - wx)[:, None] \
        + rows1[..., :, x1i, :] * wx[:, None]
    return top * (1 - wy)[:, None, None] + bot * wy[:, None, None]


def clahe_u8(x):
    """Float pixels in [0, 255] -> rounded to uint8, CLAHE'd
    (:func:`.clahe.clahe_batch`), back to fp32: the JAX package's
    ``clahe_batch(clip(round(x), 0, 255).astype(uint8)).astype(float32)``."""
    u8 = torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
    return clahe_batch(u8).float()


def letterbox_params(src_hw, dst_hw, scale_up: bool = True):
    """The letterbox's numbers, as Python floats and ints (JAX
    data/augment.py:154-162, reference img_utils.py): (ratio, (dw, dh),
    (new_w, new_h))."""
    r = min(dst_hw[0] / src_hw[0], dst_hw[1] / src_hw[1])
    if not scale_up:
        r = min(r, 1.0)
    new_w, new_h = int(round(src_hw[1] * r)), int(round(src_hw[0] * r))
    dw, dh = (dst_hw[1] - new_w) / 2, (dst_hw[0] - new_h) / 2
    return r, (dw, dh), (new_w, new_h)


def pad_sides(dst_hw, new_hw, dw: float, dh: float) -> tuple:
    """(left, right, top, bottom) rows and columns of the letterbox's
    padding around a ``new_hw`` image in ``dst_hw``."""
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    return (left, dst_hw[1] - new_hw[1] - left,
            top, dst_hw[0] - new_hw[0] - top)


def make_letterbox_fn(src_hw, dst_hw, scale_up: bool = True,
                      clahe: bool = False):
    """Letterbox from ``src_hw`` frames to ``dst_hw``: resize by the common
    ratio, CLAHE with ``clahe`` (JAX pipeline.py:271-291), zero-pad to
    ``dst_hw``, scale to [0, 1]. Returns (fn(v_u8, l_u8) -> (v, l) fp32
    NHWC, (r, r), (dw, dh))."""
    r, (dw, dh), (new_w, new_h) = letterbox_params(src_hw, dst_hw, scale_up)
    sides = pad_sides(dst_hw, (new_h, new_w), dw, dh)

    def fn(v_u8, l_u8):
        out = []
        for im in (v_u8, l_u8):
            im = resize_bilinear(im, new_h, new_w)
            if clahe:
                im = clahe_u8(im)
            # F.pad pads from the last dim backwards: C, W, H
            out.append(F.pad(im, (0, 0) + sides) / 255.0)
        return tuple(out)

    return fn, (r, r), (dw, dh)
