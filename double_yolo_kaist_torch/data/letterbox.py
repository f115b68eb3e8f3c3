"""Letterbox preprocessing in plain torch, and the bilinear resize in its
two forms.

Counterparts of the JAX package's ``data/augment.py::resize_bilinear``
(cv2 INTER_LINEAR with half-pixel centres), its matmul form
``resize_bilinear_mm`` with the separable resample ``_matmul_resample``
(JAX augment.py:57-91), and ``data/pipeline.py::make_letterbox_fn`` (the
single-stage detect-flow letterbox, reference img_utils.py:5-53 math,
with its optional CLAHE). Images are NHWC.

The matmul form moves pixels by two products with interpolation
matrices of at most two taps a row: out = RowM @ img @ ColM^T per
channel, accumulated in fp32 (on the card it raises if TF32 is on for
fp32 products), rows first, then columns, as JAX contracts them. Its
taps, clips and weights are the gather form's; the two differ only in
how the two taps are summed (an ulp of fp32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .clahe import clahe_batch


def _tf32_matmul_on() -> bool:
    """Whether cuBLAS may run fp32 products in TF32: the legacy switch
    (``torch.backends.cuda.matmul.allow_tf32``, which
    ``torch.set_float32_matmul_precision`` sets), or the per-backend one
    where the caller set that one."""
    m = torch.backends.cuda.matmul
    try:
        return bool(m.allow_tf32)
    except RuntimeError:          # the caller used the per-backend switch
        return m.fp32_precision == "tf32"


def _matmul_resample(img, rm, cm):
    """img (..., H, W, C) x rm (..., H', H) x cm (..., W', W) ->
    (..., H', W', C) in ``img``'s dtype; the leading dims of rm / cm
    broadcast against img's (JAX augment.py:57-68). The products run on
    fp32 values (bf16 pixels and weights are exact in fp32) with fp32
    accumulation, the rows contracted first, and the result is cast once
    at the end, as JAX's ``preferred_element_type`` keeps it."""
    x = img.float()
    if x.is_cuda and _tf32_matmul_on():
        raise RuntimeError(
            "the matmul resample needs full fp32 products: turn TF32 off "
            "(torch.backends.cuda.matmul.allow_tf32 = False, or "
            "torch.set_float32_matmul_precision('highest'))")
    *lead, h, w, c = x.shape
    y = torch.matmul(rm.float(), x.reshape(*lead, h, w * c))
    ho = y.shape[-2]
    # columns: (..., H' C, W) @ (..., W, W') -> (..., H', C, W')
    y = y.reshape(*y.shape[:-1], w, c).transpose(-1, -2)
    y = y.reshape(*y.shape[:-3], ho * c, w)
    z = torch.matmul(y, cm.float().transpose(-1, -2))
    z = z.reshape(*z.shape[:-2], ho, c, z.shape[-1]).transpose(-1, -2)
    return z.to(img.dtype).contiguous()


@functools.lru_cache(maxsize=32)
def _lerp_matrix_resize(out_n: int, in_n: int, scale: float, dtype,
                        device: str):
    """The resize's interpolation matrix (out_n, in_n): exactly
    :func:`resize_bilinear`'s taps (half-pixel centres, clipped base
    index, weight clipped to [0, 1], second tap min(i0 + 1, n - 1),
    coincident taps summed to weight 1), built with JAX's numpy code
    (JAX augment.py:71-82) and kept on ``device``."""
    c = (np.arange(out_n, dtype=np.float32) + 0.5) * scale - 0.5
    i0 = np.clip(np.floor(c), 0, in_n - 1)
    w = np.clip(c - i0, 0.0, 1.0)
    i1 = np.minimum(i0 + 1, in_n - 1)
    m = np.zeros((out_n, in_n), np.float32)
    np.add.at(m, (np.arange(out_n), i0.astype(np.int64)), 1.0 - w)
    np.add.at(m, (np.arange(out_n), i1.astype(np.int64)), w)
    t = torch.from_numpy(m).to(device=device, dtype=dtype)
    if t.is_cuda:
        # the cached matrix may be read from another stream next
        torch.cuda.current_stream(t.device).synchronize()
    return t


def resize_bilinear_mm(img, out_h: int, out_w: int, dtype=torch.float32):
    """:func:`resize_bilinear` as two products with static interpolation
    matrices (JAX augment.py:85-91): the same taps and weights, in
    ``dtype`` (the weights too)."""
    x = img.to(dtype)
    h, w = x.shape[-3], x.shape[-2]
    dev = str(x.device)
    rm = _lerp_matrix_resize(out_h, h, h / out_h, dtype, dev)
    cm = _lerp_matrix_resize(out_w, w, w / out_w, dtype, dev)
    return _matmul_resample(x, rm, cm)


def resize_bilinear(img, out_h: int, out_w: int, dtype=torch.float32):
    """cv2.INTER_LINEAR-compatible bilinear resize, half-pixel centres.
    img: (..., H, W, C) float or uint8 -> ``dtype``: the pixels' compute
    and storage type (bf16 halves the bytes of the train augment's
    gathers); the sample coordinates stay fp32, only the pixel values and
    the lerp weights take ``dtype`` (JAX augment.py:125-151)."""
    x = img.to(dtype)
    h, w = x.shape[-3], x.shape[-2]
    sy, sx = h / out_h, w / out_w
    dev = x.device
    yc = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * sy - 0.5
    xc = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * sx - 0.5
    y0 = torch.clamp(torch.floor(yc), 0, h - 1)
    x0 = torch.clamp(torch.floor(xc), 0, w - 1)
    wy = torch.clamp(yc - y0, 0.0, 1.0).to(dtype)
    wx = torch.clamp(xc - x0, 0.0, 1.0).to(dtype)
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
