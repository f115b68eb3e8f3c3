"""Batched train-time augmentation of dual-stream frames, in PyTorch.

Counterpart of the JAX package's ``data/augment.py``, the ``gather`` route
that ``make_train_augment_fn`` takes (reference kaist_dataset.py:213-506):
  * mosaic-4 ("quadra"): 4 image pairs around a random centre in a 2s x 2s
    canvas (:func:`mosaic4`, :func:`mosaic_place`);
  * random affine by inverse-warp bilinear sampling, separable when the
    affine is axis-aligned, with the reference's degenerate-box filter
    (:func:`random_affine_batch`);
  * the snowflake cutout: random squares zeroed in both modalities, and
    the labels they cover dropped (:func:`snowflake_cutout`; CLAHE is
    :mod:`.clahe`);
  * HSV jitter with one set of gains for both modalities
    (:func:`hsv_jitter`);
  * 50% horizontal flip (:func:`flip_lr`);
  * the batched letterbox and its labels (:func:`letterbox_batch`,
    :func:`letterbox_labels`, :func:`letterbox_params`).
Both of the JAX package's routes for the resampling stages: the
``gather`` route (row and column takes, then lerps) and the ``matmul``
route, its default (``random_affine_batch(resample="matmul")``,
``letterbox.resize_bilinear_mm``: the same taps, clips and borders as
products with interpolation matrices, JAX augment.py:40-109). The mosaic
paste is :func:`mosaic_place` on both: JAX's ``mosaic_place_mm`` moves
pixels by 0 / 1 matrices, so its canvas is this take's, bit for bit.
Pixels may be fp32 or bf16 (the matmul route accumulates in fp32 and
rounds once).

Images are NHWC, uint8 or float in [0, 255]; labels are fixed-shape (B, T,
5) [cls, ...] blocks with a (B, T) mask, carried in absolute xyxy pixels
through the geometric ops. Every random input comes in as an argument or
from an explicit ``torch.Generator`` (drawn on the CPU, so that the card
and the CPU augment alike from one seed).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .letterbox import (_matmul_resample, letterbox_params, pad_sides,
                        resize_bilinear,
                        resize_bilinear_mm)  # noqa: F401 (JAX's name here)


def letterbox_batch(imgs, dst_hw, scale_up: bool = True,
                    pad_value: float = 0.0):
    """(B, H, W, C) -> (B, dst_h, dst_w, C) fp32 in the images' range,
    resized by the letterbox's ratio and padded with ``pad_value`` (JAX
    data/augment.py:165-179). Returns (images, ratio, (dw, dh))."""
    src_hw = tuple(imgs.shape[1:3])
    r, (dw, dh), (new_w, new_h) = letterbox_params(src_hw, dst_hw, scale_up)
    if (new_h, new_w) != src_hw:
        x = resize_bilinear(imgs, new_h, new_w)
    else:
        x = imgs.float()
    # F.pad pads from the last dim backwards: C, W, H
    x = F.pad(x, (0, 0) + pad_sides(dst_hw, (new_h, new_w), dw, dh),
              value=pad_value)
    return x, r, (dw, dh)


def letterbox_labels(labels, src_hw, ratio, pad):
    """Normalized [cls, cx, cy, w, h] labels -> [cls, x1, y1, x2, y2] in
    the letterboxed frame's pixels (JAX data/augment.py:182-190,
    reference kaist_dataset.py:298-306)."""
    h, w = src_hw
    cx, cy = labels[..., 1] * w * ratio, labels[..., 2] * h * ratio
    bw, bh = labels[..., 3] * w * ratio, labels[..., 4] * h * ratio
    return torch.stack([labels[..., 0],
                        cx - bw / 2 + pad[0], cy - bh / 2 + pad[1],
                        cx + bw / 2 + pad[0], cy + bh / 2 + pad[1]], dim=-1)


def _uniform(generator, shape, lo, hi):
    """U[lo, hi) on the CPU from ``generator``."""
    return torch.rand(shape, generator=generator) * (hi - lo) + lo


def _pymod(a, b: float):
    """Python's (and ``jnp``'s) float modulus: the remainder takes the
    divisor's sign, computed from fmod as XLA does."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


# ------------------------------------------------------------- affine warp

def affine_from_draws(a, s, tx, ty, sh, src_hw, border: int):
    """Per-image forward affine M = S @ T @ R (reference
    kaist_dataset.py:427-444) from its random draws: angle ``a`` (degrees),
    scale ``s``, translations ``tx`` / ``ty`` as fractions in [-t, t], shear
    ``sh`` (B, 2) in degrees. Returns (M (B, 3, 3), s (B,)), fp32."""
    h, w = src_hw
    tx = tx * h + border
    ty = ty * w + border
    rad = a * math.pi / 180.0
    cos, sin = torch.cos(rad) * s, torch.sin(rad) * s
    cx, cy = w / 2.0, h / 2.0
    # cv2.getRotationMatrix2D(center, angle, scale): rotation about center
    r02 = (1 - cos) * cx - sin * cy
    r12 = sin * cx + (1 - cos) * cy
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    R = torch.stack([torch.stack([cos, sin, r02], -1),
                     torch.stack([-sin, cos, r12], -1),
                     torch.stack([zeros, zeros, ones], -1)], -2)
    T = torch.stack([torch.stack([ones, zeros, tx], -1),
                     torch.stack([zeros, ones, ty], -1),
                     torch.stack([zeros, zeros, ones], -1)], -2)
    t0 = torch.tan(sh[:, 0] * math.pi / 180.0)
    t1 = torch.tan(sh[:, 1] * math.pi / 180.0)
    S = torch.stack([torch.stack([ones, t0, zeros], -1),
                     torch.stack([t1, ones, zeros], -1),
                     torch.stack([zeros, zeros, ones], -1)], -2)
    return S @ T @ R, s


def _affine_matrices(generator, batch: int, src_hw, degrees, translate,
                     scale, shear, border: int):
    """Draw the per-image affines from ``generator`` (JAX
    augment.py:195-230): angle, scale, x and y translation, shear."""
    a = _uniform(generator, (batch,), -degrees, degrees)
    s = _uniform(generator, (batch,), 1 - scale, 1 + scale)
    tx = _uniform(generator, (batch,), -translate, translate)
    ty = _uniform(generator, (batch,), -translate, translate)
    sh = _uniform(generator, (batch, 2), -shear, shear)
    return affine_from_draws(a, s, tx, ty, sh, src_hw, border)


def _warp_bilinear(img, minv, out_h: int, out_w: int,
                   separable: bool = False):
    """Inverse-warp a batch (B, H, W, C) by ``minv`` (B, 3, 3) with bilinear
    sampling and a zero border (cv2.warpAffine INTER_LINEAR). ``separable``:
    the caller asserts the affine is axis-aligned, so the sample point
    factors into a row and a column coordinate (one row gather, one column
    gather; the same taps, clips, masks and lerp order as the full warp).
    Floating pixels keep their dtype (bf16 for the reduced-precision
    pixel path), uint8 ones become fp32; coordinates stay fp32."""
    x = img if img.is_floating_point() else img.float()
    B, h, w, C = x.shape
    dev = x.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    bidx = torch.arange(B, device=dev)

    if separable:
        src_x = minv[:, 0, 0, None] * xs + minv[:, 0, 2, None]    # (B, W')
        src_y = minv[:, 1, 1, None] * ys + minv[:, 1, 2, None]    # (B, H')
        x0, y0 = torch.floor(src_x), torch.floor(src_y)
        wx = (src_x - x0)[:, None, :, None].to(x.dtype)
        wy = (src_y - y0)[:, :, None, None].to(x.dtype)

        def take_rows(yi):
            inb = (yi >= 0) & (yi < h)
            yc = yi.clamp(0, h - 1).long()
            return x[bidx[:, None], yc], inb[:, :, None, None]

        def take_cols(rows, xi):
            inb = (xi >= 0) & (xi < w)
            xc = xi.clamp(0, w - 1).long()
            return rows[bidx[:, None], :, xc].transpose(1, 2), \
                inb[:, None, :, None]

        r0, iy0 = take_rows(y0)
        r1, iy1 = take_rows(y0 + 1)
        v00, ix0 = take_cols(r0, x0)
        v01, ix1 = take_cols(r0, x0 + 1)
        v10, _ = take_cols(r1, x0)
        v11, _ = take_cols(r1, x0 + 1)
        z = torch.zeros((), dtype=x.dtype, device=dev)
        v00 = torch.where(iy0 & ix0, v00, z)
        v01 = torch.where(iy0 & ix1, v01, z)
        v10 = torch.where(iy1 & ix0, v10, z)
        v11 = torch.where(iy1 & ix1, v11, z)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        return top * (1 - wy) + bot * wy

    gy, gx = torch.meshgrid(ys, xs, indexing="ij")           # (H', W')
    m = minv[:, :2, :, None, None]                             # (B,2,3,1,1)
    src_x = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]
    src_y = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx = (src_x - x0)[..., None].to(x.dtype)
    wy = (src_y - y0)[..., None].to(x.dtype)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        v = x[bidx[:, None, None], yc, xc]
        return torch.where(inb[..., None], v,
                           torch.zeros((), dtype=x.dtype, device=dev))

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _lerp_matrix_warp(src_pos, in_n: int, dtype):
    """(..., n_out) sample positions -> (..., n_out, in_n) interpolation
    matrices: exactly the separable warp's taps (floor base, weight not
    clipped, taps at clip(i, 0, n - 1), each masked by its own in-bounds
    test: a zero border; JAX augment.py:94-109)."""
    i0 = torch.floor(src_pos)
    w = (src_pos - i0).to(dtype)
    ar = torch.arange(in_n, dtype=torch.float32, device=src_pos.device)
    zero = torch.zeros((), dtype=dtype, device=src_pos.device)

    def tap(i, tw):
        inb = (i >= 0) & (i < in_n)
        ic = i.clamp(0, in_n - 1)
        return torch.where(inb[..., None],
                           (ar == ic[..., None]).to(dtype) * tw[..., None],
                           zero)

    return tap(i0, 1.0 - w) + tap(i0 + 1, w)


def random_affine_batch(generator, v_imgs, l_imgs, labels, lmask, *,
                        degrees=0.0, translate=0.0, scale=0.0, shear=0.0,
                        border: int = 0, Ms=None, separable=None,
                        resample: str = "gather"):
    """Random affine of both modalities and their labels (JAX
    augment.py:313-391). labels: (B, T, 5) [cls, x1, y1, x2, y2] absolute
    in the source frame; the output frame is (H + 2 border, W + 2 border).
    ``Ms``: pre-drawn (M, s) (:func:`affine_from_draws`), else drawn from
    ``generator``; with ``Ms`` pass ``separable`` explicitly (whether the
    matrices are axis-aligned cannot be told from the degrees / shear
    defaults). ``resample``: ``"gather"`` (:func:`_warp_bilinear`) or
    ``"matmul"``, which applies only to a separable affine: per-image
    interpolation matrices in the pixels' dtype (fp32 for uint8), the
    products accumulated in fp32 (:func:`_matmul_resample`). Returns (v,
    l, labels, mask)."""
    B, H, W = v_imgs.shape[:3]
    out_h, out_w = H + border * 2, W + border * 2
    dev = v_imgs.device
    if separable is None:
        if Ms is not None:
            raise ValueError("random_affine_batch: pass separable= "
                             "explicitly with pre-drawn Ms")
        separable = degrees == 0.0 and shear == 0.0
    if Ms is None:
        Ms = _affine_matrices(generator, B, (H, W), degrees, translate,
                              scale, shear, border)
    M, s = (t.to(dev, torch.float32) for t in Ms)
    Minv = torch.linalg.inv(M)
    if resample == "matmul" and separable:
        dtype = (v_imgs.dtype if v_imgs.is_floating_point()
                 else torch.float32)
        xs = torch.arange(out_w, dtype=torch.float32, device=dev)
        ys = torch.arange(out_h, dtype=torch.float32, device=dev)
        src_x = Minv[:, 0, 0, None] * xs + Minv[:, 0, 2, None]   # (B, W')
        src_y = Minv[:, 1, 1, None] * ys + Minv[:, 1, 2, None]   # (B, H')
        rm = _lerp_matrix_warp(src_y, H, dtype)                  # (B, H', H)
        cm = _lerp_matrix_warp(src_x, W, dtype)                  # (B, W', W)
        v_out = _matmul_resample(v_imgs.to(dtype), rm, cm)
        l_out = _matmul_resample(l_imgs.to(dtype), rm, cm)
    else:
        v_out = _warp_bilinear(v_imgs, Minv, out_h, out_w, separable)
        l_out = _warp_bilinear(l_imgs, Minv, out_h, out_w, separable)

    # the 4 corners of every box (reference kaist_dataset.py:452-462)
    x1, y1 = labels[..., 1], labels[..., 2]
    x2, y2 = labels[..., 3], labels[..., 4]
    cx = torch.stack([x1, x2, x1, x2], -1)                     # (B, T, 4)
    cy = torch.stack([y1, y2, y2, y1], -1)
    Mb = M[:, None, None]                                       # (B,1,1,3,3)
    wx = cx * Mb[..., 0, 0] + cy * Mb[..., 0, 1] + Mb[..., 0, 2]
    wy = cx * Mb[..., 1, 0] + cy * Mb[..., 1, 1] + Mb[..., 1, 2]
    nx1 = wx.amin(-1).clamp(0, out_w)
    ny1 = wy.amin(-1).clamp(0, out_h)
    nx2 = wx.amax(-1).clamp(0, out_w)
    ny2 = wy.amax(-1).clamp(0, out_h)

    bw, bh = nx2 - nx1, ny2 - ny1
    area_new = bw * bh
    area_old = (x2 - x1) * (y2 - y1)
    ar = torch.maximum(bw / (bh + 1e-16), bh / (bw + 1e-16))
    keep = ((bw > 4) & (bh > 4)
            & (area_new / (area_old * s[:, None] + 1e-16) > 0.2) & (ar < 10))
    new_labels = torch.stack([labels[..., 0], nx1, ny1, nx2, ny2], -1)
    return v_out, l_out, new_labels, lmask & keep


# -------------------------------------------------------------- mosaic-4

def mosaic4(generator, v_imgs, l_imgs, labels, lmask, img_size: int,
            partner_idx=None, centers=None):
    """Mosaic ("quadra"): each image with 3 partners around a random centre
    in a (2s, 2s) canvas (JAX augment.py:396-425, reference
    kaist_dataset.py:213-286). Inputs are the size-s tiles, labels (B, T,
    5) absolute xyxy in the tile frame. ``partner_idx`` (B, 3): positions of
    the partners in the inputs (which may then be longer than B); without
    it, partners are drawn from the batch. ``centers`` (B, 2) are drawn
    from ``generator`` unless given. Returns (B, 2s, 2s, C) canvases and
    (B, 4T, 5) labels with their mask."""
    s = img_size
    B = partner_idx.shape[0] if partner_idx is not None else v_imgs.shape[0]
    if centers is None:
        centers = torch.randint(int(s * 0.5), int(s * 1.5) + 1, (B, 2),
                                generator=generator)
    if partner_idx is None:
        partner_idx = torch.randint(0, B, (B, 3), generator=generator)
    dev = v_imgs.device
    idx = torch.cat([torch.arange(B)[:, None], partner_idx.cpu()], 1).to(dev)
    return mosaic_place(v_imgs[idx], l_imgs[idx], labels[idx], lmask[idx],
                        centers.to(dev), img_size)


def mosaic_place(v4, l4, lab4, lm4, centers, img_size: int):
    """Paste pre-gathered 4-tile groups (B, 4, h, w, C) around ``centers``
    (B, 2) into (B, 2s, 2s, C) canvases (JAX augment.py:428-495): quadrant
    i of image b takes tile i, shifted by an integer offset, inside its
    rectangle; labels move by the same offsets and clip to the canvas."""
    s = img_size
    B, _, h, w, C = v4.shape
    dev = v4.device
    xr, yr = centers[:, 0].long(), centers[:, 1].long()
    zero = torch.zeros_like(xr)
    two_s = torch.full_like(xr, 2 * s)
    yy = torch.arange(2 * s, device=dev)
    bidx = torch.arange(B, device=dev)
    canvas_v = torch.zeros((B, 2 * s, 2 * s, C), dtype=v4.dtype, device=dev)
    canvas_l = torch.zeros_like(canvas_v)
    out_lab, out_m = [], []
    for i in range(4):
        # quadrant corners (reference kaist_dataset.py:239-249)
        if i == 0:
            x1a, y1a = torch.maximum(xr - w, zero), torch.maximum(yr - h, zero)
            x2a, y2a = xr, yr
        elif i == 1:
            x1a, y1a = xr, torch.maximum(yr - h, zero)
            x2a, y2a = torch.minimum(xr + w, two_s), yr
        elif i == 2:
            x1a, y1a = torch.maximum(xr - w, zero), yr
            x2a, y2a = xr, torch.minimum(two_s, yr + h)
        else:
            x1a, y1a = xr, yr
            x2a, y2a = torch.minimum(xr + w, two_s), torch.minimum(two_s,
                                                                   yr + h)
        # source offsets: pad = dst corner - src corner (x1b / y1b)
        padw = x1a - (w - (x2a - x1a)) if i in (0, 2) else x1a
        padh = y1a - (h - (y2a - y1a)) if i in (0, 1) else y1a

        inside = (((yy >= y1a[:, None]) & (yy < y2a[:, None]))[:, :, None]
                  & ((yy >= x1a[:, None]) & (yy < x2a[:, None]))[:, None, :])
        src_y = (yy - padh[:, None]).clamp(0, h - 1)            # (B, 2s)
        src_x = (yy - padw[:, None]).clamp(0, w - 1)
        rows = bidx[:, None, None], src_y[:, :, None], src_x[:, None, :]
        canvas_v = torch.where(inside[..., None], v4[:, i][rows], canvas_v)
        canvas_l = torch.where(inside[..., None], l4[:, i][rows], canvas_l)

        lab = lab4[:, i]
        pw = padw[:, None].to(lab.dtype)
        ph = padh[:, None].to(lab.dtype)
        out_lab.append(torch.stack([
            lab[..., 0],
            (lab[..., 1] + pw).clamp(0, 2 * s),
            (lab[..., 2] + ph).clamp(0, 2 * s),
            (lab[..., 3] + pw).clamp(0, 2 * s),
            (lab[..., 4] + ph).clamp(0, 2 * s)], -1))
        out_m.append(lm4[:, i])
    return canvas_v, canvas_l, torch.cat(out_lab, 1), torch.cat(out_m, 1)


# ------------------------------------------------------------ photometric

def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn + 1e-12
    h = torch.where(mx == r, _pymod((g - b) / d, 6.0),
                    torch.where(mx == g, (b - r) / d + 2.0,
                                (r - g) / d + 4.0))
    h = h / 6.0
    s = torch.where(mx > 0, d / (mx + 1e-12), 0.0)
    return torch.stack([h, s, mx], -1)


def _hsv_to_rgb(hsv):
    """The branchless sector formula c(n) = v - v s clamp(min(k, 4 - k),
    0, 1), k = (n + 6h) mod 6 (JAX augment.py:603-616)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]

    def chan(n):
        k = _pymod(n + h * 6.0, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], -1)


def hsv_jitter(generator, v_imgs, l_imgs, h_gain, s_gain, v_gain,
               gains=None):
    """HSV gains, one set per image for both modalities (JAX
    augment.py:564-588, reference kaist_dataset.py:482-506). Images float
    RGB in [0, 255]. ``gains``: pre-drawn (B, 3) factors, else drawn from
    ``generator`` as U(-1, 1) * (h, s, v gain) + 1."""
    B = v_imgs.shape[0]
    r = gains
    if r is None:
        r = (_uniform(generator, (B, 3), -1.0, 1.0)
             * torch.tensor([h_gain, s_gain, v_gain], dtype=torch.float32)
             + 1.0)
    r = r.to(v_imgs.device, torch.float32)[:, None, None, :]

    def adjust(img):
        hsv = _rgb_to_hsv((img / 255.0).float())
        h = _pymod(hsv[..., 0] * r[..., 0], 1.0)
        s = torch.clamp(hsv[..., 1] * r[..., 1], 0.0, 1.0)
        v = torch.clamp(hsv[..., 2] * r[..., 2], 0.0, 1.0)
        return (_hsv_to_rgb(torch.stack([h, s, v], -1)) * 255.0).to(img.dtype)

    return adjust(v_imgs), adjust(l_imgs)


def flip_lr(generator, v_imgs, l_imgs, labels_xywh_norm, do=None):
    """50% horizontal flip of both modalities and the x-centres (reference
    kaist_dataset.py:362-369); labels normalized xywh. ``do``: pre-drawn
    (B,) bools, else U[0, 1) < 0.5 from ``generator``."""
    B = v_imgs.shape[0]
    if do is None:
        do = torch.rand(B, generator=generator) < 0.5
    do = do.to(v_imgs.device)
    d4 = do[:, None, None, None]
    v = torch.where(d4, torch.flip(v_imgs, [2]), v_imgs)
    l = torch.where(d4, torch.flip(l_imgs, [2]), l_imgs)
    x = torch.where(do[:, None], 1.0 - labels_xywh_norm[..., 1],
                    labels_xywh_norm[..., 1])
    labels = torch.cat([labels_xywh_norm[..., :1], x[..., None],
                        labels_xywh_norm[..., 2:]], -1)
    return v, l, labels


# ---------------------------------------------------------------- cutout

def snowflake_cutout(generator, v_imgs, l_imgs, labels_xyxy, lmask, *,
                     n_thr: int = 6, step: int = 16, n_snow: int = 25,
                     label_thr: float = 0.35, u=None):
    """Zero ``n_snow`` random ``step`` x ``step`` squares in both modalities
    and drop the labels whose cover of the cut squares exceeds
    ``label_thr``, in each image that has at most ``n_thr`` labels (JAX
    augment.py:636-691, reference snowflake.py:54-93). Labels absolute
    xyxy. ``u``: pre-drawn (B, n_snow, 2) uniforms in [0, 1), else drawn
    from ``generator``. Squares are placed in the true frame (the
    reference swaps w and h, snowflake.py:73). Returns (v, l, mask)."""
    B, H, W = v_imgs.shape[0], v_imgs.shape[1], v_imgs.shape[2]
    dev = v_imgs.device
    if u is None:
        u = torch.rand((B, n_snow, 2), generator=generator)
    u = u.to(dev, torch.float32)
    xy = torch.floor(u * torch.tensor([W - 1, H - 1], dtype=torch.float32,
                                      device=dev))
    x2 = torch.clamp(xy[..., 0] + step - 1, 0, W - 1)
    y2 = torch.clamp(xy[..., 1] + step - 1, 0, H - 1)
    cut = torch.stack([xy[..., 0], xy[..., 1], x2, y2], -1)    # (B, N, 4)

    active = lmask.sum(-1) <= n_thr                             # (B,)
    yy = torch.arange(H, dtype=torch.float32, device=dev)
    xx = torch.arange(W, dtype=torch.float32, device=dev)
    # a pixel is cut when one square covers its row and column: per
    # square, a row mask and a column mask, and their product summed over
    # squares, as an (H, N) x (N, W) product of 0/1 values
    rows = ((yy[None, :, None] >= cut[:, None, :, 1])
            & (yy[None, :, None] <= cut[:, None, :, 3]))        # (B, H, N)
    cols = ((xx[None, None, :] >= cut[:, :, 0, None])
            & (xx[None, None, :] <= cut[:, :, 2, None]))        # (B, N, W)
    hits = torch.bmm(rows.float(), cols.float())                # (B, H, W)
    masks = (hits > 0) & active[:, None, None]
    m4 = masks[..., None]
    zero = torch.zeros((), dtype=v_imgs.dtype, device=dev)
    v = torch.where(m4, zero, v_imgs)
    l = torch.where(m4, zero, l_imgs)

    # cover of each label by all the squares (reference snowflake.py:28-43)
    lb = labels_xyxy[..., 1:5]                                  # (B, T, 4)
    ix1 = torch.maximum(lb[..., None, 0], cut[:, None, :, 0])
    iy1 = torch.maximum(lb[..., None, 1], cut[:, None, :, 1])
    ix2 = torch.minimum(lb[..., None, 2], cut[:, None, :, 2])
    iy2 = torch.minimum(lb[..., None, 3], cut[:, None, :, 3])
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    area = torch.clamp_min((lb[..., 2] - lb[..., 0])
                           * (lb[..., 3] - lb[..., 1]), 1.0)
    cover = inter.sum(-1) / area                                # (B, T)
    keep = torch.where(active[:, None], cover < label_thr, True)
    return v, l, lmask & keep


# ----------------------------------------------------------- label formats

def xyxy_to_norm_xywh(labels_xyxy, lmask, frame_hw):
    """Absolute xyxy -> normalized xywh (reference kaist_dataset.py:351-358);
    masked rows zeroed."""
    h, w = frame_hw
    x1, y1 = labels_xyxy[..., 1], labels_xyxy[..., 2]
    x2, y2 = labels_xyxy[..., 3], labels_xyxy[..., 4]
    out = torch.stack([labels_xyxy[..., 0],
                       (x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
                       (x2 - x1) / w, (y2 - y1) / h], -1)
    return torch.where(lmask[..., None], out, 0.0)
