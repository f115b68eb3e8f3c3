"""Batched CLAHE (contrast-limited adaptive histogram equalization) on the
tensor's device.

Counterpart of the JAX package's ``data/clahe.py``: the reference's
``cv2.createCLAHE(clip 1.0, 4x4 tiles)`` per channel (snowflake.py:46-51)
as batched torch ops: a 256-bin histogram per tile, cv2's integer clip and
redistribution of the excess, the CDF as a LUT per tile, then a bilinear
blend of the 4 neighbouring tiles' LUTs per pixel. The JAX package builds
its histograms as a one-hot sum for the TPU's MXU; here they are one
integer ``bincount`` over ``tile * 256 + value``, exact on every device,
and small at any size (the one-hot of a 1024x1024 tile set is 64 MB per
tile and channel). The blend is separate elementwise ops in the JAX
package's order, so the bytes equal its bytes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _tile_luts(tiles, clip_limit: float):
    """tiles: (nt, P) integer pixels per tile -> (nt, 256) fp32 LUTs (JAX
    clahe.py:20-44, cv2's rules): an integer clip limit int(clip * P / 256)
    of at least 1; the clipped excess spread as excess // 256 to every bin
    and the residual to bins 0, step, 2 step, ... with step = max(256 //
    residual, 1); LUT = round-half-even(cdf * 255 / P), clipped to [0,
    255]."""
    nt, n_px = tiles.shape
    dev = tiles.device
    offs = torch.arange(nt, device=dev, dtype=torch.int64)[:, None] * 256
    hist = torch.bincount((tiles.long() + offs).reshape(-1),
                          minlength=nt * 256).reshape(nt, 256)

    limit = max(int(clip_limit * n_px / 256.0), 1)
    clipped = torch.clamp_max(hist, limit)
    excess = (hist - clipped).sum(-1, keepdim=True)            # (nt, 1)
    batch = excess // 256
    residual = excess - batch * 256                             # < 256
    step = torch.clamp_min(256 // torch.clamp_min(residual, 1), 1)
    bins = torch.arange(256, device=dev)[None, :]
    bump = ((bins % step == 0) & (bins // step < residual)).long()
    clipped = clipped + batch + bump

    cdf = torch.cumsum(clipped.float(), dim=-1)   # exact: sums below 2^24
    scale = torch.tensor(255.0 / n_px, dtype=torch.float32)
    return torch.clamp(torch.round(cdf * scale), 0, 255)


def _axis(n: int, t: int, grid: int, dev):
    """Per-pixel tile indices (lower, upper) and the upper tile's weight
    along one axis of ``n`` pixels in tiles of ``t`` (cv2's weights, with
    the tile centres' border replicated), fp32 as JAX computes them."""
    c = torch.arange(n, dtype=torch.float32, device=dev)
    # a divisor on the device: CUDA divides by a host scalar as a product
    # with its reciprocal, which rounds otherwise
    f = (c - t / 2.0 + 0.5) / torch.tensor(float(t), device=dev)
    fl = torch.floor(f)
    i0 = torch.clamp(fl, 0, grid - 1).long()
    i1 = torch.clamp(i0 + 1, 0, grid - 1)
    w = torch.clamp(f - fl, 0.0, 1.0)
    w = torch.where(f < 0, 0.0, torch.where(f > grid - 1, 1.0, w))
    return i0, i1, w


def clahe_batch(imgs_u8, clip_limit: float = 1.0, grid: int = 4):
    """imgs_u8: (B, H, W, C) uint8 -> uint8, CLAHE per image and channel
    (JAX clahe.py:46-102), on the input's device. A shape that does not
    divide by ``grid`` is extended by reflection (cv2's BORDER_REFLECT_101)
    to the next multiple and cut back after."""
    B, H, W, C = imgs_u8.shape
    if H % grid or W % grid:
        ph, pw = (-H) % grid, (-W) % grid
        x = imgs_u8.permute(0, 3, 1, 2).float()
        ext = F.pad(x, (0, pw, 0, ph), mode="reflect").to(torch.uint8)
        return clahe_batch(ext.permute(0, 2, 3, 1), clip_limit,
                           grid)[:, :H, :W]
    th, tw = H // grid, W // grid
    dev = imgs_u8.device

    planes = imgs_u8.permute(0, 3, 1, 2).reshape(B * C, H, W)
    tiles = (planes.reshape(B * C, grid, th, grid, tw)
             .permute(0, 1, 3, 2, 4)
             .reshape(B * C * grid * grid, th * tw))
    luts = _tile_luts(tiles, clip_limit).reshape(B * C, grid * grid * 256)

    y0, y1, wy = _axis(H, th, grid, dev)
    x0, x1, wx = _axis(W, tw, grid, dev)
    p = planes.long()

    def take(yi, xi):
        idx = (yi[:, None] * grid + xi[None, :]) * 256 + p     # (BC, H, W)
        return torch.gather(luts, 1, idx.reshape(B * C, -1)).reshape(
            B * C, H, W)

    v00, v01 = take(y0, x0), take(y0, x1)
    v10, v11 = take(y1, x0), take(y1, x1)
    wxr, wyc = wx[None, None, :], wy[None, :, None]
    top = v00 * (1 - wxr) + v01 * wxr
    bot = v10 * (1 - wxr) + v11 * wxr
    out = top * (1 - wyc) + bot * wyc
    out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out.reshape(B, C, H, W).permute(0, 2, 3, 1)
