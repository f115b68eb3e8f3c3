"""Kernel K3 (``ops/csrc/stem.cu``, ``stem_wg_kernel`` in bf16): a 3x3,
stride 2, pad 1 conv of 32 input channels with its bias and activation.
It reads its input once and writes its output once, in bf16 (the packed
kernel is a few KB); its operations are the conv's multiply-adds. The
bound is the larger of the bytes over the card's bandwidth and the
operations over its bf16 rate."""

from __future__ import annotations

from .. import peaks

KERNEL = "stem_wg_kernel"


def bytes_moved(batch: int, h: int, w: int, cin: int, cout: int) -> float:
    ho, wo = (h + 1) // 2, (w + 1) // 2
    return 2.0 * batch * (h * w * cin + ho * wo * cout)


def flops(batch: int, h: int, w: int, cin: int, cout: int) -> float:
    ho, wo = (h + 1) // 2, (w + 1) // 2
    return 2.0 * batch * ho * wo * 9 * cin * cout


def bound_s(batch: int, h: int, w: int, cin: int, cout: int) -> float:
    """The least time of one launch."""
    return max(bytes_moved(batch, h, w, cin, cout) / peaks.HBM_BYTES,
               flops(batch, h, w, cin, cout) / peaks.BF16_FLOPS)
