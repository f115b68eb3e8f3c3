"""Kernel K1 (``ops/csrc/decode.cu``, ``decode_heads_kernel``): every
head of a batch decoded in one launch. It reads each head's raw output
once in bf16 and writes each decoded row once in float32; its arithmetic
(a sigmoid and a few products a value) is far below the card's rate, so
bytes bound it."""

from __future__ import annotations

from .. import peaks

KERNEL = "decode_heads_kernel"


def bytes_moved(batch: int, rows: int, no: int, in_bytes: int = 2) -> float:
    return batch * rows * no * (in_bytes + 4)


def bound_s(batch: int, rows: int, no: int) -> float:
    """The least time of one launch."""
    return bytes_moved(batch, rows, no) / peaks.HBM_BYTES
