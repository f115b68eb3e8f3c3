"""Kernel K5 (``ops/csrc/bias_act.cu``: ``bias_act_kernel``, and
``bias_act_kernel_scalar`` where the channels are not a multiple of 8): a
conv's bias and activation in one pass over its output. It reads the
conv's output and the bias once and writes the output once, in the
compute type. The bound is those bytes over the card's bandwidth alone: a lower
bound on the time whatever the activation costs, so the share cannot
pass 100%."""

from __future__ import annotations

from .. import peaks

KERNEL = "bias_act_kernel"
IN_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def launched(model) -> list:
    """The convs of a forward that K5 finishes: every standard conv but
    the stems, which K3 computes with their activation (the predicate of
    ``metrics/stem_roofline.serve.py``)."""
    def stem(L):
        return (L.k == 3 and L.stride == 2 and L.pad == 1 and L.cin == 32
                and L.groups == 1 and L.act in ("mish", "leaky"))
    return [L for L in model.layers
            if L.kind == "conv" and L.groups == 1 and not stem(L)]


def bytes_moved(batch: int, cout: int, ho: int, wo: int,
                in_bytes: int = 2) -> float:
    return float(batch * cout * ho * wo * 2 * in_bytes + cout * in_bytes)


def bound_s(batch: int, cout: int, ho: int, wo: int,
            in_bytes: int = 2) -> float:
    """The least time of one launch."""
    return bytes_moved(batch, cout, ho, wo, in_bytes) / peaks.HBM_BYTES
