"""Kernel K1's share of its roofline in the serve window: its least time
a launch (:mod:`perfbench.rooflines.decode`, bytes bound) times its
launches, over its device time by name in the trace. Nothing when the
trace holds no K1 launch."""

from perfbench.reference.cfg import shapes
from perfbench.reference.detect import letterbox_geometry
from perfbench.rooflines import decode


def read(ctx):
    k = ctx.trace.kernel(decode.KERNEL)
    if k is None:
        return None
    n, seconds = k
    h, w = letterbox_geometry(tuple(ctx.mix["src_hw"]), ctx.mix["img_size"])[0]
    sh = shapes(ctx.model, h, w)
    heads = ctx.model.heads
    rows = sum(len(L.anchors) * sh[L.i][1] * sh[L.i][2] for L in heads)
    bound = decode.bound_s(ctx.mix["batch"], rows, heads[0].nc + 5)
    return 100.0 * bound * n / seconds
