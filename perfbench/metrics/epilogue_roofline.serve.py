"""Kernel K5's share of its roofline in the serve window: the least time
of a forward's launches (:mod:`perfbench.rooflines.epilogue`: their
bytes), times the forwards its launches make (launches over the
forward's K5 convs), over its device time by name in the trace. Nothing
when the trace holds no K5 launch."""

from perfbench.reference.cfg import shapes
from perfbench.reference.detect import letterbox_geometry
from perfbench.rooflines import epilogue


def read(ctx):
    k = ctx.trace.kernel(epilogue.KERNEL)
    if k is None:
        return None
    n, seconds = k
    h, w = letterbox_geometry(tuple(ctx.mix["src_hw"]), ctx.mix["img_size"])[0]
    sh = shapes(ctx.model, h, w)
    in_bytes = epilogue.IN_BYTES[ctx.mix["compute_dtype"]]
    bounds = [epilogue.bound_s(ctx.mix["batch"], *sh[L.i], in_bytes)
              for L in epilogue.launched(ctx.model)]
    return 100.0 * sum(bounds) * (n / len(bounds)) / seconds
