"""Kernel K3's share of its roofline in the serve window: the least time
of a launch (:mod:`perfbench.rooflines.stem`: the larger of its bytes
and its bf16 operations) times its launches, over its device time by
name in the trace. The launches are the model's stem convs (3x3, stride
2, pad 1, 32 input channels), all of one shape. Nothing when the trace
holds no K3 launch."""

from perfbench.reference.cfg import shapes
from perfbench.reference.detect import letterbox_geometry
from perfbench.rooflines import stem


def read(ctx):
    k = ctx.trace.kernel(stem.KERNEL)
    if k is None:
        return None
    n, seconds = k
    h, w = letterbox_geometry(tuple(ctx.mix["src_hw"]), ctx.mix["img_size"])[0]
    sh = shapes(ctx.model, h, w)
    stems = [L for L in ctx.model.layers
             if L.kind == "conv" and L.k == 3 and L.stride == 2
             and L.pad == 1 and L.cin == 32 and L.groups == 1
             and L.act in ("mish", "leaky")]
    bounds = [stem.bound_s(ctx.mix["batch"], *sh[L.i - 1][1:], L.cin, L.cout)
              for L in stems]
    return 100.0 * (sum(bounds) / len(bounds)) * n / seconds
