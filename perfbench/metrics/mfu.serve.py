"""The serve step's share of the card's bf16 peak: the benchmark's FLOP
count of one forward of a frame pair at the letterbox's size
(:mod:`perfbench.flops`), times the frames served a second in the traced
window, over 989 TFLOP/s."""

from perfbench import flops, peaks
from perfbench.reference.detect import letterbox_geometry


def read(ctx):
    dst = letterbox_geometry(tuple(ctx.mix["src_hw"]), ctx.mix["img_size"])[0]
    f = flops.forward_flops(ctx.model, *dst)
    return 100.0 * f * ctx.e2e["frames_per_s"] / peaks.BF16_FLOPS
