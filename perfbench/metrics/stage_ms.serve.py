"""Staging a request: the median over the traced window's requests of the
program's ``serve/stage`` spans (frames into pinned buffers, then onto the
card). Nothing where the program records no spans."""

from perfbench import program_spans


def read(ctx):
    return program_spans.median_ms(ctx, "serve/stage")
