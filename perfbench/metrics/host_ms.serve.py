"""The serving entry's own host time a request: the median over the
traced window's requests of the program's ``serve/request`` span less its
``serve/fetch_wait`` (the wait for the replay). It holds the staging, the
graph's launch (the card runs the graph while it is submitted), the
output's copy and the letterbox undo. Nothing where the program records
no spans."""

from perfbench import program_spans


def read(ctx):
    return program_spans.median_ms(ctx, "serve/request",
                                   less="serve/fetch_wait")
