"""How long the host waits for the replay a request, once its launch has
returned: the median over the traced window's requests of the program's
``serve/fetch_wait`` spans. The card runs the graph while the launch
submits it, so a slower launch shortens this wait: it is the serving
entry's idle host time, not the graph's (that is ``replay_ms.serve``).
Nothing where the program records no spans."""

from perfbench import program_spans


def read(ctx):
    return program_spans.median_ms(ctx, "serve/fetch_wait")
