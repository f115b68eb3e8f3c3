"""The graph's time a request as the host sees it: the median over the
traced window's requests of the program's ``serve/launch`` (the replay
submitted, the output's copy enqueued) plus its ``serve/fetch_wait``
(the wait for both), from the launch's start to the output on the host.
The card runs the graph while the launch submits it, so the two trade
off against each other and their sum does not move with the host's
speed. Nothing where the program records no spans."""

from perfbench import program_spans


def read(ctx):
    return program_spans.median_ms(ctx, "serve/launch",
                                   plus="serve/fetch_wait")
