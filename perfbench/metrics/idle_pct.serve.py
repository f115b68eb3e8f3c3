"""Share of the traced serve window in which no kernel, copy or set ran
on the card (the profiler's timeline)."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
