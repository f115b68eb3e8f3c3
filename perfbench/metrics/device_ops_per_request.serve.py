"""Device operations a request: every kernel, copy and set in the traced
window, by name, over the requests the program counted
(``serve.requests``), summed over the names. The profiler loses records
and never adds one, so a name's count a request that lies less than
``LOSS`` of it below a whole number is taken as that number; any other
(a name that runs on some requests only, or once more on some) counts as
it reads. A window that loses more of a name than that reads short by
what it lost. Nothing where the program counts no requests."""

import math

from perfbench import program_spans

# the share of a name's records the profiler may lose in a window: it
# lost at most 0.9% (2,579 of 288,150 records in 150 requests) on an
# H100 80GB HBM3
LOSS = 0.02


def read(ctx):
    st = program_spans.store(ctx)
    if st is None or not st["counters"].get("serve.requests"):
        return None
    n = st["counters"]["serve.requests"]
    total = 0.0
    for c, _ in ctx.trace.kernels.values():
        r = c / n
        whole = math.ceil(r)
        total += whole if whole - r <= LOSS * whole else r
    return total
