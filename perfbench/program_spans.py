"""The program's own spans and counters of the traced window
(``double_yolo_kaist_torch.utils.profiling``), for the per-layer readers
of the serving entry.

The program records them only while a ``torch.profiler`` window is open,
so the store holds the traced window and nothing of set-up. The first
reader takes the store (which clears it) and keeps it on the run's
``ctx``; the others read that copy. A program without spans (no
``profiling.take``) gives nothing, and so does a store that dropped
spans or holds no request: the readers then return None.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

ROOT = "serve/request"


def store(ctx):
    """``{"spans": [...], "counters": {...}}`` of the window, or None."""
    if not hasattr(ctx, "program_store"):
        from double_yolo_kaist_torch.utils import profiling
        take = getattr(profiling, "take", None)
        ctx.program_store = take() if take is not None else None
    st = ctx.program_store
    if (st is None or st["counters"].get("dropped")
            or not any(s.name == ROOT for s in st["spans"])):
        return None
    return st


def per_request(st, name: str) -> dict:
    """{request id: seconds of the spans ``name`` of that request}, over
    every request that has a root span (0 where it has none of them)."""
    out = {s.request: 0.0 for s in st["spans"] if s.name == ROOT}
    for s in st["spans"]:
        if s.name == name and s.request in out:
            out[s.request] += (s.end_ns - s.start_ns) / 1e9
    return out


def median_ms(ctx, name: str, less: str | None = None,
              plus: str | None = None):
    """The median over the window's requests of the seconds of ``name``
    a request, less those of ``less`` and plus those of ``plus`` in the
    same request, in ms."""
    st = store(ctx)
    if st is None:
        return None
    t = per_request(st, name)
    minus = per_request(st, less) if less else defaultdict(float)
    more = per_request(st, plus) if plus else defaultdict(float)
    return 1e3 * float(np.median([t[r] - minus[r] + more[r] for r in t]))
