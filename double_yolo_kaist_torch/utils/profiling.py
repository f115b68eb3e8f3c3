"""Profiling and tracing: the program's spans and counters, the operator's
``torch.profiler`` window, and the train loop's step timer.

  * :func:`span` / :func:`count`: named intervals and counts, recorded
    into one store in memory while a ``torch.profiler`` window is open,
    and nothing otherwise; :func:`take` returns them and clears the store;
  * :func:`trace`: the operator's window: a ``torch.profiler`` window that
    writes a Chrome trace and the window's spans and counters;
  * :class:`StepTimer`: the train loop's rolling data / step time.

Tracing is on exactly while a profiler window is open (the flag
``torch.autograd.profiler._is_profiler_enabled``); when it is off, a span
or a count reads that flag and does nothing else. Spans are stamped on
the clock the profiler's host events carry (epoch ns, ``time.time_ns``),
so a span lines up with the profiler's timeline. A span with
``timeline=True`` also enters a profiler range of its name (the one
``torch.compile`` uses, ``_RecordFunctionFast``, a tenth of
``record_function``'s cost under a window): only host-side leaves take
it, since the profiler repeats a range that encloses work on the card as
an event on the card's timeline.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 20          # spans the store holds; more count as dropped
# the range a timeline span enters; ``record_function`` where torch lacks it
_RANGE = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or _profiler.record_function)


class Span(NamedTuple):
    """One recorded span. ``parent``: the id of the span it ran in (None
    at a root); ``request``: the id shared by every span of one request
    (None outside a request); ``thread``: ``threading.get_ident()``."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: Optional[int]
    thread: int


class _Store:
    """The spans and counters recorded since the last :meth:`take`."""

    def __init__(self):
        self.capacity = CAPACITY
        self.spans: list = []
        self.counters: dict = {}
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.requests = itertools.count(1)
        self.local = threading.local()      # .stack: the open spans

    def add(self, rec: Span) -> None:
        with self.lock:
            if len(self.spans) < self.capacity:
                self.spans.append(rec)
            else:
                self.counters["dropped"] = self.counters.get("dropped", 0) + 1

    def count(self, name: str, n) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def take(self) -> dict:
        with self.lock:
            spans, self.spans = self.spans, []
            counters, self.counters = self.counters, {}
        return {"spans": spans, "counters": counters}


STORE = _Store()


_OFF = contextlib.nullcontext()     # the span of a call with tracing off


class _On:
    """The span of a call made with tracing on."""
    __slots__ = ("name", "request", "timeline", "id", "parent", "req",
                 "start", "range")

    def __init__(self, name: str, request: bool, timeline: bool):
        self.name = name
        self.request = request
        self.timeline = timeline

    def __enter__(self):
        local = STORE.local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        up = stack[-1] if stack else None
        self.id = next(STORE.ids)
        self.parent = None if up is None else up.id
        self.req = (next(STORE.requests) if self.request
                    else None if up is None else up.req)
        stack.append(self)
        self.start = time.time_ns()
        if self.timeline:
            self.range = _RANGE(self.name)
            self.range.__enter__()
        return None

    def __exit__(self, *exc):
        if self.timeline:
            self.range.__exit__(*exc)
        end = time.time_ns()
        STORE.local.stack.pop()
        STORE.add(Span(self.name, self.start, end, self.id, self.parent,
                       self.req, threading.get_ident()))
        return False


def span(name: str, *, request: bool = False, timeline: bool = False):
    """A context manager that records the interval it encloses as ``name``
    while tracing is on. ``request=True`` starts a request: the span and
    every span inside it on this thread share a new request id.
    ``timeline=True`` (host-only leaves: nothing inside may enqueue work on
    the card) also enters a profiler range of ``name``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, request, timeline)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _profiler._is_profiler_enabled:
        return
    STORE.count(name, n)


def take() -> dict:
    """``{"spans": [Span, ...], "counters": {name: n}}`` recorded since the
    last take, and clear the store. ``counters["dropped"]``: spans that did
    not fit in the store's ``CAPACITY``."""
    return STORE.take()


@contextlib.contextmanager
def trace(logdir: str = "runs/trace"):
    """A ``torch.profiler`` window over the host and, where there is one,
    the CUDA device. On exit it writes ``<logdir>/trace.json`` (Chrome
    trace format: chrome://tracing or Perfetto) and ``<logdir>/spans.json``
    (the program's spans and counters of the window, as :func:`take`
    gives them, each span a dict).
    Yields the profiler, whose ``key_averages()`` sums the kernels by
    name."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    take()                      # what an earlier window left
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    taken = take()
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"spans": [s._asdict() for s in taken["spans"]],
                   "counters": taken["counters"]}, f)


class StepTimer:
    """Rolling data-load vs step-compute timer for train loops."""

    def __init__(self, window: int = 50):
        self.data_times: list = []
        self.step_times: list = []
        self.window = window
        self._t = time.perf_counter()

    def data_ready(self):
        now = time.perf_counter()
        self.data_times.append(now - self._t)
        self._t = now

    def step_done(self):
        now = time.perf_counter()
        self.step_times.append(now - self._t)
        self._t = now

    def summary(self) -> str:
        d = np.mean(self.data_times[-self.window:]) if self.data_times else 0
        s = np.mean(self.step_times[-self.window:]) if self.step_times else 0
        return f"data {d * 1e3:.1f}ms step {s * 1e3:.1f}ms"
