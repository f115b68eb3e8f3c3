"""The traced window: ``torch.profiler`` over the host and the card, kept
in memory and reduced to what the per-layer readers and the result line
need.

* ``busy_s``: the union of the intervals in which a kernel, a copy or a
  set ran on the card;
* ``window_s``: the window's length on the host clock;
* ``kernels``: {name: [count, seconds]} of every device operation;
* ``breakdown``: the ten device operations that took most time, and the
  ten largest sums of idle time by the host operation that was running
  in the middle of each gap (the innermost one).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Trace:
    def __init__(self):
        self.busy_s = None
        self.window_s = None
        self.kernels: dict = {}
        self.breakdown: dict = {}

    @contextlib.contextmanager
    def window(self, torch):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            yield self
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        self._reduce(prof.profiler.kineto_results.events())

    def _reduce(self, events) -> None:
        dev, host = [], []
        for e in events:
            kind = str(e.device_type())
            span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            (dev if kind.endswith("CUDA") else host).append(span)
        kernels: dict = defaultdict(lambda: [0, 0.0])
        for a, b, name in dev:
            k = kernels[name]
            k[0] += 1
            k[1] += (b - a) / 1e9
        self.kernels = dict(kernels)
        dev.sort()
        busy, gaps = 0, []
        end = None
        for a, b, _ in dev:
            if end is None or a > end:
                if end is not None:
                    gaps.append((end, a))
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        self.busy_s = busy / 1e9
        idle = self._idle_by_host(gaps, host)
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        self.breakdown = {
            "device_ops": [[n, s] for n, (_, s) in top],
            "idle_gaps": [[n, s] for n, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}

    @staticmethod
    def _idle_by_host(gaps, host) -> dict:
        """Idle seconds summed by the innermost host operation running at
        the middle of each gap."""
        host.sort()
        out: dict = defaultdict(float)
        stack: list = []           # open host operations, outermost first
        i = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) // 2
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            out[stack[-1][2] if stack else "no host operation"] += \
                (b - a) / 1e9
        return out

    def kernel(self, substr: str):
        """(count, seconds) of the device operations whose name holds
        ``substr``, or None when there is none."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if substr in name:
                n += c
                s += t
        return (n, s) if n else None
