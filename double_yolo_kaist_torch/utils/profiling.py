"""Profiling utilities: ``StepTimer``, the train loop's data / step time.

Counterpart of part of the JAX package's ``utils/profiling.py``; its
device-sync timing, trace context and FLOP estimate are not ported yet
(ROADMAP.md, queue 1 item 16).
"""

from __future__ import annotations

import time

import numpy as np


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
