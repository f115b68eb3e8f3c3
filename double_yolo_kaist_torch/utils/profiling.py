"""Profiling and tracing utilities: the JAX package's
``utils/profiling.py`` on the card.

  * :func:`device_sync` / :func:`device_sync_time`: wait for the device,
    and time calls between CUDA events on the card (the host clock
    around a synchronise on the CPU);
  * :func:`trace`: a ``torch.profiler`` window that writes a Chrome trace;
  * :func:`flops_estimate`: the analytic conv FLOP count from the IR;
  * :class:`StepTimer`: the train loop's rolling data / step time.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(x) -> None:
    """Wait until the device has finished the work that made ``x`` (a
    tensor or a tree of them): ``torch.cuda.synchronize`` of its device;
    nothing on the CPU."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def device_sync_time(fn, *args, repeats: int = 1):
    """Run ``fn(*args)`` once to warm up, then ``repeats`` times; return
    (seconds per call, the last output). On CUDA the calls are timed
    between two CUDA events on the current stream (the device's time for
    them, host gaps included); on the CPU by the host clock."""
    out = fn(*args)
    t = _first_tensor(out)
    if t is None or not t.is_cuda:
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = fn(*args)
        return (time.perf_counter() - t0) / repeats, out
    torch.cuda.synchronize(t.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / repeats, out


@contextlib.contextmanager
def trace(logdir: str = "runs/trace"):
    """A ``torch.profiler`` window over the host and, where there is one,
    the CUDA device; on exit it writes ``<logdir>/trace.json`` (Chrome
    trace format: chrome://tracing or Perfetto). Yields the profiler, whose
    ``key_averages()`` sums the kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def flops_estimate(ir, img_hw=(512, 640)) -> float:
    """Analytic multiply-add FLOPs (x2) of one dual/single-stream forward."""
    from ..config.ir import infer_shapes

    shapes = infer_shapes(ir, *img_hw)
    total = 0.0
    for node in ir.nodes:
        if node.kind == "conv":
            c, h, w = shapes[node.index]
            total += 2 * h * w * node.kernel ** 2 * (
                node.in_ch // node.groups) * node.out_ch
        elif node.kind == "dwconv":
            c, h, w = shapes[node.index]
            total += 2 * h * w * (node.kernel ** 2 * node.in_ch
                                  + node.in_ch * node.out_ch)
        elif node.kind == "inception":
            c, h, w = shapes[node.index]
            icp = node.icp
            ci = node.in_ch
            total += 2 * h * w * (
                ci * icp["n1x1"] + ci * icp["n3x3_reduce"]
                + 9 * icp["n3x3_reduce"] * icp["n3x3"]
                + ci * icp["n5x5_reduce"] + 9 * icp["n5x5_reduce"] * icp["n5x5"]
                + 9 * icp["n5x5"] ** 2 + ci * icp["pool_proj"])
        elif node.kind == "se":
            total += 2 * 2 * node.in_ch * node.squeeze_ch
    return total


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
