"""CUDA graphs of a serving body and their pinned staging: what
``serving.Predictor`` and ``export.ExportedPredictor`` both serve from.

:func:`capture` captures a body that reads static tensors; a :class:`Stage`
holds the static uint8 inputs of one (bucket, frame size) and the pinned
host buffers requests are copied through; a :class:`Graph` replays one
captured body and fetches its packed output once. Nothing here imports the
model code, so a host that loads an exported program needs only this,
``export.py`` and ``ops/``.

Spans (:mod:`.utils.profiling`, recorded only under a profiler window):
``serve/stage`` (:meth:`Stage.load`) and its host-only leaf
``serve/stage_copy`` (the copy into the staging buffers), ``serve/launch``
(the replay and the output's copy enqueued), ``serve/fetch_wait`` (the
wait for them) and ``serve/fetch_copy`` (the output's copy out of pinned
memory).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import _build
from .utils import profiling


def capture(fn, device, pool=None):
    """Capture ``fn()`` (no arguments; its inputs are static tensors) as a
    CUDA graph on ``device``. ``fn`` runs once eagerly on a side stream
    first, so that kernel libraries are loaded, K1's launch plan is made and
    cuDNN has chosen its kernels before capture. Returns (graph, fn's
    output, {kernel: launches the graph holds}); the wrappers' counts of
    the capture itself are taken back, since nothing launched then. A
    failed capture raises: nothing falls back to eager execution."""
    with torch.cuda.device(device):
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)
        before = dict(_build.launches)
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph, pool=pool):
            out = fn()
    held = {k: n - before.get(k, 0) for k, n in _build.launches.items()
            if n != before.get(k, 0)}
    for name, n in held.items():
        _build.launches[name] -= n
    return cuda_graph, out, held


def replay(cuda_graph, held: dict) -> None:
    """Replay ``cuda_graph`` on the current device and count the launches
    it holds (``held``, as :func:`capture` returns them): the wrappers do
    not run on a replay, so this is where its launches are counted."""
    cuda_graph.replay()
    for name, n in held.items():
        _build.launches[name] += n


class Stage:
    """The static uint8 inputs of one (bucket, source size): device tensors
    that the graphs of that bucket read, and, on CUDA, pinned host staging
    that requests are copied through. Slots past a request's frames are
    zero, as the JAX package pads them."""

    def __init__(self, bucket: int, src_hw: tuple, device):
        shape = (bucket,) + tuple(src_hw) + (3,)
        self.dev = tuple(torch.zeros(shape, dtype=torch.uint8, device=device)
                         for _ in range(2))
        self.host = (tuple(torch.zeros(shape, dtype=torch.uint8,
                                       pin_memory=True) for _ in range(2))
                     if device.type == "cuda" else None)
        self.filled = 0          # slots the previous request wrote

    def load(self, chunk_v: np.ndarray, chunk_l: np.ndarray) -> None:
        """Frames in, zeros after them; only the slots that changed move."""
        real = len(chunk_v)
        n = max(real, self.filled)
        with profiling.span("serve/stage"):
            if self.host is not None:
                with torch.cuda.device(self.dev[0].device):
                    self._load(chunk_v, chunk_l, real, n)
            else:
                self._load(chunk_v, chunk_l, real, n)
        self.filled = real

    def _load(self, chunk_v, chunk_l, real: int, n: int) -> None:
        for i, chunk in enumerate((chunk_v, chunk_l)):
            dev = self.dev[i]
            if self.host is None:
                with profiling.span("serve/stage_copy", timeline=True):
                    dev[:real].copy_(torch.from_numpy(chunk))
                    dev[real:n].zero_()
                continue
            host = self.host[i].numpy()
            with profiling.span("serve/stage_copy", timeline=True):
                host[:real] = chunk
                host[real:n] = 0
            dev[:n].copy_(self.host[i][:n], non_blocking=True)


class Graph:
    """One captured body: the CUDA graph, its packed output on the device
    and its pinned host copy, and the kernel launches the graph holds (the
    wrappers count these on each replay, since they do not run then)."""

    def __init__(self, cuda_graph, out, launches: dict):
        self.graph = cuda_graph
        self.out = out
        self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        self.launches = launches
        self.replays = 0

    def run(self, real: int) -> np.ndarray:
        """Replay, count the graph's launches, and fetch the first ``real``
        rows of the packed output (one device-to-host copy)."""
        self.launch()
        return self.fetch(real)

    def launch(self) -> None:
        """Replay on the output's card and start the copy of the packed
        output to the host; :meth:`fetch` waits for it. A mesh launches
        every replica before it fetches any."""
        with profiling.span("serve/launch"), \
                torch.cuda.device(self.out.device):
            replay(self.graph, self.launches)
            self.host.copy_(self.out, non_blocking=True)
        self.replays += 1

    def fetch(self, real: int) -> np.ndarray:
        """The first ``real`` rows of the launched replay's output."""
        with profiling.span("serve/fetch_wait", timeline=True):
            torch.cuda.current_stream(self.out.device).synchronize()
        with profiling.span("serve/fetch_copy", timeline=True):
            return self.host.numpy()[:real].copy()
