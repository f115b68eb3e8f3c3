"""Cross-request micro-batching in front of any predictor
(``serving.Predictor`` or ``export.ExportedPredictor``): the JAX package's
``serving.MicroBatcher`` and ``QueueFull``. They live here, apart from
``serving``, so that a server of an exported artifact imports no model
code.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class QueueFull(RuntimeError):
    """Raised by MicroBatcher.submit when the pending queue exceeds
    max_queue: the server sheds the request (HTTP 503) instead of letting
    tail latency grow without bound."""


class MicroBatcher:
    """Cross-request micro-batching: coalesce concurrent single-frame
    requests into one batched predictor call (the JAX package's
    ``serving.MicroBatcher``).

    * one dispatcher thread owns the device; request threads enqueue
      frames and block on a per-request event;
    * the dispatcher takes everything pending (same source shape, up to
      ``max_batch``) the moment it is free, so an idle server runs a lone
      request at once;
    * while a batch runs, new arrivals pile up and form the next batch, so
      under load the batch size follows the device's throughput;
    * ``max_wait_ms`` (default 0) holds the first request of a batch for a
      fixed window so that more arrivals join it, trading tail latency for
      bigger buckets;
    * ``max_queue`` bounds the frames waiting: beyond it ``submit`` raises
      :class:`QueueFull`;
    * an error of a batch is raised in every submitter of that batch.

    Results equal unbatched serving: the fixed-shape NMS is per image, and
    the predictor zero-pads partial buckets itself.
    """

    def __init__(self, predictor, *, max_batch: int = 16,
                 max_wait_ms: float = 0.0, max_queue: int | None = None):
        self.predictor = predictor
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_queue = None if max_queue is None else int(max_queue)
        self._lock = threading.Lock()
        self._arrived = threading.Condition(self._lock)
        self._pending: list = []       # request dicts, first in first out
        self._stop = False
        self._n_batches = 0
        self._n_frames = 0
        self._size_hist: dict = {}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatch-dispatcher")
        self._thread.start()

    @property
    def stats(self) -> dict:
        """Coalescing statistics: how well concurrent traffic batches."""
        with self._lock:
            n = max(self._n_batches, 1)
            return {"batches": self._n_batches, "frames": self._n_frames,
                    "mean_batch": round(self._n_frames / n, 2),
                    "size_hist": dict(sorted(self._size_hist.items()))}

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._arrived.notify()
        self._thread.join(timeout=5)

    def submit(self, v_img: np.ndarray, l_img: np.ndarray | None = None):
        """One frame in (H, W, 3) uint8 -> (boxes, scores, classes). Blocks
        until the coalesced batch holding this frame completes. Thread-safe:
        call it from each request handler thread."""
        req = {"v": np.asarray(v_img),
               "l": np.asarray(v_img if l_img is None else l_img),
               "done": threading.Event(), "t0": time.monotonic()}
        if req["v"].shape != req["l"].shape:
            raise ValueError(f"visible/lwir shape mismatch: "
                             f"{req['v'].shape} vs {req['l'].shape}")
        with self._lock:
            if self._stop:
                raise RuntimeError("MicroBatcher is closed")
            if (self.max_queue is not None
                    and len(self._pending) >= self.max_queue):
                raise QueueFull(
                    f"{len(self._pending)} requests already queued "
                    f"(max_queue={self.max_queue})")
            self._pending.append(req)
            self._arrived.notify()
        req["done"].wait()
        if "err" in req:
            raise req["err"]
        return req["res"]

    def _take_batch(self) -> list:
        """Called with the lock held and requests pending: pop the oldest
        request and every same-shape request after it, up to max_batch."""
        if self.max_wait > 0:
            deadline = self._pending[0]["t0"] + self.max_wait
            while len(self._pending) < self.max_batch and not self._stop:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._arrived.wait(left)
                if not self._pending:   # raced with close()
                    return []
        shape = self._pending[0]["v"].shape
        take, keep = [], []
        for r in self._pending:
            if r["v"].shape == shape and len(take) < self.max_batch:
                take.append(r)
            else:
                keep.append(r)
        self._pending = keep
        return take

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._stop:
                    self._arrived.wait()
                if self._stop:
                    batch, self._pending = self._pending, []
                    for r in batch:
                        r["err"] = RuntimeError("MicroBatcher closed")
                        r["done"].set()
                    return
                batch = self._take_batch()
                if batch:
                    self._n_batches += 1
                    self._n_frames += len(batch)
                    self._size_hist[len(batch)] = (
                        self._size_hist.get(len(batch), 0) + 1)
            if not batch:
                continue
            try:
                res = self.predictor(np.stack([r["v"] for r in batch]),
                                     np.stack([r["l"] for r in batch]))
                for r, out in zip(batch, res):
                    r["res"] = out
            except Exception as e:  # noqa: BLE001 — delivered to submitters
                for r in batch:
                    r["err"] = e
            for r in batch:
                r["done"].set()
