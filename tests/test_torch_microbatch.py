"""MicroBatcher: cross-request coalescing, the port's ``serving.MicroBatcher``
and ``QueueFull`` against the JAX package's.

Every case of ``tests/test_microbatch.py`` runs here on both classes, each
over the same fake predictor, so that the port keeps the JAX semantics:
result routing, shape grouping, error delivery to every submitter, the
``max_batch`` cap, ``max_wait_ms``, ``max_queue`` backpressure, and the
continuous-batching property that requests arriving while a batch runs
form the next batch. A stress case with more threads than cores and a
short switch interval checks the port's dispatcher and ``stats``.
"""

import sys
import threading
import time

import numpy as np
import pytest

from double_yolo_kaist_tpu import serving as JS
from double_yolo_kaist_torch import serving as TS

IMPLS = {"jax": JS, "torch": TS}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    """The serving module under test: ``MicroBatcher`` and ``QueueFull``."""
    return IMPLS[request.param]

class FakePredictor:
    """Returns, per frame, (its mean pixel, batch size it ran in, seq#)."""

    def __init__(self, delay=0.0, fail_on=None):
        self.calls = []                    # list of (batch_size, shape)
        self.delay = delay
        self.fail_on = fail_on             # batch size that raises
        self._lock = threading.Lock()

    def __call__(self, v_imgs, l_imgs):
        with self._lock:
            self.calls.append((len(v_imgs), v_imgs.shape[1:3]))
            n_call = len(self.calls)
        if self.fail_on is not None and len(v_imgs) == self.fail_on:
            raise RuntimeError("boom")
        if self.delay:
            time.sleep(self.delay)
        return [(float(v.mean()), len(v_imgs), n_call) for v in v_imgs]


def _frame(val, hw=(8, 10)):
    return np.full(hw + (3,), val, np.uint8)


def test_single_request_passthrough(impl):
    p = FakePredictor()
    mb = impl.MicroBatcher(p, max_batch=8)
    try:
        mean, bs, _ = mb.submit(_frame(7))
        assert mean == 7.0 and bs == 1
        assert p.calls == [(1, (8, 10))]
    finally:
        mb.close()


def test_concurrent_requests_coalesce(impl):
    # hold the device busy briefly so a burst piles up into one batch
    p = FakePredictor(delay=0.05)
    mb = impl.MicroBatcher(p, max_batch=16)
    try:
        results = {}

        def hit(i):
            results[i] = mb.submit(_frame(i))

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # every request got ITS OWN frame's result back
        assert all(results[i][0] == float(i) for i in range(12))
        # strictly fewer device calls than requests, none above the cap
        assert len(p.calls) < 12
        assert max(c[0] for c in p.calls) <= 16
        assert sum(c[0] for c in p.calls) == 12
    finally:
        mb.close()


def test_max_batch_cap(impl):
    p = FakePredictor(delay=0.05)
    mb = impl.MicroBatcher(p, max_batch=4)
    try:
        threads = [threading.Thread(target=mb.submit, args=(_frame(i),))
                   for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert max(c[0] for c in p.calls) <= 4
        assert sum(c[0] for c in p.calls) == 10
    finally:
        mb.close()


def test_mixed_shapes_grouped_separately(impl):
    p = FakePredictor(delay=0.05)
    mb = impl.MicroBatcher(p, max_batch=16)
    try:
        out = {}

        def hit(i, hw):
            out[i] = mb.submit(_frame(i, hw))

        threads = []
        for i in range(10):
            hw = (8, 10) if i % 2 == 0 else (16, 20)
            threads.append(threading.Thread(target=hit, args=(i, hw)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(out[i][0] == float(i) for i in range(10))
        # every device call is shape-uniform
        assert all(c[1] in ((8, 10), (16, 20)) for c in p.calls)
        assert sum(c[0] for c in p.calls) == 10
    finally:
        mb.close()


def test_error_propagates_to_every_submitter(impl):
    p = FakePredictor(delay=0.05, fail_on=3)
    mb = impl.MicroBatcher(p, max_batch=3)
    try:
        errs = []

        def hit(i):
            try:
                mb.submit(_frame(i))
            except RuntimeError as e:
                errs.append(str(e))

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # the batches that ran at the failing size all raised; the batcher
        # stays alive for the rest
        assert errs and all(e == "boom" for e in errs)
        assert mb.submit(_frame(9))[0] == 9.0     # still serving
    finally:
        mb.close()


def test_max_wait_collects_a_burst(impl):
    p = FakePredictor()
    mb = impl.MicroBatcher(p, max_batch=8, max_wait_ms=120)
    try:
        threads = [threading.Thread(target=mb.submit, args=(_frame(i),))
                   for i in range(4)]
        for t in threads:
            t.start()
            time.sleep(0.01)               # staggered arrivals inside window
        for t in threads:
            t.join()
        assert len(p.calls) == 1 and p.calls[0][0] == 4
    finally:
        mb.close()


def test_visible_lwir_shape_mismatch_rejected(impl):
    mb = impl.MicroBatcher(FakePredictor())
    try:
        with pytest.raises(ValueError):
            mb.submit(_frame(1, (8, 10)), _frame(1, (16, 20)))
    finally:
        mb.close()


def test_submit_after_close_raises(impl):
    mb = impl.MicroBatcher(FakePredictor())
    mb.close()
    with pytest.raises(RuntimeError):
        mb.submit(_frame(1))


def test_max_queue_backpressure(impl):
    """submit() fails fast with QueueFull once max_queue frames are queued
    behind a busy device; the server maps it to HTTP 503."""
    p = FakePredictor(delay=0.25)
    mb = impl.MicroBatcher(p, max_batch=1, max_queue=2)
    try:
        results, rejects = [], []

        def worker(v):
            try:
                results.append(mb.submit(_frame(v)))
            except impl.QueueFull:
                rejects.append(v)

        # first request occupies the device; give the dispatcher time to
        # take it so the queue is empty again
        t0 = threading.Thread(target=worker, args=(1,))
        t0.start()
        time.sleep(0.1)
        # burst of 5 while busy: 2 queue, 3 must be shed
        ts = [threading.Thread(target=worker, args=(v,))
              for v in (2, 3, 4, 5, 6)]
        for t in ts:
            t.start()
            time.sleep(0.01)   # deterministic arrival order
        for t in [t0] + ts:
            t.join(timeout=10)
        assert len(rejects) == 3 and len(results) == 3
    finally:
        mb.close()


def test_stress_many_threads_port():
    """64 submitters on a short switch interval: every one gets its own
    frame's result, and the stats count every frame once."""
    p = FakePredictor(delay=0.002)
    mb = TS.MicroBatcher(p, max_batch=8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = {}

        def hit(i):
            results[i] = mb.submit(_frame(i))

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert all(results[i][0] == float(i) for i in range(64))
        stats = mb.stats
        assert stats["frames"] == 64 == sum(c[0] for c in p.calls)
        assert stats["batches"] == len(p.calls)
        assert sum(k * v for k, v in stats["size_hist"].items()) == 64
    finally:
        sys.setswitchinterval(old)
        mb.close()
