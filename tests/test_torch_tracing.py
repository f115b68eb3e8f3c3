"""The program's spans and counters (``utils/profiling.py``) in the
serving entry: recorded only under a ``torch.profiler`` window, one tree a
request, on the profiler's clock, bounded, and taken out whole.

The CPU cases serve the tiny cfg from a CPU ``Predictor``; the ``cuda``
case serves it from a captured graph on the card:
    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import json
import os
import re
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import graph
from double_yolo_kaist_torch.serving import Predictor
from double_yolo_kaist_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
HW = (64, 96)
# the spans that also enter a profiler range (host-only leaves)
TIMELINE = {"serve/lock_wait", "serve/stage_copy", "serve/fetch_wait",
            "serve/fetch_copy", "serve/unpack"}


def _predictor(device="cpu", buckets=(8,)):
    ir = compile_cfg(TINY, yolo_strides=[8, 4])
    return Predictor(ir, graph.init(ir, 0), img_size=96, conf_thres=0.01,
                     batch_buckets=buckets, compute_dtype=torch.float32,
                     device=device)


def _frames(seed, n):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n,) + HW + (3,), dtype=np.uint8)
                 for _ in range(2))


@pytest.fixture(scope="module")
def pred():
    p = _predictor()
    p(*_frames(0, 1))           # the first call's lazy set-up
    return p


def _traced(fn, activities=(ProfilerActivity.CPU,)):
    """Run ``fn`` under a profiler window; (fn's result, the store taken
    after it, the profiler's events)."""
    profiling.take()
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, profiling.take(), list(prof.profiler.kineto_results.events())


def _check_tree(spans, root):
    """Every span of ``root``'s request chains up to ``root`` and lies
    within its parent."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.request != root.request or s is root:
            continue
        up = by_id[s.parent]
        assert up.request == root.request
        assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
        while up.parent is not None:
            up = by_id[up.parent]
        assert up is root


def test_no_profiler_records_nothing(pred, monkeypatch):
    """With no window open a request reads no clock, enters no profiler
    range and records nothing, and still serves."""
    def refuse(*a, **k):
        raise AssertionError("entered with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_RANGE", refuse)
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(time_ns=refuse))
    profiling.take()
    out = pred(*_frames(1, 3))
    assert len(out) == 3
    assert profiling.take() == {"spans": [], "counters": {}}
    assert profiling.span("a") is profiling.span("b")   # nothing allocated


def test_one_request_is_one_tree(pred):
    out, st, _ = _traced(lambda: pred(*_frames(2, 3)))
    assert len(out) == 3
    spans = st["spans"]
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["serve/request"]
    root = roots[0]
    assert {s.request for s in spans} == {root.request}
    assert {s.name for s in spans} == {
        "serve/request", "serve/lock_wait", "serve/stage",
        "serve/stage_copy", "serve/unpack"}
    _check_tree(spans, root)
    assert st["counters"] == {"serve.requests": 1, "serve.frames": 3,
                              "serve.slots": 8, "serve.eager_batches": 1}


def test_each_chunk_is_a_request(pred):
    """10 frames in bucket 8: two chunks, two requests."""
    _, st, _ = _traced(lambda: pred(*_frames(3, 10)))
    roots = [s for s in st["spans"] if s.name == "serve/request"]
    assert len({s.request for s in roots}) == 2
    for root in roots:
        _check_tree(st["spans"], root)
    assert st["counters"]["serve.requests"] == 2
    assert st["counters"]["serve.frames"] == 10
    assert st["counters"]["serve.slots"] == 16


def test_two_threads_get_their_own_requests(pred):
    frames = [_frames(10 + i, 2) for i in range(2)]

    def both():
        threads = [threading.Thread(target=pred, args=f) for f in frames]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)

    _, st, _ = _traced(both)
    spans = st["spans"]
    roots = [s for s in spans if s.name == "serve/request"]
    assert len(roots) == 2
    assert roots[0].request != roots[1].request
    assert roots[0].thread != roots[1].thread
    for root in roots:
        _check_tree(spans, root)
        waits = [s for s in spans if s.name == "serve/lock_wait"
                 and s.request == root.request]
        assert len(waits) == 1 and waits[0].thread == root.thread


def test_timeline_spans_match_profiler_events(pred):
    """Each host-only leaf lies within 1 ms of the profiler's event of its
    name, start and end: the spans are on the profiler's clock."""
    _, st, events = _traced(lambda: pred(*_frames(4, 3)))
    for name in TIMELINE:
        spans = sorted((s.start_ns, s.end_ns) for s in st["spans"]
                       if s.name == name)
        evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in events if e.name() == name)
        assert len(spans) == len(evs)
        for (a, b), (c, d) in zip(spans, evs):
            assert abs(a - c) < 1_000_000 and abs(b - d) < 1_000_000
    # the spans that enclose work are kept in the store only
    assert not {e.name() for e in events} & {"serve/request", "serve/stage"}


def test_no_span_name_holds_a_roofline_kernel():
    """The benchmark's rooflines find their kernels by a substring of the
    name: no span of the program may carry one."""
    kernels = set()
    for f in ("decode.py", "stem.py"):
        text = open(os.path.join(REPO, "perfbench", "rooflines", f)).read()
        kernels |= set(re.findall(r'^KERNEL = "([^"]+)"', text, re.M))
    assert kernels == {"decode_heads_kernel", "stem_wg_kernel"}
    names = set()
    for f in ("serving.py", "cuda_graphs.py", "export.py"):
        text = open(os.path.join(REPO, "double_yolo_kaist_torch", f)).read()
        names |= set(re.findall(r'profiling\.span\(\s*"([^"]+)"', text))
    assert names >= TIMELINE | {"serve/request", "serve/stage",
                                "serve/launch", "serve/capture"}
    assert not any(k in n for k in kernels for n in names)


def test_store_bound_counts_dropped(pred, monkeypatch):
    monkeypatch.setattr(profiling.STORE, "capacity", 3)
    _, st, _ = _traced(lambda: pred(*_frames(5, 3)))
    assert len(st["spans"]) == 3
    assert st["counters"]["dropped"] == 3       # of 6 spans
    assert st["counters"]["serve.requests"] == 1


def test_take_clears_the_store(pred):
    _, st, _ = _traced(lambda: pred(*_frames(6, 1)))
    assert st["spans"] and st["counters"]
    assert profiling.take() == {"spans": [], "counters": {}}


def test_span_records_and_closes_on_an_error():
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer", request=True):
            with pytest.raises(ValueError):
                with profiling.span("inner", timeline=True):
                    raise ValueError("in the span")
            with profiling.span("after"):
                pass
    spans = {s.name: s for s in profiling.take()["spans"]}
    assert spans["inner"].parent == spans["outer"].id
    assert spans["after"].parent == spans["outer"].id
    assert spans["outer"].parent is None


def test_store_under_threads_loses_nothing():
    """16 threads count and record at once: no update is lost."""
    n, each = 16, 500
    switch = sys.getswitchinterval()
    profiling.take()

    def work():
        for _ in range(each):
            with profiling.span("w"):
                profiling.count("c")

    try:
        sys.setswitchinterval(1e-6)
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work) for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    st = profiling.take()
    assert st["counters"] == {"c": n * each}
    assert len(st["spans"]) == n * each
    assert len({s.id for s in st["spans"]}) == n * each


def test_trace_writes_the_request_tree(pred, tmp_path):
    logdir = str(tmp_path / "tr")
    with profiling.trace(logdir):
        pred(*_frames(7, 3))
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0
    with open(os.path.join(logdir, "spans.json")) as f:
        got = json.load(f)
    spans = [profiling.Span(**s) for s in got["spans"]]
    roots = [s for s in spans if s.name == "serve/request"]
    assert len(roots) == 1
    _check_tree(spans, roots[0])
    assert got["counters"]["serve.requests"] == 1
    assert profiling.take() == {"spans": [], "counters": {}}


# ----------------------------------------------------------------- the card


@pytest.mark.cuda
def test_graph_spans_on_card():
    """Over a captured graph a request records its launch and its fetch
    wait, and the profiler's events on the card carry no span's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = _predictor("cuda", buckets=(4,))
    p.warmup(HW, 4)
    p(*_frames(8, 3))
    _, st, events = _traced(
        lambda: p(*_frames(9, 3)),
        (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    spans = st["spans"]
    root, = [s for s in spans if s.name == "serve/request"]
    _check_tree(spans, root)
    names = {s.name for s in spans}
    assert names == {"serve/request", "serve/lock_wait", "serve/stage",
                     "serve/stage_copy", "serve/launch", "serve/fetch_wait",
                     "serve/fetch_copy", "serve/unpack"}
    assert st["counters"] == {"serve.requests": 1, "serve.frames": 3,
                              "serve.slots": 4}
    on_card = [e.name() for e in events
               if str(e.device_type()).endswith("CUDA")]
    assert on_card
    assert not [n for n in on_card if any(s in n for s in names)]
