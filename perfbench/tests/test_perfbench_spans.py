"""The readers of the program's spans and counters, on a synthetic store
and a stand-in for the run's ``ctx``."""

import types

import pytest

from double_yolo_kaist_torch.utils import profiling
from perfbench import harness
from perfbench.tests.conftest import ROOT

MS = 1_000_000          # ns


def _request(req, t0, request_ms, stage_ms, launch_ms, wait_ms, first_id):
    """The spans of one request starting at ``t0`` ns: the root, its
    staging, its launch and its fetch wait (split in two where
    ``wait_ms`` is a pair, as a mesh waits for each replica)."""
    S = profiling.Span
    root = first_id
    out = [S("serve/request", t0, t0 + request_ms * MS, root, None, req, 1),
           S("serve/stage", t0, t0 + stage_ms * MS, root + 1, root, req, 1),
           S("serve/stage_copy", t0, t0 + stage_ms * MS // 2, root + 2,
             root + 1, req, 1)]
    t = t0 + stage_ms * MS
    out.append(S("serve/launch", t, t + launch_ms * MS, root + 3, root, req,
                 1))
    t += launch_ms * MS
    waits = wait_ms if isinstance(wait_ms, tuple) else (wait_ms,)
    for i, w in enumerate(waits):
        out.append(S("serve/fetch_wait", t, t + w * MS, root + 4 + i, root,
                     req, 1))
        t += w * MS
    return out


def _store(requests, counters=None):
    spans = []
    for i, (request_ms, stage_ms, launch_ms, wait_ms) in enumerate(requests):
        spans += _request(i + 1, i * 100 * MS, request_ms, stage_ms,
                          launch_ms, wait_ms, 10 * i + 1)
    return {"spans": spans,
            "counters": dict(counters or {"serve.requests": len(requests)})}


def _ctx(store, kernels=None):
    ctx = types.SimpleNamespace(program_store=store)
    ctx.trace = types.SimpleNamespace(kernels=kernels or {})
    return ctx


def _reader(name):
    return harness.load_file_module(f"{ROOT}/perfbench/metrics/{name}.py",
                                    "t_" + name.replace(".", "_"))


# (request ms, stage ms, launch ms, fetch wait ms) of three requests
REQUESTS = [(26, 3, 4, 18), (32, 5, 6, 20), (24, 2, 5, (8, 9))]
WANT = {"host_ms.serve": 8.0,               # 26-18, 32-20, 24-17
        "stage_ms.serve": 3.0,
        "fetch_wait_ms.serve": 18.0,
        "replay_ms.serve": 22.0,            # 4+18, 6+20, 5+17
        "device_ops_per_request.serve": 20 + 3 + 2 / 3}
# 20 and 3 a request, a record of kern_a dropped; kern_b on two requests
KERNELS = {"kern_a": [59, 0.5], "Memcpy HtoD": [9, 0.1],
           "kern_b": [2, 0.01]}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_its_median(name):
    got = _reader(name).read(_ctx(_store(REQUESTS), KERNELS))
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
@pytest.mark.parametrize("store", [
    {"spans": [], "counters": {}},
    _store(REQUESTS, {"serve.requests": 3, "dropped": 1})],
    ids=["empty", "dropped"])
def test_reader_gives_nothing_without_a_whole_store(name, store):
    assert _reader(name).read(_ctx(store, KERNELS)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_nothing_where_the_program_has_no_spans(name,
                                                             monkeypatch):
    """A program without ``profiling.take`` (the parent of the spans)."""
    monkeypatch.delattr(profiling, "take")
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(kernels=KERNELS))
    assert _reader(name).read(ctx) is None


def test_store_is_taken_once_and_shared():
    """The first reader takes the program's store; the others read the
    copy kept on the ctx."""
    from torch.profiler import ProfilerActivity, profile
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("serve.requests", 3)
        for s in _store(REQUESTS)["spans"]:
            profiling.STORE.add(s)
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(kernels=KERNELS))
    got = {n: _reader(n).read(ctx) for n in sorted(WANT)}
    assert got == pytest.approx(WANT, rel=1e-12)
    assert profiling.take() == {"spans": [], "counters": {}}



@pytest.mark.parametrize("records,want", [
    (3000, 10.0),               # 10 a request, every record
    (2990, 10.0),               # a third of a percent lost: taken as 10
    (2900, 2900 / 300),         # 3.3% short: more than the profiler loses
    (3001, 3001 / 300),         # once more on one request
    (100, 1 / 3)],              # on a third of the requests
    ids=["whole", "lost", "short", "above", "partial"])
def test_device_ops_takes_as_whole_only_what_the_profiler_lost(records,
                                                              want):
    got = _reader("device_ops_per_request.serve").read(
        _ctx(_store(REQUESTS, {"serve.requests": 300}), {"k": [records, 0.1]}))
    assert got == pytest.approx(want, rel=1e-12)
