"""Shared pieces of the benchmark's tests: the repository's ``cuda``
marker, and the tiny cells under ``data/`` run on the CPU."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
DATA = os.path.join(HERE, "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without CUDA")


TINY_BENCH = {
    "workloads": [
        {"name": n, "config": "tiny-dual", "traffic": t, "chips": 1,
         "why": "a tiny cell for the CPU tests"}
        for n, t in (("tiny-serve", "serve_tiny"),
                     ("tiny-serve32", "serve_tiny32"))],
    "end_to_end": [
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"},
        {"name": "frames_per_s", "unit": "frames/s", "better": "higher",
         "bound": 0.03, "source": "host_clock",
         "workloads": ["tiny-serve", "tiny-serve32"]},
        {"name": "request_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.03, "source": "host_clock",
         "workloads": ["tiny-serve", "tiny-serve32"]}],
    "per_layer": []}


@pytest.fixture
def tiny_bench(tmp_path):
    """A BENCHMARK.json of the tiny cells, and the search path that finds
    their files first."""
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(TINY_BENCH))
    return str(path), (DATA, os.path.join(ROOT, "perfbench"))


def run_tiny(tiny_bench, workload, seed, variant="program", seconds=0.5):
    from perfbench import harness
    bench, search = tiny_bench
    return harness.run(["--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--variant", variant],
                       device="cpu", bench_path=bench, search=search)
