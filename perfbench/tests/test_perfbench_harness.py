"""The harness: found by name, driven by data, and free of JAX."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.tests.conftest import DATA, ROOT, TINY_BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "double_yolo_kaist_tpu"}


def _modules_after(code: str) -> set:
    """Top-level names of every module a fresh interpreter holds after
    running ``code`` from the root of the repository."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_drivers_load_no_jax():
    names = _modules_after(
        "import perfbench.run, perfbench.harness as h, perfbench.trace\n"
        "import perfbench.compare_serve, perfbench.program\n"
        "h.load_file_module('perfbench/drivers/serve.py', 'serve')\n"
        "import double_yolo_kaist_torch.serving\n")
    assert "double_yolo_kaist_torch" in names
    assert not names & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    names = _modules_after(
        "import perfbench.reference.cfg, perfbench.reference.model\n"
        "import perfbench.reference.detect\n"
        "import perfbench.weights, perfbench.flops\n")
    assert not names & (FORBIDDEN | {"double_yolo_kaist_torch"})
    for f in os.listdir(os.path.join(ROOT, "perfbench", "reference")):
        if f.endswith(".py"):
            text = open(os.path.join(ROOT, "perfbench", "reference",
                                     f)).read()
            assert "double_yolo_kaist" not in text, f


def test_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "flagship-serve-b8", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_new_cell_mix_and_metric_are_files_only(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a limits file
    added as new files under a search directory, with entries in a
    BENCHMARK.json, are found by name; nothing else changes."""
    from perfbench import harness
    new = tmp_path / "bench"
    shutil.copytree(os.path.join(DATA, "configs", "tiny-dual"),
                    new / "configs" / "tiny-new")
    mix = json.load(open(os.path.join(DATA, "traffic", "serve_tiny.json")))
    mix["batch"] = 2
    (new / "traffic").mkdir()
    (new / "traffic" / "serve_new.json").write_text(json.dumps(mix))
    (new / "metrics").mkdir()
    (new / "metrics" / "requests.new.py").write_text(
        "def read(ctx):\n    return ctx.counts.get('requests')\n")
    (new / "limits").mkdir()
    shutil.copy(os.path.join(DATA, "limits", "tiny-serve.json"),
                new / "limits" / "tiny-new-serve.json")
    bench = dict(TINY_BENCH)
    bench["workloads"] = TINY_BENCH["workloads"] + [
        {"name": "tiny-new-serve", "config": "tiny-new",
         "traffic": "serve_new", "chips": 1, "why": "added as files"}]
    bench["end_to_end"] = [dict(m) for m in TINY_BENCH["end_to_end"]]
    for m in bench["end_to_end"][1:3]:
        m["workloads"] = m["workloads"] + ["tiny-new-serve"]
    bench["per_layer"] = [{"name": "requests.new", "unit": "1",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "frames_per_s",
                           "workloads": ["tiny-new-serve"]}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    search = (str(new), DATA, os.path.join(ROOT, "perfbench"))
    cell = harness.Cell("tiny-new-serve", str(path), search)
    assert cell.mix["batch"] == 2
    assert [m["name"] for m in cell.per_layer] == ["requests.new"]
    assert set(cell.limits) == {"gap_excess", "frame_excess",
                                "recall_excess", "extra_excess"}
    out = harness.run(["--workload", "tiny-new-serve", "--seed", "2",
                       "--seconds", "0.3"], device="cpu",
                      bench_path=str(path), search=search)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "frames_per_s",
                                   "request_p95_ms"}

    class Ctx:
        counts = {"requests": 7}
    assert cell.reader("requests.new").read(Ctx) == 7


def test_result_line_keys_and_checks_last(tiny_bench):
    from perfbench.tests.conftest import run_tiny
    out = run_tiny(tiny_bench, "tiny-serve", 2)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """One short run of the first cell through the command, on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "flagship-serve-b8", "--seed", "2147483911", "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
