"""The PyTorch port imports neither jax nor the JAX package (nor its
``cli/`` entry points).

Runs in a subprocess: this test process already holds jax (conftest.py)."""

import os
import pkgutil
import subprocess
import sys

import double_yolo_kaist_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = double_yolo_kaist_torch
    names = [pkg.__name__]
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(m.name)
    return names


def test_port_imports_no_jax():
    modules = _port_modules() + ["chip_smoke"]
    assert "double_yolo_kaist_torch.serving" in modules
    for name in ("ops.nms_kernel", "ops.stem", "ops.qgemm",
                 "models.quantize", "evaluate", "eval.evaluator",
                 "eval.metrics", "eval.coco_map", "data.dataset",
                 "data.pipeline", "utils.checkpoint", "utils.native",
                 "common", "models.zoo", "serve", "detect", "bench",
                 "data.streams", "utils.draw", "data.augment",
                 "train.loss", "train.optim", "train.step", "train.trainer",
                 "train.anchors", "train.cli", "config.writer",
                 "utils.logging", "utils.profiling", "utils.tree",
                 "data.clahe", "calibrate"):
        assert f"double_yolo_kaist_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'double_yolo_kaist_tpu', 'cli'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
