"""The port's ``utils/general.py`` and ``utils/profiling.py`` against the
JAX package's on the CPU: ``model_info`` gives the same string on the same
weights, ``flops_estimate`` the same number on each cfg and size,
``init_seeds`` the same Python and numpy draws (and seeds torch),
``load_class_names`` and ``check_file`` the same answers. Plus what has no
JAX counterpart to compare: ``device_sync_time`` and ``trace`` on the CPU,
and ``enable_compile_cache`` doing nothing."""

import os
import random

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.utils import general as TGN
from double_yolo_kaist_torch.utils import profiling as TPR

try:        # the card's machine has no JAX
    import jax

    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
    from double_yolo_kaist_tpu.models import graph as JG
    from double_yolo_kaist_tpu.utils import general as JGN
    from double_yolo_kaist_tpu.utils import profiling as JPR
except ModuleNotFoundError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = [("tests/fixtures/tiny_dyolov3.cfg", [8, 4]),
        ("configs/kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg", None),
        ("configs/kaist_dyolov4_fshare_global_concat_se3.cfg", None),
        ("configs/kaist_dyolov3_concat_seinc.cfg", None)]


@pytest.mark.parametrize("cfg,strides", CFGS[:2], ids=[c[0] for c in CFGS[:2]])
@pytest.mark.parametrize("verbose", [False, True])
def test_model_info_matches_jax(cfg, strides, verbose):
    path = os.path.join(REPO, cfg)
    jir = jax_compile_cfg(path, yolo_strides=strides)
    tir = compile_cfg(path, yolo_strides=strides)
    jv = jax.tree.map(np.asarray, JG.init(jir, jax.random.PRNGKey(0)))
    tv = TW.from_jax_variables(tir, jv)
    assert TGN.model_info(tir, tv, verbose) == JGN.model_info(jir, jv,
                                                              verbose)


@pytest.mark.parametrize("cfg,strides", CFGS, ids=[c[0] for c in CFGS])
def test_flops_estimate_matches_jax(cfg, strides):
    path = os.path.join(REPO, cfg)
    jir = jax_compile_cfg(path, yolo_strides=strides)
    tir = compile_cfg(path, yolo_strides=strides)
    for hw in ((512, 640), (64, 96)):
        assert TPR.flops_estimate(tir, hw) == JPR.flops_estimate(jir, hw)


def test_init_seeds_matches_jax():
    draws = []
    for init in (JGN.init_seeds, TGN.init_seeds):
        init(1234)
        draws.append((random.random(), np.random.rand(3).tolist()))
    assert draws[0] == draws[1]
    TGN.init_seeds(7)
    a = torch.rand(4)
    TGN.init_seeds(7)
    assert torch.equal(a, torch.rand(4))


def test_class_names_and_check_file_match_jax(tmp_path, monkeypatch):
    names = tmp_path / "kaist.names"
    names.write_text("person\n\n  people \ncyclist\n")
    assert TGN.load_class_names(str(names)) == \
        JGN.load_class_names(str(names)) == ["person", "people", "cyclist"]
    sub = tmp_path / "a" / "b"
    sub.mkdir(parents=True)
    (sub / "deep.cfg").write_text("[net]\n")
    monkeypatch.chdir(tmp_path)
    for f in (str(names), "deep.cfg"):
        assert TGN.check_file(f) == JGN.check_file(f)
    for mod in (TGN, JGN):
        with pytest.raises(FileNotFoundError, match="nowhere.cfg"):
            mod.check_file("nowhere.cfg")


def test_profiling_on_the_cpu(tmp_path):
    x = torch.arange(12.0).reshape(3, 4)
    sec, out = TPR.device_sync_time(lambda t: t @ t.T, x, repeats=3)
    assert sec >= 0 and torch.equal(out, x @ x.T)
    TPR.device_sync({"a": [out]})
    with TPR.trace(str(tmp_path / "tr")) as prof:
        (x + 1).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert prof.key_averages() is not None
    assert TGN.enable_compile_cache() is None
