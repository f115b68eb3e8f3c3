"""The port's ``utils/general.py`` against the JAX package's on the CPU:
``model_info`` gives the same string on the same weights, ``init_seeds``
the same Python and numpy draws (and seeds torch), ``load_class_names``
and ``check_file`` the same answers. Plus what has no JAX counterpart to
compare: ``utils/profiling.py``'s ``trace`` on the CPU, with the spans of
its window in ``spans.json`` (the serving entry's spans are
``tests/test_torch_tracing.py``'s), and ``enable_compile_cache`` doing
nothing."""

import json
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
except ModuleNotFoundError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = [("tests/fixtures/tiny_dyolov3.cfg", [8, 4]),
        ("configs/kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg", None)]


@pytest.mark.parametrize("cfg,strides", CFGS, ids=[c[0] for c in CFGS])
@pytest.mark.parametrize("verbose", [False, True])
def test_model_info_matches_jax(cfg, strides, verbose):
    path = os.path.join(REPO, cfg)
    jir = jax_compile_cfg(path, yolo_strides=strides)
    tir = compile_cfg(path, yolo_strides=strides)
    jv = jax.tree.map(np.asarray, JG.init(jir, jax.random.PRNGKey(0)))
    tv = TW.from_jax_variables(tir, jv)
    assert TGN.model_info(tir, tv, verbose) == JGN.model_info(jir, jv,
                                                              verbose)


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
    with TPR.trace(str(tmp_path / "tr")) as prof:
        with TPR.span("outer", request=True):
            with TPR.span("inner", timeline=True):
                (x + 1).sum()
            TPR.count("things", 2)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert "inner" in {e.key for e in prof.key_averages()}
    got = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert got["counters"] == {"things": 2}
    spans = {s["name"]: s for s in got["spans"]}
    assert set(spans) == {"outer", "inner"}
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["inner"]["request"] == spans["outer"]["request"]
    assert TPR.take() == {"spans": [], "counters": {}}
    assert TGN.enable_compile_cache() is None
