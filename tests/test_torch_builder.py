"""The port's cfg-free builder (``models/builder.py``) gives the same
GraphIR as the JAX package's, builder by builder: every ``build_*`` with
its defaults and every entry of ``BUILDERS`` (the 16 zoo models and their
variants), node by node, field by field, exactly."""

import dataclasses

import numpy as np
import pytest

from double_yolo_kaist_torch.models import builder as TB

try:        # the card's machine has no JAX
    from double_yolo_kaist_tpu.models import builder as JB
except ModuleNotFoundError:
    JB = None

FUNCS = sorted(n for n in dir(TB) if n.startswith("build_"))
CASES = [("fn", n) for n in FUNCS] + [("zoo", n) for n in sorted(TB.BUILDERS)]


def test_builders_are_jax_builders():
    assert FUNCS == sorted(n for n in dir(JB) if n.startswith("build_"))
    assert sorted(TB.BUILDERS) == sorted(JB.BUILDERS)
    assert TB.KAIST_ANCHORS_V3_DOUBLE == JB.KAIST_ANCHORS_V3_DOUBLE
    assert TB.KAIST_ANCHORS_V3_SINGLE == JB.KAIST_ANCHORS_V3_SINGLE


def _same_value(va, vb, where):
    if isinstance(vb, np.ndarray):
        np.testing.assert_array_equal(va, vb, err_msg=str(where))
        assert va.dtype == vb.dtype, where
    elif isinstance(vb, dict):
        assert sorted(va) == sorted(vb), where
        for k in vb:
            _same_value(va[k], vb[k], where + (k,))
    else:
        assert va == vb, (where, va, vb)


@pytest.mark.parametrize("kind,name", CASES,
                         ids=[f"{k}-{n}" for k, n in CASES])
def test_builder_matches_jax(kind, name):
    if kind == "fn":
        mine, ref = getattr(TB, name)(), getattr(JB, name)()
    else:
        mine, ref = TB.BUILDERS[name](), JB.BUILDERS[name]()
    for f in ("cfg_path", "consumed", "routs", "yolo_indices",
              "second_index", "dual_stream", "num_layers"):
        assert getattr(mine, f) == getattr(ref, f), f
    _same_value(mine.net, ref.net, ("net",))
    assert len(mine.nodes) == len(ref.nodes)
    for a, b in zip(mine.nodes, ref.nodes):
        for f in dataclasses.fields(b):
            _same_value(getattr(a, f.name), getattr(b, f.name),
                        (b.index, f.name))
