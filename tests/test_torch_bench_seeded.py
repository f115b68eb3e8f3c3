"""``bench.seeded_variables`` on every zoo model (F7): the weights ``bench``
and ``zoo_bench`` draw when no ``--weights`` is given.

For each of the 16 models: the tree is ``graph.init``'s (the same keys,
shapes and dtypes), and the fp32 folded forward at 64x96 on the CPU gives
finite heads that move when one input frame changes (by more than
``MOVES``: at seed 0 the smallest change over the zoo is 0.016, against
exactly 0.0 on ``graph.init``'s weights for the YOLOv4 models). The
flagship's draws are the ones every earlier figure was taken on (a digest
of the whole tree and a few leaves fixed here), and ``bench`` runs on a
model that failed before the repair.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch import bench as TB
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models.zoo import FLAGSHIP, MODELS, cfg_path

HW = (64, 96)
MOVES = 1e-3            # least max |change| of a head when a frame changes
# sha256 of the flagship's seeded tree at seed 0 (:func:`_digest`), as the
# function drew it before dwconv and inception were added
FLAGSHIP_DIGEST = \
    "90dcee8ce74ec5f2e903075bdc66b00beb2f3f89824d60982fec93d33fc6f6a4"


def _digest(tree) -> str:
    h = hashlib.sha256()

    def walk(t, path):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], f"{path}/{k}")
            else:
                h.update(f"{path}/{k}".encode())
                h.update(t[k].numpy().tobytes())

    walk(tree, "")
    return h.hexdigest()


def _layout(tree, path=""):
    """{path: (shape, dtype)} of every leaf."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_layout(v, f"{path}/{k}"))
        else:
            out[f"{path}/{k}"] = (tuple(v.shape), v.dtype)
    return out


@pytest.fixture(scope="module", params=list(MODELS))
def seeded(request):
    torch.set_num_threads(1)
    ir = compile_cfg(cfg_path(request.param))
    return request.param, ir, TB.seeded_variables(ir, 0)


def _heads(ir, placed, xv, xl):
    with torch.inference_mode():
        io, raw = TG.apply_folded(ir, placed, torch.from_numpy(xv),
                                  torch.from_numpy(xl)
                                  if ir.dual_stream else None)
    return io, torch.cat([r.reshape(-1) for r in raw])


def test_seeded_tree_is_graph_init_tree(seeded):
    name, ir, variables = seeded
    assert _layout(variables) == _layout(TG.init(ir, 0)), name


def test_seeded_heads_finite_and_input_dependent(seeded):
    name, ir, variables = seeded
    placed = TG.place_folded(ir, TG.fold_batchnorm(ir, variables), "cpu",
                             torch.float32)
    rng = np.random.default_rng(5)
    xv, xl, xv2 = (rng.random((1,) + HW + (3,), dtype=np.float32)
                   for _ in range(3))
    io, raw = _heads(ir, placed, xv, xl)
    io2, raw2 = _heads(ir, placed, xv2, xl)
    assert bool(torch.isfinite(io).all() and torch.isfinite(io2).all()), name
    assert float((raw - raw2).abs().max()) > MOVES, name


def test_seeded_gain_by_family():
    gains = {name: TB.seeded_gain(compile_cfg(cfg_path(name)))
             for name in MODELS}
    for name, gain in gains.items():
        want = (TB.MOBILENET_GAIN if "MobileNet" in name or "MNv" in name
                else TB.FLAGSHIP_GAIN if "YOLOv4" in name
                else TB.DARKNET53_GAIN)
        assert gain == want, name


def test_flagship_draws_unchanged():
    ir = compile_cfg(cfg_path(FLAGSHIP))
    v = TB.seeded_variables(ir, 0)
    np.testing.assert_array_equal(
        v["params"]["l0"]["w"].reshape(-1)[:3].numpy(),
        np.float32([0.1159764751791954, -0.19494009017944336,
                    -0.3886946141719818]))
    assert _digest(v) == FLAGSHIP_DIGEST


def test_bench_runs_on_a_darknet53_model(capsys):
    """Visible-YOLOv3-Normal's seeded heads overflowed before the repair
    and ``bench`` refused them as non-finite."""
    TB.main(["--model", "Visible-YOLOv3-Normal", "--bf16", "--device", "cpu",
             "--height", "64", "--width", "96", "--batch", "1", "--iters",
             "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["value"]) and out["value"] > 0
    assert out["device"] == "cpu"
