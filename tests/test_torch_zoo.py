"""Every zoo model that no other test holds at full width, port against
JAX (the YOLOv3 family here, the YOLOv4 family in ``test_torch_zoo_v4.py``,
so that xdist spreads them): ``graph.apply_folded`` in fp32 at full width
on one seeded 64x96 pair (the visible frame alone for ``Visible-*``), on
the repaired ``bench.seeded_variables`` carried to JAX with
``models.weights.to_jax_variables``.

MNv3 dual (trained fixture weights) is held in ``test_torch_slice.py``;
the flagship there is narrowed, so it is held here at full width.

Bounds: the raw heads within ``HEAD_REL`` of the largest JAX head value
(the heads' scale, 5-20 here), the decoded rows within rtol ``IO_RTOL``,
atol ``IO_ATOL``. On the CPU the worst raw difference over the zoo was
2.3e-6 of the scale and the worst decoded one 6.1e-5 relative
(Double-YOLOv4-Add-SL): fp32 convs summed in another order, amplified by
the exp() of the YOLOv3 decode; the bounds leave 40x and 8x of room for
other thread counts. The heads must also be finite and move with the
input, so that the agreement is not that of two constant outputs.
"""

import jax
import numpy as np
import pytest
import torch

from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
from double_yolo_kaist_tpu.models import graph as JG
from double_yolo_kaist_torch.bench import seeded_variables
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.models.zoo import MODELS, cfg_path

HELD_ELSEWHERE = ("Double-YOLOv4-MNv3-Fshare-Global-CSE3",)
ZOO = [n for n in MODELS if n not in HELD_ELSEWHERE]
ZOO_V3 = [n for n in ZOO if "YOLOv3" in n]
ZOO_V4 = [n for n in ZOO if "YOLOv3" not in n]
HW = (64, 96)
HEAD_REL = 1e-4
IO_RTOL = 5e-4
IO_ATOL = 1e-3
MOVES = 1e-3


def _jax_folded(jir, jv, xv, xl):
    folded = JG.fold_batchnorm(jir, jv)
    if jir.dual_stream:
        return jax.jit(lambda f, a, b: JG.apply_folded(jir, f, a, b))(
            folded, xv, xl)
    return jax.jit(lambda f, a: JG.apply_folded(jir, f, a))(folded, xv)


def _port_folded(tir, tv, xv, xl):
    placed = TG.place_folded(tir, TG.fold_batchnorm(tir, tv), "cpu",
                             torch.float32)
    with torch.inference_mode():
        return TG.apply_folded(tir, placed, torch.from_numpy(xv),
                               torch.from_numpy(xl) if tir.dual_stream
                               else None)


@pytest.mark.parametrize("name", ZOO_V3)
def test_zoo_apply_folded_matches_jax(name):
    hold_against_jax(name)


def hold_against_jax(name):
    """``name``'s port forward against JAX's, within the module's bounds."""
    torch.set_num_threads(1)
    path = cfg_path(name)
    jir, tir = jax_compile_cfg(path), compile_cfg(path)
    tv = seeded_variables(tir, 0)
    jv = TW.to_jax_variables(tv)
    rng = np.random.default_rng(1)
    xv, xl, xv2 = (rng.random((1,) + HW + (3,), dtype=np.float32)
                   for _ in range(3))
    jio, jraw = _jax_folded(jir, jv, xv, xl)
    io, raw = _port_folded(tir, tv, xv, xl)
    jraw = [np.asarray(r) for r in jraw]
    assert len(raw) == len(jraw) == len(tir.yolo_indices)
    scale = max(float(np.abs(r).max()) for r in jraw)
    for mine, ref in zip(raw, jraw):
        assert tuple(mine.shape) == ref.shape
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                   atol=HEAD_REL * scale, err_msg=name)
    assert bool(torch.isfinite(io).all()), name
    np.testing.assert_allclose(io.numpy(), np.asarray(jio), rtol=IO_RTOL,
                               atol=IO_ATOL, err_msg=name)
    _, raw2 = _port_folded(tir, tv, xv2, xl)
    moved = max(float((a - b).abs().max()) for a, b in zip(raw, raw2))
    assert moved > MOVES, name
