"""The training forward of the port against the JAX package on the CPU:
``graph.init`` (structure, bounds, smart bias), ``count_params``, the
unfolded ``graph.apply`` in train mode (raw heads and the new BN state),
``remat_segments`` and ``evaluate_dataset(folded=False)``.

Tolerances, and why:
  * MNv3 (trained fixture weights) at 64x96, fp32 on both sides: raw heads
    and BN state within 1e-4 relative (by norm);
  * the narrowed flagship of ``tests/test_torch_slice.py``: train-mode BN
    over a batch of 2 at 2x3 cells amplifies rounding, so that two fp32
    summation orders (JAX's own jitted and eager forwards too) move its raw
    heads beyond 1e-4; in float64 activations on both sides its raw heads
    and BN state agree within 1e-4, held in
    tests/test_torch_train_step.py beside its gradients, from the same JAX
    call;
  * ``remat_segments=3`` against 0 in the port: the same ops in the same
    order, so heads, BN state and gradients are equal (rtol 1e-6);
  * ``evaluate_dataset(folded=False)`` against ``folded=True``: the BN fold
    rounds otherwise, so detections match one to one with boxes within
    1e-2 px and scores within 1e-4, and AP within 1e-4;
  * the ``cuda`` cases (the card's run; they skip here): MNv3's train-mode
    forward and its gradients on the card against the CPU, float64
    activations, with and without ``remat_segments``: heads and BN state
    within 1e-9, gradients within 1e-6 of each leaf's norm (they are fp32)
    plus 1e-9 of the largest leaf's (leaves whose gradient is ~0 are noise);
    and the BN fold of variables on the card, equal bit for bit to the
    CPU's.
"""

import math
import os

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.data.dataset import KaistDataset
from double_yolo_kaist_torch.eval import evaluator as TE
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.utils import tree as TR
from double_yolo_kaist_torch.utils.checkpoint import _flatten

try:        # the card's machine has no JAX: only the cuda cases run there
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
    from double_yolo_kaist_tpu.models import graph as JG
    from double_yolo_kaist_tpu.models import import_weights as JW
    from tests.test_torch_dataset import (random_frames, random_labels,
                                          write_split)
    from tests.test_torch_slice import write_narrow_flagship
except ModuleNotFoundError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
MNV3 = os.path.join(REPO, "configs",
                    "kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg")
NPZ = os.path.join(REPO, "tests", "fixtures", "fullparity",
                   "mnv3_selftrained.fp16.npz")
FLAGSHIP = os.path.join(REPO, "configs",
                        "kaist_dyolov4_fshare_global_concat_se3.cfg")
HW = (64, 96)
INCEPTION = os.path.join(REPO, "configs", "kaist_dyolov3_concat_inc.cfg")


def nrel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def inputs(seed=0, bs=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.random((bs,) + HW + (3,)).astype(dtype),
            rng.random((bs,) + HW + (3,)).astype(dtype))


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    return write_narrow_flagship(tmp_path_factory.mktemp("narrow"))


# ---------------------------------------------------------------- graph.init

@pytest.mark.parametrize("which", ["tiny", "mnv3", "flagship", "inception"])
def test_init_structure_and_smart_bias(which, narrow):
    """The port's graph.init has JAX's tree (every key and shape, kernels
    OIHW), kaiming-uniform bounds, BN at identity, weighted shortcuts at
    0, and the smart bias on each predictor: obj -4.5 and cls
    log(0.6 / (nc - 0.99)) on top of U(+-sqrt(1 / fan_in))."""
    cfg, kw = {"tiny": (TINY, {"yolo_strides": [8, 4]}),
               "mnv3": (MNV3, {}), "flagship": (narrow, {}),
               "inception": (INCEPTION, {})}[which]
    jir, tir = jax_compile_cfg(cfg, **kw), compile_cfg(cfg, **kw)
    shapes = jax.eval_shape(lambda k: JG.init(jir, k), jax.random.PRNGKey(0))
    want = _flatten(TW.from_jax_variables(
        tir, jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)))
    v = TG.init(tir, 0)
    got = _flatten(v)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
    heads = {n.index - 1: n for n in tir.head_nodes()}
    for node in tir.nodes:
        key = f"l{node.index}"
        if node.kind == "conv":
            fan_in = node.in_ch // node.groups * node.kernel ** 2
            bound = math.sqrt(1 / fan_in)
            w = got[f"params/{key}/w"]
            assert np.abs(w).max() <= bound and np.abs(w).max() > 0.5 * bound
            if node.bn:
                np.testing.assert_array_equal(got[f"params/{key}/bn/scale"], 1)
                np.testing.assert_array_equal(got[f"params/{key}/bn/bias"], 0)
                np.testing.assert_array_equal(got[f"state/{key}/mean"], 0)
                np.testing.assert_array_equal(got[f"state/{key}/var"], 1)
            elif node.index in heads:
                yolo = heads[node.index]
                na, nc = len(yolo.anchors), yolo.nc
                b = got[f"params/{key}/b"].reshape(na, nc + 5)
                prior = np.zeros(nc + 5)
                prior[4] = -4.5
                prior[5:] = math.log(0.6 / (nc - 0.99))
                assert np.abs(b - prior).max() <= bound + 1e-6
        elif node.kind == "shortcut" and node.weighted:
            np.testing.assert_array_equal(got[f"params/{key}/w"], 0)
    # seeded: the same seed gives the same weights, another seed others
    again = _flatten(TG.init(tir, 0))
    other = _flatten(TG.init(tir, 1))
    k = next(k for k in got if k.endswith("/w") and got[k].ndim == 4)
    np.testing.assert_array_equal(got[k], again[k])
    assert not np.array_equal(got[k], other[k])


@pytest.mark.parametrize("cfg", [TINY, MNV3, FLAGSHIP, INCEPTION],
                         ids=["tiny", "mnv3", "flagship", "inception"])
def test_count_params_matches_jax(cfg):
    kw = {"yolo_strides": [8, 4]} if cfg == TINY else {}
    jir, tir = jax_compile_cfg(cfg, **kw), compile_cfg(cfg, **kw)
    shapes = jax.eval_shape(lambda k: JG.init(jir, k), jax.random.PRNGKey(0))
    want = JG.count_params(shapes)
    assert TG.count_params(TG.init(tir, 0)) == want


# -------------------------------------------------------- apply, train mode

def _jax_state(tir, ns):
    return _flatten(TW.from_jax_variables(
        tir, {"params": {}, "state": jax.tree.map(np.asarray, ns)})["state"])


def test_apply_train_matches_jax_mnv3():
    jir, tir = jax_compile_cfg(MNV3), compile_cfg(MNV3)
    with np.load(NPZ) as z:
        jv = jax.tree.map(np.asarray, JW.from_torch_state_dict(
            jir, {k: z[k] for k in z.files}))
    tv = TW.from_jax_variables(tir, jv)
    x, x2 = inputs()
    jr, jns = jax.jit(lambda v, a, b: JG.apply(jir, v, a, b, train=True))(
        jv, jnp.asarray(x), jnp.asarray(x2))
    tr, tns = TG.apply(tir, tv, torch.from_numpy(x), torch.from_numpy(x2),
                       train=True)
    assert len(tr) == len(jr) == 3
    for got, want in zip(tr, jr):
        assert tuple(got.shape) == want.shape        # (B, na, ny, nx, no)
        assert nrel(got.numpy(), want) <= 1e-4
    js, ts = _jax_state(tir, jns), _flatten(tns)
    assert sorted(ts) == sorted(js)
    for k in js:
        assert nrel(ts[k], js[k]) <= 1e-4, k


def _grads(tir, tv, x, x2, remat):
    params = TR.map_leaves(lambda p: p.clone().requires_grad_(True),
                           tv["params"])
    heads, state = TG.apply(tir, {"params": params, "state": tv["state"]},
                            torch.from_numpy(x), torch.from_numpy(x2),
                            train=True, remat_segments=remat)
    rng = np.random.default_rng(5)
    loss = sum((h * torch.from_numpy(rng.standard_normal(tuple(h.shape))
                                     .astype(np.float32))).sum()
               for h in heads)
    grads = torch.autograd.grad(loss, TR.leaves(params))
    return heads, state, grads


@pytest.mark.parametrize("which", ["tiny", "mnv3"])
def test_remat_segments_equal(which):
    """Three checkpointed segments give the heads, the BN state (updated
    once, not again by the recomputation) and the gradients of none."""
    if which == "tiny":
        tir = compile_cfg(TINY, yolo_strides=[8, 4])
        tv = TG.init(tir, 0)
    else:
        tir = compile_cfg(MNV3)
        tv = TW.load_state_dict_npz(tir, NPZ)
    x, x2 = inputs(1)
    h0, s0, g0 = _grads(tir, tv, x, x2, 0)
    h3, s3, g3 = _grads(tir, tv, x, x2, 3)
    for a, b in zip(h3, h0):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
    f0, f3 = _flatten(s0), _flatten(s3)
    assert sorted(f0) == sorted(f3)
    for k in f0:
        np.testing.assert_allclose(f3[k], f0[k], rtol=1e-6, atol=1e-7)
    for a, b in zip(g3, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_dropout_statistics_and_identity():
    from double_yolo_kaist_torch.models import layers as TL
    x = torch.ones(4, 8, 32, 32)
    y = TL.dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.01
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.7, rtol=1e-6)
    assert torch.equal(TL.dropout(x, 0.0, torch.Generator()), x)


# ------------------------------------------------------- unfolded evaluation

def test_evaluate_unfolded_matches_folded(tmp_path):
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    tv = TG.init(tir, 3)
    for p in TR.leaves(tv["params"]):   # heads that detect something
        p.mul_(2.0)
    rng = np.random.default_rng(2)
    path = write_split(tmp_path, random_frames(rng, 6, HW),
                       random_labels(rng, 6))
    ds = KaistDataset(path, 96, 4, rect=True)
    kw = dict(batch_size=4, compute_dtype=torch.float32, device="cpu",
              conf_thres=0.001)
    a = TE.evaluate_dataset(tir, tv, ds, folded=True, **kw)
    b = TE.evaluate_dataset(tir, tv, ds, folded=False, **kw)
    assert sum(len(s) for _, s in a["predictions"].values()) > 0
    for i in a["predictions"]:
        (ba, sa), (bb, sb) = a["predictions"][i], b["predictions"][i]
        assert len(sa) == len(sb)
        np.testing.assert_allclose(bb, ba, atol=1e-2)
        np.testing.assert_allclose(sb, sa, atol=1e-4)
    assert abs(a["ap"] - b["ap"]) <= 1e-4


@pytest.mark.cuda
def test_apply_train_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tir = compile_cfg(MNV3)
    tv = TW.load_state_dict_npz(tir, NPZ)
    x, x2 = inputs(dtype=np.float64)
    out = {}
    for dev, remat in (("cpu", 0), ("cuda", 0), ("cuda", 3)):
        placed = TG.place_variables(tv, dev)
        params = TR.map_leaves(
            lambda p: p.detach().clone().requires_grad_(True),
            placed["params"])
        heads, state = TG.apply(tir, {"params": params,
                                      "state": placed["state"]},
                                torch.from_numpy(x).to(dev),
                                torch.from_numpy(x2).to(dev), train=True,
                                compute_dtype=torch.float64,
                                remat_segments=remat)
        loss = sum((h * h).sum() for h in heads)
        grads = torch.autograd.grad(loss, TR.leaves(params))
        out[(dev, remat)] = ([h.detach().cpu() for h in heads],
                             [s.cpu() for s in TR.leaves(state)],
                             [g.cpu().double() for g in grads])
    want = out[("cpu", 0)]
    scale = max(float(g.norm()) for g in want[2])
    for key in (("cuda", 0), ("cuda", 3)):
        got = out[key]
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            assert float((a - b).norm()) <= 1e-9 * float(b.norm()) + 1e-15
        for a, b in zip(got[2], want[2]):
            assert float((a - b).norm()) <= (1e-6 * float(b.norm())
                                             + 1e-9 * scale)


@pytest.mark.cuda
def test_fold_card_equals_cpu():
    """The BN fold gives the same bits from variables on the card as on
    the CPU (the card's sqrt rounds otherwise; the scale is taken on the
    host), so that a trainer's evaluation equals ``evaluate`` on its
    checkpoint."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tir = compile_cfg(MNV3)
    tv = TW.load_state_dict_npz(tir, NPZ)
    cpu = _flatten(TG.fold_batchnorm(tir, tv))
    card = _flatten(TG.fold_batchnorm(tir, TG.place_variables(tv, "cuda")))
    for k in cpu:
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)
