"""Several optimizer steps a call (the port's ``make_multi_step``,
``make_fused_multi_step`` and ``Trainer(steps_per_dispatch=K)``) against
the JAX package and against the port's own single steps, on the CPU.

  * ``make_multi_step``, K = 3, ``tests/fixtures/tiny_dyolov3.cfg``, fp32,
    SGD and Adam, ``accumulate=2``, EMA and layers 0-2 frozen, against
    JAX's ``make_multi_step`` (one ``lax.scan``): the stacked metrics
    within 1e-4 relative, and the whole state (params, BN state, EMA,
    optimizer state under JAX's checkpoint keys) within 1e-4 of each
    leaf's largest magnitude plus 1e-7, the bounds of
    ``tests/test_torch_train_step.py::test_steps_match_jax`` (the same
    fp32 math summed in other orders).
  * The port's multi-step equals its own K single steps exactly; the
    optimizer alone (device counts, a learning-rate table, masked
    accumulation: the state a captured step updates in place) matches
    JAX's optax chain with ``accumulate`` 1-3; the schedule's table is the
    schedule, bit for bit.
  * ``make_fused_multi_step``: the ``images_in`` variant equals the pool
    variant exactly (the same rows, the same augment generators).
  * ``Trainer(steps_per_dispatch=2)``: one epoch of 8 pairs, fused (the
    resident pool) and grouped (streaming), with and without multi-scale,
    against the JAX trainer's epoch. The two packages draw the augment's
    randoms from different generators, so both run one deterministic
    augment (a crop of each batch image, :func:`crop_augment`); what is
    held is the epoch's plan (shuffle, partners, the bucket drawn once a
    group), the grouping into calls, the steps and the schedule. Last
    losses within 1e-4 relative, params within 1e-4 of each leaf's
    largest magnitude plus 1e-7; the port's fused and grouped epochs
    equal each other exactly.
  * ``cuda`` cases (they skip here): captured K steps against K eager
    steps on the card, bit for bit, in fp32 under deterministic algorithms
    (SGD, Adam, ``accumulate=2``), and dropout drawing new masks each
    replay.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.data import pipeline as TPL
from double_yolo_kaist_torch.data.dataset import KaistDataset
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.train import optim as TO
from double_yolo_kaist_torch.train import step as TS
from double_yolo_kaist_torch.train import trainer as TT
from double_yolo_kaist_torch.utils import tree as TR
from double_yolo_kaist_torch.utils.checkpoint import _flatten
from double_yolo_kaist_torch.utils.general import deterministic

try:        # the card's machine has no JAX: only the cuda cases run there
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
    from double_yolo_kaist_tpu.data import pipeline as JPL
    from double_yolo_kaist_tpu.data.dataset import KaistDataset as JDataset
    from double_yolo_kaist_tpu.models import graph as JG
    from double_yolo_kaist_tpu.train import optim as JO
    from double_yolo_kaist_tpu.train import step as JS
    from double_yolo_kaist_tpu.train.trainer import Trainer as JaxTrainer
    from double_yolo_kaist_tpu.utils import checkpoint as JCK
    from tests.test_torch_train_step import (HYP, batch_np, close_trees,
                                             jax_flat, port_flat)
except ModuleNotFoundError:
    jax = None
    HYP = {"box": 3.54, "obj": 64.3, "cls": 37.4, "cls_pw": 1.0,
           "obj_pw": 1.0, "iou_t": 0.2, "fl_gamma": 0.0, "ciou": 1.0,
           "momentum": 0.937, "weight_decay": 0.05, "lr0": 0.01, "lrf": 0.1}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
MNV3 = os.path.join(REPO, "configs",
                    "kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg")
NPZ = os.path.join(REPO, "tests", "fixtures", "fullparity",
                   "mnv3_selftrained.fp16.npz")
K = 3

FULL_HYP = {"lr0": 1e-3, "lrf": 0.1, "box": 1.0, "obj": 1.0, "cls": 1.0,
            "cls_pw": 1.0, "obj_pw": 1.0, "iou_t": 0.2, "fl_gamma": 0.0,
            "ciou": 1.0, "momentum": 0.9, "weight_decay": 0.0005,
            "hsv_h": 0.0138, "hsv_s": 0.678, "hsv_v": 0.36,
            "degrees": 0.0, "translate": 0.0, "scale": 0.0, "shear": 0.0}


def stacked_np(seed, k=K):
    bs = [batch_np(seed + i) for i in range(k)]
    return {name: np.stack([b[name] for b in bs]) for name in bs[0]}


def _port_setup(tir, tv, sgd, accumulate=2, device="cpu"):
    tsch = TO.cosine_epoch_schedule(HYP["lr0"], HYP["lrf"], 3, 2)
    ttx = TO.make_optimizer(HYP, tsch, sgd=sgd, accumulate=accumulate,
                            freeze_mask=TO.freeze_mask_by_layer(
                                tv["params"], 2))
    ts = TS.create_train_state(tir, 0, ttx, ema=True, variables=tv,
                               device=device)
    return ttx, ts


def _tiny():
    jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    jv = jax.tree.map(np.asarray, JG.init(jir, jax.random.PRNGKey(0)))
    return jir, tir, jv, TW.from_jax_variables(tir, jv)


@pytest.mark.parametrize("sgd", [True, False], ids=["sgd", "adam"])
def test_multi_step_matches_jax(sgd):
    jir, tir, jv, tv = _tiny()
    jsch = JO.cosine_epoch_schedule(HYP["lr0"], HYP["lrf"], 3, 2)
    jtx = JO.make_optimizer(HYP, jsch, sgd=sgd, accumulate=2,
                            freeze_mask=JO.freeze_mask_by_layer(
                                jv["params"], 2))
    js = JS.create_train_state(jir, None, jtx, ema=True,
                               variables=jax.tree.map(jnp.asarray, jv))
    ttx, ts = _port_setup(tir, tv, sgd)
    b = stacked_np(10)
    jmulti = JS.make_multi_step(jir, HYP, jtx, compute_dtype=jnp.float32)
    tmulti = TS.make_multi_step(tir, HYP, ttx, compute_dtype=torch.float32)
    js, jm = jmulti(js, {k: jnp.asarray(v) for k, v in b.items()},
                    jax.random.PRNGKey(3))
    ts, tm = tmulti(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    for name in TS.METRICS:
        assert tuple(tm[name].shape) == (K,)
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-4, err_msg=name)
    assert ts.step == int(js.step) == K
    close_trees(port_flat(ts), jax_flat(js), 1e-4, "after K steps")
    last = TS.metrics_to_host(tm)
    assert last["loss"] == float(tm["loss"][-1])


@pytest.mark.parametrize("sgd", [True, False], ids=["sgd", "adam"])
def test_multi_step_equals_single_steps(sgd):
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    tv = TG.init(tir, 0)
    b = {k: torch.from_numpy(v) for k, v in stacked_np(20).items()}
    ttx, s1 = _port_setup(tir, tv, sgd)
    step = TS.make_train_step(tir, HYP, ttx, compute_dtype=torch.float32)
    seq = []
    for i in range(K):
        s1, m = step(s1, {k: v[i] for k, v in b.items()})
        seq.append(m)
    ttx2, s2 = _port_setup(tir, tv, sgd)
    multi = TS.make_multi_step(tir, HYP, ttx2, compute_dtype=torch.float32)
    s2, m2 = multi(s2, b)
    for name in TS.METRICS:
        assert torch.equal(m2[name], torch.stack([m[name] for m in seq]))
    assert s2.step == s1.step == K
    for a, c in zip(TS._state_leaves(s1), TS._state_leaves(s2)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("sgd,accumulate", [
    (True, 1), (True, 2), (True, 3), (False, 1), (False, 2), (False, 3)])
def test_optimizer_matches_jax_chain(sgd, accumulate):
    """The port's optimizer alone (device counts, the learning-rate table,
    bias corrections as tensors, masked accumulation) against JAX's optax
    chain, 6 calls on seeded gradients with layer 0 frozen: each call's
    updates and the whole state within 1e-5 of each leaf's largest
    magnitude plus 1e-8 (the same fp32 math; optax sums some terms in
    another order)."""
    rng = np.random.default_rng(5)
    params = {f"l{i}": {"a": rng.standard_normal((3, 4)).astype(np.float32),
                        "b": rng.standard_normal(5).astype(np.float32)}
              for i in range(3)}
    tparams = {k: {n: torch.from_numpy(v.copy()) for n, v in d.items()}
               for k, d in params.items()}
    jsch = JO.cosine_epoch_schedule(HYP["lr0"], HYP["lrf"], 3, 2)
    tsch = TO.cosine_epoch_schedule(HYP["lr0"], HYP["lrf"], 3, 2)
    jtx = JO.make_optimizer(HYP, jsch, sgd=sgd, accumulate=accumulate,
                            freeze_mask=JO.freeze_mask_by_layer(params, 0))
    ttx = TO.make_optimizer(HYP, tsch, sgd=sgd, accumulate=accumulate,
                            freeze_mask=TO.freeze_mask_by_layer(tparams, 0))
    jp = jax.tree.map(jnp.asarray, params)
    js, ts = jtx.init(jp), ttx.init(tparams)
    leaves = TR.leaves(tparams)
    for i in range(6):
        g = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = ttx.update(TR.leaves(jax.tree.map(torch.from_numpy, g)),
                            ts, leaves)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        torch._foreach_add_(leaves, tu)
        close_trees(_flatten(TR.unflatten(tparams, [u.numpy() for u in tu])),
                    JCK._flatten(jax.tree.map(np.asarray, ju)), 1e-5,
                    f"updates of call {i}")
        close_trees(_flatten(TW.to_jax_tree(ts)),
                    JCK._flatten(jax.tree.map(np.asarray, js)), 1e-5,
                    f"state after call {i}")
    if accumulate > 1:
        assert int(ts[1]) == 6 // accumulate


@pytest.mark.parametrize("warmup", [True, False])
def test_schedule_table_is_the_schedule(warmup):
    for spe, epochs in ((7, 5), (3, 40), (1000, 3), (1, 9)):
        sch = TO.cosine_epoch_schedule(0.01, 0.1, epochs, spe, warmup=warmup)
        n = spe * epochs + 7
        want = torch.stack([sch(i) for i in range(n)])
        assert torch.equal(sch.table(n), want)
        assert torch.equal(TO.lr_table(lambda i: sch(i), n), want)


def _pools(n=8, src_hw=(128, 160), seed=9):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (n, *src_hw, 3), np.uint8)),
            torch.from_numpy(rng.integers(0, 256, (n, *src_hw, 3), np.uint8)))


def test_fused_images_in_equals_pool():
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    tv = TG.init(tir, 2)
    src_hw, k, bsz = (128, 160), 2, 2
    pool_v, pool_l = _pools()
    rng = np.random.default_rng(4)
    load = torch.from_numpy(rng.integers(0, 8, (k, 4 * bsz))).long()
    t = np.zeros((k, 4 * bsz, 4, 5), np.float32)
    t[..., 0, 1:] = (0.5, 0.5, 0.25, 0.4)
    m = np.zeros((k, 4 * bsz, 4), bool)
    m[..., 0] = True
    common = {"b0": [0, 2], "targets": torch.from_numpy(t),
              "tmask": torch.from_numpy(m)}
    out = []
    for images_in in (False, True):
        tx = TO.make_optimizer(FULL_HYP, lambda s: 1e-3, sgd=True)
        st = TS.create_train_state(tir, 0, tx, variables=tv, device="cpu")
        aug = TPL.make_train_augment_fn(src_hw, 64, FULL_HYP,
                                        from_pool=not images_in)
        fused = TS.make_fused_multi_step(tir, FULL_HYP, tx, aug,
                                         compute_dtype=torch.float32,
                                         images_in=images_in)
        if images_in:
            xs = {**common, "v_u8": pool_v[load], "l_u8": pool_l[load]}
            st, met = fused(st, xs, 7)
        else:
            st, met = fused(st, pool_v, pool_l, {**common, "load": load}, 7)
        out.append((st, met))
    (s1, m1), (s2, m2) = out
    assert torch.equal(m1["loss"], m2["loss"]) and s1.step == s2.step == k
    for a, c in zip(TS._state_leaves(s1), TS._state_leaves(s2)):
        assert torch.equal(a, c)


# ------------------------------------------------------- the trainer's epoch

def _crop(v, l, labels, lmask, s):
    """The deterministic augment of the trainer comparison: the top-left
    s x s of each batch image (the first B of the 4B rows), its labels."""
    nb = v.shape[0] // 4
    return {"v": v[:nb, :s, :s] / 255.0, "l": l[:nb, :s, :s] / 255.0,
            "targets": labels[:nb], "tmask": lmask[:nb]}


def crop_augment(package):
    """A ``make_train_augment_fn`` stand-in for ``package`` ("torch" or
    "jax") with :func:`_crop` in place of the random mosaic."""
    def make(src_hw, img_size, hyp, snowflake=False, clahe=False,
             epoch_partners=True, from_pool=False, jit=True, **kw):
        def fn(_key, v, l, *rest):
            if from_pool:
                idx, labels, lmask = rest
                if package == "jax":
                    v, l = jnp.take(v, idx, axis=0), jnp.take(l, idx, axis=0)
                else:
                    v, l = v.index_select(0, idx), l.index_select(0, idx)
            else:
                labels, lmask = rest
            if package == "jax":
                v, l = v.astype(jnp.float32), l.astype(jnp.float32)
            else:
                v, l = v.float(), l.float()
            return _crop(v, l, labels, lmask, img_size)
        return fn
    return make


def _split(tmp_path, seed=3):
    img_dir = tmp_path / "images" / "s"
    lab_dir = tmp_path / "labels" / "s"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    logical = []
    for i in range(8):
        for mod in ("visible", "lwir"):
            cv2.imwrite(str(img_dir / f"I{i}_{mod}.jpg"),
                        rng.integers(0, 256, (128, 160, 3), dtype=np.uint8))
        x, y = rng.uniform(0.2, 0.5, 2)
        (lab_dir / f"I{i}.txt").write_text(f"0 {x:.4f} {y:.4f} 0.2 0.3\n")
        logical.append(str(img_dir / f"I{i}.jpg"))
    split = tmp_path / "t.txt"
    split.write_text("\n".join(logical) + "\n")
    return str(split)


@pytest.mark.parametrize("multi_scale", [False, True],
                         ids=["one-size", "multi-scale"])
def test_trainer_epoch_matches_jax(tmp_path, monkeypatch, multi_scale):
    monkeypatch.setattr(JPL, "make_train_augment_fn", crop_augment("jax"))
    monkeypatch.setattr(TPL, "make_train_augment_fn", crop_augment("torch"))
    monkeypatch.setattr(TT, "make_train_augment_fn", crop_augment("torch"))
    split = _split(tmp_path)
    jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    jv = jax.tree.map(np.asarray, JG.init(jir, jax.random.PRNGKey(0)))
    kw = dict(epochs=1, batch_size=2, img_size=64, sgd=False, ema=True,
              multi_scale=multi_scale, steps_per_dispatch=2)

    ds = JDataset(split, img_size=64, batch_size=2, augment=True,
                  hyp=FULL_HYP)
    jt = JaxTrainer(jir, FULL_HYP, train_dataset=ds, val_dataset=ds,
                    compute_dtype=jnp.float32, data_parallel=False,
                    out_dir=str(tmp_path / "jax"), device_cache=True, **kw)
    jlast, _ = jt.train_one_epoch(0, print_freq=1000)
    assert jt._fused_steps and int(jt.state.step) == 4

    ports = {}
    for cache in (True, False):
        ds = KaistDataset(split, img_size=64, batch_size=2, augment=True,
                          hyp=FULL_HYP)
        tt = TT.Trainer(tir, FULL_HYP, train_dataset=ds, val_dataset=ds,
                        compute_dtype=torch.float32, device="cpu",
                        variables=TW.from_jax_variables(tir, jv),
                        out_dir=str(tmp_path / f"port{cache}"),
                        device_cache=cache, **kw)
        last, _ = tt.train_one_epoch(0, print_freq=1000)
        assert bool(tt._fused_steps) == cache and tt.state.step == 4
        ports[cache] = (tt, last)
    (tf, lf), (tu, lu) = ports[True], ports[False]
    assert lf == lu
    for a, c in zip(TS._state_leaves(tf.state), TS._state_leaves(tu.state)):
        assert torch.equal(a, c)
    if multi_scale:
        assert {s for _, s in tf._fused_steps} == \
            {s for _, s in jt._fused_steps}
    np.testing.assert_allclose(lf["loss"], jlast["loss"], rtol=1e-4)
    close_trees(port_flat(tf.state), jax_flat(jt.state), 1e-4, "epoch")


# ------------------------------------------------------------------- card

@pytest.fixture
def deterministic_mode():
    with deterministic():
        yield


@pytest.mark.cuda
@pytest.mark.parametrize("sgd,accumulate", [(True, 1), (False, 1),
                                            (False, 2)],
                         ids=["sgd", "adam", "adam-acc2"])
def test_captured_steps_equal_eager_on_card(sgd, accumulate,
                                            deterministic_mode):
    """K = 3 steps of MNv3 (fixture weights, fp32, bs 2, 128x160) replayed
    from one captured graph against 3 eager steps on the card, from the
    same state and batches: params, BN state, optimizer state, EMA and
    metrics bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ir = compile_cfg(MNV3)
    variables = TW.load_state_dict_npz(ir, NPZ)
    raw = [batch_np(40 + i, hw=(128, 160)) for i in range(K)]
    b = {k: torch.from_numpy(np.stack([r[k] for r in raw])).cuda()
         for k in raw[0]}
    runs = []
    for captured in (False, True):
        tx, st = _port_setup(ir, variables, sgd, accumulate, device="cuda")
        multi = TS.make_multi_step(ir, HYP, tx, compute_dtype=torch.float32)
        if captured:
            st, m = multi(st, b)
            assert multi.captured.replays == K
        else:
            st, m = TS._eager_steps(multi.step_fn, st,
                                    lambda i: {k: v[i] for k, v in b.items()},
                                    K)
        runs.append((st, {k: v.cpu() for k, v in m.items()}))
    (se, me), (sc, mc) = runs
    for name in TS.METRICS:
        assert torch.equal(me[name], mc[name]), name
    for a, c in zip(TS._state_leaves(se), TS._state_leaves(sc)):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_captured_dropout_draws_new_masks():
    """A dropout node draws from the registered CUDA generator: two
    replays of one captured step give other masks, each keeping about
    1 - p of the elements."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    draws = TG._DropoutDraws(gen)

    class Node:
        index = 3

    x = torch.ones((4, 64, 32, 32), device="cuda")
    static = torch.empty_like(x)

    def body():
        d = TG._DropoutDraws(gen)
        static.copy_(torch.nn.functional.relu(
            TG.L.dropout(x, 0.25, None, u=d.uniforms(Node, x))))

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        body()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    with torch.cuda.graph(g):
        body()
    g.replay()
    first = static.clone()
    g.replay()
    assert not torch.equal(first, static)
    for out in (first, static):
        kept = float((out != 0).float().mean())
        assert abs(kept - 0.75) < 0.01
    assert draws.uniforms(Node, x) is draws.uniforms(Node, x)
