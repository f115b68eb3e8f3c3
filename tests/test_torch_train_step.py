"""The port's train step, optimizer, schedule and checkpoints against the
JAX package on the CPU.

  * The narrowed flagship of ``tests/test_torch_slice.py``: the loss, its
    gradients leaf by leaf, and the train-mode raw heads and BN state.
    Train-mode BN over a batch of 2 at 2x3 cells makes its fp32 gradients
    depend on the summation order far beyond float rounding (two fp32
    orders of either package disagree), so both sides run float64
    activations (JAX under ``jax.enable_x64``). JAX's gradient is compiled
    with XLA's algebraic simplifier off: with it, XLA's jitted backward of
    this graph on the CPU disagrees with JAX's own eager gradient and with
    finite differences of its forward (below l268), while the port agrees
    with both. Bounds: gradients 1e-3 of each leaf's norm, heads and BN
    state 1e-4.
  * ``tests/fixtures/tiny_dyolov3.cfg``, fp32: 3 steps of SGD and of Adam,
    each with EMA, ``accumulate=2`` and a freeze mask, through each
    package's ``make_train_step``; after every step the params, BN state,
    EMA and optimizer state (under the keys of JAX's checkpoint layout)
    agree within 1e-4 of each leaf's largest magnitude plus 1e-7 (the
    same fp32 math, summed in other orders; the 1e-7 covers leaves still
    near 0, as BN biases two steps from their zero init). Frozen leaves
    move by the weight decay, in both packages.
  * ``cosine_epoch_schedule``: equal to 1e-6 relative over 3 epochs.
  * ``make_eval_step``, unfolded and folded, on uint8 frames: decoded rows
    within 1e-4 relative + 1e-3 (pixels), as tests/test_torch_slice.py
    holds decoded heads.
  * ``cuda`` cases (the card's run; they skip here): one SGD and one Adam
    step of MNv3 (fixture weights) on the card against the CPU in float64
    activations: losses within 1e-8, the grad norm within 1e-6, parameter
    deltas within 1e-4 and BN state within 1e-8 of each leaf's norm.
  * Checkpoints: a JAX trainer's checkpoint resumed by the port's trainer,
    and the reverse, give the same next step: every leaf within 1e-3 of
    its largest magnitude plus 1e-7 (the layer-0 BN bias sums 8192 terms
    a channel, whose fp32 order moves its gradient by ~2e-4).
"""

import os

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.train import loss as TLS
from double_yolo_kaist_torch.train import optim as TO
from double_yolo_kaist_torch.train import step as TS
from double_yolo_kaist_torch.train.trainer import Trainer
from double_yolo_kaist_torch.utils import tree as TR
from double_yolo_kaist_torch.utils.checkpoint import _flatten

try:        # the card's machine has no JAX: only the cuda cases run there
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
    from double_yolo_kaist_tpu.models import graph as JG
    from double_yolo_kaist_tpu.train import loss as JLS
    from double_yolo_kaist_tpu.train import optim as JO
    from double_yolo_kaist_tpu.train import step as JS
    from double_yolo_kaist_tpu.train.trainer import Trainer as JaxTrainer
    from double_yolo_kaist_tpu.utils import checkpoint as JCK
    from tests.test_torch_slice import flagship_variables, write_narrow_flagship
except ModuleNotFoundError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
MNV3 = os.path.join(REPO, "configs",
                    "kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg")
NPZ = os.path.join(REPO, "tests", "fixtures", "fullparity",
                   "mnv3_selftrained.fp16.npz")

HYP = {"box": 3.54, "obj": 64.3, "cls": 37.4, "cls_pw": 1.0, "obj_pw": 1.0,
       "iou_t": 0.2, "fl_gamma": 0.0, "ciou": 1.0, "momentum": 0.937,
       "weight_decay": 0.05, "lr0": 0.01, "lrf": 0.1}


def batch_np(seed, bs=2, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    t = np.zeros((bs, 4, 5), np.float32)
    m = np.zeros((bs, 4), bool)
    for b in range(bs):
        n = int(rng.integers(1, 5))
        t[b, :n, 1:3] = rng.uniform(0.2, 0.8, (n, 2))
        t[b, :n, 3:5] = rng.uniform(0.1, 0.5, (n, 2))
        m[b, :n] = True
    return {"v": rng.integers(0, 256, (bs,) + hw + (3,), dtype=np.uint8),
            "l": rng.integers(0, 256, (bs,) + hw + (3,), dtype=np.uint8),
            "targets": t, "tmask": m}


def close_trees(got: dict, want: dict, rel=1e-4, what=""):
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    for k in want:
        a = np.asarray(got[k], np.float64)
        b = np.asarray(want[k], np.float64)
        assert a.shape == b.shape, (what, k)
        tol = rel * np.abs(b).max() + 1e-7
        assert np.abs(a - b).max() <= tol, (what, k, np.abs(a - b).max(), tol)


def jax_flat(state) -> dict:
    tree = {"params": state.params, "bn_state": state.bn_state,
            "opt_state": state.opt_state}
    if state.ema is not None:
        tree["ema"] = state.ema
    return JCK._flatten(jax.tree.map(np.asarray, tree))


def port_flat(state) -> dict:
    jx = TW.to_jax_variables({"params": state.params,
                              "state": state.bn_state})
    tree = {"params": jx["params"], "bn_state": jx["state"],
            "opt_state": TW.to_jax_tree(state.opt_state)}
    if state.ema is not None:
        tree["ema"] = TW.to_jax_tree(state.ema)
    return _flatten(tree)


# ------------------------------------------------------ gradients, flagship

def test_flagship_value_and_grad_matches_jax(tmp_path):
    cfg = write_narrow_flagship(tmp_path)
    jir, tir = jax_compile_cfg(cfg), compile_cfg(cfg)
    jv = flagship_variables(jir)
    tv = TW.from_jax_variables(tir, jv)
    b = batch_np(0, hw=(64, 96))
    x = b["v"].astype(np.float64) / 255.0
    x2 = b["l"].astype(np.float64) / 255.0
    with jax.enable_x64():
        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jv)

        def loss_fn(params):
            raws, ns = JG.apply(jir, {"params": params, "state": f64["state"]},
                                jnp.asarray(x), jnp.asarray(x2), train=True)
            ld = JLS.compute_loss(raws, jnp.asarray(b["targets"]),
                                  jnp.asarray(b["tmask"]),
                                  JLS.head_specs(jir), HYP)
            return JLS.total_loss(ld), (ns, raws)
        # compiled without XLA's algebraic simplifier: see the docstring
        (jl, (jns, jraws)), jg = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True)).lower(f64["params"]).compile(
            compiler_options={"xla_disable_hlo_passes": "algsimp"})(
            f64["params"])
        jl = float(jl)
        jg = jax.tree.map(np.asarray, jg)
        jns = jax.tree.map(np.asarray, jns)
        jraws = [np.asarray(r) for r in jraws]
    params = TR.map_leaves(lambda p: p.clone().requires_grad_(True),
                           tv["params"])
    raws, tns = TG.apply(tir, {"params": params, "state": tv["state"]},
                         torch.from_numpy(x), torch.from_numpy(x2),
                         train=True, compute_dtype=torch.float64)
    tl = TLS.total_loss(TLS.compute_loss(
        raws, torch.from_numpy(b["targets"]), torch.from_numpy(b["tmask"]),
        TLS.head_specs(tir), HYP))
    tg = torch.autograd.grad(tl, TR.leaves(params))
    assert abs(tl.item() - jl) <= 1e-9 * abs(jl)
    for got, want in zip(raws, jraws):       # the train-mode forward
        got = got.detach().numpy()
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    got = _flatten(TR.unflatten(params, tg))
    want = _flatten(TW.from_jax_variables(tir, {"params": jg,
                                                "state": {}})["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        n = np.linalg.norm(want[k])
        assert np.linalg.norm(got[k] - want[k]) <= 1e-3 * n + 1e-12, k
    ts = _flatten(tns)
    js = _flatten(TW.from_jax_variables(tir, {"params": {},
                                              "state": jns})["state"])
    for k in js:
        assert np.linalg.norm(ts[k] - js[k]) <= 1e-4 * np.linalg.norm(js[k])


# ------------------------------------------------- steps and the optimizer

@pytest.mark.parametrize("sgd", [True, False], ids=["sgd", "adam"])
def test_steps_match_jax(sgd):
    """3 steps with EMA, accumulation over 2 and layers 0-2 frozen."""
    jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    jv = jax.tree.map(np.asarray, JG.init(jir, jax.random.PRNGKey(0)))
    tv = TW.from_jax_variables(tir, jv)
    jsch = JO.cosine_epoch_schedule(HYP["lr0"], HYP["lrf"], 3, 2)
    tsch = TO.cosine_epoch_schedule(HYP["lr0"], HYP["lrf"], 3, 2)
    jtx = JO.make_optimizer(HYP, jsch, sgd=sgd, accumulate=2,
                            freeze_mask=JO.freeze_mask_by_layer(
                                jv["params"], 2))
    ttx = TO.make_optimizer(HYP, tsch, sgd=sgd, accumulate=2,
                            freeze_mask=TO.freeze_mask_by_layer(
                                tv["params"], 2))
    js = JS.create_train_state(jir, None, jtx, ema=True,
                               variables=jax.tree.map(jnp.asarray, jv))
    ts = TS.create_train_state(tir, 0, ttx, ema=True, variables=tv,
                               device="cpu")
    jstep = JS.make_train_step(jir, HYP, jtx, compute_dtype=jnp.float32,
                               donate=False)
    tstep = TS.make_train_step(tir, HYP, ttx, compute_dtype=torch.float32)
    frozen0 = tv["params"]["l0"]["w"].clone()
    for i in range(3):
        b = batch_np(10 + i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()},
                       jax.random.PRNGKey(i))
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        tm = TS.metrics_to_host(tm)
        for k in TS.METRICS:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        assert ts.step == int(js.step) == i + 1
        close_trees(port_flat(ts), jax_flat(js), 1e-4, f"step {i}")
    # the freeze mask zeroes gradients before the decay: frozen leaves
    # still move, in both packages (ROADMAP.md, section 3)
    assert not torch.equal(ts.params["l0"]["w"], frozen0)


@pytest.mark.parametrize("folded", [False, True])
def test_eval_step_matches_jax(folded):
    jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    jv = jax.tree.map(np.asarray, JG.init(jir, jax.random.PRNGKey(1)))
    tv = TW.from_jax_variables(tir, jv)
    b = batch_np(40)
    if folded:
        jv = JG.fold_batchnorm(jir, jv)
        tv = TG.place_folded(tir, TG.fold_batchnorm(tir, tv), "cpu",
                             torch.float32)
    want = JS.make_eval_step(jir, compute_dtype=jnp.float32, folded=folded)(
        jv, jnp.asarray(b["v"]), jnp.asarray(b["l"]))
    got = TS.make_eval_step(tir, compute_dtype=torch.float32,
                            folded=folded)(tv, torch.from_numpy(b["v"]),
                                           torch.from_numpy(b["l"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


def test_cosine_schedule_matches_jax():
    for spe in (1, 7, 1500):
        js = JO.cosine_epoch_schedule(0.01, 0.1, 3, spe)
        ts = TO.cosine_epoch_schedule(0.01, 0.1, 3, spe)
        steps = sorted(set(range(0, 3 * spe + 2, max(1, spe // 50)))
                       | {0, 1, spe - 1, spe, 2 * spe, 3 * spe})
        for s in steps:
            np.testing.assert_allclose(float(ts(s)), float(js(s)),
                                       rtol=1e-6, err_msg=f"{spe} {s}")


# ------------------------------------------------------------- checkpoints

def _trainers(tmp_path, sgd):
    jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    kw = dict(epochs=3, batch_size=2, img_size=64, sgd=sgd, ema=True)
    jt = JaxTrainer(jir, HYP, out_dir=str(tmp_path), name="jax",
                    compute_dtype=jnp.float32, data_parallel=False, **kw)
    jv = jax.tree.map(np.asarray, {"params": jt.state.params,
                                   "state": jt.state.bn_state})
    tt = Trainer(tir, HYP, out_dir=str(tmp_path), name="port",
                 compute_dtype=torch.float32, device="cpu",
                 variables=TW.from_jax_variables(tir, jv), **kw)
    return jt, tt


def _jax_step(jt, b, i):
    jt.state, _ = jt.step_fn(jt.state, {k: jnp.asarray(v)
                                        for k, v in b.items()},
                             jax.random.PRNGKey(i))


def _port_step(tt, b):
    tt.state, _ = tt.step_fn(tt.state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})


@pytest.mark.parametrize("sgd", [True, False], ids=["sgd", "adam"])
def test_checkpoints_resume_across_packages(tmp_path, sgd):
    jt, tt = _trainers(tmp_path, sgd)
    b1, b2 = batch_np(21), batch_np(22)
    # JAX trains a step and saves; the port resumes; both take the next
    _jax_step(jt, b1, 0)
    jt.results.append(0, np.zeros(12), 1.0, 0.01)
    jt.save(str(tmp_path / "from_jax"), 0)
    tt.load(str(tmp_path / "from_jax"))
    assert tt.start_epoch == 1 and tt.state.step == 1
    assert tt.results.read() == jt.results.read()
    _jax_step(jt, b2, 1)
    _port_step(tt, b2)
    close_trees(port_flat(tt.state), jax_flat(jt.state), 1e-3,
                "port resumed JAX")
    # the port saves; JAX resumes; both take the next step
    tt.save(str(tmp_path / "from_port"), 1)
    jt2, _ = _trainers(tmp_path / "b", sgd)
    jt2.load(str(tmp_path / "from_port"))
    assert int(jt2.state.step) == 2 and jt2.start_epoch == 2
    b3 = batch_np(23)
    _jax_step(jt2, b3, 2)
    _port_step(tt, b3)
    close_trees(port_flat(tt.state), jax_flat(jt2.state), 1e-3,
                "JAX resumed the port")


# ------------------------------------------------------------------- card

def _mnv3_step(where, sgd, batch, variables, ir):
    tx = TO.make_optimizer(HYP, lambda c: torch.tensor(1e-3), sgd=sgd)
    st = TS.create_train_state(ir, 0, tx, variables=variables, device=where)
    before = [p.detach().clone() for p in TR.leaves(st.params)]
    step = TS.make_train_step(ir, HYP, tx, compute_dtype=torch.float64)
    st, m = step(st, {k: torch.from_numpy(v).to(where)
                      for k, v in batch.items()})
    return (TS.metrics_to_host(m),
            [(p.detach() - b).cpu().double()
             for p, b in zip(TR.leaves(st.params), before)],
            [s.cpu().double() for s in TR.leaves(st.bn_state)])


@pytest.mark.cuda
@pytest.mark.parametrize("sgd", [True, False], ids=["sgd", "adam"])
def test_step_card_matches_cpu(sgd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ir = compile_cfg(MNV3)
    variables = TW.load_state_dict_npz(ir, NPZ)
    batch = batch_np(30, hw=(128, 160))
    (mc, dc, sc), (mh, dh, sh) = (
        _mnv3_step(w, sgd, batch, variables, ir) for w in ("cuda", "cpu"))
    for k in TS.METRICS:
        bound = 1e-6 if k == "grad_norm" else 1e-8
        assert abs(mc[k] - mh[k]) <= bound * abs(mh[k]) + 1e-12, k
    for got, want, bound in ((dc, dh, 1e-4), (sc, sh, 1e-8)):
        for a, b in zip(got, want):
            assert float((a - b).norm()) <= bound * float(b.norm()) + 1e-12
