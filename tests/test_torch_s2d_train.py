"""The JAX package's opt-in training-path s2d (``DYK_S2D_TRAIN``:
``batch_norm(phases=)``, ``conv_bn_act(s2d_role=)``, ``graph.apply``) in
the port, against the JAX package on the CPU with both packages' switches
set alike (their module flags, as JAX's own tests set them).

Tolerances, and why:
  * ``batch_norm(phases=4)`` on a phase-minor s2d tensor against JAX's,
    train and eval mode, fp32: the same two-pass statistics summed in
    another order: values and state within 1e-5 relative (by norm); and
    against the port's plain BN on the same tensor in the plain basis:
    within 1e-5 too;
  * ``conv_bn_act(s2d_role=)`` for each role, float64: the s2d basis is
    an exact rewrite: the plain conv's output, BN state and kernel
    gradient within 1e-10;
  * train-mode ``graph.apply`` of ``tests/fixtures/tiny_dyolov3.cfg`` at
    64x64 with ``_S2D_TRAIN`` on in both packages: JAX's bounds of its own
    s2d against plain (``tests/test_stem_fusion.py:128-178``): heads and
    BN state within rtol 1e-4, atol 1e-5, gradients within rtol 1e-3,
    atol 3e-4; the port's s2d against its plain basis the same; eval mode
    too;
  * the narrowed flagship (``tests/test_torch_slice.py``) at 64x64: its
    loss (the heads' squares summed, over 1e3) within rtol 1e-4 of JAX's,
    both with s2d;
  * the ``cuda`` case (the card's run; it skips here): the tiny cfg's
    train-mode heads with ``_S2D_TRAIN`` on, on the card against the CPU
    in float64 (within 1e-9), and two SGD steps captured in a CUDA graph
    against eager ones, equal.
"""

import os

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import layers as TL
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.utils import tree as TR
from double_yolo_kaist_torch.utils.checkpoint import _flatten

try:        # the card's machine has no JAX: only the cuda cases run there
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
    from double_yolo_kaist_tpu.models import graph as JG
    from double_yolo_kaist_tpu.models import layers as JL
    from tests.test_torch_slice import write_narrow_flagship
except ModuleNotFoundError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")
ROLES = ("e1", "e3", "i1", "i3", "x3")


def nrel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, 1)))


def _s2d(x):
    """(B, C, H, W) -> the phase-minor basis (B, 4C, H/2, W/2)."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 1, 3, 5, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def _switch(monkeypatch, name, on):
    monkeypatch.setattr(TG, name, on)
    if jax is not None:
        monkeypatch.setattr(JG, name, on)


def _tiny():
    return (jax_compile_cfg(TINY, yolo_strides=[8, 4]),
            compile_cfg(TINY, yolo_strides=[8, 4]))


def _variables(tir, seed=0):
    """The port's seeded init, BN state moved off the identity, and the
    same values in JAX's layout."""
    tv = TG.init(tir, seed)
    for i, s in enumerate(TR.leaves(tv["state"])):
        if s.ndim:
            s.copy_(torch.from_numpy(np.random.default_rng(i).uniform(
                0.5, 1.5, s.shape).astype(np.float32)))
    return jax.tree.map(np.asarray, TW.to_jax_variables(tv)), tv


def _images(seed=7, bs=2, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    return (rng.random((bs,) + hw + (3,), np.float32),
            rng.random((bs,) + hw + (3,), np.float32))


# ----------------------------------------------------------------- layers

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_phases_matches_jax(train):
    rng = np.random.default_rng(3)
    c = 6
    x = rng.normal(1.0, 2.0, (2, 8, 10, 4 * c)).astype(np.float32)  # NHWC
    params = {"scale": rng.uniform(0.5, 2, c).astype(np.float32),
              "bias": rng.normal(0, 1, c).astype(np.float32)}
    state = {"mean": rng.normal(0, 1, c).astype(np.float32),
             "var": rng.uniform(0.5, 2, c).astype(np.float32)}
    jy, js = JL.batch_norm(jnp.asarray(x), params, state, train, phases=4)
    ty, ts = TL.batch_norm(_nchw(x), {k: torch.from_numpy(v)
                                      for k, v in params.items()},
                           {k: torch.from_numpy(v) for k, v in state.items()},
                           train, phases=4)
    assert nrel(ty.numpy(), np.moveaxis(np.asarray(jy), -1, 1)) <= 1e-5
    for k in ("mean", "var"):
        assert ts[k].shape == (c,)
        assert nrel(ts[k].numpy(), js[k]) <= 1e-5
    # the plain basis's BN on the same values
    plain = torch.nn.functional.pixel_shuffle(_nchw(x), 2)   # depth->space
    assert torch.equal(_s2d(plain), _nchw(x))
    py, ps = TL.batch_norm(plain, {k: torch.from_numpy(v)
                                   for k, v in params.items()},
                           {k: torch.from_numpy(v) for k, v in state.items()},
                           train)
    assert nrel(ty.numpy(), _s2d(py).numpy()) <= 1e-5
    for k in ("mean", "var"):
        assert nrel(ts[k].numpy(), ps[k].numpy()) <= 1e-5


@pytest.mark.parametrize("role", ROLES)
def test_conv_bn_act_s2d_role_is_the_plain_conv(role):
    """Output, BN state and the plain kernel's gradient, float64."""
    rng = np.random.default_rng(ROLES.index(role))
    k = 1 if role in ("e1", "i1") else 3
    c, o = 5, 6
    w = torch.from_numpy(rng.standard_normal((o, c, k, k)))
    bn = {"scale": torch.from_numpy(rng.uniform(0.5, 2, o)),
          "bias": torch.from_numpy(rng.normal(0, 1, o))}
    st = {"mean": torch.zeros(o, dtype=torch.float64),
          "var": torch.ones(o, dtype=torch.float64)}
    x = torch.from_numpy(rng.standard_normal((2, c, 12, 16)))
    stride = (2, 2) if role == "x3" else (1, 1)
    pad = 0 if k == 1 else 1
    out = []
    for s2d in (False, True):
        wl = w.clone().requires_grad_(True)
        inp = _s2d(x) if s2d and role in ("i1", "i3", "x3") else x
        y, ns = TL.conv_bn_act(inp, {"w": wl, "bn": bn}, st, stride=stride,
                               pad=pad, act="leaky", train=True,
                               s2d_role=role if s2d else None)
        if s2d and role != "x3":
            y = torch.nn.functional.pixel_shuffle(y, 2)
        g, = torch.autograd.grad((y * y).sum(), wl)
        out.append((y, ns, g))
    (y0, s0, g0), (y1, s1, g1) = out
    torch.testing.assert_close(y1, y0, rtol=1e-10, atol=1e-10)
    for key in ("mean", "var"):
        torch.testing.assert_close(s1[key], s0[key], rtol=1e-10,
                                   atol=1e-10)
    torch.testing.assert_close(g1, g0, rtol=1e-10, atol=1e-10)


# ------------------------------------------------------ graph.apply, s2d

def _loss(heads):
    return sum((h.float() ** 2).sum() for h in heads)


def _port_run(tir, tv, xv, xl, train=True):
    params = TR.map_leaves(lambda p: p.clone().requires_grad_(True),
                           tv["params"])
    out, state = TG.apply(tir, {"params": params, "state": tv["state"]},
                          torch.from_numpy(xv), torch.from_numpy(xl),
                          train=train)
    if not train:
        return out, state, None
    grads = torch.autograd.grad(_loss(out), TR.leaves(params))
    return out, state, _flatten(TR.unflatten(params, grads))


def test_apply_train_s2d_tiny_matches_jax(monkeypatch):
    jir, tir = _tiny()
    plan = TG.s2d_plan(tir, 64, 64, exclude_stems=False)
    assert plan and plan == JG.s2d_plan(jir, 64, 64, exclude_stems=False)
    assert {"e3", "x3"} <= set(plan.values())  # the stems' entry and exit
    jv, tv = _variables(tir)
    xv, xl = _images()
    _switch(monkeypatch, "_S2D_TRAIN", False)
    h0, s0, g0 = _port_run(tir, tv, xv, xl)
    _switch(monkeypatch, "_S2D_TRAIN", True)
    h1, s1, g1 = _port_run(tir, tv, xv, xl)

    def jloss(params):
        heads, ns = JG.apply(jir, {"params": params, "state": jv["state"]},
                             jnp.asarray(xv), jnp.asarray(xl), train=True)
        return sum(jnp.sum(jnp.square(h)) for h in heads), (heads, ns)

    (_, (jh, jns)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jv["params"])
    js = _flatten(TW.from_jax_variables(
        tir, {"params": {}, "state": jax.tree.map(np.asarray, jns)})["state"])
    jgrad = _flatten(TW.from_jax_variables(
        tir, {"params": jax.tree.map(np.asarray, jg), "state": {}})["params"])
    for got, plain, want in zip(h1, h0, jh):
        for ref in (np.asarray(want), plain.detach().numpy()):
            np.testing.assert_allclose(got.detach().numpy(), ref,
                                       rtol=1e-4, atol=1e-5)
    f0, f1 = _flatten(s0), _flatten(s1)
    for k in js:
        for ref in (js[k], f0[k]):
            np.testing.assert_allclose(f1[k], ref, rtol=1e-4, atol=1e-5)
    assert sorted(g1) == sorted(jgrad)
    for k in g1:
        for ref in (jgrad[k], g0[k]):
            np.testing.assert_allclose(g1[k], ref, rtol=1e-3, atol=3e-4)
    # eval mode runs the plan too
    (d1, _), _, _ = _port_run(tir, tv, xv, xl, train=False)
    _switch(monkeypatch, "_S2D_TRAIN", False)
    (d0, _), _, _ = _port_run(tir, tv, xv, xl, train=False)
    np.testing.assert_allclose(d1.detach().numpy(), d0.detach().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_apply_train_s2d_narrow_flagship_loss(monkeypatch, tmp_path):
    cfg = write_narrow_flagship(tmp_path)
    jir, tir = jax_compile_cfg(cfg), compile_cfg(cfg)
    assert TG.s2d_plan(tir, 64, 64, exclude_stems=False)
    jv, tv = _variables(tir, seed=1)
    xv, xl = _images(8)
    _switch(monkeypatch, "_S2D_TRAIN", True)
    heads, _ = TG.apply(tir, tv, torch.from_numpy(xv), torch.from_numpy(xl),
                        train=True)
    jh, _ = jax.jit(lambda v: JG.apply(jir, v, jnp.asarray(xv),
                                       jnp.asarray(xl), train=True))(jv)
    got = float(_loss(heads)) / 1e3
    want = float(sum(jnp.sum(jnp.square(h)) for h in jh)) / 1e3
    np.testing.assert_allclose(got, want, rtol=1e-4)


# --------------------------------------------------------------- the card

@pytest.mark.cuda
def test_s2d_train_step_card_matches_cpu_and_captures(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from double_yolo_kaist_torch.train import optim as TO
    from double_yolo_kaist_torch.train import step as TS
    monkeypatch.setattr(TG, "_S2D_TRAIN", True)
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    tv = TG.init(tir, 0)
    xv, xl = _images()
    heads = {}
    for dev in ("cpu", "cuda"):
        placed = TR.map_leaves(lambda a: a.to(dev, torch.float64), tv)
        heads[dev] = TG.apply(tir, placed, torch.from_numpy(xv).to(dev),
                              torch.from_numpy(xl).to(dev), train=True,
                              compute_dtype=torch.float64)
    for a, b in zip(heads["cuda"][0], heads["cpu"][0]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-9)
    hyp = {"box": 3.54, "obj": 64.3, "cls": 37.4, "cls_pw": 1.0,
           "obj_pw": 1.0, "iou_t": 0.2, "fl_gamma": 0.0, "ciou": 1.0,
           "lr0": 1e-3, "momentum": 0.9, "weight_decay": 5e-4}
    t = np.zeros((2, 2, 4, 5), np.float32)
    t[..., 0, 1:] = (0.5, 0.5, 0.25, 0.4)
    m = np.zeros((2, 2, 4), bool)
    m[..., 0] = True
    batches = {"v": torch.from_numpy(np.stack([xv, xv])).cuda(),
               "l": torch.from_numpy(np.stack([xl, xl])).cuda(),
               "targets": torch.from_numpy(t).cuda(),
               "tmask": torch.from_numpy(m).cuda()}
    out = []
    for captured in (False, True):
        tx = TO.make_optimizer(hyp, lambda s: 1e-3, sgd=True)
        st = TS.create_train_state(tir, 0, tx, variables=tv, device="cuda")
        multi = TS.make_multi_step(tir, hyp, tx, compute_dtype=torch.float32)
        if captured:
            st, met = multi(st, batches)
        else:
            st, met = TS._eager_steps(
                multi.step_fn, st,
                lambda i: {k: v[i] for k, v in batches.items()}, 2)
        out.append((st, met))
    (s0, m0), (s1, m1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(TS._state_leaves(s0), TS._state_leaves(s1)):
        assert torch.equal(a, b)
