"""Each inference op of the port against its JAX function, fp32 on the CPU.

Inputs are made with numpy from a seed. The JAX side runs at "highest"
precision (exact fp32 convs). Tolerance 1e-5: both sides compute the same
fp32 formulas; only the summation order of convs and means differs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from double_yolo_kaist_tpu.models import layers as JL
from double_yolo_kaist_torch.config.ir import compile_blocks
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import layers as TL
from double_yolo_kaist_torch.models.weights import from_jax_variables
from double_yolo_kaist_torch.ops import act as TA

JL.set_precision("highest")
TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _x(shape=(2, 9, 11, 8), seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", sorted(JL.ACTIVATIONS))
def test_activation(name):
    assert set(TA.ACTIVATIONS) == set(JL.ACTIVATIONS)
    x = _x(scale=6.0)
    ref = np.asarray(JL.activate(name, jnp.asarray(x)))
    mine = _nhwc(TA.activate(name, _nchw(x)))
    np.testing.assert_allclose(mine, ref, **TOL)


@pytest.mark.parametrize("groups,stride,pad,k", [
    (1, (1, 1), 1, 3), (2, (2, 2), 1, 3), (8, (1, 1), 1, 3), (1, (1, 1), 0, 1)])
def test_conv2d(groups, stride, pad, k):
    x = _x()
    rng = np.random.default_rng(1)
    w = rng.standard_normal((k, k, 8 // groups, 16)).astype(np.float32) * 0.2
    b = rng.standard_normal(16).astype(np.float32)
    ref = np.asarray(JL.conv2d(jnp.asarray(x), jnp.asarray(w), stride, pad,
                               groups) + b)
    mine = _nhwc(TL.conv2d(_nchw(x), _oihw(w), torch.from_numpy(b),
                           stride=stride, pad=pad, groups=groups))
    np.testing.assert_allclose(mine, ref, **TOL)


def test_squeeze_excitation():
    x = _x((2, 6, 7, 16))
    rng = np.random.default_rng(2)
    p = {"fc1": {"w": rng.standard_normal((1, 1, 16, 8)).astype(np.float32),
                 "b": rng.standard_normal(8).astype(np.float32)},
         "fc2": {"w": rng.standard_normal((1, 1, 8, 16)).astype(np.float32),
                 "b": rng.standard_normal(16).astype(np.float32)}}
    ref = np.asarray(JL.squeeze_excitation(
        jnp.asarray(x), {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
                         for k, v in p.items()}))
    tp = {k: {"w": _oihw(v["w"]), "b": torch.from_numpy(v["b"])}
          for k, v in p.items()}
    mine = _nhwc(TL.squeeze_excitation(_nchw(x), tp))
    np.testing.assert_allclose(mine, ref, **TOL)


@pytest.mark.parametrize("k,s,pad", [(5, 1, 2), (9, 1, 4), (13, 1, 6),
                                     (2, 2, 0), (3, 2, 1)])
def test_max_pool(k, s, pad):
    x = _x((2, 13, 12, 4))
    ref = np.asarray(JL.max_pool(jnp.asarray(x), k, (s, s), pad))
    mine = _nhwc(TL.max_pool(_nchw(x), k, (s, s), pad))
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("hw,out", [((8, 12), 1), ((8, 12), 4), ((7, 11), 3)])
def test_adaptive_avg_pool(hw, out):
    x = _x((2,) + hw + (5,))
    ref = np.asarray(JL.adaptive_avg_pool(jnp.asarray(x), out))
    mine = _nhwc(TL.adaptive_avg_pool(_nchw(x), out))
    np.testing.assert_allclose(mine, ref, **TOL)


@pytest.mark.parametrize("scale", [2, 3])
def test_upsample_nearest(scale):
    x = _x((2, 4, 5, 3))
    ref = np.asarray(JL.upsample_nearest(jnp.asarray(x), scale))
    mine = _nhwc(TL.upsample_nearest(_nchw(x), scale))
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("widths", [(8, 8), (8, 4), (4, 8), (8, 8, 4)],
                         ids=["equal", "wider", "narrower", "three"])
@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_fusion(widths, weighted):
    xs = [_x((2, 5, 6, c), seed=i) for i, c in enumerate(widths)]
    w = (np.random.default_rng(9).standard_normal(len(widths))
         .astype(np.float32) if weighted else None)
    ref = np.asarray(JL.weighted_fusion(
        jnp.asarray(xs[0]), [jnp.asarray(a) for a in xs[1:]],
        None if w is None else jnp.asarray(w)))
    mine = _nhwc(TL.weighted_fusion(
        _nchw(xs[0]), [_nchw(a) for a in xs[1:]],
        None if w is None else torch.from_numpy(w)))
    np.testing.assert_allclose(mine, ref, **TOL)


def test_inception_folded():
    """Folded inception (port fold_batchnorm + layers.inception) against the
    JAX inception with BatchNorm in eval mode."""
    icp = dict(n1x1=4, n3x3_reduce=3, n3x3=4, n5x5_reduce=2, n5x5=4,
               pool_proj=4)
    ir = compile_blocks({}, [{"type": "inception", **icp}], [8], "yolov4")
    node = ir.nodes[0]
    rng = np.random.default_rng(3)
    specs = {"b1_1": (1, 3, 4), "b2_1": (1, 3, 3), "b2_2": (3, 3, 4),
             "b3_1": (1, 3, 2), "b3_2": (3, 2, 4), "b3_3": (3, 4, 4),
             "b4_1": (1, 3, 4)}
    params, state = {}, {}
    for name, (k, ci, co) in specs.items():
        params[name] = {
            "w": rng.standard_normal((k, k, ci, co)).astype(np.float32) * 0.3,
            "bn": {"scale": rng.uniform(0.5, 1.5, co).astype(np.float32),
                   "bias": rng.standard_normal(co).astype(np.float32)}}
        state[name] = {"mean": rng.standard_normal(co).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, co).astype(np.float32)}
    x = _x((2, 7, 9, 3))
    jp = {n: {"w": jnp.asarray(v["w"]),
              "bn": {k: jnp.asarray(a) for k, a in v["bn"].items()}}
          for n, v in params.items()}
    js = {n: {k: jnp.asarray(a) for k, a in v.items()}
          for n, v in state.items()}
    ref, _ = JL.inception(jnp.asarray(x), jp, js, train=False)
    tv = from_jax_variables(ir, {"params": {"l0": params},
                                 "state": {"l0": state}})
    folded = TG.fold_batchnorm(ir, tv)
    assert node.kind == "inception"
    mine = _nhwc(TL.inception(_nchw(x), folded["params"]["l0"]))
    np.testing.assert_allclose(mine, np.asarray(ref), **TOL)
