"""The int8 modes ``spine``, ``spineall`` and ``edge`` and the quantized-
variables artifacts (models/quantize.py): the port on the CPU against the
JAX package's models/quantize.py, on the flagship narrowed for the CPU
(the fixture of tests/test_torch_quantize.py).

What is held, and to what:
  * the edge plan (targets, int8 outputs, folded inputs) and its
    per-channel scale vectors exactly, on the tiny cfg, both flagships and
    MNv3 at full width (IR only);
  * quantize() in each new mode, every leaf in the JAX layout bit for bit,
    given the same stats; calibration files of either package quantize the
    same in the other;
  * every quantized conv of the spineall and edge plans, given the same
    fp32 input and the s8 codes its producer emits: to an ulp, or one int8
    step on under 1% of requantized values;
  * the artifacts: written by either package, read by the other bit for
    bit (bf16 leaves too); TPU-only keys refused; the Predictor served
    from an artifact equal to the one that quantized, and refusing a wrong
    mode or size.

The JAX comparisons switch off its space-to-depth regions
(``graph._S2D_REGION = False``), as tests/test_torch_quantize.py does.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
from double_yolo_kaist_tpu.models import graph as JG
from double_yolo_kaist_tpu.models import quantize as JQ
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import quantize as TQ
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.serving import Predictor
from tests.test_torch_quantize import (PLAN_CFGS, _flat, _hold_forward,
                                       _port_batches, _quantized_pair,
                                       one_thread)
from tests.test_torch_slice import flagship_variables, write_narrow_flagship


_one_thread = pytest.fixture(autouse=True)(one_thread)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """test_torch_quantize.py's fixture (jax ir, jax folded, port ir, the
    same folded params in the port's layout, 2 calibration batches, stats,
    jax variables), with the port's fp32 calibration of the batches as the
    stats both packages quantize from (that file holds it against JAX's)."""
    cfg = write_narrow_flagship(tmp_path_factory.mktemp("flagship"))
    jir, tir = jax_compile_cfg(cfg), compile_cfg(cfg)
    jv = flagship_variables(jir)
    jfold = JG.fold_batchnorm(jir, jv)
    tfold = TW.from_jax_variables(tir, jax.device_get(jfold))
    rng = np.random.default_rng(4)
    batches = [tuple(rng.random((2, 64, 96, 3), dtype=np.float32)
                     for _ in range(2)) for _ in range(2)]
    stats = TQ.calibrate(tir, TG.place_folded(tir, tfold, "cpu",
                                              torch.float32),
                         _port_batches(batches), compute_dtype=torch.float32)
    return jir, jfold, tir, tfold, batches, stats, jv


def _out_stats(ir, seed):
    """Random per-tensor and per-channel stats for every node that has
    them, as calibrate keys them."""
    rng = np.random.default_rng(seed)
    stats = {}
    for n in ir.nodes:
        if n.kind == "conv":
            stats[f"l{n.index}"] = float(rng.uniform(0.5, 8.0))
        if n.kind in ("conv", "shortcut", "se"):
            v = rng.uniform(0.0, 6.0, n.out_ch)
            v[::7] = 0.0                         # dead channels
            stats[f"l{n.index}.out"] = v
    return stats


@pytest.mark.parametrize("name", sorted(PLAN_CFGS))
def test_plan_edges_and_scales_equal_jax(name, monkeypatch):
    """plan_edges at a deployment size and edge_scale_vectors, as JAX's
    without its s2d regions (the port has none), exactly."""
    monkeypatch.setattr(JG, "_S2D_REGION", False)
    path, kw = PLAN_CFGS[name]
    jir, tir = jax_compile_cfg(path, **kw), compile_cfg(path, **kw)
    jt, jo, jf = JQ.plan_edges(jir, (512, 640))
    tt, to, tf = TQ.plan_edges(tir, (512, 640))
    assert (tt, to, tf) == (set(jt), dict(jo), set(jf))
    assert tt and any(to.values()) and tf
    stats = _out_stats(tir, 3)
    want = JQ.edge_scale_vectors(jir, stats, jo)
    got = TQ.edge_scale_vectors(tir, stats, to)
    assert sorted(got) == sorted(want)
    for i in want:
        assert (got[i] is None) == (want[i] is None), i
        if want[i] is not None:
            assert got[i].dtype == np.float32
            np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("mode", ["spine", "spineall", "edge"])
def test_quantize_new_modes_match_jax(flagship, monkeypatch, mode):
    """Every leaf of quantize() in the JAX layout, bit for bit: int8
    kernels (edge: with the input scales folded in), scales, the spine
    adds' scales, the edge scale vectors and the fp tails."""
    jq, tq = _quantized_pair(flagship, monkeypatch, mode)
    want = _flat(jax.device_get(jq))
    got = _flat(TQ._to_numpy_tree(tq))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    n_spine = sum("spine" in e for e in tq.values())
    n_in = sum("in_s" in e.get("q", {}) for e in tq.values())
    n_out = sum("out_s" in e.get("q", e) for e in tq.values())
    assert (n_spine, n_in > 0, n_out > 0) == {
        "spine": (0, False, False), "spineall": (44, False, False),
        "edge": (0, True, True)}[mode]


@pytest.mark.parametrize("mode", ["spine", "spineall", "edge"])
def test_calibration_files_cross_load(flagship, monkeypatch, tmp_path,
                                      mode):
    """A calibration file either package writes loads in the other and
    quantizes there in each new mode: the JAX package's file gives the
    port the variables of the stats it was given, and the port's file
    gives JAX's quantize the port's variables of the same stats, bit for
    bit."""
    jir, jfold, tir, tfold, _, port_stats, _ = flagship
    jstats = {k: (np.asarray(v) if np.ndim(v) else v)
              for k, v in port_stats.items()}
    monkeypatch.setattr(JG, "_S2D_REGION", False)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JQ.save_calibration(jpath, jstats)
    TQ.save_calibration(tpath, port_stats)
    loaded, _ = TQ.load_calibration(jpath)
    a = _flat(TQ._to_numpy_tree(TQ.quantize(tir, tfold, loaded, mode=mode)))
    b = _flat(TQ._to_numpy_tree(TQ.quantize(tir, tfold, jstats, mode=mode)))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jloaded, _ = JQ.load_calibration(tpath)
    want = _flat(jax.device_get(JQ.quantize(jir, jfold, jloaded,
                                            mode=mode)))
    got = _flat(TQ._to_numpy_tree(TQ.quantize(tir, tfold, port_stats,
                                              mode=mode)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_edge_needs_per_channel_stats(flagship):
    """A calibration made without the ``l<i>.out`` vectors (the port's
    files before edge mode) is refused in edge mode, never re-calibrated
    on the quiet; the other modes take it."""
    _, _, tir, tfold, _, jstats, _ = flagship
    old = {k: v for k, v in jstats.items() if "." not in k}
    with pytest.raises(ValueError, match="re-calibrate"):
        TQ.quantize(tir, tfold, old, mode="edge")
    assert TQ.quantize(tir, tfold, old, mode="spineall")["params"]


def _conv_inputs(flagship, targets):
    """Each target conv's input in the port's fp32 forward of batch 0."""
    _, _, tir, tfold, batches, _, _ = flagship
    inputs = {}

    def record(node, inp, p):
        if node.index in targets:
            inputs[node.index] = inp
        return TG.conv_folded(node, inp, p)

    TG.run_graph(tir, TG.place_folded(tir, tfold, "cpu",
                                      torch.float32)["params"],
                 *_port_batches(batches)[0], dtype=torch.float32,
                 conv=record)
    assert sorted(inputs) == sorted(targets)
    return inputs


def _hold_conv(got, ref, s8: bool, what):
    if s8:
        assert got.dtype == np.int8 and ref.dtype == np.int8, what
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() < 0.01, what
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                   err_msg=what)


def test_every_spineall_conv_matches_jax(flagship, monkeypatch):
    """Each quantized conv of the spineall plan (the spine-fed 1x1s among
    them), port vs JAX ``_qconv``, on the same fp32 input and on the s8
    codes a spine add would hand it: the bounds of
    test_every_qconv_matches_jax."""
    tir = flagship[2]
    jq, tq = _quantized_pair(flagship, monkeypatch, "spineall")
    qp = TQ.place_quantized(tir, {"params": tq}, "cpu",
                            torch.float32)["params"]
    targets, emits, spine = TQ._plan_with_spine(tir, "spineall")
    inputs = _conv_inputs(flagship, targets)
    fed = {si + 1 for si in spine}
    assert fed <= targets and len(fed) == 44
    for i in sorted(targets):
        node, x = tir.nodes[i], inputs[i]
        cases = [x]
        if i in fed:        # the codes the add before it emits
            cases.append(TQ._quantize_input(
                x, tq[f"l{i - 1}"]["spine"]["inv_sy"]))
        for inp in cases:
            jin = jnp.asarray(inp.permute(0, 2, 3, 1).numpy())
            ref = np.asarray(JQ._qconv(
                jin, jq[f"l{i}"]["q"], stride=node.stride, pad=node.pad,
                groups=node.groups, act=node.act, out_dtype=jnp.float32))
            got = TQ.qconv(node, inp, qp[f"l{i}"]["q"], torch.float32)
            _hold_conv(got.permute(0, 2, 3, 1).numpy(), ref, i in emits,
                       f"l{i} {inp.dtype}")


def test_every_edge_conv_matches_jax(flagship, monkeypatch):
    """Each quantized conv of the edge plan, port ``qconv_edge`` vs JAX
    ``_qconv_e``: from the fp32 input (a folded-in conv then quantizes it
    per channel) and, for the folded-in convs, from the s8 codes of its
    input edge with their scales. Outputs re-emitted as s8 within one step
    on under 1%, with the same scale vectors; fp outputs within 1e-6."""
    tir = flagship[2]
    jq, tq = _quantized_pair(flagship, monkeypatch, "edge")
    qp = TQ.place_quantized(tir, {"params": tq}, "cpu",
                            torch.float32)["params"]
    targets, _, folded_in = TQ.plan_edges(tir)
    inputs = _conv_inputs(flagship, targets)
    n_s8_in = 0
    for i in sorted(targets):
        node, x = tir.nodes[i], inputs[i]
        jqp, tqp = jq[f"l{i}"]["q"], qp[f"l{i}"]["q"]
        cases = [(x, None)]
        if i in folded_in:
            cases.append((TQ._quantize_input(x, tqp["in_inv"]),
                          _vec(tq[f"l{i}"]["q"]["in_s"])))
            n_s8_in += 1
        for inp, xs in cases:
            jin = jnp.asarray(inp.permute(0, 2, 3, 1).numpy())
            jxs = None if xs is None else jnp.asarray(xs.reshape(-1).numpy())
            ref, rs = JQ._qconv_e(jin, jxs, jqp, stride=node.stride,
                                  pad=node.pad, act=node.act,
                                  out_dtype=jnp.float32)
            got = TQ.qconv_edge(node, inp if xs is None else TQ.QVal(inp, xs),
                                tqp, torch.float32)
            got, gs = (got.q, got.s) if isinstance(got, TQ.QVal) else (got,
                                                                       None)
            _hold_conv(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                       "out_inv" in jqp, f"l{i} {inp.dtype}")
            assert (gs is None) == (rs is None)
            if rs is not None:
                np.testing.assert_array_equal(gs.reshape(-1).numpy(),
                                              np.asarray(rs))
    assert n_s8_in == len(folded_in) > 0


def _vec(t):
    return torch.as_tensor(t).reshape(1, -1, 1, 1)


def test_edge_convs_before_activation_bit_equal_jax(flagship, monkeypatch):
    """Each quantized conv of the edge plan up to its activation (input
    quantize, int8 product, dequant by the input-folded scales, bias),
    port against JAX's ``_qconv_e`` run op by op: bit for bit, from the
    fp32 input; and with its activation too where that is leaky. What the
    two packages then differ by is mish: torch's and XLA's round an ulp
    apart on part of each output."""
    tir = flagship[2]
    jq, tq = _quantized_pair(flagship, monkeypatch, "edge")
    qp = TQ.place_quantized(tir, {"params": tq}, "cpu",
                            torch.float32)["params"]
    targets = TQ.plan_edges(tir)[0]
    inputs = _conv_inputs(flagship, targets)
    drop = ("out_inv", "out_s")
    acts = set()
    for i in sorted(targets):
        jqp = {k: v for k, v in jq[f"l{i}"]["q"].items() if k not in drop}
        tqp = {k: v for k, v in qp[f"l{i}"]["q"].items() if k not in drop}
        jin = jnp.asarray(inputs[i].permute(0, 2, 3, 1).numpy())
        node = tir.nodes[i]
        acts.add(node.act)
        for act in {"linear", node.act} - {"mish"}:
            n = dataclasses.replace(node, act=act)
            with jax.disable_jit():
                ref, _ = JQ._qconv_e(jin, None, jqp, stride=n.stride,
                                     pad=n.pad, act=act,
                                     out_dtype=jnp.float32)
            got = TQ.qconv_edge(n, inputs[i], tqp, torch.float32)
            np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                          np.asarray(ref),
                                          err_msg=f"l{i} {act}")
    assert acts == {"leaky", "mish"}


@pytest.mark.parametrize("mode", ["spine", "spineall", "edge"])
def test_quantize_new_modes_match_jax(flagship, monkeypatch, mode):
    """Every leaf of quantize() in the JAX layout, bit for bit: int8
    kernels (edge: with the input scales folded in), scales, the spine
    adds' scales, the edge scale vectors and the fp tails."""
    jq, tq = _quantized_pair(flagship, monkeypatch, mode)
    want = _flat(jax.device_get(jq))
    got = _flat(TQ._to_numpy_tree(tq))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    n_spine = sum("spine" in e for e in tq.values())
    n_in = sum("in_s" in e.get("q", {}) for e in tq.values())
    n_out = sum("out_s" in e.get("q", e) for e in tq.values())
    assert (n_spine, n_in > 0, n_out > 0) == {
        "spine": (0, False, False), "spineall": (44, False, False),
        "edge": (0, True, True)}[mode]


@pytest.mark.parametrize("mode", ["spine", "spineall", "edge"])
def test_calibration_files_cross_load(flagship, monkeypatch, tmp_path,
                                      mode):
    """A calibration file either package writes loads in the other and
    quantizes there in each new mode: the JAX package's file gives the
    port the variables of the stats it was given, and the port's file
    gives JAX's quantize the port's variables of the same stats, bit for
    bit."""
    jir, jfold, tir, tfold, _, port_stats, _ = flagship
    jstats = {k: (np.asarray(v) if np.ndim(v) else v)
              for k, v in port_stats.items()}
    monkeypatch.setattr(JG, "_S2D_REGION", False)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JQ.save_calibration(jpath, jstats)
    TQ.save_calibration(tpath, port_stats)
    loaded, _ = TQ.load_calibration(jpath)
    a = _flat(TQ._to_numpy_tree(TQ.quantize(tir, tfold, loaded, mode=mode)))
    b = _flat(TQ._to_numpy_tree(TQ.quantize(tir, tfold, jstats, mode=mode)))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jloaded, _ = JQ.load_calibration(tpath)
    want = _flat(jax.device_get(JQ.quantize(jir, jfold, jloaded,
                                            mode=mode)))
    got = _flat(TQ._to_numpy_tree(TQ.quantize(tir, tfold, port_stats,
                                              mode=mode)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_edge_needs_per_channel_stats(flagship):
    """A calibration made without the ``l<i>.out`` vectors (the port's
    files before edge mode) is refused in edge mode, never re-calibrated
    on the quiet; the other modes take it."""
    _, _, tir, tfold, _, jstats, _ = flagship
    old = {k: v for k, v in jstats.items() if "." not in k}
    with pytest.raises(ValueError, match="re-calibrate"):
        TQ.quantize(tir, tfold, old, mode="edge")
    assert TQ.quantize(tir, tfold, old, mode="spineall")["params"]


def _conv_inputs(flagship, targets):
    """Each target conv's input in the port's fp32 forward of batch 0."""
    _, _, tir, tfold, batches, _, _ = flagship
    inputs = {}

    def record(node, inp, p):
        if node.index in targets:
            inputs[node.index] = inp
        return TG.conv_folded(node, inp, p)

    TG.run_graph(tir, TG.place_folded(tir, tfold, "cpu",
                                      torch.float32)["params"],
                 *_port_batches(batches)[0], dtype=torch.float32,
                 conv=record)
    assert sorted(inputs) == sorted(targets)
    return inputs


def _hold_conv(got, ref, s8: bool, what):
    if s8:
        assert got.dtype == np.int8 and ref.dtype == np.int8, what
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() < 0.01, what
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                   err_msg=what)


def test_every_spineall_conv_matches_jax(flagship, monkeypatch):
    """Each quantized conv of the spineall plan (the spine-fed 1x1s among
    them), port vs JAX ``_qconv``, on the same fp32 input and on the s8
    codes a spine add would hand it: the bounds of
    test_every_qconv_matches_jax."""
    tir = flagship[2]
    jq, tq = _quantized_pair(flagship, monkeypatch, "spineall")
    qp = TQ.place_quantized(tir, {"params": tq}, "cpu",
                            torch.float32)["params"]
    targets, emits, spine = TQ._plan_with_spine(tir, "spineall")
    inputs = _conv_inputs(flagship, targets)
    fed = {si + 1 for si in spine}
    assert fed <= targets and len(fed) == 44
    for i in sorted(targets):
        node, x = tir.nodes[i], inputs[i]
        cases = [x]
        if i in fed:        # the codes the add before it emits
            cases.append(TQ._quantize_input(
                x, tq[f"l{i - 1}"]["spine"]["inv_sy"]))
        for inp in cases:
            jin = jnp.asarray(inp.permute(0, 2, 3, 1).numpy())
            ref = np.asarray(JQ._qconv(
                jin, jq[f"l{i}"]["q"], stride=node.stride, pad=node.pad,
                groups=node.groups, act=node.act, out_dtype=jnp.float32))
            got = TQ.qconv(node, inp, qp[f"l{i}"]["q"], torch.float32)
            _hold_conv(got.permute(0, 2, 3, 1).numpy(), ref, i in emits,
                       f"l{i} {inp.dtype}")


def test_every_edge_conv_matches_jax(flagship, monkeypatch):
    """Each quantized conv of the edge plan, port ``qconv_edge`` vs JAX
    ``_qconv_e``: from the fp32 input (a folded-in conv then quantizes it
    per channel) and, for the folded-in convs, from the s8 codes of its
    input edge with their scales. Outputs re-emitted as s8 within one step
    on under 1%, with the same scale vectors; fp outputs within 1e-6."""
    tir = flagship[2]
    jq, tq = _quantized_pair(flagship, monkeypatch, "edge")
    qp = TQ.place_quantized(tir, {"params": tq}, "cpu",
                            torch.float32)["params"]
    targets, _, folded_in = TQ.plan_edges(tir)
    inputs = _conv_inputs(flagship, targets)
    n_s8_in = 0
    for i in sorted(targets):
        node, x = tir.nodes[i], inputs[i]
        jqp, tqp = jq[f"l{i}"]["q"], qp[f"l{i}"]["q"]
        cases = [(x, None)]
        if i in folded_in:
            cases.append((TQ._quantize_input(x, tqp["in_inv"]),
                          _vec(tq[f"l{i}"]["q"]["in_s"])))
            n_s8_in += 1
        for inp, xs in cases:
            jin = jnp.asarray(inp.permute(0, 2, 3, 1).numpy())
            jxs = None if xs is None else jnp.asarray(xs.reshape(-1).numpy())
            ref, rs = JQ._qconv_e(jin, jxs, jqp, stride=node.stride,
                                  pad=node.pad, act=node.act,
                                  out_dtype=jnp.float32)
            got = TQ.qconv_edge(node, inp if xs is None else TQ.QVal(inp, xs),
                                tqp, torch.float32)
            got, gs = (got.q, got.s) if isinstance(got, TQ.QVal) else (got,
                                                                       None)
            _hold_conv(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                       "out_inv" in jqp, f"l{i} {inp.dtype}")
            assert (gs is None) == (rs is None)
            if rs is not None:
                np.testing.assert_array_equal(gs.reshape(-1).numpy(),
                                              np.asarray(rs))
    assert n_s8_in == len(folded_in) > 0


def _vec(t):
    return torch.as_tensor(t).reshape(1, -1, 1, 1)


def test_edge_convs_before_activation_bit_equal_jax(flagship, monkeypatch):
    """Each quantized conv of the edge plan up to its activation (input
    quantize, int8 product, dequant by the input-folded scales, bias),
    port against JAX's ``_qconv_e`` run op by op: bit for bit, from the
    fp32 input. What the two packages then differ by is the activation:
    torch's mish and XLA's round an ulp apart on part of each output."""
    tir = flagship[2]
    jq, tq = _quantized_pair(flagship, monkeypatch, "edge")
    qp = TQ.place_quantized(tir, {"params": tq}, "cpu",
                            torch.float32)["params"]
    targets = TQ.plan_edges(tir)[0]
    inputs = _conv_inputs(flagship, targets)
    drop = ("out_inv", "out_s")
    for i in sorted(targets):
        node = dataclasses.replace(tir.nodes[i], act="linear")
        jqp = {k: v for k, v in jq[f"l{i}"]["q"].items() if k not in drop}
        tqp = {k: v for k, v in qp[f"l{i}"]["q"].items() if k not in drop}
        with jax.disable_jit():
            ref, _ = JQ._qconv_e(
                jnp.asarray(inputs[i].permute(0, 2, 3, 1).numpy()), None,
                jqp, stride=node.stride, pad=node.pad, act="linear",
                out_dtype=jnp.float32)
        got = TQ.qconv_edge(node, inputs[i], tqp, torch.float32)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(ref), err_msg=f"l{i}")


@pytest.mark.parametrize("mode", ["spine", "spineall", "edge"])
def test_apply_quantized_new_modes_match_jax(flagship, monkeypatch, mode):
    """The whole int8 forward of each new mode, port vs JAX, fp32, same
    qvars, to test_apply_quantized_matches_jax's bounds: the median raw-head
    difference under 1e-3, the mean under 0.75 of the mean quantization
    error.

    Edge mode requantizes 271 edges of this model, 141 of them behind a
    mish, and torch's mish and XLA's round an ulp apart on part of every
    mish output (each conv before its activation is bit-equal:
    test_edge_convs_before_activation_bit_equal_jax). An ulp on a
    rounding boundary moves a code by a step (-97.49999 in JAX against
    -97.5 here), and the steps compound, so that the median stands at
    about 0.4 of the quantization error, not under 1e-3. JAX run op by op
    (``jax.disable_jit``) gives its jitted forward (median difference
    under 1e-6, held here), so XLA's fusion is not the cause. The edge median is held under 0.6 of that
    error, its mean under 0.75 as in the other modes;
    test_every_edge_conv_matches_jax holds each conv to the strict
    bounds."""
    _hold_forward(flagship, monkeypatch, mode,
                  median=(lambda q_err: 0.6 * q_err) if mode == "edge"
                  else 1e-3)
    if mode == "edge":          # op by op, JAX gives its jitted forward
        jir, xv, xl = flagship[0], *flagship[4][0]
        jq = {"params": _quantized_pair(flagship, monkeypatch, mode)[0]}
        run = lambda q, a, b: JQ.apply_quantized(  # noqa: E731
            jir, q, a, b, compute_dtype=jnp.float32, mode=mode)[1]
        args = (jq, jnp.asarray(xv), jnp.asarray(xl))
        with jax.disable_jit():
            eager = run(*args)
        for a, b in zip(jax.jit(run)(*args), eager):
            assert np.median(np.abs(np.asarray(a) - np.asarray(b))) < 1e-6


# ------------------------------------------------- quantized artifacts


def _bf16_pair(flagship, monkeypatch, mode):
    """JAX's quantize() of the bf16-cast fold, as tools/calibrate.py makes
    it (bf16 biases and fp tails), and the port's quantize of the same."""
    jir, jfold, tir, _, _, jstats, _ = flagship
    monkeypatch.setattr(JG, "_S2D_REGION", False)
    bf = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), jfold)
    return jax.device_get(JQ.quantize(jir, bf, jstats, mode=mode))


@pytest.mark.parametrize("mode", ["spineall", "edge"])
def test_quantized_artifacts_cross_load(flagship, monkeypatch, tmp_path,
                                        mode):
    """A file JAX's save_quantized writes loads in the port, and the port's
    save of what it loaded loads in JAX: every leaf bit for bit, bf16 ones
    too, with the mode and hw; the port's own quantize() round-trips to
    itself."""
    jq = _bf16_pair(flagship, monkeypatch, mode)
    want = _flat(jq)
    assert any(a.dtype == jnp.bfloat16 for a in want.values())
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JQ.save_quantized(jpath, jq, mode=mode, hw=(64, 96))
    tq, tmode, thw = TQ.load_quantized(jpath)
    assert (tmode, thw) == (mode, (64, 96))
    got = _flat(TQ._to_numpy_tree(tq), convert=False)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if w.dtype == jnp.bfloat16:             # kept as a torch tensor
            assert g.dtype == torch.bfloat16, k
            g, w = g.view(torch.int16).numpy(), w.view(np.int16)
        np.testing.assert_array_equal(g, w, err_msg=k)
    TQ.save_quantized(tpath, tq, mode=mode, hw=(64, 96))
    back, bmode, bhw = JQ.load_quantized(tpath)
    assert (bmode, bhw) == (mode, (64, 96))
    back = _flat(back)
    assert sorted(back) == sorted(want)
    for k, w in want.items():
        assert back[k].dtype == w.dtype, k
        np.testing.assert_array_equal(np.atleast_1d(back[k]).view(np.uint8),
                                      np.atleast_1d(w).view(np.uint8),
                                      err_msg=k)
    # the port's fp32 quantize() round-trips through its own files
    _, tq32 = _quantized_pair(flagship, monkeypatch, mode)
    TQ.save_quantized(tpath, {"params": tq32}, mode=mode)
    again, _, hw = TQ.load_quantized(tpath)
    assert hw is None
    a, b = _flat(TQ._to_numpy_tree(again)), _flat(TQ._to_numpy_tree(
        {"params": tq32}))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("what", ["s2d", "int8_stems"])
def test_tpu_only_artifact_refused(flagship, tmp_path, what):
    """An artifact with the JAX package's TPU-only rewrites (s2d kernels
    prepared for a size, or the int8 fused stem) is refused, naming queue
    1 item 14, not served without them."""
    jir, jfold, _, _, _, jstats, _ = flagship
    path = str(tmp_path / "q.npz")
    if what == "s2d":                       # JAX's default, with an hw
        q = JQ.quantize(jir, jfold, jstats, mode="chain", hw=(64, 96))
    else:
        q = JQ.quantize(jir, jfold, jstats, mode="edge", int8_stems=True)
    JQ.save_quantized(path, jax.device_get(q), mode="chain", hw=(64, 96))
    with pytest.raises(ValueError, match="item 14"):
        TQ.load_quantized(path)


def _frames(seed, n=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, 64, 96, 3), dtype=np.uint8)
                 for _ in range(2))


@pytest.mark.parametrize("mode", ["edge"])
def test_predictor_quantized_artifact(flagship, tmp_path, mode):
    """Predictor(quantized=): a missing file is written by the first
    quantization; a Predictor built from it serves int8 from the first
    request, with the detections of the Predictor that quantized in
    process, exactly."""
    _, _, tir, _, _, _, jv = flagship
    tv = TW.from_jax_variables(tir, jv)
    qpath = str(tmp_path / "q.npz")
    kw = dict(img_size=96, int8=True, int8_mode=mode, device="cpu",
              compute_dtype=torch.float32, batch_buckets=(2,),
              calibration_batches=1, conf_thres=0.01)
    first = Predictor(tir, tv, quantized=qpath, **kw)
    first(*_frames(1))                              # calibrates, saves
    assert first.qvars is not None and os.path.exists(qpath)
    _, qmode, qhw = TQ.load_quantized(qpath)
    assert (qmode, qhw) == (mode, (96, 96))
    second = Predictor(tir, tv, quantized=qpath, **kw)
    assert second.qvars is not None and not second._cal_batches
    for seed in (2, 3):
        got, want = second(*_frames(seed)), first(*_frames(seed))
        assert sum(len(s) for _, s, _ in want) > 0
        for (b, s, c), (rb, rs, rc) in zip(got, want):
            np.testing.assert_array_equal(b, rb)
            np.testing.assert_array_equal(s, rs)
            np.testing.assert_array_equal(c, rc)


def test_predictor_artifact_checks(flagship, tmp_path):
    """As in the JAX package: the mode must match, and an edge artifact
    must have been made for the server's (img_size, img_size)."""
    _, _, tir, tfold, _, jstats, jv = flagship
    tv = TW.from_jax_variables(tir, jv)
    path = str(tmp_path / "q.npz")
    TQ.save_quantized(path, TQ.quantize(tir, tfold, jstats, mode="edge"),
                      mode="edge", hw=(64, 64))
    kw = dict(img_size=96, int8=True, device="cpu", quantized=path)
    with pytest.raises(ValueError, match="built for mode='edge'"):
        Predictor(tir, tv, int8_mode="chain", **kw)
    with pytest.raises(ValueError, match="hw=\\(64, 64\\)"):
        Predictor(tir, tv, int8_mode="edge", **kw)
    Predictor(tir, tv, int8_mode="edge", **dict(kw, img_size=64))
