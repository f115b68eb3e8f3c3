"""int8 post-training quantization (models/quantize.py): the port on the
CPU against the JAX package's models/quantize.py. The new modes' own tests
and the quantized-variables artifacts are in test_torch_quantize_modes.py.

What is held, and to what:
  * the plan: targets and emitters equal JAX's in all six modes (seed,
    chain, all, spine, spineall, edge), on the tiny cfg, both flagships
    and MNv3, at full width (IR only);
  * the quantized weights: int8 kernels, scales, input and output inverse
    scales bit-exact, given the same stats;
  * calibrate: every conv's input amax and every per-channel output amax
    within 1e-5 relative of JAX's, fp32 (the same forward; only the order
    of the fp32 sums differs);
  * every quantized conv of the flagship narrowed for the CPU (every
    ``filters=`` divided by 4 but the heads', 64x96), given the same fp32
    input: to an ulp, or one int8 step on under 1% of requantized values;
  * apply_quantized given JAX's stats, fp32 compute, in chain, spine,
    spineall and edge, and Predictor(int8=True) on the CPU, on the same
    narrowed flagship: to the bounds stated in their docstrings. An ulp
    that lands on an int8 rounding boundary moves a value by one
    quantization step, and the steps compound through 80 and more
    quantized convs, so these two hold the result statistically.

The JAX int8 executor runs its convs in a space-to-depth basis by default,
re-quantizing the transformed kernels; the comparisons of the int8 forward
switch that off (``graph._S2D_REGION = False``, read by the JAX functions
at call time) so that both sides run the same int8 codes.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
from double_yolo_kaist_tpu.models import graph as JG
from double_yolo_kaist_tpu.models import quantize as JQ
from double_yolo_kaist_tpu.serving import Predictor as JaxPredictor
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import quantize as TQ
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.serving import Predictor
from tests.test_torch_slice import (MNV3, NPZ, REPO, TINY, _perturb_bn,
                                    flagship_variables,
                                    write_narrow_flagship)

def one_thread():
    """Run torch on one thread while a test runs. The port's CPU fp32
    results depend on how torch splits elementwise work over its threads
    (the vectorized body and the scalar tail of each split round an ulp
    apart), an int8 forward turns such an ulp into a step now and then,
    and the steps compound: with the default threads one process in five
    or six gave another narrowed-flagship forward (median raw-head
    difference to JAX 0.024 instead of 2e-5). One thread makes every run
    the same; under pytest-xdist it also keeps the workers' thread pools
    from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


_one_thread = pytest.fixture(autouse=True)(one_thread)


PLAN_CFGS = {
    "tiny": (TINY, {"yolo_strides": [8, 4]}),
    "v4_flagship": (os.path.join(
        REPO, "configs", "kaist_dyolov4_fshare_global_concat_se3.cfg"), {}),
    "v3_flagship": (os.path.join(
        REPO, "configs", "kaist_dyolov3_fshare_global_concat_se3.cfg"), {}),
    "mnv3": (MNV3, {}),
}


@pytest.mark.parametrize("mode", TQ.MODES)
@pytest.mark.parametrize("name", sorted(PLAN_CFGS))
def test_plan_equals_jax(name, mode):
    path, kw = PLAN_CFGS[name]
    jt, je = JQ.plan_quantization(jax_compile_cfg(path, **kw), mode)
    tt, te = TQ.plan_quantization(compile_cfg(path, **kw), mode)
    assert (tt, te) == (set(jt), set(je))
    if name == "mnv3" and mode not in ("all", "edge"):
        assert not tt            # depthwise convs and thin stems only
    if name == "v4_flagship" and mode == "chain":
        # the ten chain 1x1 convs K4 computes
        ir = compile_cfg(path)
        assert sorted(i for i in tt if ir.nodes[i].kernel == 1) == [
            227, 236, 244, 246, 254, 256, 265, 267, 276, 278]


def test_quant_weight_bit_exact():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 3, 24, 16)) * 0.1).astype(np.float32)
    w[..., 3] = 0.0                               # an all-zero channel
    w[0, 0, 0, 5] = 2.0                           # one dominant weight
    jwq, jsw = JQ._quant_weight(jnp.asarray(w))
    twq, tsw = TQ._quant_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(twq.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jwq))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    b = rng.standard_normal(16).astype(np.float32)
    jp = JQ._qconv_params({"w": jnp.asarray(w), "b": jnp.asarray(b)}, 3.7)
    tp = TQ._qconv_params({"w": torch.from_numpy(w).permute(3, 2, 0, 1),
                           "b": torch.from_numpy(b)}, 3.7)
    np.testing.assert_array_equal(tp["scale"].numpy(),
                                  np.asarray(jp["scale"]))
    assert tp["inv_sx"] == jp["inv_sx"]


# ------------------------------------------------- the narrowed flagship


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """(jax ir, jax folded, port ir, the same folded params in the port's
    layout (CPU fp32), 2 calibration batches (numpy NHWC), jax stats, jax
    variables). The port gets JAX's folded params, not its own fold, so
    that quantize sees bit-identical weights (the two folds may differ in
    the last bit)."""
    cfg = write_narrow_flagship(tmp_path_factory.mktemp("flagship"))
    jir, tir = jax_compile_cfg(cfg), compile_cfg(cfg)
    jv = flagship_variables(jir)
    jfold = JG.fold_batchnorm(jir, jv)
    tfold = TW.from_jax_variables(tir, jax.device_get(jfold))
    rng = np.random.default_rng(4)
    batches = [tuple(rng.random((2, 64, 96, 3), dtype=np.float32)
                     for _ in range(2)) for _ in range(2)]
    jstats = JQ.calibrate(jir, jfold, [tuple(map(jnp.asarray, b))
                                       for b in batches],
                          compute_dtype=jnp.float32)
    return jir, jfold, tir, tfold, batches, jstats, jv


def _port_batches(batches):
    return [tuple(map(torch.from_numpy, b)) for b in batches]


def _hold_stats(stats, want):
    """Every key of JAX's stats: each per-tensor input amax within 1e-5
    relative; each per-channel ``l<i>.out`` vector within 1e-5 relative
    or 1e-5 of its largest entry (a channel far below the tensor's max
    carries the fp32 drift of the forward to that depth, as the max
    does)."""
    assert sorted(stats) == sorted(want)
    assert any(k.endswith(".out") for k in want)
    for k in want:
        if k.endswith(".out"):
            assert stats[k].shape == np.shape(want[k]), k
            atol = 1e-5 * float(np.max(want[k]))
        else:
            assert isinstance(stats[k], float), k
            atol = 0.0
        np.testing.assert_allclose(stats[k], want[k], rtol=1e-5, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("pct", [100.0, 99.9])
def test_calibrate_matches_jax_tiny(pct):
    jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    jv = _perturb_bn(jax.tree.map(lambda a: np.array(a),
                                  JG.init(jir, jax.random.PRNGKey(0))))
    rng = np.random.default_rng(1)
    batches = [tuple(rng.random((2, 64, 64, 3), dtype=np.float32)
                     for _ in range(2)) for _ in range(2)]
    jstats = JQ.calibrate(jir, JG.fold_batchnorm(jir, jv),
                          [tuple(map(jnp.asarray, b)) for b in batches],
                          compute_dtype=jnp.float32, pct=pct)
    folded = TG.place_folded(tir, TG.fold_batchnorm(
        tir, TW.from_jax_variables(tir, jv)), "cpu", torch.float32)
    stats = TQ.calibrate(tir, folded, _port_batches(batches),
                         compute_dtype=torch.float32, pct=pct)
    _hold_stats(stats, jstats)


def test_calibrate_matches_jax_flagship(flagship):
    _, _, tir, tfold, batches, jstats, _ = flagship
    folded = TG.place_folded(tir, tfold, "cpu", torch.float32)
    stats = TQ.calibrate(tir, folded, _port_batches(batches),
                         compute_dtype=torch.float32)
    _hold_stats(stats, jstats)


def _quantized_pair(flagship, monkeypatch, mode="chain"):
    """JAX's and the port's quantize() of the narrowed flagship, given the
    same stats and the same folded params."""
    jir, jfold, tir, tfold, _, jstats, _ = flagship
    monkeypatch.setattr(JG, "_S2D_REGION", False)
    jq = JQ.quantize(jir, jfold, jstats, mode=mode)["params"]
    tq = TQ.quantize(tir, tfold, jstats, mode=mode)["params"]
    return jq, tq


def _flat(tree, prefix="", convert=True):
    """{"a/b/c": leaf} of a nested dict, the leaves as numpy arrays unless
    ``convert`` is False."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/", convert))
        else:
            out[prefix + k] = np.asarray(v) if convert else v
    return out


def test_quantize_matches_jax(flagship, monkeypatch):
    jq, tq = _quantized_pair(flagship, monkeypatch)
    assert sorted(jq) == sorted(tq)
    n_q = n_emit = 0
    for key, ent in tq.items():
        assert sorted(ent) == sorted(jq[key]), key
        if "q" not in ent:
            continue
        mine, ref = ent["q"], jq[key]["q"]
        assert sorted(mine) == sorted(ref), key
        np.testing.assert_array_equal(
            mine["wq"].permute(2, 3, 1, 0).numpy(), np.asarray(ref["wq"]))
        np.testing.assert_array_equal(mine["scale"].numpy(),
                                      np.asarray(ref["scale"]))
        assert mine["inv_sx"] == ref["inv_sx"], key
        if "out_inv_s" in ref:
            assert mine["out_inv_s"] == ref["out_inv_s"], key
            n_emit += 1
        n_q += 1
    assert (n_q, n_emit) == (80, 15)


def test_place_quantized_packs_gemm_weights(flagship, monkeypatch):
    """Every quantized 1x1 conv is placed with K4's packed weights (the
    (N, K) form of its int8 kernel, contiguous, made once), every kxk one
    with the im2col matrix; scale and bias are contiguous fp32."""
    _, _, tir, _, _, _, _ = flagship
    _, tq = _quantized_pair(flagship, monkeypatch)
    qp = TQ.place_quantized(tir, {"params": tq}, "cpu",
                            torch.float32)["params"]
    n_gemm = n_kxk = 0
    for key, ent in tq.items():
        if "q" not in ent:
            continue
        node, placed = tir.nodes[int(key[1:])], qp[key]["q"]
        wq = ent["q"]["wq"]                        # (O, I, kh, kw) s8
        if TQ._gemm_conv(node):
            assert "w_nk" not in placed and "w_kn" not in placed
            packed = placed["k4"]
            assert packed.shape == (node.out_ch, node.in_ch)
            assert packed.is_contiguous() and packed.dtype == torch.int8
            assert torch.equal(packed, wq[:, :, 0, 0])
            n_gemm += 1
        else:
            assert "k4" not in placed
            w_nk = wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)
            n, k = w_nk.shape
            # zero-padded to multiples of 16 for the card's int8 GEMM
            assert placed["w_nk"].shape == (-(-n // 16) * 16,
                                            -(-k // 16) * 16)
            assert torch.equal(placed["w_nk"][:n, :k], w_nk)
            assert not placed["w_nk"][n:].any()
            assert not placed["w_nk"][:, k:].any()
            n_kxk += 1
        for name in ("scale", "b"):
            assert placed[name].dtype == torch.float32
            assert placed[name].is_contiguous()
    assert (n_gemm, n_kxk) == (10, 70)


def test_every_qconv_matches_jax(flagship, monkeypatch):
    """Each of the 80 quantized convs, port vs JAX (``_qconv``), on the same
    fp32 input (the conv's input in the fp forward): fp outputs within
    1e-6 relative + 1e-6 (JAX may contract the dequant multiply-add into an
    FMA); requantized s8 outputs within one step on under 1% of elements."""
    jir, _, tir, tfold, batches, _, _ = flagship
    jq, tq = _quantized_pair(flagship, monkeypatch)
    qp = TQ.place_quantized(tir, {"params": tq}, "cpu",
                            torch.float32)["params"]
    targets, emits = TQ.plan_quantization(tir, "chain")
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
    for i in sorted(targets):
        node = tir.nodes[i]
        x = inputs[i]
        ref = np.asarray(JQ._qconv(
            jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jq[f"l{i}"]["q"],
            stride=node.stride, pad=node.pad, groups=node.groups,
            act=node.act, out_dtype=jnp.float32))
        got = TQ.qconv(node, x, qp[f"l{i}"]["q"], torch.float32)
        got = got.permute(0, 2, 3, 1).numpy()
        if i in emits:
            assert got.dtype == np.int8
            diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() < 0.01, i
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                       err_msg=f"l{i}")


def test_apply_quantized_matches_jax(flagship, monkeypatch):
    """The whole int8 forward, port vs JAX, fp32, same qvars. Each conv
    agrees to an ulp (test_every_qconv_matches_jax), but an ulp that lands
    on a quantizer's rounding boundary moves that value by one int8 step,
    and such steps compound through the 80 quantized convs. So: the median
    raw-head difference under 1e-3, and the mean under 0.75 of the mean
    quantization error (JAX int8 against JAX fp32); a wrong scale or
    layout gives differences far above that."""
    _hold_forward(flagship, monkeypatch, "chain", median=1e-3)


def _hold_forward(flagship, monkeypatch, mode, median):
    """Port vs JAX int8 forward of ``mode`` on the same qvars, fp32: each
    raw head's median difference under ``median`` (an absolute bound, or
    a callable of the mean quantization error), its mean under 0.75 of
    that error (JAX int8 against JAX fp32)."""
    jir, jfold, tir, _, batches, _, _ = flagship
    jq, tq = _quantized_pair(flagship, monkeypatch, mode)
    xv, xl = batches[0]
    args = (jnp.asarray(xv), jnp.asarray(xl))
    _, jraw = jax.jit(lambda q, a, b: JQ.apply_quantized(
        jir, q, a, b, compute_dtype=jnp.float32, mode=mode))(
            {"params": jq}, *args)
    _, fraw = jax.jit(lambda f, a, b: JG.apply_folded(
        jir, f, a, b, compute_dtype=jnp.float32))(jfold, *args)
    qp = TQ.place_quantized(tir, {"params": tq}, "cpu", torch.float32)
    io, raw = TQ.apply_quantized(tir, qp, torch.from_numpy(xv),
                                 torch.from_numpy(xl),
                                 compute_dtype=torch.float32, mode=mode)
    assert io.dtype == torch.float32 and torch.isfinite(io).all()
    for mine, ref, fp in zip(raw, jraw, fraw):
        ref, fp = np.asarray(ref), np.asarray(fp)
        d = np.abs(mine.numpy() - ref)
        q_err = np.abs(ref - fp).mean()
        assert q_err > 1e-3                  # int8 is not the fp forward
        bound = median(q_err) if callable(median) else median
        assert np.median(d) < bound, (np.median(d), bound)
        assert d.mean() < 0.75 * q_err, (d.mean(), q_err)


def _match_rate(mine, ref, min_score=0.1):
    """Share of ``ref``'s detections scoring >= min_score that ``mine``
    matches: same class, IoU >= 0.8, score within 0.1."""
    hit = total = 0
    for (b, s, c), (rb, rs, rc) in zip(mine, ref):
        for box, score, cls in zip(rb, rs, rc):
            if score < min_score:
                continue
            total += 1
            if not len(b):
                continue
            lt = np.maximum(b[:, :2], box[:2])
            rb2 = np.minimum(b[:, 2:], box[2:])
            inter = np.prod(np.clip(rb2 - lt, 0, None), axis=1)
            area = np.prod(b[:, 2:] - b[:, :2], axis=1)
            iou = inter / (area + np.prod(box[2:] - box[:2]) - inter)
            ok = (iou >= 0.8) & (np.abs(s - score) < 0.1) & (c == cls)
            hit += bool(ok.any())
    return hit, total


def test_int8_predictor_matches_jax(flagship, monkeypatch):
    """Two calibration requests, then int8 requests, 3 frames padded into a
    bucket of 4; each side calibrates itself. The int8 steps compound as in
    test_apply_quantized_matches_jax, so detections are matched: at least
    90% of JAX's detections scoring >= 0.1 have a port detection of the
    same class with IoU >= 0.8 and a score within 0.1 (80 of 82 on the
    CPU when the bound was set). The first request
    (fp32, before quantization) matches exactly as in test_torch_slice."""
    jir, _, tir, _, _, _, jv = flagship
    monkeypatch.setattr(JG, "_S2D_REGION", False)
    kw = dict(img_size=96, conf_thres=0.01, batch_buckets=(4,), int8=True)
    rng = np.random.default_rng(7)
    reqs = [tuple(rng.integers(0, 256, (3, 64, 96, 3), dtype=np.uint8)
                  for _ in range(2)) for _ in range(3)]
    jp = JaxPredictor(jir, jv, compute_dtype=jnp.float32, **kw)
    tp = Predictor(tir, TW.from_jax_variables(tir, jv),
                   compute_dtype=torch.float32, device="cpu", **kw)
    hit = total = 0
    for i, (v, l) in enumerate(reqs):
        ref, mine = jp(v, l), tp(v, l)
        assert len(mine) == len(ref) == 3
        assert (tp.qvars is not None) == (i >= 1)
        if i == 0:
            for (b, s, c), (rb, rs, rc) in zip(mine, ref):
                np.testing.assert_allclose(b, rb, rtol=1e-4, atol=1e-3)
                np.testing.assert_allclose(s, rs, rtol=1e-4, atol=1e-3)
            continue
        h, t = _match_rate(mine, ref)
        hit, total = hit + h, total + t
    print(f"int8 detections matched: {hit} of {total}")
    assert total > 0 and hit >= 0.9 * total


def test_int8_predictor_empty_plan_serves_bf16():
    """MNv3's plan is empty: int8=True warns and serves compute_dtype."""
    ir = compile_cfg(MNV3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pred = Predictor(ir, TW.load_state_dict_npz(ir, NPZ), img_size=96,
                         int8=True, compute_dtype=torch.float32,
                         device="cpu")
    assert any("int8 plan" in str(w.message) for w in caught)
    assert not pred._int8
    frames = np.zeros((1, 64, 96, 3), np.uint8)
    pred(frames, frames)
    assert pred.qvars is None and not pred._cal_batches


def test_warmup_takes_no_calibration_slot(flagship):
    _, _, tir, tfold, _, _, jv = flagship
    pred = Predictor(tir, TW.from_jax_variables(tir, jv), img_size=96,
                     int8=True, compute_dtype=torch.float32, device="cpu",
                     batch_buckets=(2,))
    pred.warmup((64, 96), batch=2)
    assert not pred._cal_batches and pred.qvars is None
