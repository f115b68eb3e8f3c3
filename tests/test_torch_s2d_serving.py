"""The int8 forwards and their callers at the JAX package's defaults
(``DYK_S2D_REGION=1``, ``DYK_FUSE_STEM=1``, ``hw`` set), on the CPU:

  * ``apply_quantized`` in ``spine`` and ``edge``, with and without int8
    stems, on the narrowed flagship of tests/test_torch_s2d.py at 128x128
    (its s2d plan there: 32 convs, 4 int8 adds in ``spine``), calibrated
    on the frames it runs, against JAX's jitted forward, which computes
    the planned convs in the s2d basis and the stem pairs fused: to the
    whole-int8 bounds of tests/test_torch_quantize_modes.py (the int8
    steps compound, so the heads are held statistically; the per-conv
    holds are in tests/test_torch_s2d.py);
  * the Predictor serves JAX's default artifact and refuses one prepared
    for a size whose s2d plan differs from its own (JAX serving.py:163-187);
  * the evaluator quantizes for a rect dataset's batch shape (JAX
    evaluator.py:108-117).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from double_yolo_kaist_tpu.data.dataset import KaistDataset as JaxDataset
from double_yolo_kaist_tpu.models import graph as JG
from double_yolo_kaist_tpu.models import quantize as JQ
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.data.dataset import KaistDataset
from double_yolo_kaist_torch.eval import evaluator as TE
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import quantize as TQ
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.serving import Predictor
from tests.test_torch_dataset import random_frames, write_split
from tests.test_torch_quantize import one_thread
from tests.test_torch_s2d import (_depth_to_space, _nhwc, _pair, _save_jax,
                                  _space_to_depth, flagship)  # noqa: F401
from tests.test_torch_slice import TINY, flagship_variables

_one_thread = pytest.fixture(autouse=True)(one_thread)
HW = (128, 128)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(8)
    return tuple(rng.random((1,) + HW + (3,), dtype=np.float32)
                 for _ in range(2))


@pytest.fixture(scope="module")
def calibrated(flagship, frames):
    """The flagship tuple with stats the port calibrates on ``frames``
    (fp32, 128x128): the whole forwards run on their calibration batch, as
    tests/test_torch_quantize.py's do."""
    tir, tfold = flagship[2:4]
    stats = TQ.calibrate(tir, TG.place_folded(tir, tfold, "cpu",
                                              torch.float32),
                         [tuple(map(torch.from_numpy, frames))],
                         compute_dtype=torch.float32)
    return flagship[:4] + (stats,)


@pytest.fixture(scope="module")
def fp_heads(flagship, frames):
    """JAX's fp32 forward of the frames: the reference of the int8 error."""
    jir, jfold = flagship[:2]
    _, raw = jax.jit(lambda f, a, b: JG.apply_folded(
        jir, f, a, b, compute_dtype=jnp.float32))(
            jfold, *map(jnp.asarray, frames))
    return [np.asarray(r) for r in raw]


def _int8_heads(calibrated, frames, mode, hw, stems=False):
    """(port's raw heads, JAX's raw heads) of the int8 forward of ``mode``,
    each package's own quantize of the same fold and stats for ``hw``."""
    jir, tir = calibrated[0], calibrated[2]
    jq, tq = _pair(calibrated, mode, hw, stems)
    _, jraw = jax.jit(lambda q, a, b: JQ.apply_quantized(
        jir, q, a, b, compute_dtype=jnp.float32, mode=mode))(
            jq, *map(jnp.asarray, frames))
    qp = TQ.place_quantized(tir, tq, "cpu", torch.float32)
    io, raw = TQ.apply_quantized(tir, qp, *map(torch.from_numpy, frames),
                                 compute_dtype=torch.float32, mode=mode)
    assert io.dtype == torch.float32 and torch.isfinite(io).all()
    return [r.numpy() for r in raw], [np.asarray(r) for r in jraw], tq


@pytest.fixture(scope="module")
def chain_floor(calibrated, frames):
    """The port-against-JAX differences of the parent's int8 path on the
    same frames, its three raw heads pooled: ``chain``, no ``hw``, the s2d
    regions off in both packages, as tests/test_torch_quantize.py's
    test_apply_quantized_matches_jax runs it (there, on its own batch at
    64x96, to a 1e-3 median)."""
    saved = JG._S2D_REGION, TG._S2D_REGION
    JG._S2D_REGION = TG._S2D_REGION = False
    try:
        mine, ref, _ = _int8_heads(calibrated, frames, "chain", None)
    finally:
        JG._S2D_REGION, TG._S2D_REGION = saved
    return _pooled(mine, ref)


def _pooled(mine, ref):
    return np.concatenate([np.abs(m - r).ravel() for m, r in zip(mine, ref)])


@pytest.mark.parametrize("stems", [False, True], ids=["fpstem", "int8stem"])
@pytest.mark.parametrize("mode", ["spine", "edge"])
def test_apply_quantized_at_jax_defaults(calibrated, frames, fp_heads,
                                         chain_floor, mode, stems):
    """The whole int8 forward, port against JAX at its defaults, fp32, the
    same quantization (each side's own quantize of the same fold and
    stats, equal leaf for leaf), on the calibration batch. JAX computes the
    planned convs in the s2d basis and the stem pairs fused, the port in
    the plain basis.

    edge: test_apply_quantized_new_modes_match_jax's bounds, each raw
    head's median difference under 0.6 of the mean quantization error (JAX
    int8 against JAX fp32; its mish outputs round an ulp apart from XLA's,
    as that test shows), the mean under 0.75 of it.

    spine: each conv agrees with JAX's to an ulp (tests/test_torch_s2d.py),
    but at 128x128 an ulp moves codes here: the fp32 stem convs of torch
    and XLA differ by 4e-7 at the first int8 conv's input, which flips
    0.4% of its output codes, and the flips compound through the int8
    convs. The parent's chain path, with no plan at all, differs from JAX
    on these frames by a median of 0.059-0.074 (about 0.8 of the
    quantization error) and a mean above that error, so the 1e-3 median
    that the 64x96 batch of tests/test_torch_quantize.py allows does not
    hold for any mode here: one flipped code moves the heads by about the
    quantization error (a one-ulp nudge of every pixel moves the port's own
    chain heads by a median of 0.061). spine is held to that path's
    difference on the same frames (``chain_floor``), the three heads
    pooled: median and mean each under 1.25 of it."""
    mine, ref, tq = _int8_heads(calibrated, frames, mode, HW, stems)
    assert sum("spine" in e for e in tq["params"].values()) == (
        4 if mode == "spine" else 0)
    for m, r, fp in zip(mine, ref, fp_heads):
        q_err = np.abs(r - fp).mean()
        assert q_err > 1e-3                  # int8 is not the fp forward
        if mode == "edge":
            d = np.abs(m - r)
            assert np.median(d) < 0.6 * q_err, (np.median(d), q_err)
            assert d.mean() < 0.75 * q_err, (d.mean(), q_err)
    if mode == "spine":
        d = _pooled(mine, ref)
        assert np.median(d) < max(1e-3, 1.25 * np.median(chain_floor)), (
            np.median(d), np.median(chain_floor))
        assert d.mean() < 1.25 * chain_floor.mean(), (d.mean(),
                                                      chain_floor.mean())


def test_spine_walk_equals_jax_op_by_op(calibrated, frames, monkeypatch):
    """spine at JAX's defaults on the calibration batch, each step of the
    port's own forward held against JAX's op on the same input, so that
    no flipped code upstream hides a difference (the whole-forward test
    above can only hold the heads to about the quantization error): each
    int8 conv against ``_qconv`` or, planned, ``_qconv_s2d`` in the s2d
    basis (its input in the basis, its output back to plain): fp outputs
    within 1e-6 relative + 1e-6 (test_every_qconv_matches_jax's rule; the
    s2d epilogue's scale is within two ulps of the port's), requantized s8
    within one step on under 1% of elements; each int8 add's codes equal
    to JAX's round-and-clip of the same sum with its ``inv_sy``, bit for
    bit, and its scale JAX's ``sy``."""
    jir, tir = calibrated[0], calibrated[2]
    jq, tq = _pair(calibrated, "spine", HW)
    jp = jq["params"]
    plan = TG.s2d_plan(tir, *HW)
    seen = {"conv": 0, "plan": 0, "add": 0}
    orig_qconv, orig_run = TQ.qconv, TG.run_graph

    def qconv(node, x, qp, out_dtype):
        got = orig_qconv(node, x, qp, out_dtype)
        e = jp[f"l{node.index}"]
        role = plan.get(node.index)
        if role is None:
            ref = JQ._qconv(_nhwc(x), e["q"], stride=node.stride,
                            pad=node.pad, groups=node.groups, act=node.act,
                            out_dtype=jnp.float32)
            ref = torch.from_numpy(np.array(ref)).permute(0, 3, 1, 2)
        else:
            inp = x if role in ("e1", "e3") else _space_to_depth(x)
            ref = JQ._qconv_s2d(_nhwc(inp), e["q"], e["fp"], role,
                                act=node.act, out_dtype=jnp.float32)
            ref = torch.from_numpy(np.array(ref)).permute(0, 3, 1, 2)
            ref = ref if role == "x3" else _depth_to_space(ref)
            seen["plan"] += 1
        seen["conv"] += 1
        assert got.dtype == ref.dtype and got.shape == ref.shape, node.index
        if got.dtype == torch.int8:
            diff = (got.int() - ref.int()).abs()
            assert diff.max() <= 1, node.index
            assert (diff != 0).float().mean() < 0.01, node.index
        else:
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6,
                                       msg=f"l{node.index}")
        return got

    def run_graph(*args, after, **kw):
        def held(node, x):
            y = after(node, x)
            sp = jp.get(f"l{node.index}", {}).get("spine")
            if sp is not None:
                want = jnp.clip(jnp.round(
                    _nhwc(x) * jnp.asarray(sp["inv_sy"], jnp.float32)),
                    -127, 127).astype(jnp.int8)
                assert torch.equal(y.q.permute(0, 2, 3, 1),
                                   torch.from_numpy(np.array(want)))
                assert y.s == float(sp["sy"])
                seen["add"] += 1
            return y
        return orig_run(*args, after=held, **kw)

    monkeypatch.setattr(TQ, "qconv", qconv)
    monkeypatch.setattr(TG, "run_graph", run_graph)
    qp = TQ.place_quantized(tir, tq, "cpu", torch.float32)
    TQ.apply_quantized(tir, qp, *map(torch.from_numpy, frames),
                       compute_dtype=torch.float32, mode="spine")
    n_q = sum("q" in e for e in tq["params"].values())
    n_plan = sum("q" in tq["params"][f"l{i}"] for i in plan
                 if f"l{i}" in tq["params"])
    assert seen == {"conv": n_q, "plan": n_plan, "add": 4}, seen


@pytest.mark.parametrize("fuse_stem", [True, False],
                         ids=["stem_on", "stem_off"])
def test_stems_run_int8_where_quantized(flagship, frames, monkeypatch,
                                        fuse_stem):
    """With int8 stems the pair runs as two int8 im2col convs (no K3, no
    fp stem conv); without, as fp convs, the second through K3's plain
    version. With the stem switch off where the artifact is served (JAX's
    executors take ``_q_fused_stem`` only for ``stem_pairs``, empty then),
    an int8-stem artifact runs its stems as fp convs and gives the heads of
    the same artifact without its int8 stems, bit for bit."""
    tir = flagship[2]
    seen = []
    orig = TG.conv_folded

    def spy(node, inp, p):
        seen.append(node.index)
        return orig(node, inp, p)

    pairs = TG.stem_fusion_pairs(tir)
    stem_convs = set(pairs) | set(pairs.values())
    qvars = {stems: _pair(flagship, "chain", HW, stems)[1]
             for stems in (False, True)}
    monkeypatch.setattr(TG, "_FUSE_STEM", fuse_stem)
    heads = {}
    for stems, tq in qvars.items():
        seen.clear()
        qp = TQ.place_quantized(tir, tq, "cpu", torch.float32)
        monkeypatch.setattr(TG, "conv_folded", spy)
        _, heads[stems] = TQ.apply_quantized(
            tir, qp, *map(torch.from_numpy, frames),
            compute_dtype=torch.float32, mode="chain")
        monkeypatch.setattr(TG, "conv_folded", orig)
        int8 = stems and fuse_stem
        assert stem_convs & set(seen) == (set() if int8 else stem_convs)
    same = [torch.equal(a, b) for a, b in zip(heads[False], heads[True])]
    assert all(same) == (not fuse_stem), same


def _frames_u8(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (2,) + HW + (3,), dtype=np.uint8)
                 for _ in range(2))


@pytest.mark.parametrize("mode", ["spine", "edge"])
def test_predictor_serves_jax_default_artifact(flagship, tmp_path, mode):
    """JAX's default artifact (hw, int8 stems) served by the Predictor: the
    detections of the port's own artifact of the same quantization, bit
    for bit."""
    jir, _, tir, tfold, stats = flagship
    tv = TW.from_jax_variables(tir, flagship_variables(jir))
    path, mine = str(tmp_path / "q.npz"), str(tmp_path / "t.npz")
    _save_jax(flagship, path, mode, HW, True)
    TQ.save_quantized(mine, TQ.quantize(tir, tfold, stats, mode=mode, hw=HW,
                                        int8_stems=True), mode=mode, hw=HW)
    kw = dict(img_size=HW[0], int8=True, int8_mode=mode, device="cpu",
              compute_dtype=torch.float32, batch_buckets=(2,),
              conf_thres=0.01)
    served = Predictor(tir, tv, quantized=path, **kw)
    own = Predictor(tir, tv, quantized=mine, **kw)
    assert served.qvars is not None and own.qvars is not None
    got, want = served(*_frames_u8(1)), own(*_frames_u8(1))
    assert sum(len(s) for _, s, _ in want) > 0
    for (b, s, c), (rb, rs, rc) in zip(got, want):
        np.testing.assert_array_equal(b, rb)
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(c, rc)


def test_predictor_s2d_plan_check(flagship, tmp_path, monkeypatch):
    """As JAX's Predictor: a chain artifact prepared for a size whose s2d
    plan differs from the server's (64x96: 14 planned convs, 128x128: 32)
    is refused; one whose plan is the server's (192x256) serves; with
    ``_S2D_REGION`` off no size is checked."""
    jir, _, tir, tfold, stats = flagship
    tv = TW.from_jax_variables(tir, flagship_variables(jir))
    assert TG.s2d_plan(tir, 64, 96) != TG.s2d_plan(tir, *HW)
    assert TG.s2d_plan(tir, 192, 256) == TG.s2d_plan(tir, *HW)
    kw = dict(img_size=HW[0], int8=True, int8_mode="chain", device="cpu")
    paths = {}
    for hw in ((64, 96), (192, 256)):
        paths[hw] = str(tmp_path / f"q{hw[0]}.npz")
        TQ.save_quantized(paths[hw], TQ.quantize(tir, tfold, stats,
                                                 mode="chain", hw=hw),
                          mode="chain", hw=hw)
    with pytest.raises(ValueError, match="s2d plans differ"):
        Predictor(tir, tv, quantized=paths[(64, 96)], **kw)
    assert Predictor(tir, tv, quantized=paths[(192, 256)],
                     **kw).qvars is not None
    monkeypatch.setattr(TG, "_S2D_REGION", False)
    assert Predictor(tir, tv, quantized=paths[(64, 96)],
                     **kw).qvars is not None


@pytest.mark.parametrize("rect", [True, False])
def test_evaluator_quantizes_for_the_batch_shape(tmp_path, monkeypatch,
                                                 rect):
    """The evaluator's int8 path quantizes for JAX's ``_prepare_hw``: a
    rect dataset's first batch shape (64x96 frames at img-size 96), else
    (img_size, img_size)."""
    ir = compile_cfg(TINY, yolo_strides=[8, 4])
    tv = TG.init(ir, 0)
    path = write_split(tmp_path, random_frames(np.random.default_rng(3), 4,
                                               (64, 96)))
    want = (tuple(int(x) for x in JaxDataset(path, 96, 4,
                                             rect=True).batch_shapes[0])
            if rect else (96, 96))
    ds = KaistDataset(path, 96, 4, rect=rect)
    assert TE._prepare_hw(ds) == want
    seen = []
    quantize = TQ.quantize

    def spy(*a, **kw):
        seen.append(kw.get("hw"))
        return quantize(*a, **kw)

    monkeypatch.setattr(TQ, "quantize", spy)
    res = TE.evaluate_dataset(ir, tv, ds, batch_size=4, int8=True,
                              int8_mode="spine", calibration_batches=1,
                              compute_dtype=torch.float32, device="cpu")
    assert seen == [want] and np.isfinite(res["ap"])
