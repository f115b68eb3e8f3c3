"""The JAX package's inference rewrites at its defaults (``DYK_S2D_REGION=1``,
``DYK_FUSE_STEM=1``, ``hw`` set): the port's s2d planner, the int8 plans
it sets, the s2d and int8-stem leaves of the artifacts, and the int8
stem pair, on the CPU against the JAX package.

What is held, and to what:
  * the s2d transforms of models/layers.py (every role, the stem pair's
    kernels): equal to JAX's; each transformed kernel, run here in the s2d
    basis as JAX runs it, computes the plain conv (the port itself runs
    every conv in the plain basis);
  * plans, pure IR: for all 25 detection cfgs at 512x640, 512x512 and
    416x512, at JAX's defaults and with each switch off, ``s2d_plan``,
    ``s2d_basis``, the stem pairs, ``s2d_candidates``,
    ``plan_quantization`` in every mode with the plan, the spine adds and
    ``plan_edges(ir, hw)`` equal JAX's; the counts of the four models with
    regions (F8: the parent's planner dropped the plan);
  * ``quantize(hw=, int8_stems=)`` on the narrowed flagship (every
    ``filters=`` divided by 4 but the heads') in chain, spine, spineall and
    edge: every leaf in the JAX layout bit for bit;
  * the artifacts: JAX's default artifacts (hw, int8 stems, bf16) load
    in the port and equal its own quantization; the port's load in JAX,
    whose executor then takes its precomputed s2d kernels; an artifact
    whose s2d or stem kernels are not the transforms of its plain ones is
    refused, naming the leaf;
  * per conv: each planned int8 conv in the port's plain basis against
    JAX's ``_qconv_s2d`` / ``_qconv_s2d_e`` (after depth-to-space): the
    int32 sums the same integers, the epilogue scales within two ulps
    (JAX rebuilds the input scale from its inverse), the fp32 outputs
    within what that moves; the int8 stem pair against
    ``_q_fused_stem``: exact with leaky; with mish within 1e-4 but where
    an ulp of mish moved a mid code by a step.
The whole forwards and the serving checks are in
tests/test_torch_s2d_serving.py.
"""

import dataclasses
import glob
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
from double_yolo_kaist_tpu.models import graph as JG
from double_yolo_kaist_tpu.models import layers as JL
from double_yolo_kaist_tpu.models import quantize as JQ
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import layers as TL
from double_yolo_kaist_torch.models import quantize as TQ
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.ops import qgemm as K4
from tests.test_torch_quantize import _flat, _port_batches, one_thread
from tests.test_torch_slice import flagship_variables, write_narrow_flagship

_one_thread = pytest.fixture(autouse=True)(one_thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
DETECTION_CFGS = sorted(os.path.basename(p) for p in
                        glob.glob(str(REPO / "configs" / "kaist_*.cfg")))
SIZES = ((512, 640), (512, 512), (416, 512))
ROLES = ("e1", "e3", "i1", "i3", "x3")
# hw of the narrowed flagship's quantizations: (64, 96) plans 14 convs and
# no spine add (its first stage is too thin), (128, 128) 32 convs, 4 adds
HWS = ((64, 96), (128, 128))


def _hwio(t):
    return t.permute(2, 3, 1, 0).numpy()


def _oihw(a):
    return torch.from_numpy(np.asarray(a)).permute(3, 2, 0, 1)


def _nhwc(t):
    return jnp.asarray(t.permute(0, 2, 3, 1).numpy())


# ------------------------------------------------------------- transforms
#
# The s2d-basis executors of JAX layers.py:164-200 and :268-285, in the
# test only: they show that the transforms the artifacts hold compute the
# plain convs.


def _space_to_depth(x):
    """(B, C, H, W) -> the phase-minor basis (B, 4C, H/2, W/2)."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 1, 3, 5, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def _depth_to_space(x):
    b, c4, h, w = x.shape
    return x.reshape(b, c4 // 4, 2, 2, h, w).permute(
        0, 1, 4, 2, 5, 3).reshape(b, c4 // 4, 2 * h, 2 * w)


def _s2d_conv(x, w, b, act, role):
    """One planned conv in the s2d basis, + bias + activation."""
    s, ((pt, pb), (pl, pr)) = TL._S2D_GEOM[role]
    y = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x, (pl, pr, pt, pb)), TL._s2d_w(w, role),
        TL.s2d_bias(b, role), stride=s)
    return TL.activate(act, y)


def _fused_stem_pair(x, w1, b1, act1, w2, b2, act2):
    """The stem pair as a 4x4 stride-2 conv on the image padded (1, 2)
    into the phase-major basis, then a 2x2 stride-1 conv padded (1, 0)."""
    wb, w2s = TL.stem_pair_weights(w1, w2)
    pad = torch.nn.functional.pad
    y1 = TL.activate(act1, torch.nn.functional.conv2d(
        pad(x, (1, 2, 1, 2)), wb, b1.repeat(4), stride=2))
    return TL.activate(act2, torch.nn.functional.conv2d(
        pad(y1, (1, 0, 1, 0)), w2s, b2))


@pytest.mark.parametrize("role", ROLES)
def test_s2d_kernels_equal_jax_and_compute_the_plain_conv(role):
    """layers._s2d_w of a float and an int8 kernel equals JAX's; the conv
    in the s2d basis (``_s2d_conv``) equals the plain conv, fp64."""
    rng = np.random.default_rng(ROLES.index(role))
    k = 1 if role in ("e1", "i1") else 3
    w = rng.standard_normal((k, k, 6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_array_equal(_hwio(TL._s2d_w(_oihw(w), role)),
                                  np.asarray(JL._s2d_w(jnp.asarray(w), role)))
    wq = rng.integers(-127, 128, w.shape).astype(np.int8)
    np.testing.assert_array_equal(
        _hwio(TL._s2d_w(_oihw(wq), role)),
        np.asarray(JL._s2d_w(jnp.asarray(wq), role)))
    x = torch.from_numpy(rng.standard_normal((2, 6, 12, 16)))
    tw, tb = _oihw(w).double(), torch.from_numpy(b).double()
    stride = 2 if role == "x3" else 1
    plain = TL.activate("leaky", TL.conv2d(x, tw, tb, stride=(stride,) * 2,
                                           pad=k // 2))
    inp = x if role in ("e1", "e3") else _space_to_depth(x)
    got = _s2d_conv(inp, tw, tb, "leaky", role)
    if role != "x3":
        got = _depth_to_space(got)
    torch.testing.assert_close(got, plain, rtol=1e-12, atol=1e-12)
    assert torch.equal(_depth_to_space(_space_to_depth(x)), x)


def test_stem_pair_kernels_equal_jax_and_compute_the_pair():
    rng = np.random.default_rng(7)
    w1 = rng.standard_normal((3, 3, 3, 8)).astype(np.float32)
    w2 = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    b1, b2 = (rng.standard_normal(n).astype(np.float32) for n in (8, 16))
    jwb, jw2s = JL.stem_pair_weights(jnp.asarray(w1), jnp.asarray(w2))
    twb, tw2s = TL.stem_pair_weights(_oihw(w1), _oihw(w2))
    np.testing.assert_array_equal(_hwio(twb), np.asarray(jwb))
    np.testing.assert_array_equal(_hwio(tw2s), np.asarray(jw2s))
    x = torch.from_numpy(rng.random((2, 3, 16, 24)))
    t1, t2 = _oihw(w1).double(), _oihw(w2).double()
    c1, c2 = torch.from_numpy(b1).double(), torch.from_numpy(b2).double()
    plain = TL.activate("mish", TL.conv2d(TL.activate(
        "leaky", TL.conv2d(x, t1, c1, pad=1)), t2, c2, stride=(2, 2), pad=1))
    got = _fused_stem_pair(x, t1, c1, "leaky", t2, c2, "mish")
    torch.testing.assert_close(got, plain, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ plans


def _switches(monkeypatch, s2d: bool, stem: bool):
    for g in (JG, TG):
        monkeypatch.setattr(g, "_S2D_REGION", s2d)
        monkeypatch.setattr(g, "_FUSE_STEM", stem)


@pytest.mark.parametrize("switches", ["defaults", "s2d_off", "stem_off"])
@pytest.mark.parametrize("name", DETECTION_CFGS)
def test_plans_equal_jax(name, switches, monkeypatch):
    _switches(monkeypatch, switches != "s2d_off", switches != "stem_off")
    path = str(REPO / "configs" / name)
    jir, tir = jax_compile_cfg(path), compile_cfg(path)
    jpairs = JG.stem_fusion_pairs(jir) if JG._FUSE_STEM else {}
    assert TG.stem_fusion_pairs(tir) == jpairs
    assert TG.s2d_candidates(tir) == JG.s2d_candidates(jir)
    for hw in SIZES:
        plan = TG.s2d_plan(tir, *hw)
        assert plan == JG.s2d_plan(jir, *hw), hw
        assert TG.s2d_basis(tir, plan) == JG.s2d_basis(jir, plan)
        assert (TG.s2d_plan(tir, *hw, exclude_stems=False)
                == JG.s2d_plan(jir, *hw, exclude_stems=False))
        qplan = plan if TG._S2D_REGION else {}
        for mode in TQ.MODES:
            got = TQ.plan_quantization(tir, mode, qplan)
            want = JQ.plan_quantization(jir, mode, qplan)
            assert got == (set(want[0]), set(want[1])), (hw, mode)
        for mode in ("spine", "spineall"):
            got = TQ._plan_with_spine(tir, mode, qplan)
            want = JQ._plan_with_spine(jir, mode, qplan)
            assert got == (set(want[0]), set(want[1]), list(want[2]))
        got = TQ.plan_edges(tir, hw)
        want = JQ.plan_edges(jir, hw)
        assert got == (set(want[0]), dict(want[1]), set(want[2])), hw


# the plans at JAX's defaults (512x640; 512x512 and 416x512 give the
# same): planned convs (e1, i1, i3, x3), spine (adds, targets), edge
# (targets, int8 edges), and the parent's spine and edge plans, which
# ignored the s2d plan (F8)
PLAN_COUNTS = {
    "kaist_dyolov4_fshare_global_concat_se3.cfg":
        ((8, 14, 6, 4), (6, 88), (156, 233), (0, 82), (178, 271)),
    "kaist_dyolov4_concat_se.cfg":
        ((8, 14, 6, 4), (6, 88), (156, 227), (0, 82), (178, 265)),
    "kaist_dyolov4_add_sl.cfg":
        ((8, 14, 6, 4), (6, 89), (156, 227), (0, 83), (178, 265)),
    "kaist_yolov4.cfg":
        ((4, 7, 3, 2), (3, 55), (94, 133), (0, 52), (105, 152)),
}


@pytest.mark.parametrize("name", sorted(PLAN_COUNTS))
def test_default_plans_place_int8_as_jax(name):
    """F8: at JAX's defaults the s2d plan sets spine's adds and edge's
    edges; the plans without it (the parent's) differ."""
    ir = compile_cfg(str(REPO / "configs" / name))
    roles, spine, edge, old_spine, old_edge = PLAN_COUNTS[name]
    for hw in SIZES:
        plan = TG.s2d_plan(ir, *hw)
        assert tuple(sorted(plan.values()).count(r)
                     for r in ("e1", "i1", "i3", "x3")) == roles
        targets, _, adds = TQ._plan_with_spine(ir, "spine", plan)
        assert (len(adds), len(targets)) == spine
        e_t, e_out, _ = TQ.plan_edges(ir, hw)
        assert (len(e_t), sum(e_out.values())) == edge
    targets, _, adds = TQ._plan_with_spine(ir, "spine", {})
    assert (len(adds), len(targets)) == old_spine
    e_t, e_out, _ = TQ.plan_edges(ir, None)
    assert (len(e_t), sum(e_out.values())) == old_edge


# --------------------------------------------------- the narrowed flagship


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """(jax ir, jax folded, port ir, the same folded params in the port's
    layout, stats): the narrowed flagship of tests/test_torch_quantize.py,
    calibrated by the port in fp32 on 2 batches of 2 at 64x96."""
    cfg = write_narrow_flagship(tmp_path_factory.mktemp("s2d"))
    jir, tir = jax_compile_cfg(cfg), compile_cfg(cfg)
    jfold = JG.fold_batchnorm(jir, flagship_variables(jir))
    tfold = TW.from_jax_variables(tir, jax.device_get(jfold))
    rng = np.random.default_rng(4)
    batches = [tuple(rng.random((2, 64, 96, 3), dtype=np.float32)
                     for _ in range(2)) for _ in range(2)]
    stats = TQ.calibrate(tir, TG.place_folded(tir, tfold, "cpu",
                                              torch.float32),
                         _port_batches(batches), compute_dtype=torch.float32)
    return jir, jfold, tir, tfold, stats


def _pair(flagship, mode, hw, stems=False):
    """JAX's and the port's quantize() at JAX's defaults, same fold and
    stats."""
    jir, jfold, tir, tfold, stats = flagship
    jq = JQ.quantize(jir, jfold, stats, mode=mode, hw=hw, int8_stems=stems)
    tq = TQ.quantize(tir, tfold, stats, mode=mode, hw=hw, int8_stems=stems)
    return jax.device_get(jq), tq


def _same_leaves(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("hw", HWS, ids=["64x96", "128x128"])
@pytest.mark.parametrize("stems", [False, True], ids=["fpstem", "int8stem"])
@pytest.mark.parametrize("mode", ["chain", "spine", "spineall", "edge"])
def test_quantize_equals_jax_leaf_for_leaf(flagship, mode, stems, hw):
    jq, tq = _pair(flagship, mode, hw, stems)
    _same_leaves(_flat(TQ._to_numpy_tree(tq)), _flat(jq))
    params = tq["params"]
    plan = TG.s2d_plan(flagship[2], *hw)
    assert plan
    assert sum("wq_t" in e.get("q", {}) or "wt" in e.get("fp", {})
               for e in params.values()) == len(plan)
    assert sum("stem_q" in e for e in params.values()) == 2 * stems
    n_spine = sum("spine" in e for e in params.values())
    if mode == "spine":
        assert n_spine == (4 if hw == (128, 128) else 0)
    if mode == "edge" and stems:
        assert sum("stem_out_s" in e for e in params.values()) == 2


# -------------------------------------------------------------- artifacts


def _save_jax(flagship, path, mode, hw, stems=False, bf16=False):
    """The JAX package's artifact as tools/calibrate.py writes it (its
    quantize of the fold, bf16-cast when ``bf16``)."""
    jir, jfold, _, _, stats = flagship
    if bf16:
        jfold = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                             jfold)
    q = jax.device_get(JQ.quantize(jir, jfold, stats, mode=mode, hw=hw,
                                   int8_stems=stems))
    JQ.save_quantized(path, q, mode=mode, hw=hw)
    return q


@pytest.mark.parametrize("mode, stems", [
    ("chain", False), ("spine", False), ("edge", True), ("chain", True)],
    ids=["chain-s2d", "spine-s2d", "edge-int8_stems", "chain-int8_stems"])
def test_jax_default_artifact_loads_and_equals_the_port(flagship, tmp_path,
                                                        mode, stems):
    """JAX's default artifact (s2d keys, with int8 stems where asked) loads
    in the port, passes its check and equals the port's own quantization
    leaf for leaf; it places for the executors."""
    path = str(tmp_path / "j.npz")
    _save_jax(flagship, path, mode, (128, 128), stems)
    qv, qmode, qhw = TQ.load_quantized(path)
    assert (qmode, qhw) == (mode, (128, 128))
    _, tq = _pair(flagship, mode, (128, 128), stems)
    _same_leaves(_flat(TQ._to_numpy_tree(qv)), _flat(TQ._to_numpy_tree(tq)))
    placed = TQ.place_quantized(flagship[2], qv, "cpu", torch.float32)
    assert sum("stem8" in e for e in placed["params"].values()) == 2 * stems


@pytest.mark.parametrize("mode", ["spine", "edge"])
def test_jax_bf16_artifact_with_int8_stems_loads(flagship, tmp_path, mode):
    """tools/calibrate.py quantizes a bf16 fold: the s2d and stem kernels
    of its artifact are checked in bf16 arithmetic, as JAX made them, and
    every leaf comes back bit for bit."""
    path = str(tmp_path / "j.npz")
    want = _flat(_save_jax(flagship, path, mode, (128, 128), True, True))
    qv, _, _ = TQ.load_quantized(path)
    got = _flat(TQ._to_numpy_tree(qv), convert=False)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if w.dtype == jnp.bfloat16:
            g, w = g.view(torch.int16).numpy(), w.view(np.int16)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("mode", ["spine", "edge"])
def test_port_artifact_takes_jax_precomputed_branch(flagship, tmp_path,
                                                    mode):
    """The port's artifact loads in JAX bit for bit, and every planned
    conv's precomputed kernel passes the shape check of JAX's executor
    (``wq_t.shape[0] == _S2D_KSHAPE[role]``, ``wt`` likewise) at the
    artifact's size."""
    jir, _, tir, _, _ = flagship
    jq, tq = _pair(flagship, mode, (128, 128), True)
    path = str(tmp_path / "t.npz")
    TQ.save_quantized(path, tq, mode=mode, hw=(128, 128))
    back, bmode, bhw = JQ.load_quantized(path)
    assert (bmode, bhw) == (mode, (128, 128))
    _same_leaves(_flat(back), _flat(jq))
    plan = JG.s2d_plan(jir, 128, 128)
    for i, role in plan.items():
        e = back["params"][f"l{i}"]
        kernel = e["q"]["wq_t"] if "q" in e else e["fp"]["wt"]
        assert kernel.shape[0] == JG._S2D_KSHAPE[role], (i, role)


def _tamper(path, out, leaf, fn):
    with np.load(path) as z:
        files = {k: z[k] for k in z.files}
    key = next(k for k in sorted(files) if k.endswith(leaf))
    files[key] = fn(files[key].copy())
    np.savez(out, **files)
    return key


@pytest.mark.parametrize("leaf", ["q/wq_t", "q/sw_t", "q/bt", "fp/wt",
                                  "stem_q/w2q", "stem_q/swb"])
def test_tampered_rewrite_leaf_refused(flagship, tmp_path, leaf):
    """An artifact whose s2d or stem kernel is not the transform of its
    plain kernel is refused, naming the leaf."""
    path, bad = str(tmp_path / "j.npz"), str(tmp_path / "bad.npz")
    _save_jax(flagship, path, "spineall", (128, 128), True)

    def change(a):
        flat = a.reshape(-1)
        if a.dtype == np.int8:
            flat[np.flatnonzero(flat == 0)[0]] = 1     # a scattered zero
        else:
            j = np.flatnonzero(flat)[0]
            flat[j] = flat[j] * np.float32(1.001)
        return a

    key = _tamper(path, bad, leaf, change)
    TQ.load_quantized(path)
    with pytest.raises(ValueError, match=key.removeprefix("q/params/")):
        TQ.load_quantized(bad)


# ---------------------------------------------------------------- per conv


def _conv_inputs(tfold, tir, x):
    """Each conv's input in the port's fp32 forward of ``x``."""
    inputs = {}

    def record(node, inp, p):
        inputs[node.index] = inp
        return TG.conv_folded(node, inp, p)

    TG.run_graph(tir, TG.place_folded(tir, tfold, "cpu",
                                      torch.float32)["params"], x, x,
                 dtype=torch.float32, conv=record)
    return inputs


def _int32_plain(node, xq, wq):
    """The plain conv's int32 sums of s8 codes, as the port's executor
    takes them (int8 im2col and the int32 product)."""
    xn = xq.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    w = TQ._place_kxk(wq, "cpu")
    a, ho, wo = TQ._im2col(xn, node.kernel, node.stride, node.pad,
                           w.shape[1])
    acc = K4.int_mm(a, w)[:, :wq.shape[0]]
    return acc.reshape(xq.shape[0], ho, wo, -1)


@pytest.mark.parametrize("mode", ["all", "edge"])
def test_planned_int8_convs_equal_jax_s2d_basis(flagship, mode):
    """Each planned int8 conv at 128x128 (``all`` plans e1, i1, i3 and x3;
    the flagship has no e3), the port's plain basis against JAX's s2d
    basis (``_qconv_s2d``, ``_qconv_s2d_e`` with the precomputed kernels)
    on the same fp32 input, depth-to-space after: the int32 sums are the
    same integers; the epilogue scales differ by the rounding of JAX's
    rebuilt input scale (1 / inv_sx, an ulp from the port's) and of the
    product after it, at most two ulps of the scale; the fp32 outputs (no
    requant) differ, with a linear epilogue, by at most the sums times
    that difference and an ulp of the product and of the output, with the
    conv's activation by test_every_qconv_matches_jax's rule (1e-6
    relative + 1e-6)."""
    jir, _, tir, tfold, _ = flagship
    jq, tq = _pair(flagship, mode, (128, 128))
    qp = TQ.place_quantized(tir, tq, "cpu", torch.float32)["params"]
    plan = TG.s2d_plan(tir, 128, 128)
    x = torch.from_numpy(np.random.default_rng(5).random(
        (1, 128, 128, 3), dtype=np.float32))
    inputs = _conv_inputs(tfold, tir, x)
    drop = ("out_inv_s", "out_inv", "out_s")
    roles = set()
    for i, role in sorted(plan.items()):
        if "q" not in tq["params"][f"l{i}"]:
            continue
        roles.add(role)
        jqp = {k: v for k, v in jq["params"][f"l{i}"]["q"].items()
               if k not in drop}
        tqp = {k: v for k, v in qp[f"l{i}"]["q"].items() if k not in drop}
        x_in = inputs[i]
        basis = (lambda t: t) if role in ("e1", "e3") else _space_to_depth
        back = (lambda t: t) if role == "x3" else _depth_to_space

        def jax_out(t):
            return back(torch.from_numpy(np.array(t)).permute(0, 3, 1, 2))

        # the int32 sums: JAX's s2d kernel on the codes in the s2d basis
        inv = tqp.get("in_inv", tqp.get("inv_sx"))
        xq = TQ._quantize_input(x_in, inv)
        s, pad = JL._S2D_GEOM[role]
        acc = jax.lax.conv_general_dilated(
            _nhwc(basis(xq)), jnp.asarray(jqp["wq_t"]), (s, s), pad,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        acc = jax_out(acc)
        plain = _int32_plain(tir.nodes[i], xq,
                             tq["params"][f"l{i}"]["q"]["wq"])
        assert torch.equal(acc, plain.permute(0, 3, 1, 2)), i
        # the epilogue scales, per plain channel
        jscale = np.asarray(jqp["sw_t"], np.float32)
        if "in_s" not in jqp:
            jscale = jscale * (np.float32(1.0) / jqp["inv_sx"])
        if role != "x3":
            jscale = jscale[::4]
        tscale = tqp["scale"].numpy()
        d_scale = np.abs(jscale - tscale)
        assert (d_scale <= 2 * np.spacing(tscale)).all(), (i, role)
        prod = (acc.double() * torch.from_numpy(tscale).double().reshape(
            1, -1, 1, 1)).abs().numpy()
        for act in ("linear", tir.nodes[i].act):
            node = dataclasses.replace(tir.nodes[i], act=act)
            fp = jq["params"][f"l{i}"].get("fp")
            if mode == "edge":
                ref, _ = JQ._qconv_s2d_e(_nhwc(basis(x_in)), None, jqp, fp,
                                         role, act=act,
                                         out_dtype=jnp.float32)
                got = TQ.qconv_edge(node, x_in, tqp, torch.float32)
            else:
                ref = JQ._qconv_s2d(_nhwc(basis(x_in)), jqp, fp, role,
                                    act=act, out_dtype=jnp.float32)
                got = TQ.qconv(node, x_in, tqp, torch.float32)
            ref = jax_out(ref)
            bound = (acc.double().abs().numpy()
                     * d_scale.reshape(1, -1, 1, 1)
                     + np.spacing(prod.astype(np.float32))
                     + np.spacing(ref.abs().numpy()))
            err = (got - ref).abs().numpy()
            if act == "linear":
                assert (err <= bound).all(), (i, role, err.max())
            else:       # test_every_qconv_matches_jax's rule
                np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                           rtol=1e-6, atol=1e-6)
    assert roles == ({"e1", "i1", "i3", "x3"} if mode == "all"
                     else {"i3", "x3"})


@pytest.mark.parametrize("act", ["leaky", "mish"])
def test_int8_stem_pair_equals_jax(flagship, act):
    """The int8 stem pair in the plain basis (two int8 im2col convs) against
    JAX's ``_q_fused_stem`` with its precomputed kernels, fp32: exact with
    leaky (the same int32 sums, scales and requant). With mish, torch's
    and XLA's mish round an ulp apart, and an ulp on a rounding boundary
    moves a mid code by a step (on 15 of 49152 outputs here): within the
    CPU mish guard (1e-4) on all but 0.1% of the outputs, and within one
    mid step's worth on those."""
    jir, _, tir, _, _ = flagship
    jq, tq = _pair(flagship, "chain", (64, 96), True)
    qp = TQ.place_quantized(tir, tq, "cpu", torch.float32)["params"]
    pairs = TG.stem_fusion_pairs(tir)
    x = torch.from_numpy(np.random.default_rng(6).random(
        (2, 3, 64, 96), dtype=np.float32))
    for i, j in pairs.items():
        n1 = dataclasses.replace(tir.nodes[i], act=act)
        n2 = dataclasses.replace(tir.nodes[j], act=act)
        ent = jq["params"][f"l{i}"]
        ref = JQ._q_fused_stem(_nhwc(x), ent["fp"], jq["params"][f"l{j}"]
                               ["fp"], act, act, ent["amax_in"],
                               ent["amax_mid"], jnp.float32,
                               pre=ent["stem_q"])
        ir = dataclasses.replace(tir, nodes=[
            n1 if n.index == i else n2 if n.index == j else n
            for n in tir.nodes])
        fused = set()
        got = TQ._stem8(ir, n1, x, qp[f"l{i}"], torch.float32, fused)
        assert fused == {j}
        got = got.permute(0, 2, 3, 1).numpy()
        if act == "leaky":
            np.testing.assert_array_equal(got, np.asarray(ref))
            continue
        # one mid code a step off moves an output by at most one tap's
        # weight (127 sw2 sx2) times mish's slope (< 1.1)
        step = 1.1 * 127 * float(np.max(ent["stem_q"]["sw2"])) * float(
            TQ._inv_scale(ent["amax_mid"])[0])
        err = np.abs(got - np.asarray(ref))
        assert (err > 1e-4).mean() < 1e-3 and err.max() <= step, (
            (err > 1e-4).mean(), err.max(), step)
