"""K3 (stem conv, 3x3 s2 for C_in = 32): the port's plain version against
the JAX package's Pallas kernels in interpret mode (``stem_conv_s2`` in both
variants and ``stem_conv_s2_packed``, as tests/test_pallas_stem.py runs
them) and against ``lax.conv``; the CUDA kernel against the plain version
on the card.

JAX is imported inside the tests that use it, so that the card, which has
no JAX, can run the CUDA cases:
    python -m pytest --noconftest -m cuda tests/test_torch_stem.py

Tolerances, and why:
  * CPU, fp32: rtol = atol = 1e-5. The same fp32 conv, bias and activation
    on both sides; only the order of the 288-term sums differs. For mish
    rtol is 1e-4: PyTorch's CPU mish ops were seen, now and then, to come
    out ~1e-4 off (relative) on a process's first call, and exact to fp32
    rounding on every later call.
  * card, bf16: one bf16 ulp (rtol 2**-7) plus 1e-5 absolute. Both sum the
    exact bf16 products in fp32, in another order, then round once to
    bf16, so a result may land on the neighbouring bf16 value.
  * card, fp32: rtol = atol = 1e-5, with TF32 off for the plain conv.
  * the bf16 kernel's fast mish (one exp, one division) against the JAX
    package's mish over [-30, 30], in fp32 on the CPU: half a bf16 ulp
    (rtol 2**-9) plus 2e-6 absolute, so that the kernel's single rounding
    to bf16 lands where the exact form's would, up to a tie. The two forms
    are the same function; they differ by a few fp32 roundings (seen: 1e-6).
  * packed weights, probe copies and checksums: exact (they move values).
"""

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.ops import _build
from double_yolo_kaist_torch.ops import stem_probe as SP
from double_yolo_kaist_torch.ops.stem import (matches, pack_weights,
                                              padded_out, stem_conv_s2,
                                              stem_conv_s2_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
CPU_TOL = {"leaky": TOL, "mish": dict(rtol=1e-4, atol=1e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def mish_fast(x):
    """The bf16 CUDA kernel's mish (csrc/stem.cu, mish_fast), in plain
    torch (fp32): with e = exp(x) and n = e (e + 2), tanh(softplus(x)) =
    n / (n + 2). The exponent is cut at 2**60, where n / (n + 2) has long
    been 1 in fp32, so n stays finite."""
    e = torch.exp2(torch.clamp(x * 1.4426950408889634, max=60.0))
    n = e * (e + 2.0)
    return x * (n / (n + 2.0))


def _inputs(b, h, w, o, seed):
    """NHWC x, HWIO kernel and bias as numpy fp32 (the JAX layouts)."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, h, w, 32), dtype=np.float32)
    k = (rng.standard_normal((3, 3, 32, o)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(o) * 0.1).astype(np.float32)
    return x, k, bias


def _port(x, k, bias, act, device="cpu", dtype=torch.float32):
    """The port's plain version on the same numbers, back as NHWC numpy."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(device, dtype)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1).to(device, dtype)
    y = stem_conv_s2_plain(xt, wt, torch.from_numpy(bias).to(device), act)
    return y.permute(0, 2, 3, 1).float().cpu().numpy()


@pytest.mark.parametrize("act", ["mish", "leaky"])
@pytest.mark.parametrize("variant", ["acc", "scratch", "packed"])
def test_plain_matches_pallas_interpret(variant, act):
    """Shapes that meet the packed kernel's gate: W*C/128 a multiple of 8
    (W = 32) and H a multiple of 2*TR."""
    import jax.numpy as jnp
    from double_yolo_kaist_tpu.ops import pallas_stem as PS
    x, k, bias = _inputs(2, 64, 32, 64, seed=5)
    args = (jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    if variant == "packed":
        ref = PS.stem_conv_s2_packed(*args, act=act, interpret=True)
    else:
        ref = PS.stem_conv_s2(*args, act=act, variant=variant,
                              interpret=True)
    np.testing.assert_allclose(_port(x, k, bias, act), np.asarray(ref),
                               **CPU_TOL[act])


@pytest.mark.parametrize("hw,o", [((9, 13), 24), ((16, 70), 64)])
def test_plain_matches_lax_conv_off_gate(hw, o):
    """Odd sizes and another width, which the Pallas kernels do not take:
    held against lax.conv + bias + mish, the function they compute."""
    import jax
    import jax.numpy as jnp
    x, k, bias = _inputs(1, *hw, o, seed=3)
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
    ref = np.asarray(y * jnp.tanh(jax.nn.softplus(y)))
    np.testing.assert_allclose(_port(x, k, bias, "mish"), ref,
                               **CPU_TOL["mish"])


def test_wrapper_on_cpu_is_the_plain_version():
    x, k, bias = _inputs(1, 16, 24, 64, seed=1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1)
    got = stem_conv_s2(xt, pack_weights(wt, torch.from_numpy(bias)), "leaky")
    assert got.shape == (1, 64, 8, 12)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, stem_conv_s2_plain(
        xt, wt, torch.from_numpy(bias), "leaky"), rtol=0, atol=0)


def test_wrapper_rejects_off_gate_inputs():
    x = torch.zeros((1, 32, 8, 8))
    w, b = torch.zeros((64, 32, 3, 3)), torch.zeros(64)
    with pytest.raises(ValueError):
        stem_conv_s2(torch.zeros((1, 16, 8, 8)), pack_weights(w, b), "mish")
    with pytest.raises(ValueError):
        pack_weights(torch.zeros((64, 32, 1, 1)), b)
    with pytest.raises(ValueError):
        pack_weights(torch.zeros((129, 32, 3, 3)), torch.zeros(129))
    with pytest.raises(ValueError):
        pack_weights(w, torch.zeros(63))
    with pytest.raises(ValueError):
        stem_conv_s2(x, pack_weights(w, b), "relu")
    with pytest.raises(TypeError):          # the bare kernel is not taken
        stem_conv_s2(x, (w, b), "mish")


@pytest.mark.parametrize("cfg,kw,want", [
    ("configs/kaist_dyolov4_fshare_global_concat_se3.cfg", {}, [1, 56]),
    ("configs/kaist_dyolov3_fshare_global_concat_se3.cfg", {}, [1, 38]),
    ("configs/kaist_dyolov4_mobilenetv3_fshare_global_cse3.cfg", {}, []),
    ("tests/fixtures/tiny_dyolov3.cfg", {"yolo_strides": [8, 4]}, [10]),
])
def test_gate_picks_the_stem_convs(cfg, kw, want):
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ir = compile_cfg(os.path.join(repo, cfg), **kw)
    assert [n.index for n in ir.nodes if matches(n)] == want


def test_fast_mish_matches_jax_mish():
    import jax.numpy as jnp
    from double_yolo_kaist_tpu.models import layers as JL
    x = np.linspace(-30.0, 30.0, 200001, dtype=np.float32)
    ref = np.asarray(JL.activate("mish", jnp.asarray(x)))
    got = mish_fast(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2 ** -9, atol=2e-6)
    # above the cut the fast form is x itself, as mish is to fp32 there
    big = torch.tensor([20.5, 50.0, 100.0, 1e4])
    assert torch.equal(mish_fast(big), big)


@pytest.mark.parametrize("o", [24, 64, 100, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_weights_hold_the_oihw_kernel(o, dtype):
    """Every weight of the OIHW kernel sits where the CUDA kernel reads it:
    fp32 as (3, 3, 32, O); bf16 as [k // 8][n][k % 8] with k = (kh * 3 +
    kw) * 32 + c, zero rows for the padded outputs; the bias as fp32."""
    _, k, bias = _inputs(1, 4, 4, o, seed=o)
    w = torch.from_numpy(k).permute(3, 2, 0, 1).to(dtype)      # OIHW
    b = torch.from_numpy(bias).to(dtype)
    kept_w, kept_b, packed, pb = pack_weights(w, b)
    assert kept_w is w and kept_b is b
    assert pb.dtype == torch.float32 and torch.equal(pb, b.float())
    assert packed.dtype == dtype and packed.is_contiguous()
    hwio = torch.from_numpy(k).to(dtype)                       # (3, 3, 32, O)
    if dtype == torch.float32:
        assert torch.equal(packed, hwio)
        return
    np_ = padded_out(o)
    assert np_ >= o and np_ in (32, 64, 128)
    assert packed.shape == (36, np_, 8)
    flat = packed.permute(0, 2, 1).reshape(288, np_)           # [k][n]
    assert torch.equal(flat[:, :o], hwio.reshape(288, o))
    assert not flat[:, o:].any()


def _probe_inputs(b, h, w, o, seed, device="cpu"):
    x, k, bias = _inputs(b, h, w, o, seed)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(device, torch.bfloat16)
    xt = xt.contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1).to(device, torch.bfloat16)
    return xt, pack_weights(wt, torch.from_numpy(bias).to(device))


@pytest.mark.parametrize("variant", sorted(SP.MODES))
def test_probe_plain_versions(variant):
    """Each probe's plain version at a small odd shape, against what the
    variant is defined to do, written out independently here."""
    xt, wts = _probe_inputs(2, 9, 13, 64, seed=7)
    got = SP.probe(variant, xt, wts, "mish", seg_rows=2, fill=0.75)
    nhwc = xt.permute(0, 2, 3, 1)
    if variant == "load":
        # blocks: 1 strip x runs of 2 output rows (Ho = 5 -> 3 runs); a run
        # oy0 ... oy1 - 1 loads input rows 2 oy0 - 1 ... 2 oy1 - 1
        bits = nhwc.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
        assert got.shape == (2, 1, 3)
        for r, (lo, hi) in enumerate([(0, 3), (3, 7), (7, 9)]):
            want = bits[:, max(lo, 0):hi + 1].sum((1, 2, 3)) % (1 << 32)
            assert torch.equal(got[:, 0, r], want)
        return
    assert got.shape == (2, 64, 5, 7) and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    out = got.permute(0, 2, 3, 1)
    if variant == "store":
        assert torch.equal(out, torch.full_like(out, 0.75))
    elif variant == "copy":
        even = nhwc[:, ::2, ::2]
        odd = torch.nn.functional.pad(nhwc, (0, 0, 0, 1))[:, ::2, 1::2]
        assert torch.equal(out, torch.cat([even, odd], -1))
    elif variant == "mma":
        want = torch.nn.functional.conv2d(xt.float(), wts.w.float(), stride=2,
                                          padding=1).to(torch.bfloat16)
        assert torch.equal(got, want)
    else:
        assert torch.equal(got, stem_conv_s2_plain(xt, wts.w, wts.b, "mish"))


def test_probe_rejects_unknown_variant_and_fp32_sums():
    xt, wts = _probe_inputs(1, 8, 8, 32, seed=2)
    with pytest.raises(ValueError):
        SP.probe("dma", xt, wts, "mish")
    with pytest.raises(TypeError):
        SP.load_sums_plain(xt.float(), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["mish", "leaky"])
@pytest.mark.parametrize("shape", [
    (2, 64, 96, 64), (1, 37, 141, 24), (1, 16, 20, 128),
    (3, 33, 300, 64),       # B 3, H odd, W not a multiple of the strip
    (1, 40, 258, 128),      # two strips and one column
    (3, 9, 6, 24),          # W below the strip width
])
def test_kernel_matches_plain_on_card(cuda, shape, act):
    """Kernel vs plain version on the same inputs, bf16 and fp32, at tile
    edges (W below and not a multiple of the strip's 128 input columns, odd
    H and W, B 1 and 3) and three widths."""
    b, h, w, o = shape
    x, k, bias = _inputs(b, h, w, o, seed=11)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype, tol in ((torch.bfloat16, dict(rtol=2 ** -7, atol=1e-5)),
                           (torch.float32, TOL)):
            xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(cuda, dtype)
            xt = xt.contiguous(memory_format=torch.channels_last)
            wt = torch.from_numpy(k).permute(3, 2, 0, 1).to(cuda, dtype)
            bt = torch.from_numpy(bias).to(cuda)
            n0 = _build.launches["stem_conv_s2"]
            got = stem_conv_s2(xt, pack_weights(wt, bt), act)
            assert _build.launches["stem_conv_s2"] == n0 + 1
            want = stem_conv_s2_plain(xt, wt, bt, act)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == want.shape
            torch.testing.assert_close(got.float(), want.float(), **tol)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("seg_rows", [None, 1, 5])
def test_kernel_with_kept_packing_and_any_segmentation(cuda, seg_rows):
    """The conv on weights packed once and used again (what the model
    does), and the full probe at forced segmentations: runs of one row, and
    runs that do not divide Ho."""
    xt, wts = _probe_inputs(2, 45, 150, 64, seed=13, device=cuda)
    want = stem_conv_s2_plain(xt, wts.w, wts.b, "mish")
    if seg_rows is None:
        stem_conv_s2(xt, wts, "mish")
        got = stem_conv_s2(xt, wts, "mish")
    else:
        got = SP.probe("full", xt, wts, "mish", seg_rows=seg_rows)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 256, 64), (1, 37, 141, 24),
                                   (2, 30, 300, 128)])
@pytest.mark.parametrize("variant", sorted(SP.MODES))
def test_probe_matches_plain_on_card(cuda, variant, shape):
    """Each probe variant against its plain version on the card: the sums,
    the fill and the copy exactly; the products within one bf16 ulp."""
    b, h, w, o = shape
    xt, wts = _probe_inputs(b, h, w, o, seed=17, device=cuda)
    _, seg_rows, _ = SP.plan(xt, o)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        n0 = _build.launches["stem_probe"]
        got = SP.probe(variant, xt, wts, "mish", fill=-1.5)
        assert _build.launches["stem_probe"] == n0 + 1
        want = SP.probe_plain(variant, xt, wts, "mish", seg_rows, fill=-1.5)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert got.shape == want.shape and got.dtype == want.dtype
    if variant in ("load", "store", "copy"):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-5)
