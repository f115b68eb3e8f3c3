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
"""

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.ops import _build
from double_yolo_kaist_torch.ops.stem import (matches, stem_conv_s2,
                                              stem_conv_s2_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
CPU_TOL = {"leaky": TOL, "mish": dict(rtol=1e-4, atol=1e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


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
    got = stem_conv_s2(xt, wt, torch.from_numpy(bias), "leaky")
    assert got.shape == (1, 64, 8, 12)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, stem_conv_s2_plain(
        xt, wt, torch.from_numpy(bias), "leaky"), rtol=0, atol=0)


def test_wrapper_rejects_off_gate_inputs():
    x = torch.zeros((1, 32, 8, 8))
    w, b = torch.zeros((64, 32, 3, 3)), torch.zeros(64)
    with pytest.raises(ValueError):
        stem_conv_s2(torch.zeros((1, 16, 8, 8)), w, b, "mish")
    with pytest.raises(ValueError):
        stem_conv_s2(x, torch.zeros((64, 32, 1, 1)), b, "mish")
    with pytest.raises(ValueError):
        stem_conv_s2(x, w, torch.zeros(63), "mish")
    with pytest.raises(ValueError):
        stem_conv_s2(x, w, b, "relu")


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


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["mish", "leaky"])
@pytest.mark.parametrize("shape", [(2, 64, 96, 64), (1, 37, 141, 24),
                                   (1, 16, 20, 128)])
def test_kernel_matches_plain_on_card(cuda, shape, act):
    """Kernel vs plain version on the same inputs, bf16 and fp32, at tile
    edges (W not a multiple of 128, odd H and W) and three widths."""
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
            got = stem_conv_s2(xt, wt, bt, act)
            assert _build.launches["stem_conv_s2"] == n0 + 1
            want = stem_conv_s2_plain(xt, wt, bt, act)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == want.shape
            torch.testing.assert_close(got.float(), want.float(), **tol)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
