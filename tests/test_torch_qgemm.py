"""K4 (int8 GEMM + dequant/act/requant epilogue): the port's plain version
against the JAX package's Pallas ``qgemm`` in interpret mode, at the shapes
of tests/test_pallas_qgemm.py; the CUDA kernel against the plain version on
the card.

JAX is imported inside the tests that use it, so that the card, which has
no JAX, can run the CUDA cases:
    python -m pytest --noconftest -m cuda tests/test_torch_qgemm.py

Tolerances (JAX's own contract for this kernel), and why:
  * the int32 products are exact on both sides: equal;
  * bf16 outputs without requant: equal for linear and leaky (the same
    rounded op sequence); within one bf16 ulp for mish, whose exp, log1p
    and tanh come from different libraries (plus 1e-30 absolute: for a
    large negative input exp(-|x|) is subnormal, which XLA's CPU flushes
    to zero and PyTorch does not, so mish gives 0 against ~1e-36);
  * requantized s8 outputs: within 1 int8 LSB on fewer than 5% of the
    elements, as tests/test_pallas_qgemm.py allows (a bf16 product on a
    rounding boundary flips by one step).
"""

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.ops import _build
from double_yolo_kaist_torch.ops.qgemm import (int_mm, qgemm, qgemm_plain)

BF16_ULP = dict(rtol=2 ** -7, atol=1e-30)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _mk(m, k, n, seed=0):
    """test_pallas_qgemm._mk's draws, as numpy."""
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.random(n) * 1e-3 + 1e-5).astype(np.float32)
    bias = (rng.normal(size=n) * 0.1).astype(np.float32)
    return xq, wq, scale, bias


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _assert_requant(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.05


def _assert_bf16(got, want, act):
    if act == "mish":
        np.testing.assert_allclose(got, want, **BF16_ULP)
    else:
        np.testing.assert_array_equal(got, want)


def test_int_mm_is_exact():
    """int32 products against numpy's int64, including M <= 16 (padded)."""
    for m in (3, 17, 300):
        xq, wq, _, _ = _mk(m, 128, 64, seed=m)
        got = int_mm(*_torch(xq, np.ascontiguousarray(wq.T)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), xq.astype(np.int64) @ wq.astype(np.int64))


@pytest.mark.parametrize("act", ["mish", "leaky", "linear"])
@pytest.mark.parametrize("requant", [False, True])
def test_plain_matches_pallas_interpret(act, requant):
    import jax.numpy as jnp
    from double_yolo_kaist_tpu.ops.pallas_qgemm import qgemm as jax_qgemm
    xq, wq, scale, bias = _mk(300, 128, 128)    # M off the 1024 tile
    inv = np.float32(97.3) if requant else None
    ref = np.asarray(jax_qgemm(jnp.asarray(xq), jnp.asarray(wq),
                               jnp.asarray(scale), jnp.asarray(bias), act,
                               out_inv_s=inv))
    got = qgemm_plain(*_torch(xq, wq, scale, bias), act, out_inv_s=inv)
    if requant:
        assert got.dtype == torch.int8
        _assert_requant(got.numpy(), ref)
    else:
        assert got.dtype == torch.bfloat16
        _assert_bf16(got.float().numpy(), ref.astype(np.float32), act)


def test_plain_leading_dims_and_large_m():
    import jax.numpy as jnp
    from double_yolo_kaist_tpu.ops.pallas_qgemm import qgemm as jax_qgemm
    b, h, w, k, n = 2, 40, 16, 256, 128
    xq, wq, scale, bias = _mk(b * h * w, k, n, seed=3)
    x4 = xq.reshape(b, h, w, k)
    ref = np.asarray(jax_qgemm(jnp.asarray(x4), jnp.asarray(wq),
                               jnp.asarray(scale), jnp.asarray(bias), "mish"))
    got = qgemm(*_torch(x4, wq, scale, bias), "mish")
    assert tuple(got.shape) == (b, h, w, n)
    _assert_bf16(got.float().numpy(), ref.astype(np.float32), "mish")


def test_fp32_epilogue_matches_numpy():
    """out_dtype fp32: the epilogue as numpy computes it in fp32."""
    xq, wq, scale, bias = _mk(64, 256, 128, seed=4)
    acc = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
    y = acc * scale + bias
    want = np.maximum(y, np.float32(0.1) * y)
    got = qgemm(*_torch(xq, wq, scale, bias), "leaky",
                out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    inv = np.float32(3.7)
    q = qgemm(*_torch(xq, wq, scale, bias), "leaky", out_inv_s=inv,
              out_dtype=torch.float32)
    np.testing.assert_array_equal(
        q.numpy(), np.clip(np.round(want * inv), -127, 127).astype(np.int8))


def test_wrapper_rejects_bad_operands():
    xq, wq, scale, bias = _torch(*_mk(32, 64, 32))
    with pytest.raises(TypeError):
        qgemm(xq.float(), wq, scale, bias, "leaky")
    with pytest.raises(ValueError):
        qgemm(xq, wq[:48], scale, bias, "leaky")
    with pytest.raises(ValueError):
        qgemm(xq, wq, scale[:16], bias, "leaky")
    with pytest.raises(ValueError):
        qgemm(xq, wq, scale, bias, "hard-swish")
    with pytest.raises(TypeError):
        qgemm(xq, wq, scale, bias, "leaky", out_dtype=torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["mish", "leaky", "linear", "relu", "relu6"])
@pytest.mark.parametrize("requant", [False, True])
def test_kernel_matches_plain_on_card(cuda, dtype, act, requant):
    """Kernel vs plain version on the same inputs: an off-tile M with
    leading dims, and K, N not multiples of the 64-wide tile."""
    for (lead, k, n), seed in (((2, 40, 17), 256, 128), 1), \
                               (((300,), 80, 48), 2), (((5,), 1024, 512), 3):
        m = int(np.prod(lead))
        xq, wq, scale, bias = _mk(m, k, n, seed=seed)
        args = _torch(xq.reshape(*lead, k), wq, scale, bias, device=cuda)
        inv = np.float32(97.3) if requant else None
        n0 = _build.launches["qgemm"]
        got = qgemm(*args, act, out_inv_s=inv, out_dtype=dtype)
        assert _build.launches["qgemm"] == n0 + 1
        want = qgemm_plain(*args, act, out_inv_s=inv, out_dtype=dtype)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        if requant:
            _assert_requant(got.cpu().numpy(), want.cpu().numpy())
        elif dtype == torch.bfloat16:
            _assert_bf16(got.float().cpu().numpy(),
                         want.float().cpu().numpy(), act)
        else:
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-6, atol=0)
