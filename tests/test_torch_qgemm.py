"""K4 (int8 GEMM + dequant/act/requant epilogue): the port's plain version
against the JAX package's Pallas ``qgemm`` in interpret mode, at the shapes
of tests/test_pallas_qgemm.py; the wrapper's packed weights and tile choice;
the CUDA kernel against the plain version on the card.

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
from double_yolo_kaist_torch.ops.qgemm import (SMS, TILES, choose_tile,
                                               int_mm, pack_weights, qgemm,
                                               qgemm_plain)

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


def _packed(x, w_kn, scale, bias, device="cpu"):
    """qgemm's operands: the weights as pack_weights makes them."""
    x, w_kn, scale, bias = _torch(x, w_kn, scale, bias, device=device)
    return x, pack_weights(w_kn), scale, bias


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
    got = qgemm(*_packed(x4, wq, scale, bias), "mish")
    assert tuple(got.shape) == (b, h, w, n)
    _assert_bf16(got.float().numpy(), ref.astype(np.float32), "mish")


def test_fp32_epilogue_matches_numpy():
    """out_dtype fp32: the epilogue as numpy computes it in fp32."""
    xq, wq, scale, bias = _mk(64, 256, 128, seed=4)
    acc = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
    y = acc * scale + bias
    want = np.maximum(y, np.float32(0.1) * y)
    got = qgemm(*_packed(xq, wq, scale, bias), "leaky",
                out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    inv = np.float32(3.7)
    q = qgemm(*_packed(xq, wq, scale, bias), "leaky", out_inv_s=inv,
              out_dtype=torch.float32)
    np.testing.assert_array_equal(
        q.numpy(), np.clip(np.round(want * inv), -127, 127).astype(np.int8))


def test_wrapper_rejects_bad_operands():
    xq, wq, scale, bias = _packed(*_mk(32, 64, 32))
    with pytest.raises(TypeError):
        qgemm(xq.float(), wq, scale, bias, "leaky")
    with pytest.raises(ValueError):         # weights not packed: (K, N)
        qgemm(xq, wq.t().contiguous(), scale, bias, "leaky")
    with pytest.raises(ValueError):
        qgemm(xq, wq[:, :48].contiguous(), scale, bias, "leaky")
    with pytest.raises(ValueError):
        qgemm(xq, wq, scale[:16], bias, "leaky")
    with pytest.raises(ValueError):
        qgemm(xq, wq, scale, bias, "hard-swish")
    with pytest.raises(TypeError):
        qgemm(xq, wq, scale, bias, "leaky", out_dtype=torch.float16)


def test_pack_weights_is_the_transpose():
    _, wq, _, _ = _mk(8, 48, 32, seed=5)
    w = torch.from_numpy(wq)
    packed = pack_weights(w)
    assert isinstance(packed, torch.Tensor)
    assert packed.shape == (32, 48) and packed.is_contiguous()
    assert packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), wq.T)
    # a (K, N) view with other strides packs to the same matrix
    np.testing.assert_array_equal(
        pack_weights(w.t().contiguous().t()).numpy(), wq.T)
    with pytest.raises(TypeError):
        pack_weights(w.float())


@pytest.mark.parametrize("act", ["mish", "leaky", "linear"])
@pytest.mark.parametrize("requant", [False, True])
def test_packed_qgemm_matches_pallas_interpret(act, requant):
    """qgemm on CPU tensors with packed weights against the JAX qgemm in
    interpret mode, as test_plain_matches_pallas_interpret runs it."""
    import jax.numpy as jnp
    from double_yolo_kaist_tpu.ops.pallas_qgemm import qgemm as jax_qgemm
    xq, wq, scale, bias = _mk(300, 128, 128)
    inv = np.float32(97.3) if requant else None
    ref = np.asarray(jax_qgemm(jnp.asarray(xq), jnp.asarray(wq),
                               jnp.asarray(scale), jnp.asarray(bias), act,
                               out_inv_s=inv))
    got = qgemm(*_packed(xq, wq, scale, bias), act, out_inv_s=inv)
    plain = qgemm_plain(*_torch(xq, wq, scale, bias), act, out_inv_s=inv)
    assert torch.equal(got, plain)       # the same products, the same ops
    if requant:
        assert got.dtype == torch.int8
        _assert_requant(got.numpy(), ref)
    else:
        assert got.dtype == torch.bfloat16
        _assert_bf16(got.float().numpy(), ref.astype(np.float32), act)


# the flagship's chain 1x1 convs at 512x640: (M at batch 8, K, N), each
# family four, four and two layers (chip_smoke._k4_shapes)
FLAGSHIP_SHAPES = [(2560, 1024, 512), (10240, 512, 256), (40960, 256, 128)]


@pytest.mark.parametrize("bs", [8, 1])
@pytest.mark.parametrize("m8,k,n", FLAGSHIP_SHAPES)
def test_choose_tile_on_flagship_shapes(bs, m8, k, n):
    """A tile the kernel has, and a grid that gives every multiprocessor a
    block unless even the smallest tile cannot."""
    m = m8 * bs // 8
    bm, bn = choose_tile(m, k, n)
    assert (bm, bn) in TILES
    blocks = -(-m // bm) * -(-n // bn)
    assert blocks >= SMS or (bm, bn) == TILES[-1]
    # no larger tile would have filled the card as its blocks need: two
    # rounds of 128 x 128 blocks, one of the others
    for tile in TILES[:TILES.index((bm, bn))]:
        rounds = 2 if tile == (128, 128) else 1
        assert -(-m // tile[0]) * -(-n // tile[1]) < rounds * SMS
    if bs == 8:     # the tiles the flagship's families were measured best at
        assert (bm, bn) == {1024: (64, 128), 512: (64, 128),
                            256: (128, 128)}[k]


def test_choose_tile_general_shapes():
    assert choose_tile(1, 16, 16) == (64, 64)
    assert choose_tile(10 ** 6, 144, 64) == (64, 64)     # never wider than N
    assert choose_tile(10 ** 6, 144, 80) == (128, 128)
    assert choose_tile(20000, 144, 80) == (64, 128)      # 157 < 2 x 132
    assert choose_tile(10000, 144, 80) == (64, 128)
    assert choose_tile(1000, 144, 80) == (64, 64)
    # the card's size enters: a smaller card is filled by larger tiles
    assert choose_tile(10000, 144, 80, sms=33) == (128, 128)
    assert choose_tile(1000, 144, 80, sms=16) == (64, 128)


# (K, N) of the flagship's three families and one off every tile
CARD_KN = [(256, 128), (512, 256), (1024, 512), (144, 80)]
CARD_M = [1, 63, 64, 320, 1000, 5120]


def _hold(got, want, requant, dtype, act):
    assert got.dtype == want.dtype and got.shape == want.shape
    if requant:
        _assert_requant(got.cpu().numpy(), want.cpu().numpy())
    elif dtype == torch.bfloat16:
        _assert_bf16(got.float().cpu().numpy(), want.float().cpu().numpy(),
                     act)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-6, atol=0)


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
        x, w, sc, bi = _torch(xq.reshape(*lead, k), wq, scale, bias,
                              device=cuda)
        inv = np.float32(97.3) if requant else None
        n0 = _build.launches["qgemm"]
        got = qgemm(x, pack_weights(w), sc, bi, act, out_inv_s=inv,
                    out_dtype=dtype)
        assert _build.launches["qgemm"] == n0 + 1
        want = qgemm_plain(x, w, sc, bi, act, out_inv_s=inv, out_dtype=dtype)
        torch.cuda.synchronize()
        _hold(got, want, requant, dtype, act)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", CARD_KN)
@pytest.mark.parametrize("m", CARD_M)
def test_kernel_shapes_on_card(cuda, m, k, n):
    """Every tile of the kernel, M on and off its tiles, K and N on and off
    the 128-byte stage: five activations, requant on and off, bf16 and
    fp32 against the plain version."""
    xq, wq, scale, bias = _mk(m, k, n, seed=m + k)
    x, w, sc, bi = _torch(xq, wq, scale, bias, device=cuda)
    packed = pack_weights(w)
    for dtype in (torch.bfloat16, torch.float32):
        for act in ("mish", "leaky", "linear", "relu", "relu6"):
            for inv in (None, np.float32(97.3)):
                got = qgemm(x, packed, sc, bi, act, out_inv_s=inv,
                            out_dtype=dtype)
                want = qgemm_plain(x, w, sc, bi, act, out_inv_s=inv,
                                   out_dtype=dtype)
                torch.cuda.synchronize()
                _hold(got, want, inv is not None, dtype, act)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(40960, 256, 128), (2560, 1024, 512),
                                   (1280, 512, 256), (1000, 144, 80)])
def test_kernel_repeats_on_card(cuda, m, k, n):
    """200 launches on the same operands all equal the first (the ring and
    the persistent blocks leave nothing behind)."""
    xq, wq, scale, bias = _mk(m, k, n, seed=7)
    x, w, sc, bi = _torch(xq, wq, scale, bias, device=cuda)
    packed = pack_weights(w)
    for inv in (None, np.float32(31.0)):
        first = qgemm(x, packed, sc, bi, "leaky", out_inv_s=inv)
        outs = [qgemm(x, packed, sc, bi, "leaky", out_inv_s=inv)
                for _ in range(200)]
        torch.cuda.synchronize()
        _hold(first, qgemm_plain(x, w, sc, bi, "leaky", out_inv_s=inv),
              inv is not None, torch.bfloat16, "leaky")
        assert all(torch.equal(o, first) for o in outs)
