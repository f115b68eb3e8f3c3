"""K1 (head decode): the port's plain version against the Pallas kernel in
interpret mode and against graph.decode_head; decode_heads (every head of a
forward in one call) against graph.decode_head per head; the CUDA kernel
against the plain version on the card.

JAX is imported inside the tests that use it, so that the card, which has
no JAX, can run the CUDA cases:
    python -m pytest --noconftest -m cuda tests/test_torch_decode.py

Tolerance 1e-5 on the CPU: the same fp32 formulas on both sides, with
sigmoid/exp from different libraries."""

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.ops import _build
from double_yolo_kaist_torch.ops import decode as K1
from double_yolo_kaist_torch.ops.decode import (decode_head,
                                                decode_head_plain,
                                                decode_heads, fast_path,
                                                reshape_head)

ANCHORS = np.asarray([[10., 13.], [33., 23.], [62., 45.]], np.float32)
TOL = dict(rtol=1e-5, atol=1e-5)
# (raw shape, stride, bf_type): the shapes of test_pallas_decode.py; the
# last has a row count that is no multiple of the Pallas block (ragged tail)
CASES = [((2, 3, 8, 16, 6), 32, "yolov3"), ((2, 3, 8, 16, 6), 8, "yolov4"),
         ((5, 3, 6, 10, 6), 16, "yolov3"), ((5, 3, 6, 10, 6), 16, "yolov4")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _jax_decoders():
    import jax.numpy as jnp
    from double_yolo_kaist_tpu.models.graph import decode_head
    from double_yolo_kaist_tpu.ops.pallas_decode import decode_head_pallas
    return jnp, decode_head, decode_head_pallas


def _raw(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _conv_out(raw):
    """(bs, na, ny, nx, no) -> the head conv's (bs, na*no, ny, nx) output."""
    bs, na, ny, nx, no = raw.shape
    return np.ascontiguousarray(
        raw.transpose(0, 1, 4, 2, 3).reshape(bs, na * no, ny, nx))


@pytest.mark.parametrize("shape,stride,bf_type", CASES)
def test_plain_matches_pallas_and_graph(shape, stride, bf_type):
    jnp, jax_decode_head, decode_head_pallas = _jax_decoders()
    raw = _raw(shape, seed=stride)
    pallas = np.asarray(decode_head_pallas(jnp.asarray(raw), ANCHORS, stride,
                                           bf_type, interpret=True))
    ref = np.asarray(jax_decode_head(jnp.asarray(raw), ANCHORS, stride,
                                     bf_type))
    mine = decode_head_plain(torch.from_numpy(raw), ANCHORS, stride,
                             bf_type).numpy()
    np.testing.assert_allclose(mine, pallas, **TOL)
    np.testing.assert_allclose(mine, ref, **TOL)


@pytest.mark.parametrize("channels_last", [False, True])
def test_wrapper_reads_conv_output_into_slice(channels_last):
    """The wrapper takes the 4-D conv output in either memory layout and
    fills only its own rows of a larger output."""
    jnp, jax_decode_head, _ = _jax_decoders()
    raw = _raw((2, 3, 4, 5, 6), seed=7)
    x = torch.from_numpy(_conv_out(raw))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(reshape_head(x, 3, 6).numpy(), raw)
    out = torch.full((2, 100, 6), -7.0)
    decode_head(x, ANCHORS, 8, "yolov4", out=out, row_offset=30)
    ref = np.asarray(jax_decode_head(jnp.asarray(raw), ANCHORS, 8, "yolov4"))
    np.testing.assert_allclose(out[:, 30:90].numpy(), ref, **TOL)
    assert (out[:, :30] == -7).all() and (out[:, 90:] == -7).all()


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros((1, 17, 4, 4))
    with pytest.raises(ValueError):
        decode_head(x, ANCHORS, 8, "yolov4")
    with pytest.raises(ValueError):
        decode_head(torch.zeros((1, 18, 4, 4)), ANCHORS, 8, "yolov4",
                    out=torch.zeros((1, 10, 6)), row_offset=0)


# three heads of one model: (ny, nx), stride, anchors
HEADS = [((8, 12), 8, ANCHORS), ((4, 6), 16, ANCHORS * 2),
         ((2, 3), 32, ANCHORS * 4)]


def _three_heads(bs, seed, channels_last, dtype=torch.float32, device="cpu"):
    raws, heads = [], []
    for i, ((ny, nx), stride, anchors) in enumerate(HEADS):
        raw = _raw((bs, 3, ny, nx, 6), seed=seed + i)
        x = torch.from_numpy(_conv_out(raw)).to(device, dtype)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        raws.append(raw)
        heads.append((x, anchors, stride))
    return raws, heads


@pytest.mark.parametrize("bf_type", ["yolov3", "yolov4"])
@pytest.mark.parametrize("channels_last", [False, True])
def test_decode_heads_matches_graph_per_head(channels_last, bf_type):
    """One call for three heads equals JAX's graph.decode_head per head and
    writes each head's slice, and nothing else, of a larger output."""
    jnp, jax_decode_head, _ = _jax_decoders()
    raws, heads = _three_heads(2, 11, channels_last)
    rows = [3 * ny * nx for (ny, nx), _, _ in HEADS]
    out = torch.full((2, 10 + sum(rows) + 7, 6), -7.0)
    got = decode_heads(heads, bf_type, out=out, row_offset=10)
    assert got is out
    offset = 10
    for raw, (_, stride, anchors), n in zip(raws, HEADS, rows):
        ref = np.asarray(jax_decode_head(jnp.asarray(raw), anchors, stride,
                                         bf_type))
        np.testing.assert_allclose(out[:, offset:offset + n].numpy(), ref,
                                   **TOL)
        offset += n
    assert (out[:, :10] == -7).all() and (out[:, offset:] == -7).all()
    # without `out`: exactly the heads' rows; one bf_type per head allowed
    alone = decode_heads(heads, [bf_type] * 3)
    assert alone.shape == (2, sum(rows), 6)
    np.testing.assert_array_equal(alone.numpy(),
                                  out[:, 10:10 + sum(rows)].numpy())


def test_decode_heads_rejects_mismatched_heads():
    _, heads = _three_heads(2, 3, True)
    with pytest.raises(ValueError):
        decode_heads([], "yolov4")
    with pytest.raises(ValueError):
        decode_heads(heads, ["yolov4", "yolov3"])
    with pytest.raises(ValueError):          # another batch size
        decode_heads(heads[:2] + [(heads[2][0][:1], ANCHORS, 32)], "yolov4")
    with pytest.raises(ValueError):          # another number of outputs
        decode_heads(heads[:2] + [(torch.zeros((2, 21, 2, 3)), ANCHORS, 32)],
                     "yolov4")


def test_fast_path_is_chosen_from_layout():
    """The kernel's 16-byte path: channels-last bf16, six values a row, a
    grid of a multiple of 4 cells; anything else goes the general way."""
    x = torch.zeros((2, 18, 8, 16), dtype=torch.bfloat16)
    cl = x.contiguous(memory_format=torch.channels_last)
    assert fast_path(cl.shape, cl.stride(), cl.dtype, 3)
    assert not fast_path(x.shape, x.stride(), x.dtype, 3)          # NCHW
    assert not fast_path(cl.shape, cl.stride(), torch.float32, 3)  # fp32
    assert not fast_path(cl.shape, cl.stride(), cl.dtype, 2)       # no = 9
    odd = torch.zeros((2, 18, 5, 7), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert not fast_path(odd.shape, odd.stride(), odd.dtype, 3)    # 35 cells
    part = cl[:, :, :, :8]                                         # not dense
    assert not fast_path(part.shape, part.stride(), part.dtype, 3)
    # the flagship's and MNv3's heads at 512x640, and at 416x512 (rect
    # eval), where 13 x 16 = 208 cells leave a last block of 16
    for ny, nx in ((64, 80), (32, 40), (16, 20), (52, 64), (26, 32),
                   (13, 16)):
        h = torch.zeros((1, 18, ny, nx), dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        assert fast_path(h.shape, h.stride(), h.dtype, 3)


def test_plan_is_kept_by_the_anchors_values():
    """The kernel's arguments for a model's heads are worked out once and
    found again by value: equal anchors in another array give the same
    plan, anchors changed in place a new one with the new grid anchors."""
    _, heads = _three_heads(2, 3, True, dtype=torch.bfloat16)
    types = ("yolov4",) * 3
    plan = K1._plan(K1._specs(heads), types, None, 0)
    bs, no, total, launches = plan
    assert (bs, no, total) == (2, 6, 3 * (96 + 24 + 6)) and len(launches) == 1
    args, fast, part = launches[0]
    assert args.n == 3 and list(part) == [0, 1, 2]
    assert fast == [True, True, False]       # 96 and 24 cells: 4s; 6 not
    assert [args.h[i].row_offset for i in range(3)] == [0, 288, 360]
    np.testing.assert_array_equal(
        np.asarray(args.h[1].wh[:6], np.float32),
        (HEADS[1][2] / np.float32(16)).reshape(-1))
    copies = [(x, a.copy(), s) for x, a, s in heads]
    assert K1._plan(K1._specs(copies), types, None, 0) is plan
    copies[1][1][0, 0] = 100.0               # in place
    changed = K1._plan(K1._specs(copies), types, None, 0)
    assert changed is not plan
    assert changed[3][0][0].h[1].wh[0] == np.float32(100.0) / np.float32(16)
    assert plan[3][0][0].h[1].wh[0] == np.float32(20.0) / np.float32(16)
    # another place in the output is another plan
    assert K1._plan(K1._specs(heads), types, 6000, 10)[3][0][0].h[0] \
        .row_offset == 10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bf_type", ["yolov3", "yolov4"])
def test_kernel_matches_plain_on_card(cuda, dtype, bf_type):
    """Kernel vs plain version on the same (bf16 or fp32) input, for the
    three MNv3 head shapes at 512x640, in both memory layouts. Bound 1e-4
    relative: the kernel's expf and the library's differ by a few ulp."""
    raw = _raw((3, 3, 64, 80, 6), seed=1)
    for ny, nx in ((64, 80), (32, 40), (16, 20)):
        r = raw[:, :, :ny, :nx]
        x = torch.from_numpy(_conv_out(r)).to(cuda, dtype)
        for fmt in (torch.contiguous_format, torch.channels_last):
            xf = x.contiguous(memory_format=fmt)
            n0 = _build.launches["decode_head"]
            got = decode_head(xf, ANCHORS, 8, bf_type)
            assert _build.launches["decode_head"] == n0 + 1
            want = decode_head_plain(reshape_head(xf, 3, 6), ANCHORS, 8,
                                     bf_type)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# grids of three heads: 512x640 (every head on the 16-byte path when bf16
# channels-last), 416x512 (rect eval: the 13x16 head's last block takes 16
# cells), and a ragged one (221 and 63 cells: general path; 20 cells: one
# short block of the 16-byte path)
GRIDS = {"aligned": ((64, 80), (32, 40), (16, 20)),
         "eval": ((52, 64), (26, 32), (13, 16)),
         "ragged": ((13, 17), (7, 9), (4, 5))}


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bf_type", ["yolov3", "yolov4"])
def test_one_launch_matches_plain_on_card(cuda, bf_type, dtype,
                                          channels_last, grid):
    """Three heads in one launch, into a slice of a larger output, against
    the plain version per head: 1e-5 relative + 1e-5 (the same fp32
    formulas; expf and the library's exp differ by a few ulp)."""
    bs = 3
    heads, want = [], []
    for i, (ny, nx) in enumerate(GRIDS[grid]):
        raw = _raw((bs, 3, ny, nx, 6), seed=5 + i) * 3
        x = torch.from_numpy(_conv_out(raw)).to(cuda, dtype)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        stride, anchors = 8 * 2 ** i, ANCHORS * (i + 1)
        heads.append((x, anchors, stride))
        want.append(decode_head_plain(reshape_head(x, 3, 6), anchors, stride,
                                      bf_type))
    want = torch.cat(want, dim=1)
    rows = want.shape[1]
    for offset in (0, 6, 5):          # 5: rows off the 16-byte store
        out = torch.full((bs, offset + rows + 3, 6), -7.0, device=cuda)
        n0 = _build.launches["decode_head"]
        h0 = _build.launches[K1.HEADS_DECODED]
        decode_heads(heads, bf_type, out=out, row_offset=offset)
        assert _build.launches["decode_head"] == n0 + 1
        assert _build.launches[K1.HEADS_DECODED] == h0 + 3
        torch.cuda.synchronize()
        got = out[:, offset:offset + rows]
        assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5).all())
        assert (out[:, :offset] == -7).all()
        assert (out[:, offset + rows:] == -7).all()


@pytest.mark.cuda
def test_more_heads_than_a_launch_takes_on_card(cuda):
    """Five heads: two launches, every slice written."""
    raw = _raw((2, 3, 8, 16, 6), seed=9)
    x = torch.from_numpy(_conv_out(raw)).to(cuda, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    heads = [(x, ANCHORS * (i + 1), 8) for i in range(5)]
    n0 = _build.launches["decode_head"]
    got = decode_heads(heads, "yolov4")
    assert _build.launches["decode_head"] == n0 + 2
    want = torch.cat([decode_head_plain(reshape_head(x, 3, 6), a, s, "yolov4")
                      for _, a, s in heads], dim=1)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5).all())
