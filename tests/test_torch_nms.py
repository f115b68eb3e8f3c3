"""K2 (greedy NMS) and the batched non_max_suppression around it.

The port's plain K2 is held index-exact against the Pallas kernel in
interpret mode, on scores in random order; the port's non_max_suppression
against the JAX one; the CUDA kernel against the plain version on the
card.

The CUDA kernel's algorithm (rank by counting, upper-triangular mask in
rank order, scan for the first rank alive) has a plain torch twin here,
``nms_indices_rank_scan``. It decides ``IoU > thres`` as the kernel does:
by a multiply test with a margin of 2**-20 where that is sure, by the
division otherwise. It is held index-exact (no tolerance: the decision must
fall as the fp32 quotient falls) against the JAX ``ops/nms.nms_indices``
and against the port's plain loop, also on pools built to land IoU within
a few ulps of the threshold.

JAX is imported inside the tests that use it, so that the card, which has
no JAX, can run the CUDA cases:
    python -m pytest --noconftest -m cuda tests/test_torch_nms.py
"""

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.ops import _build
from double_yolo_kaist_torch.ops.boxes import box_iou
from double_yolo_kaist_torch.ops.nms import non_max_suppression
from double_yolo_kaist_torch.ops.nms_kernel import (NEG_INF, nms_indices,
                                                    nms_indices_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.random((n, 2), dtype=np.float32) * 200
    wh = rng.random((n, 2), dtype=np.float32) * 60 + 2
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.random(n).astype(np.float32)
    return boxes, scores


def _pallas(boxes, scores, iou, max_det):
    import jax
    import jax.numpy as jnp
    from double_yolo_kaist_tpu.ops.pallas_nms import pallas_nms_indices
    i, v = jax.vmap(lambda b, s: pallas_nms_indices(
        b, s, iou_thres=iou, max_det=max_det, interpret=True))(
        jnp.asarray(boxes), jnp.asarray(scores))
    return np.asarray(i), np.asarray(v)


def _assert_same(idx, valid, ref_idx, ref_valid):
    np.testing.assert_array_equal(valid, ref_valid)
    np.testing.assert_array_equal(np.where(valid, idx, 0),
                                  np.where(ref_valid, ref_idx, 0))


@pytest.mark.parametrize("seed,iou", [(0, 0.5), (1, 0.3), (2, 0.6)])
def test_plain_matches_pallas(seed, iou):
    boxes, scores = _rand(128, seed)
    ri, rv = _pallas(boxes[None], scores[None], iou, 32)
    i, v = nms_indices(torch.from_numpy(boxes[None]),
                       torch.from_numpy(scores[None]), iou, 32)
    _assert_same(i.numpy(), v.numpy(), ri, rv)


def test_plain_fewer_than_max_det():
    boxes, scores = _rand(128, 3)
    scores[10:] = -1e10                      # mask most candidates out
    ri, rv = _pallas(boxes[None], scores[None], 0.5, 64)
    i, v = nms_indices_plain(torch.from_numpy(boxes[None]),
                             torch.from_numpy(scores[None]), 0.5, 64)
    _assert_same(i.numpy(), v.numpy(), ri, rv)
    assert 0 < v.sum() <= 10 and not v[0, v[0].int().argmin():].any()


def test_plain_batched_matches_pallas():
    pools = [_rand(128, 10 + s) for s in range(3)]
    boxes = np.stack([p[0] for p in pools])
    scores = np.stack([p[1] for p in pools])
    scores[1, ::3] = -1e10
    ri, rv = _pallas(boxes, scores, 0.5, 48)
    i, v = nms_indices_plain(torch.from_numpy(boxes),
                             torch.from_numpy(scores), 0.5, 48)
    _assert_same(i.numpy(), v.numpy(), ri, rv)


def _pool(kind, k, seed):
    """A pool of ``k`` candidates: scores in random order, sorted
    descending, on a few levels (many ties), or mostly masked out."""
    boxes, scores = _rand(k, seed)
    if kind == "sorted":
        scores = np.sort(scores)[::-1].copy()
    elif kind == "tied":
        scores = np.round(scores * 4) / 4
    elif kind == "tied-sorted":
        scores = np.sort(np.round(scores * 4) / 4)[::-1].copy()
    elif kind == "short":
        scores[7:] = -1e10
    elif kind == "none":
        scores[:] = -1e10
    return boxes, scores.astype(np.float32)


def _dense_pool(k, n_centres, seed, order="random"):
    """An eval-like pool: ``k`` boxes jittered around ``n_centres`` centres
    (every round suppresses a cluster); with few centres the pool runs out
    before ``max_det`` rounds, with many it does not. ``order``: scores in
    random order, or sorted descending as non_max_suppression hands them
    over."""
    rng = np.random.default_rng(seed)
    centres = rng.random((n_centres, 2), dtype=np.float32) * [560, 432]
    size = rng.random((n_centres, 2), dtype=np.float32) * [40, 80] + 20
    c = rng.integers(0, n_centres, k)
    xy = centres[c] + rng.normal(0, 3, (k, 2)).astype(np.float32)
    wh = size[c] * rng.uniform(0.85, 1.15, (k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.random(k).astype(np.float32) * 0.9 + 0.01
    if order == "sorted":
        scores = np.sort(scores)[::-1].copy()
    return boxes, scores


def _dense_batch(bs, k, order, seed=700):
    """Images alternating 20 centres (the pool runs out before 100 rounds)
    and 300 (it does not)."""
    pools = [_dense_pool(k, 20 if s % 2 == 0 else 300, seed + s, order)
             for s in range(bs)]
    return np.stack([p[0] for p in pools]), np.stack([p[1] for p in pools])


@pytest.mark.parametrize("order", ["random", "sorted"])
def test_rank_scan_dense_pool_matches_jax_and_plain(order):
    """Eval-like dense pools (K 512, IoU 0.6, max_det 100): every round
    suppresses, and some pools run out before max_det."""
    import jax.numpy as jnp
    from double_yolo_kaist_tpu.ops import nms as JN
    boxes, scores = _dense_batch(2, 512, order)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    i, v, _ = nms_indices_rank_scan(tb, ts, 0.6, 100)
    pi, pv = nms_indices_plain(tb, ts, 0.6, 100)
    _assert_same(i.numpy(), v.numpy(), pi.numpy(), pv.numpy())
    for b in range(2):
        ji, jv = JN.nms_indices(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                iou_thres=0.6, max_det=100)
        _assert_same(i[b].numpy(), v[b].numpy(), np.asarray(ji),
                     np.asarray(jv))
    kept = v.sum(1).tolist()
    assert kept[0] < 100 and kept[1] == 100, kept


def iou_over_with_margin(boxes, thres: float):
    """``IoU > thres`` for every pair of ``boxes`` (B, K, 4), decided as
    csrc/nms.cu decides it (iou_terms, iou_over): inter and den in box_iou's
    order of fp32 operations; sure where inter lies outside thres (1 -+
    2**-20) den (and den > 1e-30), the division only elsewhere. Returns the
    (B, K, K) decisions and how many pairs took the division."""
    f32 = torch.float32
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    den = area[:, :, None] + area[:, None, :] - inter + 1e-16
    t = torch.tensor(thres, dtype=f32)
    if thres > 1e-6:
        th_hi = t * torch.tensor(1 + 2.0 ** -20, dtype=f32)
        th_lo = t * torch.tensor(1 - 2.0 ** -20, dtype=f32)
    else:
        th_hi, th_lo = torch.tensor(np.inf), torch.tensor(-np.inf)
    over = inter > th_hi * den
    sure = (den > 1e-30) & (over | (inter < th_lo * den))
    over = torch.where(sure, over, inter / den > t)
    return over, int((~sure).sum())


def nms_indices_rank_scan(boxes, scores, iou_thres: float, max_det: int):
    """The CUDA kernel's algorithm in plain torch, same contract as
    ``nms_indices_plain``: rank every candidate by counting those that beat
    it (higher score, then lower index), put the pool in rank order, take
    the upper triangle of ``IoU > iou_thres`` there (decided with the
    kernel's margin test), then scan: the next winner is the first rank
    still alive among the valid ones, and it clears the ranks its mask row
    holds. Also returns the number of pairs that took the division."""
    bs, k = scores.shape
    s = scores.float()
    ar = torch.arange(k)
    beats = (s[:, :, None] > s[:, None, :]) | (
        (s[:, :, None] == s[:, None, :]) & (ar[:, None] < ar[None, :]))
    rank = beats.sum(1)                               # beats[b, j, i]: j, i
    order = torch.empty_like(rank).scatter_(1, rank, ar.expand(bs, k))
    sbox = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    over, n_divided = iou_over_with_margin(sbox, iou_thres)
    mask = torch.triu(over, diagonal=1)
    n_valid = (s > NEG_INF / 2).sum(1)
    idx = torch.zeros((bs, max_det), dtype=torch.int32)
    valid = torch.zeros((bs, max_det), dtype=torch.bool)
    for b in range(bs):
        alive = ar < n_valid[b]
        for n in range(max_det):
            left = alive.nonzero()
            if left.numel() == 0:
                break
            r = int(left[0])
            idx[b, n], valid[b, n] = order[b, r], True
            alive &= ~mask[b, r]
            alive[r] = False
    return idx, valid, n_divided


def _near_threshold_pool(thres: float, seed: int):
    """Pairs of boxes whose IoU lies on ``thres``, a few fp32 ulps to either
    side of it (inside the kernel's margin) and some tens of ulps away
    (outside it), each pair far from the others: A = (0, y0, 1, y0 + 1) and
    B = A widened to the right to 1 / thres, moved by some ulps. Scores in
    random order. Returns boxes (1, K, 4), scores (1, K)."""
    rng = np.random.default_rng(seed)
    boxes = []
    steps = (0, 1, 2, 3, 5, 8, 40, 100)
    for j, step in enumerate(sorted({-s for s in steps} | set(steps))):
        y0 = np.float32(2.0 * j)
        x1 = np.float32(1.0 / thres)
        for _ in range(abs(step)):
            x1 = np.nextafter(x1, np.float32(np.inf if step > 0 else -np.inf))
        boxes.append([0.0, y0, 1.0, y0 + 1.0])
        boxes.append([0.0, y0, x1, y0 + 1.0])
    boxes = np.asarray(boxes, dtype=np.float32)
    scores = rng.permutation(len(boxes)).astype(np.float32) / len(boxes)
    return boxes[None], scores[None] + np.float32(0.01)


@pytest.mark.parametrize("kind,k,max_det", [
    ("random", 128, 32), ("sorted", 128, 32), ("tied", 128, 48),
    ("tied-sorted", 96, 48), ("short", 128, 32), ("random", 45, 64),
    ("tied", 33, 40), ("none", 40, 8),
])
def test_rank_scan_matches_jax_and_plain(kind, k, max_det):
    """K not a multiple of 32, more rounds than candidates, ties (which the
    rank must break to the lower index), a short and an empty pool."""
    import jax.numpy as jnp
    from double_yolo_kaist_tpu.ops import nms as JN
    pools = [_pool(kind, k, 20 + s) for s in range(2)]
    boxes = np.stack([p[0] for p in pools])
    scores = np.stack([p[1] for p in pools])
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    i, v, _ = nms_indices_rank_scan(tb, ts, 0.5, max_det)
    pi, pv = nms_indices_plain(tb, ts, 0.5, max_det)
    _assert_same(i.numpy(), v.numpy(), pi.numpy(), pv.numpy())
    for b in range(2):
        ji, jv = JN.nms_indices(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                iou_thres=0.5, max_det=max_det)
        _assert_same(i[b].numpy(), v[b].numpy(), np.asarray(ji),
                     np.asarray(jv))
    assert v.any() == (kind != "none")


@pytest.mark.parametrize("thres", [0.5, 0.3, 0.45, 0.6])
def test_rank_scan_margin_decides_as_the_quotient_near_thres(thres):
    """IoU within a few ulps of the threshold, on both sides: the margin
    test must hand exactly these pairs to the division (some, not all), and
    the winners must be the plain loop's and the JAX function's."""
    import jax.numpy as jnp
    from double_yolo_kaist_tpu.ops import nms as JN
    boxes, scores = _near_threshold_pool(thres, seed=int(thres * 100))
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    over, n_divided = iou_over_with_margin(tb, thres)
    iou = box_iou(tb, tb)
    assert torch.equal(over, iou > thres)
    k = boxes.shape[1]
    near = (iou / thres - 1).abs() < 2.0 ** -21    # well inside the margin
    far = (iou / thres - 1).abs() > 2.0 ** -19     # well outside it
    # every close pair divides, no far one does, and both kinds are there
    assert 12 <= int(near.sum()) <= n_divided <= k * k - int(far.sum())
    assert (far & (iou > 0.9 * thres) & (iou < 1.1 * thres)).sum() >= 4
    assert 0 < int((over & near).sum()) < int(near.sum())
    i, v, _ = nms_indices_rank_scan(tb, ts, thres, k)
    pi, pv = nms_indices_plain(tb, ts, thres, k)
    _assert_same(i.numpy(), v.numpy(), pi.numpy(), pv.numpy())
    ji, jv = JN.nms_indices(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                            iou_thres=thres, max_det=k)
    _assert_same(i[0].numpy(), v[0].numpy(), np.asarray(ji), np.asarray(jv))
    assert k // 2 < int(v.sum()) < k                # some pairs suppress


def _pred(bs, m, nc, seed, tied=False):
    rng = np.random.default_rng(seed)
    xy = rng.random((bs, m, 2), dtype=np.float32) * 160
    wh = rng.random((bs, m, 2), dtype=np.float32) * 50 + 1
    obj = rng.random((bs, m, 1), dtype=np.float32)
    cls = rng.random((bs, m, nc), dtype=np.float32)
    if tied:                                 # few score levels: many ties
        obj = np.round(obj * 4) / 4
        cls = np.ones_like(cls)
    return np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)


@pytest.mark.parametrize("nc,multi_label,merge,agnostic,tied,top_k", [
    (3, True, False, False, False, 512),
    (3, False, False, False, False, 512),
    (3, True, True, False, False, 512),
    (1, True, True, False, False, 512),
    (3, True, False, True, False, 512),
    (1, False, False, False, True, 64),
    (3, True, False, False, True, 96),
], ids=["multi", "single", "multi-merge", "nc1-merge", "agnostic",
        "tied-nc1", "tied-multi"])
def test_non_max_suppression_matches_jax(nc, multi_label, merge, agnostic,
                                         tied, top_k):
    import jax.numpy as jnp
    from double_yolo_kaist_tpu.ops import nms as JN
    pred = _pred(2, 200, nc, seed=nc + 10 * tied, tied=tied)
    kw = dict(conf_thres=0.1, iou_thres=0.5, multi_label=multi_label,
              top_k=top_k, max_det=40, agnostic=agnostic, merge=merge)
    rdet, rvalid = JN.non_max_suppression(jnp.asarray(pred), **kw)
    det, valid = non_max_suppression(torch.from_numpy(pred), **kw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    assert valid.any()
    # boxes are the same fp32 ops; merge sums in another order (matmul)
    np.testing.assert_allclose(det.numpy(), np.asarray(rdet), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "sorted", "tied", "tied-sorted",
                                  "short", "none"])
@pytest.mark.parametrize("k,max_det,bs", [(33, 40, 1), (512, 100, 8),
                                          (512, 100, 32), (1024, 100, 8),
                                          (1024, 300, 1)])
def test_kernel_pools_on_card(cuda, k, max_det, bs, kind):
    """Index-exact on the card for every kind of pool: the ranking path
    (random, tied), the sorted path that skips it, pools that end early."""
    pools = [_pool(kind, k, 300 + s) for s in range(bs)]
    boxes = torch.from_numpy(np.stack([p[0] for p in pools])).to(cuda)
    scores = torch.from_numpy(np.stack([p[1] for p in pools])).to(cuda)
    for thres in (0.5, 0.3):
        i, v = nms_indices(boxes, scores, thres, max_det)
        ri, rv = nms_indices_plain(boxes, scores, thres, max_det)
        torch.cuda.synchronize()
        _assert_same(i.cpu().numpy(), v.cpu().numpy(), ri.cpu().numpy(),
                     rv.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k,max_det,bs", [(512, 100, 8), (1024, 100, 2),
                                          (100, 128, 3), (37, 10, 1)])
def test_kernel_matches_plain_on_card(cuda, k, max_det, bs):
    """Index-exact on the card, scores in random order; one image of the
    batch has most of its pool masked out."""
    pools = [_rand(k, 100 + s) for s in range(bs)]
    boxes = torch.from_numpy(np.stack([p[0] for p in pools])).to(cuda)
    scores = torch.from_numpy(np.stack([p[1] for p in pools])).to(cuda)
    scores[0, 5:] = -1e10
    n0 = _build.launches["nms_indices"]
    i, v = nms_indices(boxes, scores, 0.5, max_det)
    assert _build.launches["nms_indices"] == n0 + 1
    ri, rv = nms_indices_plain(boxes, scores, 0.5, max_det)
    torch.cuda.synchronize()
    _assert_same(i.cpu().numpy(), v.cpu().numpy(), ri.cpu().numpy(),
                 rv.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("thres", [0.5, 0.3, 0.45, 0.6])
def test_kernel_decides_as_the_quotient_near_thres_on_card(cuda, thres):
    """The kernel's margin test on pairs whose IoU lies within a few ulps of
    the threshold: index-exact against the plain loop."""
    boxes, scores = _near_threshold_pool(thres, seed=int(thres * 100))
    boxes = torch.from_numpy(boxes).to(cuda)
    scores = torch.from_numpy(scores).to(cuda)
    k = boxes.shape[1]
    i, v = nms_indices(boxes, scores, thres, k)
    ri, rv = nms_indices_plain(boxes, scores, thres, k)
    torch.cuda.synchronize()
    _assert_same(i.cpu().numpy(), v.cpu().numpy(), ri.cpu().numpy(),
                 rv.cpu().numpy())
    assert k // 2 < int(v.sum()) < k


@pytest.mark.cuda
@pytest.mark.parametrize("k,bs,order", [(1024, 32, "random"),
                                        (1024, 32, "sorted"),
                                        (512, 32, "random")])
def test_kernel_repeats_exactly_on_card(cuda, k, bs, order):
    """300 launches back to back on the same pool, every one index-exact
    against the plain loop: the cluster's hand-overs through distributed
    shared memory hold under load, launch after launch."""
    pools = [_pool(order, k, 500 + s) for s in range(bs)]
    boxes = torch.from_numpy(np.stack([p[0] for p in pools])).to(cuda)
    scores = torch.from_numpy(np.stack([p[1] for p in pools])).to(cuda)
    ri, rv = nms_indices_plain(boxes, scores, 0.5, 100)
    want = torch.where(rv, ri, 0)
    outs = [nms_indices(boxes, scores, 0.5, 100) for _ in range(300)]
    torch.cuda.synchronize()
    bad = [n for n, (i, v) in enumerate(outs)
           if not (torch.equal(v, rv) and torch.equal(torch.where(v, i, 0),
                                                      want))]
    assert not bad, f"launches {bad[:10]} of 300 disagree"


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("bs", [8, 32])
def test_kernel_dense_pools_on_card(cuda, bs, order):
    """K2 on eval-like dense pools (512 boxes around 20 or 300 centres, IoU
    0.6, max_det 100): index-exact against the plain loop, with pools that
    run out before max_det and pools that do not."""
    boxes, scores = _dense_batch(bs, 512, order)
    boxes = torch.from_numpy(boxes).to(cuda)
    scores = torch.from_numpy(scores).to(cuda)
    i, v = nms_indices(boxes, scores, 0.6, 100)
    ri, rv = nms_indices_plain(boxes, scores, 0.6, 100)
    torch.cuda.synchronize()
    _assert_same(i.cpu().numpy(), v.cpu().numpy(), ri.cpu().numpy(),
                 rv.cpu().numpy())
    kept = v.sum(1).tolist()
    assert min(kept) < 100 and max(kept) == 100, kept
