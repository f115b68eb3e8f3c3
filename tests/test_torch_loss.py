"""The port's box IoUs and YOLO loss (``ops/boxes.bbox_iou``,
``train/loss.py``) against the JAX package's on the CPU, fp32 on both
sides, from the same numpy inputs.

Tolerances: the same fp32 formulas in the same order, so loss terms agree
to 1e-5 relative and IoUs to 1e-6; gradients (with respect to the boxes,
and to the raw heads) to 1e-4 of the tensor's largest magnitude. The
``cuda`` case (the card's run; it skips here) holds the loss and its
gradients on the card against the CPU, collisions included, as above.
"""

import zlib

import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.ops import boxes as TB
from double_yolo_kaist_torch.train import loss as TL

try:        # the card's machine has no JAX: only the cuda cases run there
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.ops import boxes as JB
    from double_yolo_kaist_tpu.train import loss as JL
except ModuleNotFoundError:
    jax = None

GRIDS = [(8, 12, 8), (4, 6, 16), (2, 3, 32)]       # ny, nx, stride at 64x96
ANCHORS = [np.array([[10, 13], [16, 30], [33, 23]], np.float32),
           np.array([[30, 61], [62, 45], [59, 119]], np.float32),
           np.array([[116, 90], [156, 198], [373, 326]], np.float32)]
HYP = {"box": 3.54, "obj": 64.3, "cls": 37.4, "cls_pw": 1.0, "obj_pw": 1.0,
       "iou_t": 0.2}


def close_grad(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= rel * scale, \
        (np.abs(got - want).max(), scale)


def random_boxes(rng, n):
    xy = rng.uniform(0, 20, (n, 2))
    wh = rng.uniform(0.5, 10, (n, 2))
    return np.concatenate([xy, wh], 1).astype(np.float32)


@pytest.mark.parametrize("mode", ["iou", "giou", "diou", "ciou"])
def test_bbox_iou_matches_jax(mode):
    rng = np.random.default_rng(0)
    b1, b2 = random_boxes(rng, 64), random_boxes(rng, 64)
    b2[:8] = b1[:8] + rng.normal(0, 0.3, (8, 4)).astype(np.float32)
    kw = {} if mode == "iou" else {mode: True}

    def jf(a, b):
        return jnp.sum(JB.bbox_iou(a, b, xywh=True, **kw))
    want = JB.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=True, **kw)
    jg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(b1), jnp.asarray(b2))
    t1 = torch.from_numpy(b1).requires_grad_(True)
    t2 = torch.from_numpy(b2).requires_grad_(True)
    got = TB.bbox_iou(t1, t2, xywh=True, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    tg = torch.autograd.grad(got.sum(), (t1, t2))
    for g, w in zip(tg, jg):
        close_grad(g.numpy(), w)


def make_case(rng, nc, B=3, T=6, collide=False):
    heads = [rng.normal(0, 1.5, (B, 3, ny, nx, nc + 5)).astype(np.float32)
             for ny, nx, _ in GRIDS]
    targets = np.zeros((B, T, 5), np.float32)
    tmask = np.zeros((B, T), bool)
    for b in range(B):
        n = int(rng.integers(1, T + 1))
        targets[b, :n, 0] = rng.integers(0, nc, n)
        targets[b, :n, 1:3] = rng.uniform(0.05, 0.95, (n, 2))
        targets[b, :n, 3:5] = rng.uniform(0.05, 0.6, (n, 2))
        tmask[b, :n] = True
    if collide:
        # two labels of image 0 in one cell with one anchor's shape: both
        # match it, and their objectness targets land on one cell
        targets[0, :2] = [[0, 0.52, 0.47, 0.25, 0.3],
                          [nc - 1, 0.53, 0.49, 0.26, 0.31]]
        tmask[0, :2] = True
    return heads, targets, tmask


def specs(nc, bf_type):
    return ([JL.HeadSpec(a / s, s, bf_type, nc)
             for a, (_, _, s) in zip(ANCHORS, GRIDS)],
            port_specs(nc, bf_type))


def port_specs(nc, bf_type):
    return [TL.HeadSpec(a / s, s, bf_type, nc)
            for a, (_, _, s) in zip(ANCHORS, GRIDS)]


def run_both(heads, targets, tmask, nc, bf_type, hyp):
    jspecs, tspecs = specs(nc, bf_type)

    def jtotal(hs):
        ld = JL.compute_loss(hs, jnp.asarray(targets), jnp.asarray(tmask),
                             jspecs, hyp)
        return JL.total_loss(ld), ld
    (_, jld), jg = jax.value_and_grad(jtotal, has_aux=True)(
        [jnp.asarray(h) for h in heads])
    th = [torch.from_numpy(h).requires_grad_(True) for h in heads]
    tld = TL.compute_loss(th, torch.from_numpy(targets),
                          torch.from_numpy(tmask), tspecs, hyp)
    tg = torch.autograd.grad(TL.total_loss(tld), th)
    return jld, jg, tld, tg


@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("fl_gamma", [0.0, 1.5])
@pytest.mark.parametrize("box", ["ciou", "giou"])
@pytest.mark.parametrize("bf_type", ["yolov3", "yolov4"])
def test_compute_loss_matches_jax(bf_type, box, fl_gamma, nc):
    rng = np.random.default_rng(zlib.crc32(f"{bf_type}{box}{fl_gamma}{nc}"
                                           .encode()))
    hyp = dict(HYP, fl_gamma=fl_gamma)
    if box == "ciou":
        hyp["ciou"] = 1.0
    heads, targets, tmask = make_case(rng, nc)
    jld, jg, tld, tg = run_both(heads, targets, tmask, nc, bf_type, hyp)
    for k in ("box_loss", "obj_loss", "class_loss"):
        np.testing.assert_allclose(tld[k].item(), float(jld[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert tld["box_loss"].item() > 0 and tld["obj_loss"].item() > 0
    assert (tld["class_loss"].item() > 0) == (nc > 1)
    for g, w in zip(tg, jg):
        close_grad(g.numpy(), w)


@pytest.mark.parametrize("bf_type", ["yolov3", "yolov4"])
def test_objectness_collision_keeps_the_last_candidate(bf_type):
    """Two matched candidates on one cell: XLA keeps the last in (b, t, a)
    order; so does the port, so the objectness loss and its gradient
    equal JAX's."""
    rng = np.random.default_rng(7)
    heads, targets, tmask = make_case(rng, 3, collide=True)
    jspecs, tspecs = specs(3, bf_type)
    ny, nx = GRIDS[0][:2]
    cells = [(int(targets[0, t, 2] * ny), int(targets[0, t, 1] * nx))
             for t in range(2)]
    assert cells[0] == cells[1]
    jld, jg, tld, tg = run_both(heads, targets, tmask, 3, bf_type,
                                dict(HYP, ciou=1.0))
    np.testing.assert_allclose(tld["obj_loss"].item(),
                               float(jld["obj_loss"]), rtol=1e-5)
    for g, w in zip(tg, jg):
        close_grad(g.numpy(), w)


def test_last_wins_scatter():
    lin = torch.tensor([3, 1, 3, 0, 3, 1])
    valid = torch.tensor([True, True, True, True, False, False])
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    got = TL._last_wins_scatter((2, 3), lin, valid, vals)
    want = torch.tensor([[4.0, 2.0, 0.0], [3.0, 0.0, 0.0]])
    assert torch.equal(got, want)
    ref = jnp.zeros(6).at[jnp.where(jnp.asarray(valid.numpy()),
                                    jnp.asarray(lin.numpy()), 6)].set(
        jnp.asarray(vals.numpy()), mode="drop")
    np.testing.assert_array_equal(got.reshape(-1).numpy(), np.asarray(ref))


def test_pad_labels_matches_jax():
    rng = np.random.default_rng(1)
    labels = [rng.random((n, 5)).astype(np.float32) for n in (0, 3, 9)]
    for a, b in zip(TL.pad_labels(labels, 4), JL.pad_labels(labels, 4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bf_type", ["yolov3", "yolov4"])
def test_loss_card_matches_cpu(bf_type):
    """The loss and its head gradients on the card, the objectness
    collision included (the scatter keeps the last candidate there too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    heads, targets, tmask = make_case(np.random.default_rng(8), 3,
                                      collide=True)
    hyp = dict(HYP, ciou=1.0, fl_gamma=1.5)
    out = {}
    for dev in ("cuda", "cpu"):
        th = [torch.from_numpy(h).to(dev).requires_grad_(True)
              for h in heads]
        ld = TL.compute_loss(th, torch.from_numpy(targets).to(dev),
                             torch.from_numpy(tmask).to(dev),
                             port_specs(3, bf_type), hyp)
        grads = torch.autograd.grad(TL.total_loss(ld), th)
        out[dev] = ({k: v.item() for k, v in ld.items()},
                    [g.cpu().numpy() for g in grads])
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    for k in lh:
        np.testing.assert_allclose(lc[k], lh[k], rtol=1e-5, atol=1e-7)
    for g, w in zip(gc, gh):
        close_grad(g, w)
