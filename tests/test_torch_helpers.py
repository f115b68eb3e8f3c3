"""The port's twins of the JAX package's public helpers (ROADMAP.md queue
1, item 19), each against the JAX function on seeded inputs:
``ops/boxes.py`` (``xyxy2xywh``, ``clip_coords``, ``scale_coords``,
``wh_iou``), ``data/augment.py`` (``letterbox_params``,
``letterbox_batch``, ``letterbox_labels``) and
``models/quantize.make_calibration_fn``; and the callers that now use
them: the evaluator's letterbox undo and the loss's anchor matching,
bit-equal to the inline code they replaced.

Tolerances: box arithmetic is a few fp32 operations in the same order on
both sides, so 1e-5 of the values' magnitude (XLA on the CPU may fuse a
subtraction and a division into other roundings); the letterboxed images
within 1e-3 of [0, 255], ``tests/test_torch_augment.py``'s bound for the
gather resize; the calibration statistics within 1e-5 relative,
``tests/test_torch_quantize.py``'s bound.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.data import augment as TA
from double_yolo_kaist_torch.eval.evaluator import _undo_letterbox
from double_yolo_kaist_torch.models import graph as TG
from double_yolo_kaist_torch.models import quantize as TQ
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.ops import boxes as TB
from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
from double_yolo_kaist_tpu.data import augment as JA
from double_yolo_kaist_tpu.models import graph as JG
from double_yolo_kaist_tpu.models import quantize as JQ
from double_yolo_kaist_tpu.ops import boxes as JB

TINY = os.path.join(os.path.dirname(__file__), "fixtures",
                    "tiny_dyolov3.cfg")


def _boxes(rng, n=64, lo=-40.0, hi=700.0):
    xy = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    wh = rng.uniform(1.0, 300.0, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], axis=1)


def close(got, want, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1.0))


def test_xyxy2xywh_and_clip_coords():
    rng = np.random.default_rng(0)
    b = _boxes(rng).reshape(4, 16, 4)
    close(TB.xyxy2xywh(torch.from_numpy(b)), JB.xyxy2xywh(jnp.asarray(b)))
    close(TB.xywh2xyxy(TB.xyxy2xywh(torch.from_numpy(b))), b)
    close(TB.clip_coords(torch.from_numpy(b), (480, 640)),
          JB.clip_coords(jnp.asarray(b), (480, 640)))


@pytest.mark.parametrize("ratio_pad", [None, ((0.8, 0.8), (12.0, 30.5)),
                                       (0.5, (0.0, 64.0))],
                         ids=["derived", "pair-gain", "scalar-gain"])
def test_scale_coords(ratio_pad):
    rng = np.random.default_rng(1)
    b = _boxes(rng)
    got = TB.scale_coords((512, 640), torch.from_numpy(b), (480, 640),
                          ratio_pad)
    close(got, JB.scale_coords((512, 640), jnp.asarray(b), (480, 640),
                               ratio_pad))


def test_wh_iou():
    rng = np.random.default_rng(2)
    wh1 = rng.uniform(1, 100, (30, 2)).astype(np.float32)
    wh2 = rng.uniform(1, 100, (9, 2)).astype(np.float32)
    close(TB.wh_iou(torch.from_numpy(wh1), torch.from_numpy(wh2)),
          JB.wh_iou(jnp.asarray(wh1), jnp.asarray(wh2)))


@pytest.mark.parametrize("src, dst, up", [((48, 64), (64, 64), True),
                                          ((100, 60), (64, 96), True),
                                          ((128, 160), (64, 64), False),
                                          ((64, 64), (64, 64), True)])
def test_letterbox_batch_and_params(src, dst, up):
    assert TA.letterbox_params(src, dst, up) == JA.letterbox_params(
        src, dst, up)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (2,) + src + (3,), dtype=np.uint8)
    got, r, pad = TA.letterbox_batch(torch.from_numpy(img), dst, up, 114.0)
    want, jr, jpad = JA.letterbox_batch(jnp.asarray(img), dst, up, 114.0)
    assert (r, pad) == (jr, jpad) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def test_letterbox_labels():
    rng = np.random.default_rng(4)
    lab = rng.uniform(0.05, 0.95, (3, 7, 5)).astype(np.float32)
    got = TA.letterbox_labels(torch.from_numpy(lab), (100, 200), 0.64,
                              (3.0, 18.5))
    close(got, JA.letterbox_labels(jnp.asarray(lab), (100, 200), 0.64,
                                   (3.0, 18.5)))


@pytest.mark.parametrize("pct", [100.0, 99.9])
def test_make_calibration_fn(pct):
    """One batch's statistics of JAX's jitted calibration function and of
    the port's, on the same folded weights."""
    jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    jv = jax.tree.map(np.asarray, JG.init(jir, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    xv, xl = (rng.random((2, 64, 64, 3), dtype=np.float32) for _ in range(2))
    want = JQ.make_calibration_fn(jir, jnp.float32, pct)(
        JG.fold_batchnorm(jir, jv), jnp.asarray(xv), jnp.asarray(xl))
    folded = TG.place_folded(tir, TG.fold_batchnorm(
        tir, TW.from_jax_variables(tir, jv)), "cpu", torch.float32)
    got = TQ.make_calibration_fn(tir, torch.float32, pct)(
        folded, torch.from_numpy(xv), torch.from_numpy(xl))
    assert sorted(got) == sorted(want)
    assert any(k.endswith(".out") for k in want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5 * float(
                                       np.max(np.asarray(want[k]))),
                                   err_msg=k)


def _undo_letterbox_inline(boxes, ratio, pad, orig_hw):
    """The evaluator's letterbox undo as it was before it called
    ``ops.boxes.scale_coords``."""
    out = boxes.copy()
    out[:, [0, 2]] -= pad[0]
    out[:, [1, 3]] -= pad[1]
    out /= ratio[0]
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, orig_hw[1])
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, orig_hw[0])
    return out


def test_callers_stay_bit_equal():
    """The evaluator's letterbox undo (fp32 numpy) and the loss's wh-IoU
    with its 1e-16 give the numbers the inline code gave, bit for bit."""
    rng = np.random.default_rng(6)
    for _ in range(20):
        det = rng.uniform(-50, 700, (40, 6)).astype(np.float32)
        ratio = (float(rng.uniform(0.1, 2)),) * 2
        pad = (float(rng.uniform(0, 40)), float(rng.uniform(0, 40)))
        hw = (int(rng.integers(100, 700)), int(rng.integers(100, 700)))
        got = _undo_letterbox(det[:, :4], ratio, pad, hw)
        want = _undo_letterbox_inline(det[:, :4], ratio, pad, hw)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    gwh = torch.from_numpy(rng.uniform(0, 20, (2, 5, 2)).astype(np.float32))
    anchors = torch.from_numpy(rng.uniform(0.5, 9, (3, 2)).astype(np.float32))
    inter = torch.minimum(gwh[..., None, :], anchors).prod(-1)
    inline = inter / (gwh.prod(-1)[..., None] + anchors.prod(-1) - inter
                      + 1e-16)
    assert torch.equal(TB.wh_iou(gwh, anchors, eps=1e-16), inline)
