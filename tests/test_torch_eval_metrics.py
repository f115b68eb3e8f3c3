"""The port's host metrics against the JAX package's, on the same inputs:
``eval/metrics.py`` (VOC-AP, LAMR, greedy TP/FP matching), ``eval/
coco_map.py`` (the 12 COCO stats and their summary) and ``utils/native.py``
(the g++ build of ``native/fastmatch.cpp``). Both packages run the same
numpy code, so every result must be exactly equal, with the native matchers
and with the numpy ones.
"""

import os

import numpy as np
import pytest

from double_yolo_kaist_tpu.eval import coco_map as JC
from double_yolo_kaist_tpu.eval import metrics as JM
from double_yolo_kaist_tpu.utils import native as JN
from double_yolo_kaist_torch.eval import coco_map as TC
from double_yolo_kaist_torch.eval import metrics as TM
from double_yolo_kaist_torch.utils import native as TN


def synthetic_split(seed, n_imgs=30, w=640, h=512):
    """Labels + predictions with hits, misses, false positives, an image
    without ground truth and one without detections."""
    rng = np.random.default_rng(seed)
    labels, preds = [], []
    for i in range(n_imgs):
        n = 0 if i == 3 else int(rng.integers(1, 5))
        lab = np.zeros((n, 5), np.float32)
        lab[:, 1:3] = rng.uniform(0.2, 0.8, (n, 2))
        lab[:, 3] = rng.uniform(0.02, 0.25, n)
        lab[:, 4] = rng.uniform(0.05, 0.3, n)
        labels.append(lab)
        if i == 5:
            continue
        for j in range(n):
            if rng.random() < 0.8:
                cx, cy = lab[j, 1] * w, lab[j, 2] * h
                bw, bh = lab[j, 3] * w, lab[j, 4] * h
                jit = rng.normal(0, 3, 4)
                preds.append({"img_id": i, "conf": float(rng.uniform(0.3, 1)),
                              "bbox": np.asarray(
                                  [cx - bw / 2 + jit[0], cy - bh / 2 + jit[1],
                                   cx + bw / 2 + jit[2], cy + bh / 2 + jit[3]],
                                  np.float32)})
        for _ in range(int(rng.integers(0, 4))):
            x1, y1 = rng.uniform(0, w - 60), rng.uniform(0, h - 60)
            preds.append({"img_id": i, "conf": float(rng.uniform(0.01, 0.6)),
                          "bbox": np.asarray(
                              [x1, y1, x1 + rng.uniform(4, 200),
                               y1 + rng.uniform(4, 200)], np.float32)})
    preds.sort(key=lambda p: -p["conf"])
    shapes = np.asarray([[w, h]] * n_imgs, np.float64)
    return preds, labels, shapes


def coco_inputs(preds, labels, shapes):
    """The split as evaluate_coco takes it: predictions per image and the
    ground truth in absolute xyxy."""
    coco_preds = {}
    for p in preds:
        b, s = coco_preds.get(p["img_id"], ([], []))
        coco_preds[p["img_id"]] = (b + [p["bbox"]], s + [p["conf"]])
    coco_preds = {k: (np.asarray(b, np.float64), np.asarray(s))
                  for k, (b, s) in coco_preds.items()}
    gt = {}
    for i, lab in enumerate(labels):
        w, h = shapes[i]
        cx, cy, bw, bh = lab[:, 1] * w, lab[:, 2] * h, lab[:, 3] * w, \
            lab[:, 4] * h
        gt[i] = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                          cy + bh / 2], 1)
    return coco_preds, gt


@pytest.fixture(params=["native", "numpy"])
def matcher(request, monkeypatch):
    """Both packages on their native matchers, or both on numpy."""
    if request.param == "numpy":
        monkeypatch.setattr(JN, "get_lib", lambda: None)
        monkeypatch.setattr(TN, "get_lib", lambda: None)
    else:
        assert TN.get_lib() is not None, "g++ did not build fastmatch.cpp"
        assert JN.get_lib() is not None
    assert TN.matcher() == request.param
    return request.param


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_lamr_equal_jax(matcher, seed):
    preds, labels, shapes = synthetic_split(seed)
    mine = TM.compute_ap_lamr(preds, labels, shapes)
    ref = JM.compute_ap_lamr(preds, labels, shapes)
    assert sorted(mine) == sorted(ref)
    assert 0 < mine["ap"] < 1 and 0 < mine["lamr"] < 1
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)


def test_voc_ap_and_lamr_equal_jax():
    rng = np.random.default_rng(5)
    for n in (1, 7, 200):
        recall = np.sort(rng.random(n))
        precision = rng.random(n)
        fp_cum = np.cumsum(rng.integers(0, 2, n))
        assert TM.voc_ap(recall, precision) == JM.voc_ap(recall, precision)
        mine = TM.log_average_miss_rate(recall, fp_cum, 13)
        ref = JM.log_average_miss_rate(recall, fp_cum, 13)
        assert mine[0] == ref[0]
        np.testing.assert_array_equal(mine[1], ref[1])
        np.testing.assert_array_equal(mine[2], ref[2])


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_equal_jax(matcher, seed):
    coco_preds, gt = coco_inputs(*synthetic_split(seed))
    mine = TC.evaluate_coco(coco_preds, gt)
    ref = JC.evaluate_coco(coco_preds, gt)
    assert mine.shape == (12,) and (mine[:3] > 0).all()
    np.testing.assert_array_equal(mine, ref)
    assert TC.summarize(mine) == JC.summarize(ref)
    assert len(TC.summarize(mine).splitlines()) == 12


def test_native_matchers_equal_numpy(monkeypatch):
    """The port's g++ build of fastmatch.cpp lands in the port's build
    directory and agrees exactly with the numpy paths."""
    lib = TN.get_lib()
    assert lib is not None
    assert os.path.realpath(os.path.dirname(lib._name)) == \
        os.path.realpath(TN._BUILD_DIR)
    preds, labels, shapes = synthetic_split(3)
    gt_xyxy = [np.zeros((0, 4), np.int32)] * len(labels)
    for i, lab in enumerate(labels):
        if len(lab):
            w, h = shapes[i]
            b = np.stack([lab[:, 1] * w - lab[:, 3] * w / 2,
                          lab[:, 2] * h - lab[:, 4] * h / 2,
                          lab[:, 1] * w + lab[:, 3] * w / 2,
                          lab[:, 2] * h + lab[:, 4] * h / 2], 1)
            gt_xyxy[i] = b.astype(np.int32)
    coco_preds, gt = coco_inputs(preds, labels, shapes)
    img = max(coco_preds, key=lambda k: len(coco_preds[k][0]))
    args = (coco_preds[img][0], coco_preds[img][1], gt[img], (0, 1e10), 100)
    native = TM._match_preds(preds, gt_xyxy)
    native_coco = TC._evaluate_image(*args)
    monkeypatch.setattr(TN, "get_lib", lambda: None)
    plain = TM._match_preds(preds, gt_xyxy)
    plain_coco = TC._evaluate_image(*args)
    for a, b in zip(native + native_coco, plain + plain_coco):
        np.testing.assert_array_equal(a, b)
    assert native[0].sum() > 0


def test_native_rejects_inconsistent_arrays():
    assert TN.get_lib() is not None
    with pytest.raises(ValueError):
        TN.greedy_match(np.zeros((3, 4)), np.zeros(2), np.zeros((1, 4)),
                        np.asarray([0, 1]), 0.5)
    with pytest.raises(ValueError):
        TN.coco_match(np.zeros((3, 4)), np.zeros((2, 4)), np.zeros(3),
                      JC.IOU_THRS)
