"""Pedestrian-detection metrics: VOC-interpolated AP and log-average miss rate.

The port's copy of the JAX package's ``eval/metrics.py`` (host numpy, the
same code line for line). Numerically faithful re-implementation of the
reference's evaluation math (other_utils/metrics.py:1-165), operating on
host numpy after device NMS:

  * greedy conf-sorted TP/FP matching at IoU >= 0.5 with per-GT dedup
    (metrics.py:121-138) — including the reference's Pascal-style +1 pixel
    areas and int-cast ground-truth boxes (metrics.py:69, 124);
  * VOC interpolated AP over the PR curve (metrics.py:7-27);
  * LAMR = exp(mean log miss-rate sampled at 9 log-spaced FPPI in [1e-2, 1])
    (metrics.py:30-57).

Unlike the reference, this function does not mutate its ``labels`` argument
(the reference's single-use bug, metrics.py:114-115) — it is safe to call
repeatedly.
"""

from __future__ import annotations

import math

import numpy as np

IOU_THRESHOLD = 0.5


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC interpolated average precision (monotone precision envelope)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def log_average_miss_rate(recall: np.ndarray, fp_cumsum: np.ndarray,
                          num_imgs: int):
    """LAMR + the FPPI / miss-rate curves."""
    fppi = fp_cumsum / float(num_imgs)
    mr = 1.0 - recall
    fppi_tmp = np.concatenate(([-1.0], fppi))
    mr_tmp = np.concatenate(([1.0], mr))
    refs = np.logspace(-2.0, 0.0, num=9)
    samples = np.empty_like(refs)
    for i, ref_p in enumerate(refs):
        j = np.where(fppi_tmp <= ref_p)[0][-1]
        samples[i] = mr_tmp[j]
    lamr = math.exp(np.mean(np.log(np.maximum(1e-10, samples))))
    return lamr, fppi, mr


def _iou_one_to_many(box: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """Pascal-style IoU (+1 areas) of one box vs (n, 4) gts."""
    ix1 = np.maximum(box[0], gts[:, 0])
    iy1 = np.maximum(box[1], gts[:, 1])
    ix2 = np.minimum(box[2], gts[:, 2])
    iy2 = np.minimum(box[3], gts[:, 3])
    inter = np.clip(ix2 - ix1 + 1, 0, None) * np.clip(iy2 - iy1 + 1, 0, None)
    a1 = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    a2 = (gts[:, 2] - gts[:, 0] + 1) * (gts[:, 3] - gts[:, 1] + 1)
    return inter / (a1 + a2 - inter)


def _match_preds(preds: list, gt_xyxy: list):
    """Greedy conf-sorted TP/FP assignment (native C++ kernel from
    native/fastmatch.cpp when buildable, numpy otherwise)."""
    nd = len(preds)
    tp = np.zeros(nd, np.int32)
    fp = np.zeros(nd, np.int32)
    if nd == 0:
        return tp, fp

    from ..utils import native as NAT

    if NAT.get_lib() is not None:
        pred_boxes = np.stack([np.asarray(p["bbox"], np.float32)
                               for p in preds])
        pred_img = np.asarray([p["img_id"] for p in preds], np.int32)
        offsets = np.zeros(len(gt_xyxy) + 1, np.int64)
        np.cumsum([len(g) for g in gt_xyxy], out=offsets[1:])
        gt_flat = (np.concatenate(gt_xyxy).astype(np.float32)
                   if offsets[-1] else np.zeros((0, 4), np.float32))
        res = NAT.greedy_match(pred_boxes, pred_img, gt_flat, offsets,
                               IOU_THRESHOLD)
        if res is not None:
            return res[0].astype(np.int32), res[1].astype(np.int32)

    matched = [np.zeros(len(g), bool) for g in gt_xyxy]
    for idx, pred in enumerate(preds):
        img_id = pred["img_id"]
        gts = gt_xyxy[img_id]
        if len(gts) == 0:
            fp[idx] = 1
            continue
        iou = _iou_one_to_many(np.asarray(pred["bbox"], np.float32),
                               gts.astype(np.float32))
        j = int(np.argmax(iou))
        if iou[j] >= IOU_THRESHOLD and not matched[img_id][j]:
            matched[img_id][j] = True
            tp[idx] = 1
        else:
            fp[idx] = 1
    return tp, fp


def compute_ap_lamr(preds: list, labels: list, shapes: np.ndarray) -> dict:
    """AP@0.5 + LAMR over a whole split.

    Args:
      preds: list of dicts {img_id, conf, bbox (xyxy abs, original frame)},
        pre-sorted by conf descending (reference evaluate.py:114).
      labels: per-image (n_i, 5) arrays [cls, cx, cy, w, h] normalized.
      shapes: (n_imgs, 2) original (w, h) per image.

    Returns dict {recall, precision, fppi, mr, ap, lamr}.
    """
    n_imgs = len(labels)
    gt_xyxy = []
    for i in range(n_imgs):
        l = np.asarray(labels[i], np.float32)
        if l.size == 0:
            gt_xyxy.append(np.zeros((0, 4), np.int32))
            continue
        w, h = shapes[i][0], shapes[i][1]
        cx, cy = l[:, 1] * w, l[:, 2] * h
        bw, bh = l[:, 3] * w, l[:, 4] * h
        boxes = np.stack([cx - bw / 2, cy - bh / 2,
                          cx - bw / 2 + bw, cy - bh / 2 + bh], axis=1)
        gt_xyxy.append(boxes.astype(np.int32))

    n_gt = int(sum(len(g) for g in gt_xyxy))
    nd = len(preds)

    tp, fp = _match_preds(preds, gt_xyxy)

    fp_cum = np.cumsum(fp)
    tp_cum = np.cumsum(tp)
    recall = tp_cum / max(n_gt, 1)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-16)
    ap = voc_ap(recall, precision)
    lamr, fppi, mr = log_average_miss_rate(recall, fp_cum, n_imgs)
    return {"recall": recall, "precision": precision, "fppi": fppi,
            "mr": mr, "ap": ap, "lamr": lamr}
