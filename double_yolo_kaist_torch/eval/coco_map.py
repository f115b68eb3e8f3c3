"""Self-contained COCO-style detection evaluation (no pycocotools).

The port's copy of the JAX package's ``eval/coco_map.py`` (host numpy, the
same code line for line).

Replaces the reference's pycocotools dependency (train_utils/coco_utils.py +
coco_eval.py wrap the C extension; not available here) with a numpy
implementation of the COCOeval bbox protocol: greedy per-image matching by
descending score at IoU thresholds 0.5:0.05:0.95, area ranges
all/small/medium/large, maxDets (1, 10, 100), 101-point interpolated
precision, and the standard 12-stat summary used by the reference's per-epoch
eval (kaist_train_eval_utils.py:121-190, train.py:199-201).
"""

from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_matrix(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """(D, 4) x (G, 4) xyxy -> (D, G) IoU (COCO convention, no +1)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    a1 = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    a2 = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    return inter / (a1[:, None] + a2[None, :] - inter + 1e-12)


def _evaluate_image(dets, scores, gts, area_rng, max_det):
    """Match one image's detections to gts at every IoU threshold.

    Returns (dt_matches (T, D), dt_ignore (T, D), gt_ignore (G,), dt_scores)."""
    order = np.argsort(-scores, kind="mergesort")[:max_det]
    dets, scores = dets[order], scores[order]

    g_area = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1]) if len(gts) \
        else np.zeros(0)
    gt_ignore = (g_area < area_rng[0]) | (g_area > area_rng[1])
    # sort gts: non-ignored first (COCO convention)
    g_order = np.argsort(gt_ignore, kind="mergesort")
    gts = gts[g_order]
    gt_ignore = gt_ignore[g_order]

    T, D, G = len(IOU_THRS), len(dets), len(gts)
    from ..utils import native as NAT
    dt_m = NAT.coco_match(dets, gts, gt_ignore, IOU_THRS) \
        if (D and G) else None
    if dt_m is None:
        iou = _iou_matrix(dets, gts)
        dt_m = np.zeros((T, D), np.int64) - 1      # matched gt index or -1
        gt_m = np.zeros((T, G), np.int64) - 1
        for t, thr in enumerate(IOU_THRS):
            for d in range(D):
                best, m = min(thr, 1 - 1e-10), -1
                for g in range(G):
                    if gt_m[t, g] >= 0:
                        continue
                    # stop at ignored gts once a real match was found
                    if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                        break
                    if iou[d, g] < best:
                        continue
                    best, m = iou[d, g], g
                if m >= 0:
                    dt_m[t, d] = m
                    gt_m[t, m] = d

    d_area = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1]) if D \
        else np.zeros(0)
    out_of_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
    dt_ig = np.zeros((T, D), bool)
    for t in range(T):
        # dtype=bool: with zero detections the comprehension is empty and
        # np.array([]) defaults to float64, which cannot be |-ed below
        matched_ignored = np.array(
            [gt_ignore[m] if m >= 0 else False for m in dt_m[t]],
            dtype=bool)
        dt_ig[t] = matched_ignored | ((dt_m[t] < 0) & out_of_rng)
    return dt_m >= 0, dt_ig, gt_ignore, scores


def evaluate_coco(predictions: dict, ground_truth: dict) -> np.ndarray:
    """Compute the 12 COCO summary stats for one category.

    Args:
      predictions: img_id -> (boxes (n,4) xyxy, scores (n,)).
      ground_truth: img_id -> boxes (m, 4) xyxy.

    Returns: np.ndarray of the 12 stats [AP, AP50, AP75, APs, APm, APl,
      AR1, AR10, AR100, ARs, ARm, ARl].
    """
    img_ids = sorted(ground_truth.keys())
    stats = np.zeros(12)
    ap_entries = [("all", 100, slice(None)), ("all", 100, 0), ("all", 100, 5),
                  ("small", 100, slice(None)), ("medium", 100, slice(None)),
                  ("large", 100, slice(None))]
    ar_entries = [("all", 1), ("all", 10), ("all", 100),
                  ("small", 100), ("medium", 100), ("large", 100)]

    results = {}
    for area_name, area_rng in AREA_RANGES.items():
        for max_det in MAX_DETS:
            if (area_name, max_det) not in set(
                    [(a, m) for a, m, _ in ap_entries]
                    + [(a, m) for a, m in ar_entries]):
                continue
            per_img = []
            for iid in img_ids:
                boxes, scores = predictions.get(
                    iid, (np.zeros((0, 4)), np.zeros(0)))
                gts = ground_truth[iid]
                per_img.append(_evaluate_image(
                    np.asarray(boxes, float), np.asarray(scores, float),
                    np.asarray(gts, float), area_rng, max_det))
            results[(area_name, max_det)] = _accumulate(per_img)

    for i, (area, md, t_sel) in enumerate(ap_entries):
        prec = results[(area, md)][0][t_sel]
        valid = prec > -1
        stats[i] = np.mean(prec[valid]) if valid.any() else -1.0
    for i, (area, md) in enumerate(ar_entries):
        rec = results[(area, md)][1]
        valid = rec > -1
        stats[6 + i] = np.mean(rec[valid]) if valid.any() else -1.0
    return stats


def _accumulate(per_img):
    """Merge per-image match results -> (precision (T, R), recall (T,))."""
    T = len(IOU_THRS)
    matches = np.concatenate([p[0] for p in per_img], axis=1)
    ignores = np.concatenate([p[1] for p in per_img], axis=1)
    scores = np.concatenate([p[3] for p in per_img])
    n_gt = int(sum((~p[2]).sum() for p in per_img))

    precision = -np.ones((T, len(REC_THRS)))
    recall = -np.ones(T)
    if n_gt == 0:
        return precision, recall

    order = np.argsort(-scores, kind="mergesort")
    for t in range(T):
        tp_flags = matches[t][order] & ~ignores[t][order]
        fp_flags = ~matches[t][order] & ~ignores[t][order]
        tp = np.cumsum(tp_flags)
        fp = np.cumsum(fp_flags)
        rc = tp / n_gt
        pr = tp / np.maximum(tp + fp, 1e-12)
        recall[t] = rc[-1] if len(rc) else 0.0
        # monotone precision envelope then sample at the 101 recall points
        for i in range(len(pr) - 1, 0, -1):
            pr[i - 1] = max(pr[i - 1], pr[i])
        idx = np.searchsorted(rc, REC_THRS, side="left")
        prec_at = np.zeros(len(REC_THRS))
        for ri, pi in enumerate(idx):
            prec_at[ri] = pr[pi] if pi < len(pr) else 0.0
        precision[t] = prec_at
    return precision, recall


STAT_NAMES = [
    "AP@[0.50:0.95|all|100]", "AP@[0.50|all|100]", "AP@[0.75|all|100]",
    "AP@[0.50:0.95|small|100]", "AP@[0.50:0.95|medium|100]",
    "AP@[0.50:0.95|large|100]",
    "AR@[0.50:0.95|all|1]", "AR@[0.50:0.95|all|10]", "AR@[0.50:0.95|all|100]",
    "AR@[0.50:0.95|small|100]", "AR@[0.50:0.95|medium|100]",
    "AR@[0.50:0.95|large|100]",
]


def summarize(stats: np.ndarray) -> str:
    return "\n".join(f"{n} = {v:.4f}" for n, v in zip(STAT_NAMES, stats))
