"""The numbers that decide ``correct`` in a serve cell.

Each served frame is held against the float32 reference of its request
(:mod:`perfbench.reference.detect`) from both sides.

The gap of two boxes is the larger of their largest coordinate
difference over the longer side of the second (at least ``MIN_SIZE``)
and their score difference, at most 1 (1 across classes). Coordinates,
not IoU, because a box clipped to the frame's edge may have no area on
either side.

* Each served box's gap to the nearest candidate of the reference's
  decoded heads (every box whose objectness and score pass half the
  confidence threshold, before NMS). It is held against every candidate,
  so that a box that NMS keeps on one side and suppresses on the other,
  by an IoU a rounding away from the threshold, still has its partner.
* Each due reference detection's gap to the nearest served box (1 where
  the frame serves none). A detection is due when its score clears, by
  ``MARGIN``, the confidence threshold, the reference's ``top_k``-th
  candidate and, in a frame served full (``max_det`` boxes), the lowest
  served score: nearer to any of them, rounding decides whether it is
  kept. A frame or box left out, or NMS that suppresses too much, leaves
  due detections at 1.
* Served boxes that NMS suppresses whatever rounding does: the nearest
  reference candidate (within ``MATCH``) overlaps a kept detection by
  more than the IoU threshold and ``IOU_SLACK``, scores ``MARGIN`` below
  it, and no other candidate comes near enough to that detection to
  unseat it (:func:`perfbench.reference.detect.suppressed`; IoUs in the
  letterboxed frame, before the boxes are clipped to the source frame).
  NMS that suppresses too little serves them.

How far rounding moves the heads, and which detections it flips,
depends on the seeded network: on some seeds bf16 itself lands far from
float32 (its folded kernels and biases are rounded alike in every bf16
computation). So each number is read against that of a plain bf16
computation of the same requests (the reference's folded forward run in
bf16, :func:`perfbench.reference.model.forward_bf16`, decoded and NMS'd
in float32), as an excess that a sound bf16 program reads near 0
(:data:`CHECKED`):

* ``gap_excess``: the median gap of the served boxes over the bf16
  computation's, less 1. The bulk of the boxes: a lower precision moves
  all of them, a rounding tail does not move it.
* ``frame_excess``: the largest mean gap of a frame (of ``MIN_BOXES``
  boxes or more) over the bf16 computation's, less 1. A frame altered
  where it is produced reads many times the rest.
* ``recall_excess``: the 90th percentile of the due detections' gaps over
  the bf16 computation's, less 1. A tenth of them left out puts it at 1.
* ``extra_excess``: the share of served boxes that NMS suppresses
  whatever rounding does, less the bf16 computation's share.
"""

from __future__ import annotations

import numpy as np

MIN_SIZE = 8.0       # pixels: the finest head's stride
MIN_BOXES = 8        # a frame's mean gap is read where it holds these
MATCH = 0.25         # a served box this near a candidate is its copy
MARGIN = 0.02        # of score: nearer a cut, rounding decides
IOU_SLACK = 0.02     # of IoU: as near the threshold, rounding decides
EPS = 1e-3           # a bf16 gap below this reads as this

CHECKED = ("gap_excess", "frame_excess", "recall_excess", "extra_excess")


def box_dist(a, b):
    """(n, 4) x (m, 4) xyxy -> (n, m): the largest coordinate difference
    over the longer side of the ``b`` box, at least ``MIN_SIZE``."""
    size = np.maximum(np.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]),
                      MIN_SIZE)
    return np.abs(a[:, None, :] - b[None, :, :]).max(-1) / size[None, :]


def _dist(boxes, scores, classes, ob, os_, oc):
    """(n, m): the gap of each of (boxes, scores, classes) to each of
    (ob, os_, oc)."""
    d = np.maximum(box_dist(boxes, ob),
                   np.abs(scores[:, None] - os_[None, :]))
    return np.minimum(np.where(classes[:, None] == oc[None, :], d, 1.0), 1.0)


def _due(s, ref, nms_kw):
    """The reference's detections that are due in a frame that serves
    scores ``s``: (boxes, scores, classes)."""
    rb, rs, rc = ref["det"]
    cut = max(nms_kw["conf_thres"], ref["floor"])
    if len(s) >= nms_kw["max_det"]:
        cut = max(cut, float(s.min()))
    due = rs > cut + MARGIN
    return rb[due], rs[due], rc[due]


def frame(served, ref, nms_kw: dict) -> dict:
    """One frame: ``served`` (boxes, scores, classes) in the source frame,
    ``ref`` the reference's {"det", "cand", "suppressed", "floor"}
    (numpy). Returns the gaps of each side and the frame's counts."""
    b, s, c = (np.asarray(x) for x in served)
    b, s = b.astype(np.float64).reshape(-1, 4), s.astype(np.float64)
    cb, cs, cc = ref["cand"]
    if len(b) == 0 or len(cb) == 0:
        gaps, extra = np.ones(len(b)), 0
    else:
        d = _dist(b, s, c, cb, cs, cc)
        nearest = d.argmin(1)
        gaps = d[np.arange(len(b)), nearest]
        extra = int((ref["suppressed"][nearest] & (gaps <= MATCH)).sum())
    db, ds, dc = _due(s, ref, nms_kw)
    if len(b) == 0 or len(ds) == 0:
        recall = np.ones(len(ds))
    else:
        recall = _dist(b, s, c, db, ds, dc).min(0)
    return {"gaps": gaps, "recall": recall, "extra": extra,
            "n_ref": len(ref["det"][1])}


def summarise(frames: list) -> dict:
    """Raw numbers over every frame of every distinct answer read (as
    :func:`frame` gives them)."""
    gaps = np.concatenate([f["gaps"] for f in frames] + [np.zeros(0)])
    recall = np.concatenate([f["recall"] for f in frames] + [np.zeros(0)])
    means = [float(f["gaps"].mean()) for f in frames
             if len(f["gaps"]) >= MIN_BOXES]
    q = (np.quantile(gaps, [0.5, 0.9, 0.99]).tolist() if len(gaps)
         else [0.0, 0.0, 0.0])
    return {"gap_p50": q[0], "gap_p90": q[1], "gap_p99": q[2],
            "frame_gap": max(means) if means else 0.0,
            "recall_p90": (float(np.quantile(recall, 0.9)) if len(recall)
                           else 0.0),
            "missed": float((recall >= 1.0).mean()) if len(recall) else 0.0,
            "extra": sum(f["extra"] for f in frames) / max(len(gaps), 1),
            "served_boxes": len(gaps), "due_boxes": len(recall),
            "reference_boxes": sum(f["n_ref"] for f in frames),
            "frames": len(frames)}


def compare(served: list, bf16: list) -> dict:
    """The compared numbers (:data:`CHECKED`) of the served frames against
    those of the plain bf16 computation of the same requests, and the raw
    numbers of both (the bf16 computation's prefixed ``bf16_``)."""
    p, e = summarise(served), summarise(bf16)

    def excess(key):
        return p[key] / max(e[key], EPS) - 1.0

    out = {"gap_excess": excess("gap_p50"),
           "frame_excess": excess("frame_gap"),
           "recall_excess": excess("recall_p90"),
           "extra_excess": p["extra"] - e["extra"]}
    out.update(p)
    out.update({"bf16_" + k: v for k, v in e.items()})
    return out
