"""Anchor optimization: IoU k-means + genetic-algorithm refinement, and
in-place cfg anchor rewriting.

The port's copy of the JAX package's ``train/anchors.py`` (numpy only, the
same draws from the same seeds). Re-implementation of the reference's
anchor tooling
(other_utils/anchor_cluster.py:153-291): k-means under 1-IoU distance with
median cluster updates, then a mutation-only GA (default 1000 generations,
mutation prob 0.9, sigma 0.1, factors clipped to [0.3, 3]) maximising the
thresholded max-min-border-ratio ("MMBR") fitness. Pure numpy — this is
offline tooling, not a hot path.
"""

from __future__ import annotations

import random

import numpy as np


def wh_iou_np(wh1: np.ndarray, wh2: np.ndarray) -> np.ndarray:
    inter = np.minimum(wh1[:, None], wh2[None]).prod(2)
    return inter / (wh1.prod(1)[:, None] + wh2.prod(1)[None] - inter)


def k_means_iou(boxes: np.ndarray, k: int, dist=np.median,
                seed: int | None = None) -> np.ndarray:
    """k-means with d = 1 - IoU and ``dist`` cluster updates."""
    if seed is not None:
        np.random.seed(seed)
    n = boxes.shape[0]
    clusters = boxes[np.random.choice(n, k, replace=False)]
    last = np.zeros(n)
    while True:
        nearest = np.argmin(1 - wh_iou_np(boxes, clusters), axis=1)
        if (nearest == last).all():
            return clusters
        for c in range(k):
            sel = boxes[nearest == c]
            if len(sel):
                clusters[c] = dist(sel, axis=0)
        last = nearest


def anchor_fitness(anchors: np.ndarray, whs: np.ndarray, thr: float = 0.25):
    """(fitness, best-recall) under the MMBR metric
    (reference anchor_cluster.py:199-216)."""
    ratio = whs[:, None] / anchors[None]
    gamma = np.minimum(ratio, 1.0 / ratio).min(2)
    mmbr = gamma.max(1)
    fitness = (mmbr * (mmbr > thr)).mean()
    recall = (mmbr > thr).mean()
    return float(fitness), float(recall)


def evolve_anchors(whs: np.ndarray, n: int = 9, thr: float = 0.25,
                   gen: int = 1000, mp: float = 0.9, sigma: float = 0.1,
                   seed: int | None = None, verbose: bool = False):
    """k-means seed + GA mutation loop. whs: (N, 2) box sizes in pixels at
    the training resolution. Returns (n, 2) anchors sorted by area."""
    if seed is not None:
        np.random.seed(seed)
        random.seed(seed)
    whs = whs[(whs >= 2.0).any(1)]
    k = k_means_iou(whs.astype(np.float32), n)
    k = k[np.argsort(k.prod(1))]
    f, _ = anchor_fitness(k, whs, thr)

    npr = np.random
    sh = k.shape
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((npr.random(sh) < mp) * random.random()
                 * npr.randn(*sh) * sigma + 1).clip(0.3, 3.0)
        kg = (k.copy() * v).clip(min=2.0)
        fg, _ = anchor_fitness(kg, whs, thr)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    if verbose:
        fit, rec = anchor_fitness(k, whs, thr)
        print(f"evolved anchors fitness={fit:.5f} recall={rec:.5f}")
    return k


def dataset_box_sizes(dataset, img_size: int = 512) -> np.ndarray:
    """All gt box (w, h) in pixels with the max image side scaled to
    img_size (reference anchor_cluster.py:222-234)."""
    shapes = np.asarray(dataset.shapes, np.float32)           # (n, 2) w,h
    scaled = img_size * shapes / shapes.max(1, keepdims=True)
    out = []
    for l, s in zip(dataset.labels, scaled):
        if l.size:
            out.append(l[:, 3:5] * s)
    return np.concatenate(out) if out else np.zeros((0, 2), np.float32)


def rewrite_cfg_anchors(cfg_path: str, anchors: np.ndarray):
    """Rewrite every ``anchors = ...`` line in a cfg in place
    (reference anchor_cluster.py:273-287)."""
    with open(cfg_path) as f:
        lines = f.read().splitlines()
    new = "anchors = " + ", ".join(f"{int(a[0])}, {int(a[1])}"
                                   for a in anchors)
    lines = [new if ln.strip().startswith("anchors") else ln for ln in lines]
    with open(cfg_path, "w") as f:
        f.write("\n".join(lines))
