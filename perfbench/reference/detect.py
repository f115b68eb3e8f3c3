"""The serving path around the forward, in plain PyTorch: the letterbox
of a uint8 frame pair, greedy NMS, and boxes mapped back to the source
frame. The semantics are those of the served detector: a bilinear resize
with half-pixel centres to the letterbox's size (the frame's longer side
to ``img_size``, each side rounded up to a multiple of 64), zero padding
centred, values / 255; candidates with objectness and score above
``conf_thres`` and both sides in (2, 4096) pixels, the best ``top_k`` by
score, suppressed greedily by IoU > ``iou_thres`` within a class, at most
``max_det`` kept; boxes minus the padding, over the ratio, clipped to the
frame.
"""

from __future__ import annotations

import math

import torch

from . import model as M
from .model import decode

MIN_WH, MAX_WH = 2.0, 4096.0


def letterbox_geometry(src_hw, img_size: int):
    """(dst_hw, ratio, (new_h, new_w), (dw, dh), (top, left))."""
    r0 = img_size / max(src_hw)
    dst = (int(math.ceil(src_hw[0] * r0 / 64) * 64),
           int(math.ceil(src_hw[1] * r0 / 64) * 64))
    r = min(dst[0] / src_hw[0], dst[1] / src_hw[1], 1.0)
    new_h, new_w = int(round(src_hw[0] * r)), int(round(src_hw[1] * r))
    dw, dh = (dst[1] - new_w) / 2, (dst[0] - new_h) / 2
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    return dst, r, (new_h, new_w), (dw, dh), (top, left)


def resize_bilinear(img, out_h: int, out_w: int):
    """(..., H, W, C) -> float32 (..., out_h, out_w, C), half-pixel
    centres, edge taps clamped."""
    x = img.float()
    h, w = x.shape[-3], x.shape[-2]

    def taps(n_out, n_in):
        c = (torch.arange(n_out, dtype=torch.float32, device=x.device)
             + 0.5) * (n_in / n_out) - 0.5
        i0 = torch.clamp(torch.floor(c), 0, n_in - 1)
        f = torch.clamp(c - i0, 0.0, 1.0)
        i0 = i0.long()
        return i0, torch.clamp_max(i0 + 1, n_in - 1), f

    y0, y1, fy = taps(out_h, h)
    x0, x1, fx = taps(out_w, w)
    fx = fx[:, None]
    r0, r1 = x[..., y0, :, :], x[..., y1, :, :]
    top = r0[..., :, x0, :] * (1 - fx) + r0[..., :, x1, :] * fx
    bot = r1[..., :, x0, :] * (1 - fx) + r1[..., :, x1, :] * fx
    fy = fy[:, None, None]
    return top * (1 - fy) + bot * fy


def letterbox(u8, img_size: int):
    """uint8 (B, H, W, 3) -> float32 (B, dst_h, dst_w, 3) in [0, 1]."""
    dst, _, (nh, nw), _, (top, left) = letterbox_geometry(
        tuple(u8.shape[1:3]), img_size)
    out = torch.zeros((u8.shape[0],) + dst + (3,), device=u8.device)
    out[:, top:top + nh, left:left + nw] = resize_bilinear(u8, nh, nw)
    return out / 255.0


def candidates(pred, conf_thres: float):
    """Decoded rows of one image (rows, 5 + nc) -> (boxes xyxy, scores,
    classes) of every (row, class) whose objectness and score pass
    ``conf_thres`` and whose box sides lie in (2, 4096)."""
    xy, wh = pred[:, :2], pred[:, 2:4]
    obj, cls = pred[:, 4], pred[:, 5:]
    ok = (obj > conf_thres) & (wh > MIN_WH).all(1) & (wh < MAX_WH).all(1)
    score = obj[:, None] * cls
    if cls.shape[1] == 1:
        keep = ok & (score[:, 0] > conf_thres)
        rows = keep.nonzero()[:, 0]
        classes = torch.zeros_like(rows)
    else:
        rows, classes = ((score > conf_thres) & ok[:, None]).nonzero(
            as_tuple=True)
    boxes = torch.cat([xy[rows] - wh[rows] / 2, xy[rows] + wh[rows] / 2], 1)
    return boxes, score[rows, classes], classes


def iou(a, b):
    """(n, 4) x (m, 4) xyxy -> (n, m)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = torch.clamp_min(rb - lt, 0).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def nms(boxes, scores, classes, iou_thres: float, top_k: int,
        max_det: int):
    """Greedy NMS within each class over the ``top_k`` best; indices of
    the kept rows, best first."""
    order = torch.sort(scores, descending=True, stable=True).indices[:top_k]
    b, c = boxes[order], classes[order]
    same = c[:, None] == c[None, :]
    over = (iou(b, b) > iou_thres) & same
    alive = torch.ones(len(order), dtype=torch.bool, device=b.device)
    kept = []
    over = over.cpu()
    alive = alive.cpu()
    for i in range(len(order)):
        if not alive[i]:
            continue
        kept.append(i)
        if len(kept) == max_det:
            break
        alive &= ~over[i]
    return order[torch.tensor(kept, dtype=torch.long, device=order.device)]


def to_source(boxes, src_hw, img_size: int):
    """Letterboxed xyxy -> the source frame's, clipped."""
    _, r, _, (dw, dh), _ = letterbox_geometry(src_hw, img_size)
    b = boxes.clone()
    b[:, [0, 2]] = ((b[:, [0, 2]] - dw) / r).clamp(0, src_hw[1])
    b[:, [1, 3]] = ((b[:, [1, 3]] - dh) / r).clamp(0, src_hw[0])
    return b


def suppressed(cb, cs, cc, b, s, c, k, iou_thres: float, margin: float,
               slack: float):
    """Which candidates (cb, cs, cc) any greedy NMS suppresses, whatever
    rounding does: a kept detection of their class overlaps them by more
    than ``iou_thres + slack`` and scores ``margin`` above them, and is
    itself kept whatever rounding does: no other candidate of (b, s, c)
    that overlaps it by more than ``iou_thres - slack`` scores within
    ``margin`` of it."""
    kb, ks, kc = b[k], s[k], c[k]
    rival = ((iou(kb, b) > iou_thres - slack) & (kc[:, None] == c[None, :])
             & (s[None, :] > ks[:, None] - margin))
    rival[torch.arange(len(k)), k] = False
    sure = ~rival.any(1)
    hit = ((iou(cb, kb) > iou_thres + slack) & (cc[:, None] == kc[None, :])
           & (ks[None, :] > cs[:, None] + margin) & sure[None, :])
    return hit.any(1).cpu().numpy()


def serve(model, W, v_u8, l_u8, nms_kw: dict, img_size: int,
          clear: tuple, bf16: bool = False):
    """The whole served path on a batch of uint8 pairs (B, H, W, 3), in
    float32 (or with the forward in bf16). Returns, per frame, numpy
    ``{"det": (boxes, scores, classes)}`` after NMS in the source frame,
    ``"cand"``: every candidate at half of ``conf_thres`` in the source
    frame, ``"suppressed"``: which of them NMS suppresses whatever
    rounding does (:func:`suppressed`, ``clear`` its margin and slack),
    and ``"floor"``: the score of the ``top_k``-th candidate (0 where there
    are fewer), below which NMS does not look."""
    src_hw = tuple(v_u8.shape[1:3])
    xv = letterbox(v_u8, img_size)
    xl = letterbox(l_u8, img_size) if model.second_index is not None \
        else None
    heads = (M.forward_bf16(model, W, xv, xl) if bf16
             else M.forward(model, W, xv, xl))
    pred = decode(model, heads)
    out = []
    thr, top_k = nms_kw["conf_thres"], nms_kw["top_k"]

    def host(b, s, c):
        return (to_source(b, src_hw, img_size).cpu().double().numpy(),
                s.cpu().double().numpy(), c.cpu().numpy())

    for p in pred:
        b, s, c = candidates(p, thr)
        k = nms(b, s, c, nms_kw["iou_thres"], top_k, nms_kw["max_det"])
        floor = (float(torch.topk(s, top_k).values[-1]) if len(s) >= top_k
                 else 0.0)
        cb, cs, cc = candidates(p, thr / 2)
        out.append({"det": host(b[k], s[k], c[k]), "cand": host(cb, cs, cc),
                    "suppressed": suppressed(cb, cs, cc, b, s, c, k,
                                             nms_kw["iou_thres"], *clear),
                    "floor": floor})
    return out
