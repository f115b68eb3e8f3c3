"""Box geometry for NMS and the loss (counterpart of the JAX package's
``ops/boxes.py``: ``xywh2xyxy``, ``box_iou`` and ``bbox_iou``). Leading
batch dims are allowed."""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x):
    """[..., 4] center/size -> corners."""
    hw = x[..., 2] * 0.5
    hh = x[..., 3] * 0.5
    return torch.stack([x[..., 0] - hw, x[..., 1] - hh,
                        x[..., 0] + hw, x[..., 1] + hh], dim=-1)


def box_iou(box1, box2, eps: float = 1e-16):
    """Pairwise IoU: (..., N, 4) x (..., M, 4) xyxy -> (..., N, M), as
    inter / (area1 + area2 - inter + eps) (reference utils.py:141-163)."""
    area1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    area2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:], box2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[..., :, None] + area2[..., None, :] - inter + eps)


def _max0(x):
    """max(x, 0) with JAX's gradient at a tie (half to each side)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def bbox_iou(box1, box2, xywh: bool = False, giou: bool = False,
             diou: bool = False, ciou: bool = False, eps: float = 1e-16):
    """Elementwise IoU, GIoU, DIoU or CIoU of broadcastable [..., 4] boxes
    (JAX ops/boxes.py:64-98, reference utils.py:95-138). CIoU's trade-off
    weight ``alpha`` carries no gradient."""
    b1, b2 = (xywh2xyxy(box1), xywh2xyxy(box2)) if xywh else (box1, box2)
    b1x1, b1y1, b1x2, b1y2 = b1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = b2.unbind(-1)

    inter = (_max0(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1))
             * _max0(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)))
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1
    union = (w1 * h1 + eps) + w2 * h2 - inter
    iou = inter / union

    if not (giou or diou or ciou):
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    if giou:
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw * cw + ch * ch + eps
    rho2 = (torch.square((b2x1 + b2x2) - (b1x1 + b1x2))
            + torch.square((b2y1 + b2y2) - (b1y1 + b1y2))) / 4.0
    if diou:
        return iou - rho2 / c2
    epsv = torch.full((), eps, dtype=h1.dtype, device=h1.device)
    v = (4.0 / math.pi ** 2) * torch.square(
        torch.arctan(w2 / torch.maximum(h2, epsv))
        - torch.arctan(w1 / torch.maximum(h1, epsv)))
    with torch.no_grad():
        alpha = v / (1.0 - iou + v + eps)
    return iou - (rho2 / c2 + v * alpha)
