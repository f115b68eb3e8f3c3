"""Box geometry for NMS, the loss and the letterbox undo (counterpart of
the JAX package's ``ops/boxes.py``: ``xyxy2xywh``, ``xywh2xyxy``,
``clip_coords``, ``scale_coords``, ``box_iou``, ``bbox_iou`` and
``wh_iou``). Leading batch dims are allowed."""

from __future__ import annotations

import math

import torch


def xyxy2xywh(x):
    """[..., 4] corners -> center/size."""
    cx = (x[..., 0] + x[..., 2]) * 0.5
    cy = (x[..., 1] + x[..., 3]) * 0.5
    w = x[..., 2] - x[..., 0]
    h = x[..., 3] - x[..., 1]
    return torch.stack([cx, cy, w, h], dim=-1)


def xywh2xyxy(x):
    """[..., 4] center/size -> corners."""
    hw = x[..., 2] * 0.5
    hh = x[..., 3] * 0.5
    return torch.stack([x[..., 0] - hw, x[..., 1] - hh,
                        x[..., 0] + hw, x[..., 1] + hh], dim=-1)


def clip_coords(boxes, shape_hw):
    """xyxy boxes clipped to an image of ``shape_hw`` = (h, w)."""
    h, w = shape_hw
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
                       dim=-1)


def scale_coords(img1_hw, coords, img0_hw, ratio_pad=None):
    """Undo the letterbox: xyxy boxes from the network frame ``img1_hw``
    back to the original frame ``img0_hw``, clipped to it (JAX
    ops/boxes.py:44-61, reference utils.py:60-84). ``ratio_pad`` =
    ((gain_w, gain_h) or a scalar gain, (pad_w, pad_h)) when the letterbox
    is known; otherwise it is derived from the two shapes."""
    if ratio_pad is None:
        gain = max(img1_hw) / max(img0_hw)
        pad = ((img1_hw[1] - img0_hw[1] * gain) / 2,
               (img1_hw[0] - img0_hw[0] * gain) / 2)
    else:
        gain = (ratio_pad[0][0] if hasattr(ratio_pad[0], "__len__")
                else ratio_pad[0])
        pad = ratio_pad[1]
    out = torch.stack([coords[..., 0] - pad[0], coords[..., 1] - pad[1],
                       coords[..., 2] - pad[0], coords[..., 3] - pad[1]],
                      dim=-1) / gain
    return clip_coords(out, img0_hw)


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


def wh_iou(wh1, wh2, eps: float = 0.0):
    """Template IoU of width / height pairs, as if co-centred: (..., N, 2)
    x (M, 2) -> (..., N, M) (JAX ops/boxes.py:111-115, reference
    utils.py:166-171). ``eps`` is added to the union (the loss's anchor
    matching adds 1e-16; JAX's ``wh_iou`` adds none)."""
    inter = torch.minimum(wh1[..., None, :], wh2).prod(-1)
    union = wh1.prod(-1)[..., None] + wh2.prod(-1) - inter
    return inter / (union + eps if eps else union)
