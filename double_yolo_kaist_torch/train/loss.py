"""YOLO loss with the anchor-template target assignment, at fixed shapes.

Counterpart of the JAX package's ``train/loss.py`` (reference
build_utils/utils.py:209-384): per-scale wh-IoU > iou_t multi-anchor
matching, CIoU / GIoU box loss, BCE objectness with IoU soft targets
(tobj = (1 - gr) + gr * iou), label-smoothed / focal BCE class loss, the
hyp box / obj / cls gains, and the v3 / v4 box formulas. Labels are padded
to a fixed (B, T, 5) block with a validity mask; every (image, target,
anchor) triple is a candidate and matching is a mask, so the loss runs
with no host synchronisation.

The objectness target is a scatter in which two matched candidates may
land on one cell. XLA keeps the last of them in candidate order, (b, t, a);
the port chooses that candidate explicitly (the largest candidate index of
each cell), because ``index_put_`` leaves the winner unspecified on CUDA.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.boxes import bbox_iou, wh_iou


class HeadSpec(NamedTuple):
    """Static per-scale metadata of the IR's yolo nodes."""
    anchors_vec: np.ndarray   # (na, 2) anchors in grid units (anchors/stride)
    stride: int
    bf_type: str              # 'yolov3' | 'yolov4'
    nc: int


def head_specs(ir) -> list:
    return [HeadSpec(np.asarray(n.anchors, np.float32) / n.yolo_stride,
                     n.yolo_stride, n.bf_type, n.nc)
            for n in ir.head_nodes()]


def _softplus(x):
    """log(1 + e^x) as JAX's ``jax.nn.softplus`` computes it (logaddexp
    with 0), gradient sigmoid(x)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def bce_with_logits(x, t, pos_weight: float = 1.0):
    """Elementwise BCEWithLogits: t*pw*softplus(-x) + (1-t)*softplus(x)."""
    return t * pos_weight * _softplus(-x) + (1.0 - t) * _softplus(x)


def focal_scale(x, t, gamma: float, alpha: float = 0.25):
    """TF-style focal modulation of a BCE loss (reference utils.py:174-201)."""
    p = torch.sigmoid(x)
    p_t = t * p + (1 - t) * (1 - p)
    alpha_f = t * alpha + (1 - t) * (1 - alpha)
    return alpha_f * torch.pow(1.0 - p_t, gamma)


_CONSTS: dict = {}


def _const(values, dtype, device) -> torch.Tensor:
    """A constant tensor of ``values``, made once a (values, dtype,
    device): a step captured in a CUDA graph may copy nothing from the
    host, so the capture reuses what its warm-up run made."""
    arr = np.asarray(values)
    key = (arr.tobytes(), arr.shape, dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(arr, dtype=dtype, device=device)
    return t


def smooth_bce(eps: float = 0.0):
    """Positive / negative label-smoothing targets (reference
    utils.py:204-206)."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def _last_wins_scatter(shape, lin, valid, values):
    """A zero tensor of ``shape`` with ``values`` set at the flat indices
    ``lin`` where ``valid``; where several valid entries share an index,
    the last one (largest position) is kept, as XLA's scatter keeps it."""
    n = int(np.prod(shape))
    order = torch.arange(lin.shape[0], device=lin.device)
    slot = torch.where(valid, lin, torch.full_like(lin, n))
    winner = torch.full((n + 1,), -1, dtype=order.dtype, device=lin.device)
    winner = winner.scatter_reduce(0, slot, order, reduce="amax")
    keep = valid & (winner.gather(0, slot) == order)
    # losers write to the spare slot n, which is cut off
    out = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
    out = out.scatter(0, torch.where(keep, lin, torch.full_like(lin, n)),
                      values)
    return out[:n].reshape(shape)


def compute_loss(raw_heads, targets, tmask, specs, hyp, gr: float = 1.0,
                 group=None, space=None):
    """The 3-component YOLO loss (JAX train/loss.py:60-160).

    Args:
      raw_heads: per-scale raw predictions (B, na, ny, nx, no), the
        ``graph.apply`` train-mode output; the loss runs in fp32 (or wider).
      targets: (B, T, 5) padded labels [cls, cx, cy, w, h], normalized 0-1.
      tmask: (B, T) bool, which label rows are real.
      specs: list[HeadSpec] (:func:`head_specs`).
      hyp: box / obj / cls gains, cls_pw / obj_pw, iou_t, fl_gamma and
        optionally 'ciou' (reference hyp.scratch.4.yaml).
      gr: IoU ratio of the objectness targets (reference train.py:171).
      group: a ``torch.distributed`` group whose ranks each hold an equal
        share of the batch. The normalisers are then the whole batch's,
        as JAX's global-batch loss takes them (loss.py:110, 134, 146,
        154): the match count all-reduced, the cell count the ranks' sum.
        Each rank's result is its share of the global loss: the shares
        sum to it, and so do their gradients.
      space: a :class:`..parallel.spatial.SpaceShard`: each head is this
        rank's band of rows (``graph.apply(space=)``), the labels those of
        its data shard, whole. A match's box and class terms count on the
        rank whose band holds the match's cell row ``gj``; the match count
        is the world's sum of in-band matches, so each match counts once;
        objectness sums the band's cells over the global cell count. The
        shares of all ranks sum to the one-device loss (``group`` is then
        ``space.world``).

    Returns {box_loss, obj_loss, class_loss}, scalars, hyp-weighted.
    """
    if space is not None:
        group = space.world
    ranks = 1 if group is None else torch.distributed.get_world_size(group)
    B, T = targets.shape[:2]
    dev = raw_heads[0].device
    use_ciou = "ciou" in hyp
    iou_t = hyp["iou_t"]
    fl_gamma = float(hyp.get("fl_gamma", 0.0) or 0.0)
    cp, cn = smooth_bce(0.0)
    fdt = torch.promote_types(raw_heads[0].dtype, torch.float32)
    targets = targets.to(dev)
    tmask = tmask.to(dev)

    lbox = torch.zeros((), dtype=fdt, device=dev)
    lobj = torch.zeros((), dtype=fdt, device=dev)
    lcls = torch.zeros((), dtype=fdt, device=dev)

    for pi, spec in zip(raw_heads, specs):
        pi = pi.to(fdt)
        _, na, nyb, nx, no = pi.shape          # nyb: the band's rows
        ny = nyb if space is None else nyb * space.S
        nc = spec.nc
        anchors = _const(spec.anchors_vec, fdt, dev)

        # normalized labels on this grid (reference utils.py:328-339)
        gain = _const((nx, ny), fdt, dev)
        gxy = targets[..., 1:3].to(fdt) * gain                  # (B, T, 2)
        gwh = targets[..., 3:5].to(fdt) * gain
        tcls = targets[..., 0].to(torch.int64)

        # anchor-template matching: wh-IoU(anchor, gt) > iou_t
        match = tmask[..., None] & (wh_iou(gwh, anchors, eps=1e-16) > iou_t)

        # every (image, target, anchor) candidate, in (b, t, a) order
        m = match.reshape(-1)
        bi = torch.arange(B, device=dev)[:, None, None].expand(B, T, na) \
            .reshape(-1)
        ai = torch.arange(na, device=dev).expand(B, T, na).reshape(-1)
        gxy_f = gxy[:, :, None, :].expand(B, T, na, 2).reshape(-1, 2)
        gwh_f = gwh[:, :, None, :].expand(B, T, na, 2).reshape(-1, 2)
        cls_f = tcls[..., None].expand(B, T, na).reshape(-1)

        gij = torch.floor(gxy_f).to(torch.int64)
        gi = gij[:, 0].clamp(0, nx - 1)
        gj = gij[:, 1].clamp(0, ny - 1)
        if space is not None:
            # the band's own matches, at rows local to the band
            gj = gj - space.row_offset(nyb)
            m = m & (gj >= 0) & (gj < nyb)
            gj = gj.clamp(0, nyb - 1)
        n_match = m.sum()
        if group is not None:
            # in the loss's float type: gloo reduces CUDA floats; counts
            # are exact there
            n_match = n_match.to(fdt)
            torch.distributed.all_reduce(n_match, group=group)
        w_cnt = torch.clamp_min(n_match, 1)

        ps = pi[bi, ai, gj, gi]                                 # (M, no)

        if spec.bf_type == "yolov4":
            pxy = torch.sigmoid(ps[:, :2]) * 2.0 - 0.5
            pwh = torch.square(torch.sigmoid(ps[:, 2:4]) * 2.0) * anchors[ai]
        else:
            pxy = torch.sigmoid(ps[:, :2])
            pwh = torch.minimum(torch.exp(ps[:, 2:4]),
                                torch.full((), 1e3, dtype=fdt, device=dev)) \
                * anchors[ai]
        pbox = torch.cat([pxy, pwh], dim=-1)
        tbox = torch.cat([gxy_f - gij.to(fdt), gwh_f], dim=-1)

        iou = bbox_iou(pbox, tbox, xywh=True, ciou=use_ciou,
                       giou=not use_ciou)
        lbox = lbox + torch.where(m, 1.0 - iou, 0.0).sum() / w_cnt

        # objectness soft target at the matched cells (reference utils.py:271)
        t_iou = (1.0 - gr) + gr * torch.clamp_min(iou.detach(), 0.0)
        lin = ((bi * na + ai) * nyb + gj) * nx + gi
        tobj = _last_wins_scatter((B, na, nyb, nx), lin, m, t_iou)

        obj_l = bce_with_logits(pi[..., 4], tobj, hyp["obj_pw"])
        if fl_gamma > 0:
            obj_l = obj_l * focal_scale(pi[..., 4], tobj, fl_gamma)
        if group is None:
            lobj = lobj + obj_l.mean()
        else:
            lobj = lobj + obj_l.sum() / (obj_l.numel() * ranks)

        if nc > 1:
            onehot = torch.arange(nc, device=dev) == cls_f[:, None]
            t_cls = torch.where(onehot, cp, cn).to(fdt)
            cls_l = bce_with_logits(ps[:, 5:], t_cls, hyp["cls_pw"])
            if fl_gamma > 0:
                cls_l = cls_l * focal_scale(ps[:, 5:], t_cls, fl_gamma)
            lcls = lcls + torch.where(m[:, None], cls_l, 0.0).sum() \
                / (w_cnt * nc)

    return {"box_loss": lbox * hyp["box"],
            "obj_loss": lobj * hyp["obj"],
            "class_loss": lcls * hyp["cls"]}


def total_loss(loss_dict):
    return loss_dict["box_loss"] + loss_dict["obj_loss"] \
        + loss_dict["class_loss"]


def pad_labels(label_list, max_targets: int):
    """Host side: per-image (n_i, 5) [cls, cx, cy, w, h] arrays -> ((B, T,
    5), (B, T) mask). Images with more than T labels are truncated."""
    B = len(label_list)
    out = np.zeros((B, max_targets, 5), np.float32)
    mask = np.zeros((B, max_targets), bool)
    for i, lab in enumerate(label_list):
        n = min(len(lab), max_targets)
        if n:
            out[i, :n] = lab[:n]
            mask[i, :n] = True
    return out, mask
