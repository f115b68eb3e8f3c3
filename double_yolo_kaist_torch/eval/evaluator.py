"""Offline evaluation: COCO 12-stat summary + VOC-AP@0.5 + LAMR + fps over a
KAIST split.

Counterpart of the JAX package's ``eval/evaluator.py::evaluate_dataset``
(the reference's evaluate.py:31-123). On the device: the BN-folded forward (the
unfolded ``graph.apply`` with ``folded=False``) in ``compute_dtype`` (or
the int8 PTQ forward in any mode, also from a quantized-variables
artifact), the head decode
(kernel K1), the stem convs (K3), the quantized 1x1 convs (K4) and the
greedy NMS (K2). On the host: the letterbox undo and the metrics
(:mod:`.metrics`, :mod:`.coco_map`). The forward runs on one device, on
the replicas of a device mesh, or split over the processes of a group.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data.pipeline import eval_batches, prefetch
from ..models import graph
from ..models import quantize as Q
from ..ops.boxes import scale_coords
from ..ops.nms import non_max_suppression
from ..parallel import mesh as M
from ..parallel import multihost as MH
from ..utils import tree as TR
from .coco_map import evaluate_coco
from .metrics import compute_ap_lamr


LOOP_SPAN = "evaluate_dataset/batch_loop"


def _undo_letterbox(boxes: np.ndarray, ratio, pad, orig_hw):
    """:func:`..ops.boxes.scale_coords` of host numpy boxes, with the
    batch's letterbox (reference utils.py:60-84)."""
    return scale_coords(None, torch.from_numpy(boxes), orig_hw,
                        ratio_pad=(ratio, pad)).numpy()


def _prepare_hw(dataset) -> tuple:
    """The size the int8 weights are quantized for (JAX
    evaluator.py:108-117): a rect dataset's first batch shape (e.g.
    416x512), else (img_size, img_size). Its s2d plan sets ``spine``'s and
    ``edge``'s plans."""
    if getattr(dataset, "rect", False):
        return tuple(int(x) for x in dataset.batch_shapes[0])
    s = int(getattr(dataset, "img_size", 512))
    return (s, s)


def evaluate_dataset(ir, variables, dataset, *, batch_size: int = 32,
                     conf_thres: float = 0.01, iou_thres: float = 0.6,
                     multi_label: bool = False,
                     compute_dtype=torch.bfloat16, folded: bool = True,
                     max_det: int = 100, progress: bool = False,
                     int8: bool = False, int8_mode: str = "chain",
                     calibration_batches: int = 2,
                     calibration_pct: float = 100.0, calibration=None,
                     quantized=None, merge: bool = False, mesh=None,
                     device_cache: bool | None = None, device=None,
                     group=None):
    """Run the full eval loop. Returns a dict with the 12 COCO stats, ap,
    lamr, fps, the curves, the per-image predictions, and ``seconds``:
    host time in the forward + NMS + fetch (``infer``), in the whole batch
    loop (``loop``) and in the metrics (``metrics``), and ``batches``.

    ``variables``: the port's ``{"params", "state"}`` (:mod:`..models.
    weights`). ``folded``: False runs the unfolded ``graph.apply`` in eval
    mode (BN from the running state) instead of the BN-folded forward.
    ``int8``: post-training int8 (``int8_mode``'s plan)
    calibrated on the first ``calibration_batches`` eval batches, or with
    the stats of ``calibration`` (a :func:`..models.quantize.
    save_calibration` file) when that file exists; when it does not, this
    run's stats are saved there, and the weights are quantized for the
    batches' size (:func:`_prepare_hw`). ``quantized``: a quantized-variables
    artifact (:func:`..models.quantize.save_quantized`); when it exists the
    literal int8 model a deployment serves is evaluated (its mode must be
    ``int8_mode``), with no fold, calibration or quantization; when it does
    not, the int8 path runs as without it. ``device_cache``: the residency
    tier of the split (:func:`..data.pipeline.eval_batches`). ``device``:
    None means ``cuda``; the CPU runs only when asked for.

    ``mesh``: a :class:`..parallel.mesh.Mesh`: the forward + NMS runs
    data-parallel over its replicas (JAX evaluator.py:62-128, 222-250).
    The variables (or int8 weights) are placed on each replica once; a
    batch is padded to a multiple of the mesh size, split into equal
    shards, every replica's shard is launched before the one fetch of the
    batch, and the padding rows are dropped. ``device`` is then the
    mesh's first replica, where batches and calibration run.

    ``group``: a ``torch.distributed`` group of processes that split the
    evaluation: batch k runs on rank ``k % W``, each rank's detections
    (in the original frame, fixed shape) go through
    :func:`..parallel.multihost.allgather_predictions`, and every rank
    computes the same metrics from all of them."""
    if mesh is not None:
        if group is not None:
            raise ValueError("evaluate_dataset takes a mesh or a group, "
                             "not both")
        mesh = M.check_mesh(mesh)
        dev = mesh.replicas[0]
    else:
        dev = resolve_device(device)
    artifact = bool(quantized and os.path.exists(str(quantized)))
    # a frozen artifact is evaluated literally, whatever the plan says
    if int8 and not artifact and Q.warn_if_empty_plan(
            ir, int8_mode, "evaluating the folded path"):
        int8 = False

    devices = [dev] if mesh is None else mesh.replicas

    def place(make):
        """``make(device)`` for each replica, once a device."""
        return M.per_device(devices, make)

    if int8 and artifact:
        qv, qmode, _ = Q.load_quantized(str(quantized))
        if qmode != int8_mode:
            raise ValueError(f"quantized artifact {quantized} was built for "
                             f"mode={qmode!r}, eval requested "
                             f"{int8_mode!r}")
        reps = place(lambda d: Q.place_quantized(ir, qv, d, compute_dtype))
    elif not (folded or int8):        # int8 runs the folded path
        reps = place(lambda d: graph.place_variables(variables, d))

        def forward(unfolded, xv, xl):
            (io, raw), _ = graph.apply(ir, unfolded, xv, xl, train=False,
                                       compute_dtype=compute_dtype)
            return io, raw
    else:
        fold = graph.fold_batchnorm(ir, variables)
        if int8 and not artifact:
            placed = graph.place_folded(ir, fold, dev, compute_dtype)
        else:
            reps = place(lambda d: graph.place_folded(ir, fold, d,
                                                      compute_dtype))
    if int8 and not artifact:
        if calibration and os.path.exists(str(calibration)):
            stats, _ = Q.load_calibration(str(calibration))
        else:
            cal = []
            for v, l, _, _ in eval_batches(dataset, batch_size,
                                           device_cache=device_cache,
                                           device=dev):
                cal.append((v, l))
                if len(cal) >= calibration_batches:
                    break
            stats = Q.calibrate(ir, placed, cal, compute_dtype=compute_dtype,
                                pct=calibration_pct)
            del cal
            if calibration:
                Q.save_calibration(str(calibration), stats,
                                   pct=calibration_pct)
        # quantized from the fold on the host, wherever the variables
        # live (as Predictor quantizes): edge mode's scales are host
        # arrays, and the int8 model of live weights on the card must be
        # the one their checkpoint gives
        qv = Q.quantize(ir, TR.map_leaves(lambda t: t.cpu(), fold), stats,
                        mode=int8_mode, hw=_prepare_hw(dataset))
        del placed
        reps = place(lambda d: Q.place_quantized(ir, qv, d, compute_dtype))
    if int8:
        def forward(qvars, xv, xl):
            return Q.apply_quantized(ir, qvars, xv, xl,
                                     compute_dtype=compute_dtype,
                                     mode=int8_mode)
    elif folded:
        def forward(placed, xv, xl):
            return graph.apply_folded(ir, placed, xv, xl,
                                      compute_dtype=compute_dtype)

    def packed_dets(variables, xv, xl):
        io, _ = forward(variables, xv, xl)
        det, valid = non_max_suppression(
            io, conf_thres=conf_thres, iou_thres=iou_thres,
            multi_label=multi_label, max_det=max_det, merge=merge)
        # the valid mask as a 7th channel: one fetch per batch
        return torch.cat([det, valid[..., None].to(det.dtype)], dim=-1)

    @torch.inference_mode()
    def infer(xv, xl):
        if mesh is None:
            return packed_dets(reps[0], xv, xl).cpu().numpy()
        real = xv.shape[0]
        shards = M.shard_batch(
            {"v": M.pad_to_multiple(xv, mesh.size),
             "l": M.pad_to_multiple(xl, mesh.size)}, mesh)
        outs = []
        for r, (sh, rdev) in enumerate(zip(shards, mesh.replicas)):
            with M.device_scope(rdev):
                outs.append(packed_dets(reps[r], sh["v"], sh["l"]))
        # every shard is launched before the one fetch of the batch
        packed = torch.cat([o.to(dev) for o in outs]).cpu().numpy()
        return packed[:real]          # the padding rows go

    preds = []
    coco_preds = {}
    n_images = n_batches = 0
    fwd_time = 0.0
    ranks = 1 if group is None else torch.distributed.get_world_size(group)
    rank = 0 if group is None else torch.distributed.get_rank(group)
    if ranks > 1:
        n_all = len(dataset)
        mine = {"boxes": np.zeros((n_all, max_det, 4), np.float32),
                "scores": np.zeros((n_all, max_det), np.float32),
                "count": np.zeros((n_all,), np.int32)}
    # the batch loop is a span that a torch.profiler trace shows by this
    # name: a device busy share reads the kernels that start inside it
    with torch.profiler.record_function(LOOP_SPAN):
        t_loop = time.perf_counter()
        # host decode and preprocess launches overlap the forward
        it = prefetch(eval_batches(
            dataset, batch_size, device_cache=device_cache, device=dev,
            shard=(rank, ranks) if ranks > 1 else None))
        if progress:
            import tqdm
            it = tqdm.tqdm(it, desc="evaluating")

        for v, l, idx, (ratio, pad) in it:
            t0 = time.perf_counter()
            # single-stream graphs simply ignore the second input
            packed = infer(v, l)
            det, valid = packed[..., :6], packed[..., 6] > 0.5
            fwd_time += time.perf_counter() - t0
            n_images += len(idx)
            n_batches += 1

            for bi, img_id in enumerate(idx):
                orig_wh = dataset.shapes[img_id]
                orig_hw = (orig_wh[1], orig_wh[0])
                d = det[bi][valid[bi]]
                if len(d):
                    boxes = _undo_letterbox(d[:, :4], ratio, pad, orig_hw)
                else:
                    boxes = np.zeros((0, 4))
                if ranks > 1:
                    mine["boxes"][img_id, :len(d)] = boxes
                    mine["scores"][img_id, :len(d)] = d[:, 4]
                    mine["count"][img_id] = len(d)
                    continue
                coco_preds[int(img_id)] = (boxes, d[:, 4])
                for b, s in zip(boxes, d[:, 4]):
                    preds.append({"img_id": int(img_id), "conf": float(s),
                                  "bbox": b})
        loop_time = time.perf_counter() - t_loop

    if ranks > 1:
        coco_preds, preds = _merge_ranks(mine, batch_size, ranks, group)
    t0 = time.perf_counter()
    preds.sort(key=lambda p: -p["conf"])
    ap_lamr = compute_ap_lamr(preds, dataset.labels, dataset.shapes)
    coco_stats = evaluate_coco(coco_preds, dataset.coco_ground_truth())
    metrics_time = time.perf_counter() - t0
    # fps times forward + NMS + the device->host fetch, as the JAX package
    # does; the reference times the forward alone (evaluate.py:70-74), so
    # this fps is the conservative side of a comparison
    fps = n_images / fwd_time if fwd_time > 0 else 0.0
    return {"coco_stats": coco_stats, "ap": ap_lamr["ap"],
            "lamr": ap_lamr["lamr"], "fps": fps, "fps_timed": "fwd+nms+fetch",
            "curves": {k: ap_lamr[k] for k in
                       ("recall", "precision", "fppi", "mr")},
            "predictions": coco_preds,
            "seconds": {"infer": fwd_time, "loop": loop_time,
                        "metrics": metrics_time},
            "batches": n_batches}


def _merge_ranks(mine: dict, batch_size: int, ranks: int, group):
    """Every rank's detections, gathered: image i comes from the rank that
    ran its batch, ``(i // batch_size) % ranks``. Returns (coco_preds,
    preds) as one process builds them, in image order."""
    alls = MH.allgather_predictions(mine, group)
    coco_preds, preds = {}, []
    for i in range(len(mine["count"])):
        r = (i // batch_size) % ranks
        n = int(alls["count"][r, i])
        boxes = alls["boxes"][r, i, :n] if n else np.zeros((0, 4))
        scores = alls["scores"][r, i, :n]
        coco_preds[i] = (boxes, scores)
        for b, s in zip(boxes, scores):
            preds.append({"img_id": i, "conf": float(s), "bbox": b})
    return coco_preds, preds
