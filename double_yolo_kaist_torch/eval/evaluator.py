"""Offline evaluation: COCO 12-stat summary + VOC-AP@0.5 + LAMR + fps over a
KAIST split.

Counterpart of the JAX package's ``eval/evaluator.py::evaluate_dataset``
(the reference's evaluate.py:31-123). On the device: the BN-folded forward (the
unfolded ``graph.apply`` with ``folded=False``) in ``compute_dtype`` (or
the int8 PTQ forward in any mode, also from a quantized-variables
artifact), the head decode
(kernel K1), the stem convs (K3), the quantized 1x1 convs (K4) and the
greedy NMS (K2). On the host: the letterbox undo and the metrics
(:mod:`.metrics`, :mod:`.coco_map`).
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
from ..ops.nms import non_max_suppression
from .coco_map import evaluate_coco
from .metrics import compute_ap_lamr


LOOP_SPAN = "evaluate_dataset/batch_loop"


def _undo_letterbox(boxes: np.ndarray, ratio, pad, orig_hw):
    """scale_coords on host numpy (reference utils.py:60-84)."""
    gain = ratio[0]
    out = boxes.copy()
    out[:, [0, 2]] -= pad[0]
    out[:, [1, 3]] -= pad[1]
    out /= gain
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, orig_hw[1])
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, orig_hw[0])
    return out


def evaluate_dataset(ir, variables, dataset, *, batch_size: int = 32,
                     conf_thres: float = 0.01, iou_thres: float = 0.6,
                     multi_label: bool = False,
                     compute_dtype=torch.bfloat16, folded: bool = True,
                     max_det: int = 100, progress: bool = False,
                     int8: bool = False, int8_mode: str = "chain",
                     calibration_batches: int = 2,
                     calibration_pct: float = 100.0, calibration=None,
                     quantized=None, merge: bool = False, mesh=None,
                     device_cache: bool | None = None, device=None):
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
    run's stats are saved there. ``quantized``: a quantized-variables
    artifact (:func:`..models.quantize.save_quantized`); when it exists the
    literal int8 model a deployment serves is evaluated (its mode must be
    ``int8_mode``), with no fold, calibration or quantization; when it does
    not, the int8 path runs as without it. ``device_cache``: the residency
    tier of the split (:func:`..data.pipeline.eval_batches`). ``device``:
    None means ``cuda``; the CPU runs only when asked for."""
    if mesh is not None:
        raise NotImplementedError(
            "evaluation over several devices is not ported yet (ROADMAP.md, "
            "queue 1 item 12)")
    dev = resolve_device(device)
    artifact = bool(quantized and os.path.exists(str(quantized)))
    # a frozen artifact is evaluated literally, whatever the plan says
    if int8 and not artifact and Q.warn_if_empty_plan(
            ir, int8_mode, "evaluating the folded path"):
        int8 = False

    if int8 and artifact:
        qv, qmode, _ = Q.load_quantized(str(quantized))
        if qmode != int8_mode:
            raise ValueError(f"quantized artifact {quantized} was built for "
                             f"mode={qmode!r}, eval requested "
                             f"{int8_mode!r}")
        qvars = Q.place_quantized(ir, qv, dev, compute_dtype)
    elif not (folded or int8):        # int8 runs the folded path
        unfolded = graph.place_variables(variables, dev)

        def forward(xv, xl):
            (io, raw), _ = graph.apply(ir, unfolded, xv, xl, train=False,
                                       compute_dtype=compute_dtype)
            return io, raw
    else:
        fold = graph.fold_batchnorm(ir, variables)
        placed = graph.place_folded(ir, fold, dev, compute_dtype)
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
        qvars = Q.place_quantized(
            ir, Q.quantize(ir, fold, stats, mode=int8_mode), dev,
            compute_dtype)
        del placed
    if int8:
        def forward(xv, xl):
            return Q.apply_quantized(ir, qvars, xv, xl,
                                     compute_dtype=compute_dtype,
                                     mode=int8_mode)
    elif folded:
        def forward(xv, xl):
            return graph.apply_folded(ir, placed, xv, xl,
                                      compute_dtype=compute_dtype)

    @torch.inference_mode()
    def infer(xv, xl):
        io, _ = forward(xv, xl)
        det, valid = non_max_suppression(
            io, conf_thres=conf_thres, iou_thres=iou_thres,
            multi_label=multi_label, max_det=max_det, merge=merge)
        # the valid mask as a 7th channel: one fetch per batch
        packed = torch.cat([det, valid[..., None].to(det.dtype)], dim=-1)
        return packed.cpu().numpy()          # the fetch synchronises

    preds = []
    coco_preds = {}
    n_images = n_batches = 0
    fwd_time = 0.0
    # the batch loop is a span that a torch.profiler trace shows by this
    # name: a device busy share reads the kernels that start inside it
    with torch.profiler.record_function(LOOP_SPAN):
        t_loop = time.perf_counter()
        # host decode and preprocess launches overlap the forward
        it = prefetch(eval_batches(dataset, batch_size,
                                   device_cache=device_cache, device=dev))
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
                coco_preds[int(img_id)] = (boxes, d[:, 4])
                for b, s in zip(boxes, d[:, 4]):
                    preds.append({"img_id": int(img_id), "conf": float(s),
                                  "bbox": b})
        loop_time = time.perf_counter() - t_loop

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
