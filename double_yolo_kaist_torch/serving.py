"""Inference API: a batching, bucketed Predictor on the BN-folded model.

Counterpart of the JAX package's ``serving.Predictor`` (serving.py:25-330):
fold once, pad each request into its batch bucket, then letterbox + forward
+ NMS on the device, and undo the letterbox on the host
(``unpack_detections``, export.py:133-151 in the JAX package). The forward
is bf16 or, with ``int8=True``, the post-training-quantized path of
:mod:`.models.quantize`, calibrated on the first requests served. On a CUDA
device the head decode runs kernel K1, the greedy NMS kernel K2, the stem
convs kernel K3 and the quantized 1x1 convs kernel K4.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .config.ir import GraphIR, compile_cfg
from .data.letterbox import make_letterbox_fn
from .models import graph
from .models import quantize as Q
from .ops.nms import non_max_suppression


def unpack_detections(det, valid, real, ratio: float, pad, src_hw):
    """Packed (B, max_det, 6) detections + valid mask (numpy) -> per-image
    (boxes xyxy in the ORIGINAL frame, scores, classes) for the first
    ``real`` images: subtract the pad, divide by the ratio, clip to the
    frame (reference utils.scale_coords semantics)."""
    out = []
    for i in range(real):
        d = det[i][valid[i]]
        boxes = d[:, :4].copy()
        if len(boxes):
            boxes[:, [0, 2]] -= pad[0]
            boxes[:, [1, 3]] -= pad[1]
            boxes /= ratio
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, src_hw[1])
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, src_hw[0])
        out.append((boxes, d[:, 4], d[:, 5].astype(int)))
    return out


class Predictor:
    def __init__(self, cfg, variables: dict, *, img_size: int = 512,
                 conf_thres: float = 0.1, iou_thres: float = 0.5,
                 multi_label: bool = True, max_det: int = 100,
                 batch_buckets: Sequence[int] = (1, 8, 32),
                 compute_dtype=torch.bfloat16, int8: bool = False,
                 int8_mode: str = "chain", calibration_batches: int = 2,
                 calibration_pct: float = 100.0, calibration=None,
                 device=None):
        """``cfg``: a ``.cfg`` path or a compiled :class:`GraphIR`.
        ``variables``: the port's ``{"params", "state"}`` (see
        :mod:`.models.weights`). ``device``: ``None`` means ``"cuda"``; the
        CPU runs only when asked for.

        ``int8``: serve the post-training-quantized path. Activation scales
        are calibrated on the first ``calibration_batches`` batches served
        (their letterboxed inputs are kept until then); those batches run
        the ``compute_dtype`` path, except the last, which quantizes and
        then runs int8, as in the JAX package. ``calibration_pct``:
        percentile max-abs clipping (100 = exact max-abs). A model whose
        ``int8_mode`` plan is empty (the MobileNet family) is served in
        ``compute_dtype`` with a warning.

        ``calibration``: path of a calibration artifact
        (:func:`.models.quantize.save_calibration`, the JAX package's format
        too). If the file exists, the activation scales load from it and
        int8 serves from the first request; if not, the stats measured on
        the first ``calibration_batches`` batches are written there."""
        self.ir: GraphIR = compile_cfg(cfg) if isinstance(cfg, str) else cfg
        self.device = resolve_device(device)
        self.img_size = img_size
        self.batch_buckets = sorted(set(batch_buckets))
        self._dtype = compute_dtype
        self._nms_kw = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                            multi_label=multi_label, max_det=max_det)
        folded = graph.fold_batchnorm(self.ir, variables)
        self.folded = graph.place_folded(self.ir, folded, self.device,
                                         compute_dtype)
        self._pre_cache: dict = {}
        self._int8_mode = int8_mode
        if int8 and Q.warn_if_empty_plan(self.ir, int8_mode, "serving bf16"):
            int8 = False
        self._int8 = int8
        # quantize() reads the fp32 fold on the host
        self._folded_cpu = folded if int8 else None
        self.qvars = None
        self._cal_batches: list = []
        self._cal_needed = max(1, int(calibration_batches))
        self._cal_pct = float(calibration_pct)
        self._cal_path = str(calibration) if calibration else None
        if int8 and self._cal_path and os.path.exists(self._cal_path):
            stats, _ = Q.load_calibration(self._cal_path)
            self._quantize_from_stats(stats)

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def _preprocess(self, src_hw):
        if src_hw not in self._pre_cache:
            s = self.img_size
            r = s / max(src_hw)
            dst = (int(np.ceil(src_hw[0] * r / 64) * 64),
                   int(np.ceil(src_hw[1] * r / 64) * 64))
            self._pre_cache[src_hw] = make_letterbox_fn(src_hw, dst,
                                                        scale_up=False)
        return self._pre_cache[src_hw]

    def _quantize_from_stats(self, stats: dict) -> None:
        """Quantize the folded weights with calibration ``stats`` (CPU) and
        place them on the device; int8 serves from then on."""
        qv = Q.quantize(self.ir, self._folded_cpu, stats,
                        mode=self._int8_mode)
        self.qvars = Q.place_quantized(self.ir, qv, self.device, self._dtype)

    def _ensure_calibrated(self, xv, xl) -> bool:
        """Keep a calibration batch, then quantize once enough are kept.
        True once the int8 weights exist."""
        if self.qvars is not None:
            return True
        self._cal_batches.append((xv, xl))
        if len(self._cal_batches) < self._cal_needed:
            return False
        stats = Q.calibrate(self.ir, self.folded, self._cal_batches,
                            compute_dtype=self._dtype, pct=self._cal_pct)
        if self._cal_path:
            Q.save_calibration(self._cal_path, stats, pct=self._cal_pct)
        self._quantize_from_stats(stats)
        self._cal_batches = []
        return True

    def _forward(self, xv, xl, quant: bool):
        if quant:
            return Q.apply_quantized(self.ir, self.qvars, xv, xl,
                                     compute_dtype=self._dtype,
                                     mode=self._int8_mode)
        return graph.apply_folded(self.ir, self.folded, xv, xl,
                                  compute_dtype=self._dtype)

    @torch.inference_mode()
    def run_batch(self, v_u8, l_u8):
        """One padded bucket on the device: uint8 (B, H, W, 3) tensors ->
        (det (B, max_det, 6), valid (B, max_det)) in the letterboxed frame.
        Under ``int8`` the calibration batches are taken here."""
        fn, _, _ = self._preprocess(tuple(v_u8.shape[1:3]))
        xv, xl = fn(v_u8, l_u8)
        quant = self._int8 and self._ensure_calibrated(xv, xl)
        io, _ = self._forward(xv, xl, quant)
        return non_max_suppression(io, **self._nms_kw)

    @torch.inference_mode()
    def warmup(self, src_hw: tuple, batch: Optional[int] = None) -> None:
        """Run the ``compute_dtype`` path once on a zero batch of
        ``src_hw`` frames (cuDNN plans, kernel builds) without touching
        int8 calibration: a dummy frame served through ``__call__`` would
        take one of the calibration slots. ``batch`` is snapped to its
        bucket."""
        b = self._bucket(batch) if batch else self.batch_buckets[0]
        fn, _, _ = self._preprocess(tuple(src_hw))
        z = torch.zeros((b,) + tuple(src_hw) + (3,), dtype=torch.uint8,
                        device=self.device)
        io, _ = self._forward(*fn(z, z), quant=False)
        non_max_suppression(io, **self._nms_kw)

    def __call__(self, v_imgs: np.ndarray, l_imgs: Optional[np.ndarray] = None):
        """v_imgs / l_imgs: (N, H, W, 3) uint8 RGB at native size.

        Returns a list of (boxes xyxy in the ORIGINAL frame, scores,
        classes) per image."""
        n = len(v_imgs)
        if l_imgs is None:
            l_imgs = v_imgs
        if v_imgs.shape != l_imgs.shape:
            raise ValueError(f"visible/lwir shape mismatch: {v_imgs.shape} "
                             f"vs {l_imgs.shape}")
        src_hw = tuple(v_imgs.shape[1:3])
        _, ratio, pad = self._preprocess(src_hw)
        bucket = self._bucket(n)
        out = []
        for b0 in range(0, n, bucket):
            chunk_v = np.ascontiguousarray(v_imgs[b0:b0 + bucket])
            chunk_l = np.ascontiguousarray(l_imgs[b0:b0 + bucket])
            real = len(chunk_v)
            v = torch.zeros((bucket,) + chunk_v.shape[1:], dtype=torch.uint8,
                            device=self.device)
            l = torch.zeros_like(v)
            v[:real] = torch.from_numpy(chunk_v).to(self.device)
            l[:real] = torch.from_numpy(chunk_l).to(self.device)
            det, valid = self.run_batch(v, l)
            out.extend(unpack_detections(det.cpu().numpy(),
                                         valid.cpu().numpy(), real,
                                         ratio[0], pad, src_hw))
        return out
