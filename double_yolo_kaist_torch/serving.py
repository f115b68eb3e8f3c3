"""Inference API: a batching, bucketed Predictor on the BN-folded model, and
a micro-batcher that coalesces concurrent requests into its buckets.

Counterpart of the JAX package's ``serving.py``. ``Predictor`` folds once,
pads each request into its batch bucket and runs one body per bucket:
uint8 letterbox -> forward -> NMS -> one packed ``(B, max_det, 7)`` array
with ``valid`` as channel 6, as the JAX package's ``_full_program`` does;
the host undoes the letterbox (``unpack_detections``, export.py:133-151 in
the JAX package). The forward is bf16 or, with ``int8=True``, the
post-training-quantized path of :mod:`.models.quantize` in any of its
modes, calibrated on the first requests served, or from a calibration
artifact, or loaded finished from a quantized-variables artifact.

On a CUDA device the body is captured once per (bucket, source size,
int8) as a CUDA graph and replayed for every request: the port's
counterpart of one compiled XLA program. A request copies its frames into
pinned host staging, then into the graph's static device inputs, replays,
and copies the packed output back once. The head decode runs kernel K1,
the greedy NMS kernel K2, the stem convs kernel K3 and the quantized 1x1
convs kernel K4, inside the graph. On the CPU the same body runs eagerly.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .config.ir import GraphIR, compile_cfg
from .data.letterbox import make_letterbox_fn
from .models import graph
from .models import quantize as Q
from .ops import _build
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


def pack(det, valid):
    """(det (B, max_det, 6), valid (B, max_det)) -> (B, max_det, 7), valid
    as channel 6 (JAX serving.py:209-213)."""
    return torch.cat([det, valid[..., None].to(det.dtype)], dim=-1)


def capture(fn, device, pool=None):
    """Capture ``fn()`` (no arguments; its inputs are static tensors) as a
    CUDA graph on ``device``. ``fn`` runs once eagerly on a side stream
    first, so that kernel libraries are loaded, K1's launch plan is made and
    cuDNN has chosen its kernels before capture. Returns (graph, fn's
    output, {kernel: launches the graph holds}); the wrappers' counts of
    the capture itself are taken back, since nothing launched then. A
    failed capture raises: nothing falls back to eager execution."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn()
    current.wait_stream(side)
    before = dict(_build.launches)
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph, pool=pool):
        out = fn()
    held = {k: n - before.get(k, 0) for k, n in _build.launches.items()
            if n != before.get(k, 0)}
    for name, n in held.items():
        _build.launches[name] -= n
    return cuda_graph, out, held


class _Stage:
    """The static uint8 inputs of one (bucket, source size): device tensors
    that the graphs of that bucket read, and, on CUDA, pinned host staging
    that requests are copied through. Slots past a request's frames are
    zero, as the JAX package pads them."""

    def __init__(self, bucket: int, src_hw: tuple, device):
        shape = (bucket,) + tuple(src_hw) + (3,)
        self.dev = tuple(torch.zeros(shape, dtype=torch.uint8, device=device)
                         for _ in range(2))
        self.host = (tuple(torch.zeros(shape, dtype=torch.uint8,
                                       pin_memory=True) for _ in range(2))
                     if device.type == "cuda" else None)
        self.filled = 0          # slots the previous request wrote

    def load(self, chunk_v: np.ndarray, chunk_l: np.ndarray) -> None:
        """Frames in, zeros after them; only the slots that changed move."""
        real = len(chunk_v)
        n = max(real, self.filled)
        for i, chunk in enumerate((chunk_v, chunk_l)):
            dev = self.dev[i]
            if self.host is None:
                dev[:real].copy_(torch.from_numpy(chunk))
                dev[real:n].zero_()
                continue
            host = self.host[i].numpy()
            host[:real] = chunk
            host[real:n] = 0
            dev[:n].copy_(self.host[i][:n], non_blocking=True)
        self.filled = real


class _Graph:
    """One captured body: the CUDA graph, its packed output on the device
    and its pinned host copy, and the kernel launches the graph holds (the
    wrappers count these on each replay, since they do not run then)."""

    def __init__(self, cuda_graph, out, launches: dict):
        self.graph = cuda_graph
        self.out = out
        self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        self.launches = launches
        self.replays = 0

    def run(self, real: int) -> np.ndarray:
        """Replay, count the graph's launches, and fetch the first ``real``
        rows of the packed output (one device-to-host copy)."""
        self.graph.replay()
        for name, n in self.launches.items():
            _build.launches[name] += n
        self.replays += 1
        self.host.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream(self.out.device).synchronize()
        return self.host.numpy()[:real].copy()


class Predictor:
    def __init__(self, cfg, variables: dict, *, img_size: int = 512,
                 conf_thres: float = 0.1, iou_thres: float = 0.5,
                 multi_label: bool = True, max_det: int = 100,
                 batch_buckets: Sequence[int] = (1, 8, 32),
                 compute_dtype=torch.bfloat16, int8: bool = False,
                 int8_mode: str = "chain", calibration_batches: int = 2,
                 calibration_pct: float = 100.0, calibration=None,
                 quantized=None, merge: bool = False, device=None):
        """``cfg``: a ``.cfg`` path or a compiled :class:`GraphIR`.
        ``variables``: the port's ``{"params", "state"}`` (see
        :mod:`.models.weights`). ``device``: ``None`` means ``"cuda"``; the
        CPU runs only when asked for.

        ``int8``: serve the post-training-quantized path. Activation scales
        are calibrated on the first ``calibration_batches`` batches served
        (their letterboxed inputs are kept until then); those batches run
        the ``compute_dtype`` path eagerly, except the last, which quantizes
        and then runs int8, as in the JAX package. ``calibration_pct``:
        percentile max-abs clipping (100 = exact max-abs). A model whose
        ``int8_mode`` plan is empty (the MobileNet family) is served in
        ``compute_dtype`` with a warning.

        ``calibration``: path of a calibration artifact
        (:func:`.models.quantize.save_calibration`, the JAX package's format
        too). If the file exists, the activation scales load from it and
        int8 serves from the first request; if not, the stats measured on
        the first ``calibration_batches`` batches are written there.

        ``quantized``: path of a quantized-variables artifact
        (:func:`.models.quantize.save_quantized`, the JAX package's format
        too). If the file exists, the finished int8 weights load from it:
        no fold of int8 weights, no calibration, no quantization, and every
        (bucket, source size) is captured straight into its int8 graph. Its
        mode must be ``int8_mode``, and an ``edge`` artifact must have been
        made for ``(img_size, img_size)``. If the file does not exist, this
        server's first quantization is written there. It takes precedence
        over ``calibration``.

        ``merge``: merge-NMS (conf-weighted box fusion) in place of plain
        greedy NMS, as ``detect --merge-nms`` asks for."""
        self.ir: GraphIR = compile_cfg(cfg) if isinstance(cfg, str) else cfg
        self.device = resolve_device(device)
        self.img_size = img_size
        self.batch_buckets = sorted(set(batch_buckets))
        self._dtype = compute_dtype
        self._nms_kw = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                            multi_label=multi_label, max_det=max_det,
                            merge=merge)
        folded = graph.fold_batchnorm(self.ir, variables)
        self.folded = graph.place_folded(self.ir, folded, self.device,
                                         compute_dtype)
        self._pre_cache: dict = {}
        # staging and graphs are shared by every request: one at a time
        self._lock = threading.Lock()
        self._stages: dict = {}          # (bucket, src_hw) -> _Stage
        self._graphs: dict = {}          # (bucket, src_hw, quant) -> _Graph
        self._pool = None                # one memory pool for every graph
        self._int8_mode = int8_mode
        self._q_path = str(quantized) if quantized else None
        # an artifact on disk is served as it is, whatever the plan says
        has_artifact = bool(self._q_path and os.path.exists(self._q_path))
        if int8 and not has_artifact and Q.warn_if_empty_plan(
                self.ir, int8_mode, "serving bf16"):
            int8 = False
        self._int8 = int8
        # quantize() reads the fp32 fold on the host
        self._folded_cpu = folded if int8 else None
        self.qvars = None
        self._cal_batches: list = []
        self._cal_needed = max(1, int(calibration_batches))
        self._cal_pct = float(calibration_pct)
        self._cal_path = str(calibration) if calibration else None
        if int8 and has_artifact:
            self._load_quantized(self._q_path)
        elif int8 and self._cal_path and os.path.exists(self._cal_path):
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

    def _load_quantized(self, path: str) -> None:
        """The int8 weights from a quantized-variables artifact, with the
        JAX package's checks (serving.py:123-160) but its s2d-plan check,
        the port having no s2d plan."""
        qv, qmode, qhw = Q.load_quantized(path)
        if qmode != self._int8_mode:
            raise ValueError(
                f"quantized artifact {path} was built for mode={qmode!r}, "
                f"server requested {self._int8_mode!r}")
        size = (self.img_size, self.img_size)
        if self._int8_mode == "edge" and qhw is not None and qhw != size:
            raise ValueError(
                f"quantized artifact {path} prepared for hw={qhw}, server "
                f"img_size={self.img_size}: edge-mode plans are derived "
                f"from the prepare size, so edge artifacts require an exact "
                f"match — re-export with python -m "
                f"double_yolo_kaist_torch.calibrate")
        self.qvars = Q.place_quantized(self.ir, qv, self.device, self._dtype)

    def _quantize_from_stats(self, stats: dict) -> None:
        """Quantize the folded weights with calibration ``stats`` (CPU) and
        place them on the device; int8 serves from then on. Graphs captured
        on earlier int8 weights are dropped. With a ``quantized`` path that
        does not exist yet, the variables are saved there."""
        hw = (self.img_size, self.img_size)
        qv = Q.quantize(self.ir, self._folded_cpu, stats,
                        mode=self._int8_mode)
        if self._q_path and not os.path.exists(self._q_path):
            Q.save_quantized(self._q_path, qv, mode=self._int8_mode, hw=hw)
        self.qvars = Q.place_quantized(self.ir, qv, self.device, self._dtype)
        self._graphs = {k: g for k, g in self._graphs.items() if not k[2]}

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

    def _body(self, v_u8, l_u8, quant: bool):
        """One padded bucket, uint8 (B, H, W, 3) -> packed (B, max_det, 7):
        what a graph captures (the JAX package's ``_full_program``)."""
        fn, _, _ = self._preprocess(tuple(v_u8.shape[1:3]))
        xv, xl = fn(v_u8, l_u8)
        io, _ = self._forward(xv, xl, quant)
        return pack(*non_max_suppression(io, **self._nms_kw))

    @torch.inference_mode()
    def run_batch(self, v_u8, l_u8):
        """One padded bucket, eagerly: uint8 (B, H, W, 3) tensors on the
        device -> (det (B, max_det, 6), valid (B, max_det)) in the
        letterboxed frame. Under ``int8`` the calibration batches are taken
        here."""
        fn, _, _ = self._preprocess(tuple(v_u8.shape[1:3]))
        xv, xl = fn(v_u8, l_u8)
        quant = self._int8 and self._ensure_calibrated(xv, xl)
        io, _ = self._forward(xv, xl, quant)
        return non_max_suppression(io, **self._nms_kw)

    def _stage(self, bucket: int, src_hw: tuple) -> _Stage:
        stage = self._stages.get((bucket, src_hw))
        if stage is None:
            stage = self._stages[(bucket, src_hw)] = _Stage(bucket, src_hw,
                                                           self.device)
        return stage

    def _graph(self, bucket: int, src_hw: tuple, quant: bool) -> _Graph:
        """The graph of (bucket, src_hw, quant), captured on first use on
        the stage's static inputs (:func:`capture`)."""
        key = (bucket, src_hw, quant)
        g = self._graphs.get(key)
        if g is not None:
            return g
        v, l = self._stage(bucket, src_hw).dev
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cuda_graph, out, held = capture(lambda: self._body(v, l, quant),
                                        self.device, self._pool)
        g = self._graphs[key] = _Graph(cuda_graph, out, held)
        return g

    @torch.inference_mode()
    def _run_chunk(self, bucket: int, src_hw: tuple, chunk_v, chunk_l):
        """One chunk of a request -> its packed rows (real, max_det, 7),
        numpy. Called with the lock held."""
        real = len(chunk_v)
        stage = self._stage(bucket, src_hw)
        stage.load(chunk_v, chunk_l)
        v, l = stage.dev
        if self._int8 and self.qvars is None:
            # calibration requests run eagerly (they keep their inputs)
            return pack(*self.run_batch(v, l))[:real].cpu().numpy()
        if self.device.type != "cuda":
            return self._body(v, l, self._int8)[:real].numpy()
        return self._graph(bucket, src_hw, self._int8).run(real)

    @torch.inference_mode()
    def warmup(self, src_hw: tuple, batch: Optional[int] = None) -> None:
        """Make ready the ``compute_dtype`` path for ``src_hw`` frames at
        ``batch``'s bucket (snapped to the bucket ``__call__`` picks): on
        CUDA, capture its graph and replay it once; on the CPU, run the body
        once on zeros. Never touches int8 calibration: a dummy frame served
        through ``__call__`` would take one of the calibration slots."""
        b = self._bucket(batch) if batch else self.batch_buckets[0]
        src_hw = tuple(src_hw)
        with self._lock:
            stage = self._stage(b, src_hw)
            if self.device.type == "cuda":
                self._graph(b, src_hw, False).run(0)
            else:
                self._body(*stage.dev, quant=False)

    def __call__(self, v_imgs: np.ndarray, l_imgs: Optional[np.ndarray] = None):
        """v_imgs / l_imgs: (N, H, W, 3) uint8 RGB at native size.

        Returns a list of (boxes xyxy in the ORIGINAL frame, scores,
        classes) per image. Thread-safe: requests take turns on the
        device."""
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
            chunk_v = np.ascontiguousarray(v_imgs[b0:b0 + bucket], np.uint8)
            chunk_l = np.ascontiguousarray(l_imgs[b0:b0 + bucket], np.uint8)
            with self._lock:
                packed = self._run_chunk(bucket, src_hw, chunk_v, chunk_l)
            out.extend(unpack_detections(packed[..., :6], packed[..., 6] > 0.5,
                                         len(chunk_v), ratio[0], pad, src_hw))
        return out


class QueueFull(RuntimeError):
    """Raised by MicroBatcher.submit when the pending queue exceeds
    max_queue: the server sheds the request (HTTP 503) instead of letting
    tail latency grow without bound."""


class MicroBatcher:
    """Cross-request micro-batching: coalesce concurrent single-frame
    requests into one batched predictor call (the JAX package's
    ``serving.MicroBatcher``).

    * one dispatcher thread owns the device; request threads enqueue
      frames and block on a per-request event;
    * the dispatcher takes everything pending (same source shape, up to
      ``max_batch``) the moment it is free, so an idle server runs a lone
      request at once;
    * while a batch runs, new arrivals pile up and form the next batch, so
      under load the batch size follows the device's throughput;
    * ``max_wait_ms`` (default 0) holds the first request of a batch for a
      fixed window so that more arrivals join it, trading tail latency for
      bigger buckets;
    * ``max_queue`` bounds the frames waiting: beyond it ``submit`` raises
      :class:`QueueFull`;
    * an error of a batch is raised in every submitter of that batch.

    Results equal unbatched serving: the fixed-shape NMS is per image, and
    the predictor zero-pads partial buckets itself.
    """

    def __init__(self, predictor, *, max_batch: int = 16,
                 max_wait_ms: float = 0.0, max_queue: int | None = None):
        self.predictor = predictor
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_queue = None if max_queue is None else int(max_queue)
        self._lock = threading.Lock()
        self._arrived = threading.Condition(self._lock)
        self._pending: list = []       # request dicts, first in first out
        self._stop = False
        self._n_batches = 0
        self._n_frames = 0
        self._size_hist: dict = {}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatch-dispatcher")
        self._thread.start()

    @property
    def stats(self) -> dict:
        """Coalescing statistics: how well concurrent traffic batches."""
        with self._lock:
            n = max(self._n_batches, 1)
            return {"batches": self._n_batches, "frames": self._n_frames,
                    "mean_batch": round(self._n_frames / n, 2),
                    "size_hist": dict(sorted(self._size_hist.items()))}

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._arrived.notify()
        self._thread.join(timeout=5)

    def submit(self, v_img: np.ndarray, l_img: np.ndarray | None = None):
        """One frame in (H, W, 3) uint8 -> (boxes, scores, classes). Blocks
        until the coalesced batch holding this frame completes. Thread-safe:
        call it from each request handler thread."""
        req = {"v": np.asarray(v_img),
               "l": np.asarray(v_img if l_img is None else l_img),
               "done": threading.Event(), "t0": time.monotonic()}
        if req["v"].shape != req["l"].shape:
            raise ValueError(f"visible/lwir shape mismatch: "
                             f"{req['v'].shape} vs {req['l'].shape}")
        with self._lock:
            if self._stop:
                raise RuntimeError("MicroBatcher is closed")
            if (self.max_queue is not None
                    and len(self._pending) >= self.max_queue):
                raise QueueFull(
                    f"{len(self._pending)} requests already queued "
                    f"(max_queue={self.max_queue})")
            self._pending.append(req)
            self._arrived.notify()
        req["done"].wait()
        if "err" in req:
            raise req["err"]
        return req["res"]

    def _take_batch(self) -> list:
        """Called with the lock held and requests pending: pop the oldest
        request and every same-shape request after it, up to max_batch."""
        if self.max_wait > 0:
            deadline = self._pending[0]["t0"] + self.max_wait
            while len(self._pending) < self.max_batch and not self._stop:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._arrived.wait(left)
                if not self._pending:   # raced with close()
                    return []
        shape = self._pending[0]["v"].shape
        take, keep = [], []
        for r in self._pending:
            if r["v"].shape == shape and len(take) < self.max_batch:
                take.append(r)
            else:
                keep.append(r)
        self._pending = keep
        return take

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._stop:
                    self._arrived.wait()
                if self._stop:
                    batch, self._pending = self._pending, []
                    for r in batch:
                        r["err"] = RuntimeError("MicroBatcher closed")
                        r["done"].set()
                    return
                batch = self._take_batch()
                if batch:
                    self._n_batches += 1
                    self._n_frames += len(batch)
                    self._size_hist[len(batch)] = (
                        self._size_hist.get(len(batch), 0) + 1)
            if not batch:
                continue
            try:
                res = self.predictor(np.stack([r["v"] for r in batch]),
                                     np.stack([r["l"] for r in batch]))
                for r, out in zip(batch, res):
                    r["res"] = out
            except Exception as e:  # noqa: BLE001 — delivered to submitters
                for r in batch:
                    r["err"] = e
            for r in batch:
                r["done"].set()
