"""Inference API: a batching, bucketed Predictor on the BN-folded model, and
a micro-batcher that coalesces concurrent requests into its buckets.

Counterpart of the JAX package's ``serving.py``. ``Predictor`` folds once,
pads each request into its batch bucket and runs one body per bucket:
uint8 letterbox -> forward -> NMS -> one packed ``(B, max_det, 7)`` array
with ``valid`` as channel 6, as the JAX package's ``_full_program`` does;
the host undoes the letterbox (``unpack_detections``, kept in
:mod:`.export`, as the JAX package keeps it in its export.py:133-151). The forward is bf16 or, with ``int8=True``, the
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

With a device mesh (``mesh=``, :mod:`.parallel.mesh`) the Predictor is
data-parallel, as the JAX package's is over its mesh: the buckets round
up to multiples of the mesh size, the folded (and int8) variables are
placed on each replica's device once, a bucket is split into equal
shards, one a replica, and each replica serves its shard from its own
CUDA graph. Every replica's replay is launched before the first fetch;
the shards' detections are concatenated in order.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .config.ir import GraphIR, compile_cfg
from .cuda_graphs import Graph as _Graph
from .cuda_graphs import Stage as _Stage
from .cuda_graphs import capture
from .data.letterbox import make_letterbox_fn
from .export import unpack_detections
from .models import graph
from .models import quantize as Q
from .ops.nms import non_max_suppression
from .parallel import mesh as M


def pack(det, valid):
    """(det (B, max_det, 6), valid (B, max_det)) -> (B, max_det, 7), valid
    as channel 6 (JAX serving.py:209-213)."""
    return torch.cat([det, valid[..., None].to(det.dtype)], dim=-1)


class Predictor:
    def __init__(self, cfg, variables: dict, *, img_size: int = 512,
                 conf_thres: float = 0.1, iou_thres: float = 0.5,
                 multi_label: bool = True, max_det: int = 100,
                 batch_buckets: Sequence[int] = (1, 8, 32),
                 compute_dtype=torch.bfloat16, int8: bool = False,
                 int8_mode: str = "chain", calibration_batches: int = 2,
                 calibration_pct: float = 100.0, calibration=None,
                 quantized=None, merge: bool = False, device=None,
                 mesh=None):
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
        greedy NMS, as ``detect --merge-nms`` asks for.

        ``mesh``: a :class:`.parallel.mesh.Mesh`; every bucket is served
        data-parallel over its replicas (JAX serving.py:33-110), the
        buckets rounded up to multiples of the mesh size. ``device`` is
        then the mesh's first replica, where int8 calibration runs on the
        gathered batch."""
        self.ir: GraphIR = compile_cfg(cfg) if isinstance(cfg, str) else cfg
        self.mesh = None if mesh is None else M.check_mesh(mesh)
        self._replicas = ([resolve_device(device)] if mesh is None
                          else self.mesh.replicas)
        self.device = self._replicas[0]
        n = len(self._replicas)
        self.img_size = img_size
        # buckets split evenly over the replicas
        self.batch_buckets = sorted({-(-b // n) * n for b in batch_buckets})
        self._dtype = compute_dtype
        self._nms_kw = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                            multi_label=multi_label, max_det=max_det,
                            merge=merge)
        folded = graph.fold_batchnorm(self.ir, variables)
        self._folded_r = M.per_device(
            self._replicas,
            lambda d: graph.place_folded(self.ir, folded, d, compute_dtype))
        self.folded = self._folded_r[0]
        self._qvars_r = [None] * n
        self._pre_cache: dict = {}
        # staging and graphs are shared by every request: one at a time
        self._lock = threading.Lock()
        # replica r's (bucket, src_hw) -> _Stage of bucket / n frames and
        # (bucket, src_hw, quant) -> _Graph; replica 0's are _stages and
        # _graphs
        self._stages_r: list = [{} for _ in range(n)]
        self._graphs_r: list = [{} for _ in range(n)]
        self._pools: dict = {}           # one memory pool a device
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

    @property
    def _stages(self) -> dict:
        return self._stages_r[0]

    @property
    def _graphs(self) -> dict:
        return self._graphs_r[0]

    def _set_qvars(self, qv) -> None:
        """Place the int8 variables ``qv`` (host) on each replica once."""
        self._qvars_r = M.per_device(
            self._replicas,
            lambda d: Q.place_quantized(self.ir, qv, d, self._dtype))
        self.qvars = self._qvars_r[0]

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
        JAX package's checks (serving.py:163-187): the mode must match;
        with ``graph._S2D_REGION`` on, an artifact prepared for another
        size than the server's (img_size, img_size) is refused in edge
        mode (its plan is derived from that size) and, in the other modes,
        where its s2d plan differs from the server's."""
        qv, qmode, qhw = Q.load_quantized(path)
        if qmode != self._int8_mode:
            raise ValueError(
                f"quantized artifact {path} was built for mode={qmode!r}, "
                f"server requested {self._int8_mode!r}")
        size = (self.img_size, self.img_size)
        if qhw is not None and qhw != size and graph._S2D_REGION:
            if self._int8_mode == "edge":
                raise ValueError(
                    f"quantized artifact {path} prepared for hw={qhw}, "
                    f"server img_size={self.img_size}: edge-mode plans are "
                    f"derived from the prepare size, so edge artifacts "
                    f"require an exact match — re-export with python -m "
                    f"double_yolo_kaist_torch.calibrate")
            if graph.s2d_plan(self.ir, *qhw) != graph.s2d_plan(self.ir,
                                                                *size):
                raise ValueError(
                    f"quantized artifact {path} prepared for hw={qhw}, "
                    f"server img_size={self.img_size}, and the s2d plans "
                    f"differ — it quantizes another model than the "
                    f"server's; re-export with python -m "
                    f"double_yolo_kaist_torch.calibrate")
        self._set_qvars(qv)

    def _quantize_from_stats(self, stats: dict) -> None:
        """Quantize the folded weights with calibration ``stats`` (CPU) for
        the server's (img_size, img_size) and place them on the device;
        int8 serves from then on. Graphs captured on earlier int8 weights
        are dropped. With a ``quantized`` path that does not exist yet, the
        variables are saved there."""
        hw = (self.img_size, self.img_size)
        qv = Q.quantize(self.ir, self._folded_cpu, stats,
                        mode=self._int8_mode, hw=hw)
        if self._q_path and not os.path.exists(self._q_path):
            Q.save_quantized(self._q_path, qv, mode=self._int8_mode, hw=hw)
        self._set_qvars(qv)
        self._graphs_r = [{k: g for k, g in graphs.items() if not k[2]}
                          for graphs in self._graphs_r]

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

    def _forward(self, xv, xl, quant: bool, variables=None):
        if quant:
            return Q.apply_quantized(self.ir, variables or self.qvars, xv, xl,
                                     compute_dtype=self._dtype,
                                     mode=self._int8_mode)
        return graph.apply_folded(self.ir, variables or self.folded, xv, xl,
                                  compute_dtype=self._dtype)

    def _body(self, v_u8, l_u8, quant: bool, variables=None):
        """One padded bucket, uint8 (B, H, W, 3) -> packed (B, max_det, 7):
        what a graph captures (the JAX package's ``_full_program``) and what
        :func:`..export.export_serving_artifact` exports, there with the
        placed ``variables`` as the program's inputs."""
        fn, _, _ = self._preprocess(tuple(v_u8.shape[1:3]))
        xv, xl = fn(v_u8, l_u8)
        io, _ = self._forward(xv, xl, quant, variables)
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

    def _stage(self, bucket: int, src_hw: tuple, r: int = 0) -> _Stage:
        """Replica ``r``'s static inputs of (bucket, src_hw): its shard of
        bucket / n frames."""
        stages = self._stages_r[r]
        stage = stages.get((bucket, src_hw))
        if stage is None:
            stage = stages[(bucket, src_hw)] = _Stage(
                bucket // len(self._replicas), src_hw, self._replicas[r])
        return stage

    def _vars(self, quant: bool, r: int):
        return (self._qvars_r if quant else self._folded_r)[r]

    def _graph(self, bucket: int, src_hw: tuple, quant: bool,
               r: int = 0) -> _Graph:
        """Replica ``r``'s graph of (bucket, src_hw, quant), captured on
        first use on its stage's static inputs (:func:`capture`)."""
        key = (bucket, src_hw, quant)
        g = self._graphs_r[r].get(key)
        if g is not None:
            return g
        v, l = self._stage(bucket, src_hw, r).dev
        dev = self._replicas[r]
        if dev not in self._pools:
            with torch.cuda.device(dev):
                self._pools[dev] = torch.cuda.graph_pool_handle()
        variables = self._vars(quant, r)
        cuda_graph, out, held = capture(
            lambda: self._body(v, l, quant, variables), dev,
            self._pools[dev])
        g = self._graphs_r[r][key] = _Graph(cuda_graph, out, held)
        return g

    @torch.inference_mode()
    def _run_chunk(self, bucket: int, src_hw: tuple, chunk_v, chunk_l):
        """One chunk of a request -> its packed rows (real, max_det, 7),
        numpy. Called with the lock held."""
        real = len(chunk_v)
        n = len(self._replicas)
        m = bucket // n
        stages = [self._stage(bucket, src_hw, r) for r in range(n)]
        for r, stage in enumerate(stages):
            stage.load(chunk_v[r * m:(r + 1) * m], chunk_l[r * m:(r + 1) * m])
        if self._int8 and self.qvars is None:
            # calibration requests run eagerly (they keep their inputs),
            # on the batch gathered on the first replica
            v, l = (torch.cat([st.dev[i].to(self.device) for st in stages])
                    for i in (0, 1))
            return pack(*self.run_batch(v, l))[:real].cpu().numpy()
        quant = self._int8
        if self.device.type != "cuda":
            outs = [self._body(*st.dev, quant, self._vars(quant, r))
                    for r, st in enumerate(stages)]
            return torch.cat(outs)[:real].numpy()
        graphs = [self._graph(bucket, src_hw, quant, r) for r in range(n)]
        for g in graphs:
            g.launch()
        out = np.concatenate([g.fetch(m) for g in graphs])
        return out[:real]

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
            for r in range(len(self._replicas)):
                stage = self._stage(b, src_hw, r)
                if self.device.type == "cuda":
                    self._graph(b, src_hw, False, r).run(0)
                else:
                    self._body(*stage.dev, quant=False,
                               variables=self._folded_r[r])

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
