"""Exported serving artifacts: the whole request program as one file.

Counterpart of the JAX package's ``export.py``, closing the artifact chain
(``calibrate`` statistics -> quantized variables -> here the program
itself). :func:`export_serving_artifact` traces ``Predictor._body``
(uint8 letterbox -> BN-folded forward, bf16 or int8 -> NMS -> packed
``(B, max_det, 7)``) with ``torch.export``, the placed parameter tree as
the program's inputs, and writes one zip:

    program.pt2     the ``torch.export`` program (``torch.export.save``),
                    for the device it was exported on
    variables.npz   the placed parameter tree, flattened to 'a/b/c' keys
                    in the JAX package's encoding (bf16 as uint16 bit
                    patterns listed under ``__bf16__``, int8 native)
    meta.json       shapes, letterbox undo constants, thresholds, digests,
                    the tensors' strides, ``"runtime": "torch"``

Kernels K1-K4 are registered operators (:mod:`.ops.library`), so each is
one node of the program and runs the port's own hand kernel when the
program runs; the other nodes are the same eager ATen operators
``Predictor`` runs. Nothing is recompiled (no AOTInductor, no
``torch.compile``). Int8 scales are Python floats in the traced code and
become constants of the program, as an artifact is deterministic.

:class:`ExportedPredictor` serves a file with ``Predictor.__call__``'s
contract. The host that loads one imports this module, ``cuda_graphs``,
``ops/``, ``utils/npz`` and torch / numpy: no cfg, graph IR, weight importer or
quantization code.
"""

from __future__ import annotations

import hashlib
import io
import json
import threading
import zipfile
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .utils import npz as NPZ
from .utils import profiling

FORMAT_VERSION = 1
_META = "meta.json"
_PROGRAM = "program.pt2"
_VARIABLES = "variables.npz"
_JAX_PROGRAM = "program.bin"       # a JAX artifact's StableHLO


# ---------------------------------------------------------- letterbox undo

def unpack_detections(det, valid, real, ratio: float, pad, src_hw):
    """Packed (B, max_det, 6) detections + valid mask (numpy) -> per-image
    (boxes xyxy in the ORIGINAL frame, scores, classes) for the first
    ``real`` images: subtract the pad, divide by the ratio, clip to the
    frame (reference utils.scale_coords semantics). Shared by
    ``serving.Predictor`` and :class:`ExportedPredictor`, as in the JAX
    package."""
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


def serve_chunk(lock, run, chunk_v, chunk_l, slots: int, ratio: float, pad,
                src_hw) -> list:
    """One chunk of a request, as ``serving.Predictor`` and
    :class:`ExportedPredictor` serve it: ``run(chunk_v, chunk_l)`` (the
    chunk's packed output) under ``lock``, then the letterbox undone for
    its frames. Under a profiler window it records the request's root span
    ``serve/request``, ``serve/lock_wait`` and ``serve/unpack``, and the
    counters ``serve.requests``, ``serve.frames`` (real frames) and
    ``serve.slots`` (``slots``, the bucket's, padding included)."""
    with profiling.span("serve/request", request=True):
        chunk_v = np.ascontiguousarray(chunk_v, np.uint8)
        chunk_l = np.ascontiguousarray(chunk_l, np.uint8)
        with profiling.span("serve/lock_wait", timeline=True):
            lock.acquire()
        try:
            packed = run(chunk_v, chunk_l)
        finally:
            lock.release()
        with profiling.span("serve/unpack", timeline=True):
            dets = unpack_detections(packed[..., :6], packed[..., 6] > 0.5,
                                     len(chunk_v), ratio, pad, src_hw)
    profiling.count("serve.requests")
    profiling.count("serve.frames", len(chunk_v))
    profiling.count("serve.slots", slots)
    return dets


# ----------------------------------------------------------- tree <-> flat

class _Leaf:
    """A tensor's place in a tree template: its key in the flat dict."""

    def __init__(self, key: str):
        self.key = key


def _flatten(tree):
    """The tensors of ``tree`` (nested dicts, tuples and named tuples of
    tensors and scalars) as a flat {'a/b/c': tensor} in sorted key order,
    and a template that :func:`_rebuild` fills from such a dict: scalars
    stay in it as constants, and a tensor met again (the stem convs'
    packed weights hold their ``w`` and ``b`` twice) refers to its first
    key."""
    flat, seen = {}, {}

    def walk(t, path):
        if isinstance(t, torch.Tensor):
            key = seen.get(id(t))
            if key is None:
                key = seen[id(t)] = "/".join(path)
                flat[key] = t
            return _Leaf(key)
        if isinstance(t, dict):
            for k in t:
                if "/" in str(k):
                    raise TypeError(f"variable tree key {k!r} at "
                                    f"{'/'.join(path) or '<root>'!r} holds "
                                    f"'/', the flatten separator")
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, tuple):
            names = getattr(t, "_fields", None) or range(len(t))
            parts = [walk(v, path + (str(n),)) for v, n in zip(t, names)]
            return type(t)(*parts) if hasattr(t, "_fields") else tuple(parts)
        if t is None or isinstance(t, (bool, int, float, str)):
            return t
        raise TypeError(f"variable tree holds a {type(t).__name__} at "
                        f"{'/'.join(path)!r}")

    template = walk(tree, ())
    return {k: flat[k] for k in sorted(flat)}, template


def _rebuild(template, flat: dict):
    if isinstance(template, _Leaf):
        return flat[template.key]
    if isinstance(template, dict):
        return {k: _rebuild(v, flat) for k, v in template.items()}
    if isinstance(template, tuple):
        parts = [_rebuild(v, flat) for v in template]
        return (type(template)(*parts) if hasattr(template, "_fields")
                else tuple(parts))
    return template


def _flat_to_npz_bytes(flat: dict) -> bytes:
    arrays = NPZ.encode(flat)
    arrays["__empty__"] = np.asarray([], dtype="<U1")
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _flat_from_npz_bytes(data: bytes, strides: dict, device) -> dict:
    """The flat tensors on ``device`` with the strides they were exported
    with (channels-last convs stay channels-last)."""
    out = {}
    with np.load(io.BytesIO(data)) as z:
        bf16 = NPZ.bf16_keys(z)
        for key in sorted(k for k in z.files
                          if k not in (NPZ.BF16, "__empty__")):
            t = NPZ.decode(z[key], key in bf16)
            dst = torch.empty_strided(tuple(t.shape), tuple(strides[key]),
                                      dtype=t.dtype, device=device)
            out[key] = dst.copy_(t)
    return out


# ------------------------------------------------------------------ export

class _Program(torch.nn.Module):
    """``Predictor._body`` with the flat parameter tree as an input."""

    def __init__(self, predictor, template, quant: bool):
        super().__init__()
        self.predictor = predictor
        self.template = template
        self.quant = quant

    def forward(self, flat: dict, v_u8, l_u8):
        return self.predictor._body(v_u8, l_u8, self.quant,
                                    _rebuild(self.template, flat))


def export_serving_artifact(predictor, src_hw, batch: int,
                            out_path: str) -> dict:
    """Export ``predictor``'s request program for frames of ``src_hw`` at
    batch ``batch`` to ``out_path``, for the predictor's device. An int8
    predictor must be quantized already (``quantized=`` / ``calibration=``
    artifacts, or its calibration requests served): an artifact is
    deterministic, not traffic-dependent. Returns the meta dict."""
    if predictor.mesh is not None:
        raise ValueError(
            "export is single-replica: build the Predictor without a mesh "
            "(scale out by running one exported replica per card)")
    quant = bool(predictor._int8)
    if quant and predictor.qvars is None:
        raise ValueError(
            "int8 Predictor is not quantized yet — pass quantized=/"
            "calibration= artifacts (python -m double_yolo_kaist_torch."
            "calibrate) so the exported program is deterministic")
    src_hw = (int(src_hw[0]), int(src_hw[1]))
    _, ratio, pad = predictor._preprocess(src_hw)
    flat, template = _flatten(predictor.qvars if quant
                              else predictor.folded)
    dev = predictor.device
    shape = (int(batch),) + src_hw + (3,)
    frames = (torch.zeros(shape, dtype=torch.uint8, device=dev),
              torch.zeros(shape, dtype=torch.uint8, device=dev))
    with torch.no_grad():
        ep = torch.export.export(_Program(predictor, template, quant),
                                 (flat, *frames))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    program_bytes = buf.getvalue()
    var_bytes = _flat_to_npz_bytes(flat)
    meta = {
        "format_version": FORMAT_VERSION,
        "sha256": {
            "program": hashlib.sha256(program_bytes).hexdigest(),
            "variables": hashlib.sha256(var_bytes).hexdigest(),
        },
        "platforms": [dev.type],
        "src_hw": list(src_hw),
        "batch": int(batch),
        "img_size": int(predictor.img_size),
        "ratio": float(ratio[0]),
        "pad": [float(pad[0]), float(pad[1])],
        "conf_thres": float(predictor._nms_kw["conf_thres"]),
        "int8": quant,
        "int8_mode": predictor._int8_mode if quant else None,
        "torch_version": torch.__version__,
        "runtime": "torch",
        "strides": {k: list(t.stride()) for k, t in flat.items()},
    }
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_META, json.dumps(meta, indent=1))
        zf.writestr(_PROGRAM, program_bytes)
        zf.writestr(_VARIABLES, var_bytes, compress_type=zipfile.ZIP_STORED)
    return meta


# -------------------------------------------------------------------- load

class ExportedPredictor:
    """Serve an exported artifact with ``serving.Predictor``'s ``__call__``
    contract: uint8 RGB (N, H, W, 3) pairs at their native size ->
    per-image (boxes xyxy in the original frame, scores, classes). Frames
    must have the exported ``src_hw``; partial batches are zero-padded to
    the exported batch.

    ``device``: None means ``cuda``; it must be the device the program was
    exported for. On CUDA the loaded program is captured once as a CUDA
    graph on static inputs with pinned staging (:meth:`warmup`, or the
    first request) and every request replays it, as ``Predictor`` serves;
    on the CPU it runs eagerly. Under a profiler window it records
    ``Predictor``'s spans and counters (:mod:`.serving`)."""

    def __init__(self, path: str, device=None):
        from .ops import library  # noqa: F401  (the program's K1-K4 nodes)

        self.device = resolve_device(device)
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            self.meta = json.loads(zf.read(_META).decode())
            if _JAX_PROGRAM in names or self.meta.get("runtime") != "torch":
                raise ValueError(
                    f"{path} is a JAX package artifact (a StableHLO "
                    f"{_JAX_PROGRAM}, jax_version "
                    f"{self.meta.get('jax_version')}); this loader runs "
                    f"torch.export programs: export one with python -m "
                    f"double_yolo_kaist_torch.export_model")
            if self.meta.get("format_version", 0) > FORMAT_VERSION:
                raise ValueError(
                    f"{path}: format_version {self.meta['format_version']} "
                    f"is newer than this loader ({FORMAT_VERSION})")
            program_bytes = zf.read(_PROGRAM)
            var_bytes = zf.read(_VARIABLES)
        # an integrity check against corruption and botched repackaging,
        # not an authenticity check: meta.json itself is unauthenticated
        digests = self.meta.get("sha256")
        if digests is None:
            raise ValueError(
                f"{path}: meta.json has no sha256 digests — artifact was "
                f"repackaged incorrectly; re-export it")
        for name, blob in (("program", program_bytes),
                           ("variables", var_bytes)):
            want, got = digests.get(name), hashlib.sha256(blob).hexdigest()
            if want != got:
                raise ValueError(
                    f"{path}: {name} sha256 mismatch (artifact corrupt or "
                    f"repackaged without updating meta.json): recorded "
                    f"{str(want)[:12]}…, got {got[:12]}…")
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(
                f"{path} was exported for {self.meta['platforms']}; this "
                f"host serves on {self.device.type!r} — re-export it with "
                f"--device {self.device.type}")
        self.src_hw = tuple(self.meta["src_hw"])
        self.batch = int(self.meta["batch"])
        self._ratio = float(self.meta["ratio"])
        self._pad = tuple(self.meta["pad"])
        self.variables = _flat_from_npz_bytes(var_bytes, self.meta["strides"],
                                              self.device)
        self._module = torch.export.load(io.BytesIO(program_bytes)).module()
        self._stage = None
        self._graph = None
        self._pool = None
        # the staging and the graph are shared: one request at a time
        self._lock = threading.Lock()

    @torch.inference_mode()
    def run_batch(self, v_u8, l_u8):
        """One exported batch of uint8 device tensors -> packed (B,
        max_det, 7), eagerly."""
        return self._module(self.variables, v_u8, l_u8)

    def _ready(self):
        from .cuda_graphs import Graph, Stage, capture

        if self._stage is None:
            self._stage = Stage(self.batch, self.src_hw, self.device)
        if self.device.type == "cuda" and self._graph is None:
            v, l = self._stage.dev
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            with profiling.span("serve/capture"):
                g, out, held = capture(lambda: self.run_batch(v, l),
                                       self.device, self._pool)
            profiling.count("serve.captures")
            self._graph = Graph(g, out, held)
        return self._stage

    @torch.inference_mode()
    def warmup(self) -> None:
        """Make the program ready: on CUDA capture its graph and replay it
        once, on the CPU run it once on zeros."""
        with self._lock:
            stage = self._ready()
            if self._graph is not None:
                self._graph.run(0)
            else:
                self.run_batch(*stage.dev)

    def _run_chunk(self, chunk_v: np.ndarray, chunk_l: np.ndarray):
        stage = self._ready()
        stage.load(chunk_v, chunk_l)
        if self._graph is not None:
            return self._graph.run(len(chunk_v))
        profiling.count("serve.eager_batches")
        return self.run_batch(*stage.dev)[:len(chunk_v)].numpy()

    @torch.inference_mode()
    def __call__(self, v_imgs: np.ndarray,
                 l_imgs: Optional[np.ndarray] = None):
        v_imgs = np.asarray(v_imgs)
        l_imgs = v_imgs if l_imgs is None else np.asarray(l_imgs)
        if v_imgs.shape != l_imgs.shape:
            raise ValueError(f"visible/lwir shape mismatch: {v_imgs.shape} "
                             f"vs {l_imgs.shape}")
        if tuple(v_imgs.shape[1:3]) != self.src_hw:
            raise ValueError(
                f"artifact compiled for frames {self.src_hw}, got "
                f"{tuple(v_imgs.shape[1:3])} — export one artifact per "
                f"native frame size")
        out = []
        for b0 in range(0, len(v_imgs), self.batch):
            out.extend(serve_chunk(
                self._lock, self._run_chunk, v_imgs[b0:b0 + self.batch],
                l_imgs[b0:b0 + self.batch], self.batch, self._ratio,
                self._pad, self.src_hw))
        return out
