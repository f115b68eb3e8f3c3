"""ctypes loader for the host-side evaluation matchers (``native/fastmatch.cpp``).

Counterpart of the JAX package's ``utils/native.py``: ``greedy_match`` (the
VOC-AP / LAMR TP/FP assignment) and ``coco_match`` (COCOeval matching at
every IoU threshold). The repo's ``native/fastmatch.cpp`` is compiled at
first use with ``g++ -O3 -shared -fPIC`` into ``ops/_kernels/`` (listed in
``.gitignore``), under a name keyed by a hash of the source and the flags.
On a host without ``g++`` both functions return None and the callers take
their numpy paths, as in the JAX package. This is host code: the matchers
run after the detections are fetched from the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_HERE, "..", "..", "native", "fastmatch.cpp")
_BUILD_DIR = os.path.join(_HERE, "..", "ops", "_kernels")
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> str:
    with open(_SRC_PATH, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libfastmatch_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC_PATH], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, path)         # atomic: a concurrent reader never sees a part
    return True


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC_PATH):
            return None
        path = _so_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.greedy_match.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
        lib.greedy_match.restype = None
        lib.coco_match.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.coco_match.restype = None
        _lib = lib
        return _lib


def matcher() -> str:
    """Which matcher the metrics run: ``"native"`` (the g++ build of
    ``native/fastmatch.cpp``) or ``"numpy"``."""
    return "native" if get_lib() is not None else "numpy"


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def greedy_match(pred_boxes: np.ndarray, pred_img: np.ndarray,
                 gt_boxes: np.ndarray, gt_offsets: np.ndarray,
                 iou_thr: float):
    """Native greedy TP/FP matching; returns (tp, fp) uint8 arrays or None
    if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    nd = len(pred_boxes)
    pred_boxes = np.ascontiguousarray(pred_boxes, np.float32)
    pred_img = np.ascontiguousarray(pred_img, np.int32)
    gt_boxes = np.ascontiguousarray(gt_boxes, np.float32)
    gt_offsets = np.ascontiguousarray(gt_offsets, np.int64)
    if pred_img.shape != (nd,) or gt_boxes.reshape(-1, 4).shape[0] != \
            gt_offsets[-1]:
        raise ValueError("greedy_match: inconsistent prediction / ground "
                         "truth arrays")
    tp = np.zeros(nd, np.uint8)
    fp = np.zeros(nd, np.uint8)
    lib.greedy_match(_ptr(pred_boxes, ctypes.c_float),
                     _ptr(pred_img, ctypes.c_int32), nd,
                     _ptr(gt_boxes, ctypes.c_float),
                     _ptr(gt_offsets, ctypes.c_int64),
                     len(gt_offsets) - 1, iou_thr,
                     _ptr(tp, ctypes.c_uint8), _ptr(fp, ctypes.c_uint8))
    return tp, fp


def coco_match(dets: np.ndarray, gts: np.ndarray, gt_ignore: np.ndarray,
               iou_thrs: np.ndarray):
    """Native per-image COCO matching; returns dt_match (T, D) int64 or None."""
    lib = get_lib()
    if lib is None:
        return None
    D, G, T = len(dets), len(gts), len(iou_thrs)
    dets = np.ascontiguousarray(dets, np.float64)
    gts = np.ascontiguousarray(gts, np.float64)
    gt_ignore = np.ascontiguousarray(gt_ignore, np.uint8)
    iou_thrs = np.ascontiguousarray(iou_thrs, np.float64)
    if dets.shape != (D, 4) or gts.shape != (G, 4) or gt_ignore.shape != (G,):
        raise ValueError("coco_match: boxes must be (n, 4), ignores (G,)")
    out = np.full((T, D), -1, np.int64)
    lib.coco_match(_ptr(dets, ctypes.c_double), D,
                   _ptr(gts, ctypes.c_double),
                   _ptr(gt_ignore, ctypes.c_uint8), G,
                   _ptr(iou_thrs, ctypes.c_double), T,
                   _ptr(out, ctypes.c_int64))
    return out
