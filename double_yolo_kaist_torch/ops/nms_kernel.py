"""K2: greedy NMS over a fixed pool — the CUDA kernel's wrapper and its
plain version.

Replaces the TPU kernel ``double_yolo_kaist_tpu/ops/pallas_nms.py``
(``_nms_kernel``) and computes ``double_yolo_kaist_tpu/ops/nms.py::
nms_indices`` for each image of a batch. The kernel (``csrc/nms.cu``) is
bound by launch and latency on the H100, not by bytes or flops: a cluster
of 8 blocks per image ranks the pool once by counting, computes the upper
triangle of the IoU bitmask in rank order into one block's shared memory,
and one warp there runs the dependent rounds as a scan for the first rank
still alive.

:func:`nms_indices` launches the kernel for CUDA tensors and takes
:func:`nms_indices_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .boxes import box_iou

NEG_INF = -1e10
MAX_K = 1024             # DYK_NMS_MAX_K in csrc/nms.cu
# dyk_nms's C signature (csrc/nms.cu)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]


def nms_indices_plain(boxes, scores, iou_thres: float, max_det: int):
    """The ``nms_indices`` loop (JAX nms.py:37-62) with a batch dim.
    boxes (B, K, 4) xyxy, scores (B, K). Returns idx (B, max_det) int32 and
    valid (B, max_det) bool; invalid slots have idx 0."""
    bs = boxes.shape[0]
    iou = box_iou(boxes, boxes)                       # (B, K, K)
    s = scores.float().clone()
    rows = torch.arange(bs, device=boxes.device)
    idx = torch.zeros((bs, max_det), dtype=torch.int32, device=boxes.device)
    valid = torch.zeros((bs, max_det), dtype=torch.bool, device=boxes.device)
    for n in range(max_det):
        i = torch.argmax(s, dim=1)                    # first index of the max
        ok = s[rows, i] > NEG_INF / 2
        idx[:, n] = torch.where(ok, i, 0).to(torch.int32)
        valid[:, n] = ok
        # suppress the winner and everything overlapping it
        s = torch.where(iou[rows, i] > iou_thres, NEG_INF, s)
        s[rows, i] = NEG_INF
    return idx, valid


def nms_indices(boxes, scores, iou_thres: float, max_det: int):
    """Greedy NMS per image. boxes (B, K, 4) fp32 xyxy, scores (B, K) fp32
    in any order, K <= 1024. Returns idx (B, max_det) int32 and valid
    (B, max_det) bool. A CPU tensor goes to :func:`nms_indices_plain`; a
    CUDA tensor to the kernel, or this raises."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.dim() != 2 \
            or scores.shape != boxes.shape[:2]:
        raise ValueError(f"boxes {tuple(boxes.shape)} / scores "
                         f"{tuple(scores.shape)}: want (B, K, 4) / (B, K)")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    if boxes.device.type == "cpu":
        return nms_indices_plain(boxes, scores, iou_thres, max_det)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_indices runs on cpu or cuda, not {boxes.device}")
    bs, k = scores.shape
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"NMS kernel takes fp32, got {boxes.dtype}/"
                        f"{scores.dtype}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("NMS kernel takes contiguous boxes and scores")
    if not (1 <= k <= MAX_K and bs >= 1 and max_det >= 1):
        raise ValueError(f"NMS kernel: need 1 <= K <= {MAX_K}, bs >= 1 and "
                         f"max_det >= 1; got K={k}, bs={bs}, "
                         f"max_det={max_det}")

    idx = torch.empty((bs, max_det), dtype=torch.int32, device=boxes.device)
    valid = torch.empty((bs, max_det), dtype=torch.bool, device=boxes.device)
    lib = _build.library("nms.cu")
    fn = lib.dyk_nms
    if fn.argtypes is None:
        fn.restype, fn.argtypes = ctypes.c_int, _ARGTYPES
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        status = fn(boxes.data_ptr(), scores.data_ptr(), bs, k,
                    float(iou_thres), max_det, idx.data_ptr(),
                    valid.data_ptr(), stream)
    _build.check(lib, status, "nms_indices")
    _build.launches["nms_indices"] += 1
    return idx, valid
