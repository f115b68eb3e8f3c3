"""K1: YOLO head decode — the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``double_yolo_kaist_tpu/ops/pallas_decode.py``
(``_decode_kernel``) and computes ``double_yolo_kaist_tpu/models/graph.py::
decode_head``. The kernel (``csrc/decode.cu``) is bound by bytes on the H100
(bf16 in, fp32 out, a few flops each), and so small that launches were most
of its time: :func:`decode_heads` decodes every head of a forward in one
launch, each into its slice of the concatenated output. The kernel reads the
head convs' outputs as they lie (through their strides, which folds
:func:`reshape_head`'s transpose into the load); the layout the model
produces, channels-last bf16 with six values a row, takes a path of 16-byte
loads and stores.

:func:`decode_heads` (and :func:`decode_head`, the same call with one head)
launches the kernel for CUDA tensors and takes :func:`decode_head_plain`
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

_MAX_ANCHORS = 16        # DYK_MAX_ANCHORS in csrc/decode.cu
_MAX_HEADS = 4           # DYK_MAX_HEADS: heads of one launch
_FAST_MAX_ANCHORS = 4    # DYK_FAST_MAX_ANCHORS
_FAST_NO = 6             # DYK_FAST_NO

# Besides the launches (_build.launches["decode_head"]), the wrapper counts
# the heads they decoded, a launch up to _MAX_HEADS, under this name.
HEADS_DECODED = "decode_heads_decoded"


class _Head(ctypes.Structure):
    """``struct Head`` of csrc/decode.cu."""
    _fields_ = [("x", ctypes.c_void_p),
                ("s0", ctypes.c_longlong), ("s1", ctypes.c_longlong),
                ("s2", ctypes.c_longlong), ("s3", ctypes.c_longlong),
                ("row_offset", ctypes.c_longlong),
                ("na", ctypes.c_int), ("ny", ctypes.c_int),
                ("nx", ctypes.c_int), ("is_bf16", ctypes.c_int),
                ("v4", ctypes.c_int), ("fast", ctypes.c_int),
                ("first_block", ctypes.c_int), ("stride", ctypes.c_float),
                ("wh", ctypes.c_float * (2 * _MAX_ANCHORS))]


class _Heads(ctypes.Structure):
    """``struct Heads`` of csrc/decode.cu."""
    _fields_ = [("h", _Head * _MAX_HEADS),
                ("n", ctypes.c_int), ("bs", ctypes.c_int),
                ("no", ctypes.c_int), ("nblocks", ctypes.c_int),
                ("out", ctypes.c_void_p),
                ("out_batch_stride", ctypes.c_longlong)]


def reshape_head(p, na: int, no: int):
    """(bs, na*no, ny, nx) conv output -> (bs, na, ny, nx) x no view."""
    bs, _, ny, nx = p.shape
    return p.reshape(bs, na, no, ny, nx).permute(0, 1, 3, 4, 2)


def _anchors_grid(anchors, stride: int) -> np.ndarray:
    """Anchors in grid units, fp32, as the JAX package rounds them."""
    return (np.asarray(anchors, np.float32) / stride).astype(np.float32)


def decode_head_plain(p, anchors, stride: int, bf_type: str):
    """Plain PyTorch decode of one raw head (bs, na, ny, nx, no) to
    image-space rows (bs, na*ny*nx, no) fp32: xy/wh in input pixels,
    obj/cls as probabilities (JAX graph.py:72-95)."""
    bs, na, ny, nx, no = p.shape
    p = p.float()
    gy, gx = torch.meshgrid(
        torch.arange(ny, dtype=torch.float32, device=p.device),
        torch.arange(nx, dtype=torch.float32, device=p.device), indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).reshape(1, 1, ny, nx, 2)
    anchor_wh = torch.from_numpy(_anchors_grid(anchors, stride)).to(
        p.device).reshape(1, na, 1, 1, 2)
    if bf_type == "yolov3":
        xy = torch.sigmoid(p[..., :2]) + grid
        wh = torch.exp(p[..., 2:4]) * anchor_wh
        rest = torch.sigmoid(p[..., 4:])
    elif bf_type == "yolov4":
        s = torch.sigmoid(p)
        xy = s[..., :2] * 2.0 - 0.5 + grid
        wh = torch.square(s[..., 2:4] * 2.0) * anchor_wh
        rest = s[..., 4:]
    else:
        raise ValueError(f"unknown bf_type {bf_type}")
    io = torch.cat([xy * stride, wh * stride, rest], dim=-1)
    return io.reshape(bs, na * ny * nx, no)


def fast_path(shape, strides, dtype, na: int) -> bool:
    """True if a head conv output of this ``shape`` (bs, na*no, ny, nx),
    element ``strides`` and ``dtype`` has the layout the kernel's fast path
    reads: bf16, six values a row, at most four anchors, dense channels-last
    memory, and a grid of a multiple of 4 cells (a block takes 32 cells, the
    last of an image fewer; 4 cells keep its loads and stores 16-byte
    aligned). (The launch also wants 16-byte aligned bases;
    :func:`decode_heads` checks those per call.)"""
    _, c, ny, nx = shape
    return (dtype == torch.bfloat16 and c == na * _FAST_NO
            and na <= _FAST_MAX_ANCHORS and ny * nx > 0
            and (ny * nx) % 4 == 0
            and tuple(strides) == (ny * nx * c, 1, nx * c, c))


def _check(specs, types):
    """(bs, no, rows per head) of heads that may share a call. ``specs``:
    a head's (shape, strides, dtype, device, anchors as fp32 bytes, stride)."""
    if len(types) != len(specs):
        raise ValueError(f"{len(types)} bf_types for {len(specs)} heads")
    device = specs[0][3]
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_heads runs on cpu or cuda, not {device}")
    bs = no = None
    rows = []
    for (shape, strides, dtype, dev, wh, _), bf_type in zip(specs, types):
        if len(shape) != 4:
            raise ValueError(f"head conv output must be 4-D, got {shape}")
        c, na = shape[1], len(wh) // 8
        if na == 0 or c % na or c // na < 5:
            raise ValueError(f"{c} channels do not split into {na} anchors "
                             f"of >= 5 outputs")
        if bf_type not in ("yolov3", "yolov4"):
            raise ValueError(f"unknown bf_type {bf_type}")
        if bs is None:
            bs, no = shape[0], c // na
        if shape[0] != bs or c // na != no or dev != device:
            raise ValueError(f"heads of one call share batch, outputs per "
                             f"row and device; got {shape} on {dev} beside "
                             f"bs={bs}, no={no} on {device}")
        if device.type == "cuda":
            if dtype not in (torch.bfloat16, torch.float32):
                raise TypeError(f"decode kernel takes bf16 or fp32, got "
                                f"{dtype}")
            if na > _MAX_ANCHORS or bs * na * shape[2] * shape[3] >= 2 ** 31 \
                    or min(strides) < 0:
                raise ValueError(f"decode kernel: unsupported shape {shape} "
                                 f"strides {strides} with {na} anchors")
        rows.append(na * shape[2] * shape[3])
    return bs, no, rows


@functools.lru_cache(maxsize=64)
def _plan(specs, types, out_batch_stride, row_offset):
    """What the kernel's calls for these heads need, worked out from the
    heads' layout and geometry alone (``specs`` as :func:`_check` takes
    them, so equal anchors give the same plan whoever holds them), once a
    model and batch size: (bs, no, rows in all, [(arguments with
    everything but the pointers filled in: the anchors in grid units, the
    choice of path; fast flag per head; the heads' indices)]), at most
    _MAX_HEADS heads a launch. ``out_batch_stride=None``: an output of
    exactly the heads' rows."""
    bs, no, rows = _check(specs, types)
    if out_batch_stride is None:
        out_batch_stride = sum(rows) * no
    launches, offset = [], row_offset
    for i in range(0, len(specs), _MAX_HEADS):
        part = specs[i:i + _MAX_HEADS]
        args = _Heads(n=len(part), bs=bs, no=no,
                      out_batch_stride=out_batch_stride)
        for h, (shape, strides, dtype, _, wh, stride), bf_type, n in zip(
                args.h, part, types[i:], rows[i:]):
            anchors = np.frombuffer(wh, np.float32).reshape(-1, 2)
            na = len(anchors)
            h.s0, h.s1, h.s2, h.s3 = strides
            h.row_offset, h.na, h.ny, h.nx = offset, na, *shape[2:]
            h.is_bf16 = int(dtype == torch.bfloat16)
            h.v4 = int(bf_type == "yolov4")
            h.fast = int(out_batch_stride % 4 == 0 and offset % 2 == 0
                         and fast_path(shape, strides, dtype, na))
            h.stride = float(stride)
            h.wh[:2 * na] = _anchors_grid(anchors, stride).reshape(-1).tolist()
            offset += n
        launches.append((args, [bool(h.fast) for h in args.h[:len(part)]],
                         range(i, i + len(part))))
    return bs, no, sum(rows), launches


def _specs(heads):
    return tuple([(tuple(x.shape), x.stride(), x.dtype, x.device,
                   np.asarray(a, np.float32).tobytes(), s)
                  for x, a, s in heads])


def decode_heads(heads, bf_type, out=None, row_offset: int = 0):
    """Decode the heads of one forward.

    ``heads``: [(x, anchors, stride)], ``x`` a head conv's output
    (bs, na*no, ny, nx); ``bf_type``: ``"yolov3"`` or ``"yolov4"`` for all
    heads, or one per head. Head i's ``na*ny*nx`` rows follow head i-1's,
    from ``row_offset`` on, in ``out`` (bs, total rows, no) fp32, which is
    returned; with ``out=None`` a new tensor holds exactly the heads' rows.
    CPU tensors go to :func:`decode_head_plain`; CUDA tensors to the kernel
    (one launch for up to four heads), or this raises."""
    heads = list(heads)
    if not heads:
        raise ValueError("decode_heads needs at least one head")
    types = (bf_type,) * len(heads) if isinstance(bf_type, str) \
        else tuple(bf_type)
    specs = _specs(heads)
    device = heads[0][0].device
    if device.type == "cuda":
        if out is None:
            row_offset = 0
        bs, no, total, launches = _plan(
            specs, types, None if out is None else out.stride(0), row_offset)
    else:
        bs, no, rows = _check(specs, types)
        total = sum(rows)
    if out is None:
        out = torch.empty((bs, total, no), dtype=torch.float32, device=device)
        row_offset = 0
    if (out.dtype != torch.float32 or out.dim() != 3 or out.shape[0] != bs
            or out.shape[2] != no or out.shape[1] < row_offset + total
            or row_offset < 0):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} cannot take "
                         f"rows [{row_offset}, {row_offset + total}) of "
                         f"(bs={bs}, no={no}) fp32")
    if out.device != device:
        raise ValueError(f"out on {out.device}, input on {device}")

    if device.type == "cpu":
        offset = row_offset
        for (x, anchors, stride), t, n in zip(heads, types, rows):
            out[:, offset:offset + n] = decode_head_plain(
                reshape_head(x, len(anchors), no), anchors, stride, t)
            offset += n
        return out
    if not out.is_contiguous():
        raise ValueError("decode kernel writes a contiguous output")

    lib = _build.library("decode.cu")
    fn = lib.dyk_decode_heads
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Heads), ctypes.c_void_p]
    out_ptr = out.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for template, fast, part in launches:
            # the call's own arguments: threads may share a plan
            args = _Heads.from_buffer_copy(template)
            args.out = out_ptr
            for h, was_fast, i in zip(args.h, fast, part):
                h.x = ptr = heads[i][0].data_ptr()
                h.fast = int(was_fast and (ptr | out_ptr) % 16 == 0)
            status = fn(ctypes.byref(args), stream)
            _build.check(lib, status, "decode_heads")
            _build.launches["decode_head"] += 1
            _build.launches[HEADS_DECODED] += len(part)
    return out


def decode_head(x, anchors, stride: int, bf_type: str, out=None,
                row_offset: int = 0):
    """Decode one head from its conv output ``x`` (bs, na*no, ny, nx):
    :func:`decode_heads` with one entry. Writes rows ``[row_offset,
    row_offset + na*ny*nx)`` of ``out`` (bs, total rows, no) fp32 and
    returns ``out``; with ``out=None`` it returns a new (bs, na*ny*nx, no)
    tensor."""
    return decode_heads([(x, anchors, stride)], bf_type, out=out,
                        row_offset=row_offset)
