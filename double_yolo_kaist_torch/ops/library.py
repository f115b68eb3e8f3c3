"""Kernels K1-K5 as PyTorch operators, in the namespace ``dyk``.

The kernels are bound with ``ctypes`` (:mod:`._build`), which
``torch.export`` cannot trace: a pointer from ``data_ptr()`` does not
exist on the fake tensors it traces with. Registered with
``torch.library.custom_op``, each kernel is one opaque node of an exported
program, and the program calls the same wrapper code when it runs:

  * ``dyk::decode_heads_into`` (K1, writing into a given output from a
    row offset),
  * ``dyk::nms_indices`` (K2),
  * ``dyk::stem_conv_s2`` (K3, its packed weights as their four tensors),
  * ``dyk::qgemm`` (K4),
  * ``dyk::bias_act`` (K5).

For each, the CUDA implementation launches the hand kernel (the module's
``launch``, which counts its launches in ``_build.launches``, so a run of
an exported program or a replay of a graph captured over it still
counts), the CPU implementation is the plain version, and the fake
implementation gives the output's shape, dtype and strides. Any other
device raises. K1's launch plan is made inside the operator from the
runtime tensors' layout, never when a program is traced.

The wrappers :func:`.decode.decode_heads`, :func:`.nms_kernel.nms_indices`,
:func:`.stem.stem_conv_s2` and :func:`.qgemm.qgemm` check their arguments
and call these operators on every path; :func:`.bias_act.bias_act`, run
once a conv, calls its operator where a program is traced or the tensor
is on the CPU, and launches K5 directly in an eager CUDA call. Importing
this module registers them; a host that loads an exported program
imports it first.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from . import bias_act as K5
from . import decode as K1
from . import nms_kernel as K2
from . import qgemm as K4
from . import stem as K3


def _not_here(name: str, device) -> RuntimeError:
    return RuntimeError(f"{name} runs on cpu (its plain version) or cuda "
                        f"(its kernel), not {device}")


# ------------------------------------------------------------------ K1


@torch.library.custom_op("dyk::decode_heads_into", mutates_args=("out",))
def decode_heads_into(out: Tensor, heads: list[Tensor], anchors: list[float],
                      n_anchors: list[int], strides: list[int],
                      v4: list[bool], row_offset: int) -> None:
    hs, types = K1.op_heads(heads, anchors, n_anchors, strides, v4)
    if heads[0].device.type != "cpu":
        raise _not_here("decode_heads_into", heads[0].device)
    K1.decode_plain_into(hs, types, out, row_offset)


@decode_heads_into.register_kernel("cuda")
def _(out, heads, anchors, n_anchors, strides, v4, row_offset):
    hs, types = K1.op_heads(heads, anchors, n_anchors, strides, v4)
    K1.launch(hs, types, out, row_offset)


@decode_heads_into.register_fake
def _(out, heads, anchors, n_anchors, strides, v4, row_offset):
    return None


# ------------------------------------------------------------------ K2


@torch.library.custom_op("dyk::nms_indices", mutates_args=())
def nms_indices(boxes: Tensor, scores: Tensor, iou_thres: float,
                max_det: int) -> tuple[Tensor, Tensor]:
    if boxes.device.type != "cpu":
        raise _not_here("nms_indices", boxes.device)
    return K2.nms_indices_plain(boxes, scores, iou_thres, max_det)


@nms_indices.register_kernel("cuda")
def _(boxes, scores, iou_thres, max_det):
    return K2.launch(boxes, scores, iou_thres, max_det)


@nms_indices.register_fake
def _(boxes, scores, iou_thres, max_det):
    bs = boxes.shape[0]
    return (boxes.new_empty((bs, max_det), dtype=torch.int32),
            boxes.new_empty((bs, max_det), dtype=torch.bool))


# ------------------------------------------------------------------ K3


@torch.library.custom_op("dyk::stem_conv_s2", mutates_args=())
def stem_conv_s2(x: Tensor, w: Tensor, b: Tensor, kernel: Tensor,
                 bias: Tensor, act: str) -> Tensor:
    if x.device.type != "cpu":
        raise _not_here("stem_conv_s2", x.device)
    return K3.stem_conv_s2_plain(x, w, b, act)


@stem_conv_s2.register_kernel("cuda")
def _(x, w, b, kernel, bias, act):
    return K3.launch(x, K3.StemWeights(w, b, kernel, bias), act)


@stem_conv_s2.register_fake
def _(x, w, b, kernel, bias, act):
    bsz, _, h, wd = x.shape
    return x.new_empty((bsz, w.shape[0], (h + 1) // 2, (wd + 1) // 2)
                       ).contiguous(memory_format=torch.channels_last)


# ------------------------------------------------------------------ K4


@torch.library.custom_op("dyk::qgemm", mutates_args=())
def qgemm(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor, act: str,
          out_inv_s: Optional[float], out_dtype: torch.dtype) -> Tensor:
    if x.device.type != "cpu":
        raise _not_here("qgemm", x.device)
    return K4.plain(x, w, scale, bias, act, out_inv_s, out_dtype)


@qgemm.register_kernel("cuda")
def _(x, w, scale, bias, act, out_inv_s, out_dtype):
    return K4.launch(x, w, scale, bias, act, out_inv_s, out_dtype)


@qgemm.register_fake
def _(x, w, scale, bias, act, out_inv_s, out_dtype):
    dtype = torch.int8 if out_inv_s is not None else out_dtype
    return x.new_empty(tuple(x.shape[:-1]) + (w.shape[0],), dtype=dtype)


# ------------------------------------------------------------------ K5


@torch.library.custom_op("dyk::bias_act", mutates_args=())
def bias_act(y: Tensor, b: Tensor, act: str) -> Tensor:
    if y.device.type != "cpu":
        raise _not_here("bias_act", y.device)
    return K5.plain(y, b, act).contiguous(memory_format=torch.channels_last)


@bias_act.register_kernel("cuda")
def _(y, b, act):
    return K5.launch(y, b, act)


@bias_act.register_fake
def _(y, b, act):
    return torch.empty_like(y, memory_format=torch.channels_last)
