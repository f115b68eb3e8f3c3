"""K3: 3x3 stride-2 stem conv for C_in = 32 — the CUDA kernel's wrapper and
its plain version.

Replaces the TPU kernel ``double_yolo_kaist_tpu/ops/pallas_stem.py``
(``_kernel_packed`` via ``stem_conv_s2_packed``; ``_kernel_acc`` /
``_kernel_scratch`` via ``stem_conv_s2``): conv 3x3, stride 2, pad 1, C_in
32 -> O, summed in fp32, + bias and the activation (mish or leaky) in fp32,
then one rounding to the input's dtype. On the flagship it is the second
conv of each stream, 32 -> 64 at 512x640 -> 256x320 (nodes 1 and 56). The
kernel (``csrc/stem.cu``) is bound by bytes on the H100: blocks walk down
strips of 64 output columns over a ring of input rows that ``cp.async``
fills ahead of the ``wgmma`` products; its design notes are in the source.

Tensors are NCHW in shape and channels-last in memory (the port's layout),
so the kernel reads and writes NHWC as the TPU kernel did. Kernels are OIHW.
:func:`stem_conv_s2` launches the kernel for a CUDA tensor and takes
:func:`stem_conv_s2_plain` only for a CPU tensor. The kernel reads the
weights in a packed form, so the conv takes them as :func:`pack_weights`
makes them, once (:func:`..models.graph.place_folded` does, when it places
the model), and a stem conv is one launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..models import layers as L
from . import _build

C_IN = 32
ACTS = {"leaky": 1, "mish": 2}     # act codes of csrc/stem.cu
MAX_OUT = 128                      # the kernel holds O <= 128 channels
K_CHUNKS = 9 * C_IN // 8           # 16-byte chunks along the GEMM depth
# dyk_stem_conv_s2's C signature (csrc/stem.cu)
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
             + [ctypes.c_void_p])


def matches(node) -> bool:
    """True for the convs that K3 computes: 3x3, stride 2, pad 1, groups 1,
    C_in 32 -> at most 128 channels, mish or leaky."""
    return (node.kind == "conv" and node.kernel == 3
            and tuple(node.stride) == (2, 2) and node.pad == 1
            and node.groups == 1 and node.in_ch == C_IN
            and node.out_ch <= MAX_OUT and node.act in ACTS)


def stem_conv_s2_plain(x, w, b, act: str):
    """Plain PyTorch version: the conv in fp32, + bias in fp32, the
    activation in fp32, cast to ``x.dtype``. x (B, 32, H, W), w OIHW
    (O, 32, 3, 3), b (O,). On a CUDA device, fp32 here means fp32 only
    with TF32 off (``torch.backends.cudnn.allow_tf32``)."""
    y = F.conv2d(x.float(), w.float(), stride=2, padding=1)
    y = L.activate(act, y + b.float().reshape(1, -1, 1, 1))
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def padded_out(o: int) -> int:
    """The width the bf16 kernel pads ``o`` output channels to (its wgmma
    shapes: n = 32, 64 or 128)."""
    return 32 if o <= 32 else 64 if o <= 64 else 128


class StemWeights(NamedTuple):
    """A stem conv's weights as :func:`stem_conv_s2` takes them: ``w`` OIHW
    and ``b`` as given (the plain version's operands), ``kernel`` and fp32
    ``bias`` in the form the CUDA kernel reads."""
    w: torch.Tensor
    b: torch.Tensor
    kernel: torch.Tensor
    bias: torch.Tensor


def pack_weights(w, b) -> StemWeights:
    """The OIHW kernel (O, 32, 3, 3) and bias (O,), O <= 128, with the form
    the CUDA kernel reads beside them. fp32: the kernel as (3, 3, 32, O).
    bf16: (36, NP, 8), NP = :func:`padded_out` (O): element [kc, n, e] is
    the weight of output n at GEMM depth k = 8 kc + e, k = (kh * 3 + kw) *
    32 + c, and zero for n >= O (wgmma's K-major operand: 8 consecutive k
    of one output are 16 contiguous bytes)."""
    if w.dim() != 4 or tuple(w.shape[1:]) != (C_IN, 3, 3) \
            or not 1 <= w.shape[0] <= MAX_OUT:
        raise ValueError(f"stem conv kernel must be (O <= {MAX_OUT}, {C_IN}, "
                         f"3, 3), got {tuple(w.shape)}")
    if b.shape != (w.shape[0],) or b.device != w.device:
        raise ValueError(f"bias {tuple(b.shape)} on {b.device} for "
                         f"{w.shape[0]} outputs on {w.device}")
    o = w.shape[0]
    hwio = w.permute(2, 3, 1, 0).contiguous()              # (3, 3, 32, O)
    bias = b.float().contiguous()
    if w.dtype != torch.bfloat16:
        return StemWeights(w, b, hwio, bias)
    packed = torch.zeros((K_CHUNKS, padded_out(o), 8), dtype=w.dtype,
                         device=w.device)
    packed[:, :o] = hwio.reshape(K_CHUNKS, 8, o).permute(0, 2, 1)
    return StemWeights(w, b, packed, bias)


def _check(x, weights: StemWeights, act: str):
    if x.dim() != 4 or x.shape[1] != C_IN:
        raise ValueError(f"stem conv takes (B, {C_IN}, H, W), got "
                         f"{tuple(x.shape)}")
    if not isinstance(weights, StemWeights):
        raise TypeError("stem conv takes its weights as pack_weights(w, b) "
                        f"makes them, got {type(weights).__name__}")
    if act not in ACTS:
        raise ValueError(f"stem conv activation must be one of "
                         f"{sorted(ACTS)}, got {act!r}")


def _cuda_input(x, weights: StemWeights):
    """The checks of a CUDA launch; returns ``x`` NHWC-contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv_s2 runs on cpu or cuda, not {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or weights.kernel.dtype != x.dtype:
        raise TypeError(f"stem kernel takes bf16 or fp32 input and kernel "
                        f"of the same type, got {x.dtype} and "
                        f"{weights.kernel.dtype}")
    if weights.kernel.device != x.device:
        raise ValueError("stem conv: input and weights on different devices")
    B, _, H, W = x.shape
    if B * H * W >= 2 ** 31 or B == 0:
        raise ValueError(f"stem kernel: unsupported shape {tuple(x.shape)}")
    xc = x.contiguous(memory_format=torch.channels_last)   # NHWC memory
    if xc.data_ptr() % 16:             # the kernel reads 16-byte vectors
        xc = xc.clone(memory_format=torch.channels_last)
    return xc


def stem_conv_s2(x, weights: StemWeights, act: str):
    """3x3 s2 p1 conv + bias + act for C_in = 32, ``weights`` from
    :func:`pack_weights`. Returns (B, O, ceil(H/2), ceil(W/2)) in
    ``x.dtype``, channels-last. A CPU tensor goes to
    :func:`stem_conv_s2_plain`; a CUDA tensor to the kernel, or this
    raises."""
    _check(x, weights, act)
    if x.device.type == "cpu":
        return stem_conv_s2_plain(x, weights.w, weights.b, act)
    xc = _cuda_input(x, weights)
    B, _, H, W = x.shape
    O = weights.w.shape[0]
    y = torch.empty((B, O, (H + 1) // 2, (W + 1) // 2), dtype=x.dtype,
                    device=x.device, memory_format=torch.channels_last)
    lib = _build.library("stem.cu")
    fn = lib.dyk_stem_conv_s2
    if fn.argtypes is None:
        fn.restype, fn.argtypes = ctypes.c_int, _ARGTYPES
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(xc.data_ptr(), int(x.dtype == torch.bfloat16),
                    weights.kernel.data_ptr(), weights.bias.data_ptr(),
                    y.data_ptr(), B, H, W, O, ACTS[act], stream)
    _build.check(lib, status, "stem_conv_s2")
    _build.launches["stem_conv_s2"] += 1
    return y
