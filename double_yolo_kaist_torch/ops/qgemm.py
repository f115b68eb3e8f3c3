"""K4: int8 GEMM with the fused dequant -> activation -> requant epilogue —
the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``double_yolo_kaist_tpu/ops/pallas_qgemm.py``
(``_kernel`` via ``qgemm``): a quantized 1x1 stride-1 conv as a GEMM over
flattened pixels, s8 x s8 -> s32, then ``T(acc) * T(scale) + T(bias)``, the
activation in ``T``, and optionally ``clamp(round(y * T(out_inv_s)), -127,
127)`` -> s8, where ``T`` is the output dtype (bf16 in serving, fp32 in the
checks). The kernel (``csrc/qgemm.cu``) replays :func:`epilogue_plain` op by
op. A channels-last int8 NCHW tensor is already ``(B*H*W, C)`` row-major,
so neither side needs a copy.

:func:`qgemm` launches the kernel for CUDA tensors and takes
:func:`qgemm_plain` only for CPU tensors. :func:`int_mm` and
:func:`epilogue_plain` also serve the kxk int8 convs of
``models/quantize.py``, which stay an im2col + ``torch._int_mm`` as the JAX
package left them to XLA.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..models import layers as L
from . import _build

ACTS = {"linear": 0, "leaky": 1, "mish": 2, "relu": 3, "relu6": 4}
_MAX_M = 65535 * 64                 # the kernel's grid.y limit, 64 rows each
# dyk_qgemm's C signature (csrc/qgemm.cu)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


def int_mm(a, b_t):
    """Exact ``(M, K) s8 @ (K, N) s8 -> (M, N) int32``. ``b_t`` is the
    ``(N, K)`` transpose, contiguous, so that ``torch._int_mm`` gets the
    ``(K, N)`` operand column-major, the layout cuBLASLt's int8 GEMM takes.
    ``torch._int_mm`` needs more than 16 rows on CUDA, so a smaller M is
    padded with zero rows, which are cut off again."""
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a, b_t.t())[:m]


def epilogue_plain(acc, scale, bias, act: str, out_inv_s, out_dtype):
    """int32 accumulators -> dequant, activation, optional s8 requant, op by
    op in ``out_dtype`` (``quantize._qconv``'s sequence in the JAX
    package)."""
    y = acc.to(out_dtype) * scale.to(out_dtype)
    y = y + bias.to(out_dtype)
    y = L.activate(act, y)
    if out_inv_s is not None:
        inv = torch.tensor(float(out_inv_s), dtype=torch.float32).to(out_dtype)
        y = torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8)
    return y


def qgemm_plain(x, w, scale, bias, act: str, out_inv_s=None,
                out_dtype=torch.bfloat16):
    """Plain PyTorch version: x (..., K) s8, w (K, N) s8, scale/bias (N,)
    -> (..., N), s8 when ``out_inv_s`` is given, else ``out_dtype``."""
    lead, k, n = x.shape[:-1], x.shape[-1], w.shape[-1]
    acc = int_mm(x.reshape(-1, k), w.t().contiguous())
    return epilogue_plain(acc, scale, bias, act, out_inv_s,
                          out_dtype).reshape(*lead, n)


def _check(x, w, scale, bias, act, out_dtype):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"qgemm takes s8 x s8, got {x.dtype} x {w.dtype}")
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"qgemm: x {tuple(x.shape)} does not contract "
                         f"with w {tuple(w.shape)} (w must be (K, N))")
    n = w.shape[1]
    if scale.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"qgemm: scale {tuple(scale.shape)} / bias "
                         f"{tuple(bias.shape)} for N = {n}")
    if act not in ACTS:
        raise ValueError(f"qgemm activation must be one of {sorted(ACTS)}, "
                         f"got {act!r}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qgemm computes in bf16 or fp32, not {out_dtype}")


def qgemm(x, w, scale, bias, act: str, out_inv_s=None,
          out_dtype=torch.bfloat16):
    """x (..., K) s8 contiguous, w (K, N) s8, scale/bias (N,) fp32 ->
    (..., N): s8 when ``out_inv_s`` (a scalar) is given, else
    ``out_dtype``. A CPU tensor goes to :func:`qgemm_plain`; CUDA tensors
    to the kernel, or this raises."""
    _check(x, w, scale, bias, act, out_dtype)
    if x.device.type == "cpu":
        return qgemm_plain(x, w, scale, bias, act, out_inv_s, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qgemm runs on cpu or cuda, not {x.device}")
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("qgemm: operands on different devices")
    if not x.is_contiguous():
        raise ValueError("qgemm kernel reads a contiguous (..., K) input")
    lead, k, n = x.shape[:-1], x.shape[-1], w.shape[1]
    m = x.numel() // k if k else 0
    if k % 16 or n % 16 or m < 1 or m > _MAX_M:
        raise ValueError(f"qgemm kernel: unsupported shape M={m} K={k} "
                         f"N={n} (K and N multiples of 16)")
    if x.data_ptr() % 16:              # the kernel reads 16-byte vectors
        x = x.clone()
    w = w.contiguous()
    requant = out_inv_s is not None
    out = torch.empty(tuple(lead) + (n,),
                      dtype=torch.int8 if requant else out_dtype,
                      device=x.device)
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    lib = _build.library("qgemm.cu")
    fn = lib.dyk_qgemm
    if fn.argtypes is None:
        fn.restype, fn.argtypes = ctypes.c_int, _ARGTYPES
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(x.data_ptr(), w.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                    out.data_ptr(), m, k, n, ACTS[act],
                    int(out_dtype == torch.bfloat16), int(requant),
                    float(out_inv_s) if requant else 0.0, stream)
    _build.check(lib, status, "qgemm")
    _build.launches["qgemm"] += 1
    return out
