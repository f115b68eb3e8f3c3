"""K4: int8 GEMM with the fused dequant -> activation -> requant epilogue —
the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``double_yolo_kaist_tpu/ops/pallas_qgemm.py``
(``_kernel`` via ``qgemm``): a quantized 1x1 stride-1 conv as a GEMM over
flattened pixels, s8 x s8 -> s32, then ``T(acc) * T(scale) + T(bias)``, the
activation in ``T``, and optionally ``clamp(round(y * T(out_inv_s)), -127,
127)`` -> s8, where ``T`` is the output dtype (bf16 in serving, fp32 in the
checks). The kernel (``csrc/qgemm.cu``) replays :func:`epilogue_plain` op by
op. A channels-last int8 NCHW tensor is already ``(B*H*W, C)`` row-major,
so the activations need no copy.

The kernel's ``wgmma`` products read both operands K-major, so
:func:`qgemm` takes the weights as :func:`pack_weights` makes them, the
``(N, K)`` form, once (:func:`..models.quantize.place_quantized` does, when
it places the model): no request transposes anything. :func:`choose_tile`
picks the block's output tile from the shape.

:func:`qgemm` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors. :func:`int_mm` and :func:`epilogue_plain`
also serve the kxk int8 convs of ``models/quantize.py``, which stay an
im2col + ``torch._int_mm`` as the JAX package left them to XLA.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..models import layers as L
from . import _build

ACTS = {"linear": 0, "leaky": 1, "mish": 2, "relu": 3, "relu6": 4}
_MAX_M = 2 ** 24                    # rows of one launch
SMS = 132      # the H100's multiprocessors: choose_tile's default; a launch
#                asks the card it runs on (dyk_qgemm_sms)
# output tiles (BM, BN) of a block that csrc/qgemm.cu has, largest first
TILES = ((128, 128), (64, 128), (64, 64))
# dyk_qgemm's C signature (csrc/qgemm.cu)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def pack_weights(w_kn):
    """The ``(K, N)`` s8 weights of a GEMM in the form :func:`qgemm` reads:
    the ``(N, K)`` matrix, contiguous (K-major), the operand form of the
    kernel's ``wgmma`` and of :func:`int_mm`. Made once, when a model is
    placed."""
    if w_kn.dim() != 2 or w_kn.dtype != torch.int8:
        raise TypeError(f"qgemm weights are a (K, N) s8 matrix, got "
                        f"{tuple(w_kn.shape)} {w_kn.dtype}")
    return w_kn.t().contiguous()


def choose_tile(m: int, k: int, n: int, sms: int = SMS) -> tuple:
    """The output tile (BM, BN) of a block for an (M, K) x (K, N) product
    on a card of ``sms`` multiprocessors: the largest of :data:`TILES`, no
    wider than N needs, whose grid gives every multiprocessor a block, and
    two for the 128 x 128 tile, whose block holds a multiprocessor alone
    (the smaller tiles' blocks run two or three to one), so that a last,
    partly filled round does not weigh as much as the full one before it;
    else the smallest. Large tiles read the operands fewer times; the
    flagship's shapes at batch 1 have too few rows to fill the card with
    them. ``k`` does not enter: the kernel walks K in steps of 128 whatever
    the tile."""
    fits = [t for t in TILES if t[1] <= max(64, -(-n // 64) * 64)]
    for tile in fits:
        rounds = 2 if tile == (128, 128) else 1
        if -(-m // tile[0]) * -(-n // tile[1]) >= rounds * sms:
            return tile
    return fits[-1]


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
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"qgemm: x {tuple(x.shape)} does not contract "
                         f"with packed weights {tuple(w.shape)} (N, K)")
    n = w.shape[0]
    if scale.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"qgemm: scale {tuple(scale.shape)} / bias "
                         f"{tuple(bias.shape)} for N = {n}")
    if act not in ACTS:
        raise ValueError(f"qgemm activation must be one of {sorted(ACTS)}, "
                         f"got {act!r}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qgemm computes in bf16 or fp32, not {out_dtype}")


_sms: dict = {}     # CUDA device index -> its multiprocessors


def _device_sms(lib, index: int) -> int:
    """Multiprocessors of the current device, asked once a device."""
    sms = _sms.get(index)
    if sms is None:
        count = ctypes.c_int(0)
        lib.dyk_qgemm_sms.restype = ctypes.c_int
        lib.dyk_qgemm_sms.argtypes = [ctypes.POINTER(ctypes.c_int)]
        _build.check(lib, lib.dyk_qgemm_sms(ctypes.byref(count)), "qgemm")
        _sms[index] = sms = count.value
    return sms


def qgemm(x, w, scale, bias, act: str, out_inv_s=None,
          out_dtype=torch.bfloat16):
    """x (..., K) s8 contiguous, ``w`` the (N, K) weights that
    :func:`pack_weights` makes (a (K, N) matrix with K != N is refused),
    scale/bias (N,) fp32 -> (..., N): s8 when ``out_inv_s`` (a scalar) is
    given, else ``out_dtype``. CPU tensors go to the plain version
    (:func:`int_mm` + :func:`epilogue_plain`); CUDA tensors to the kernel,
    or this raises."""
    _check(x, w, scale, bias, act, out_dtype)
    lead, k, n = x.shape[:-1], x.shape[-1], w.shape[0]
    if x.device.type == "cpu":
        acc = int_mm(x.reshape(-1, k), w)
        return epilogue_plain(acc, scale, bias, act, out_inv_s,
                              out_dtype).reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"qgemm runs on cpu or cuda, not {x.device}")
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("qgemm: operands on different devices")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("qgemm kernel reads a contiguous (..., K) input "
                         "and contiguous (N, K) weights")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"qgemm kernel reads {name} as contiguous, "
                             f"16-byte aligned fp32, got {t.dtype}")
    m = x.numel() // k if k else 0
    if k % 16 or n % 16 or m < 1 or m > _MAX_M:
        raise ValueError(f"qgemm kernel: unsupported shape M={m} K={k} "
                         f"N={n} (K and N multiples of 16)")
    if w.data_ptr() % 16:
        raise ValueError("qgemm kernel reads 16-byte aligned weights")
    if x.data_ptr() % 16:              # the kernel reads 16-byte vectors
        x = x.clone()
    requant = out_inv_s is not None
    out = torch.empty(tuple(lead) + (n,),
                      dtype=torch.int8 if requant else out_dtype,
                      device=x.device)
    lib = _build.library("qgemm.cu")
    fn = lib.dyk_qgemm
    if fn.argtypes is None:
        fn.restype, fn.argtypes = ctypes.c_int, _ARGTYPES
    with torch.cuda.device(x.device):
        bm, bn = choose_tile(m, k, n, _device_sms(lib, x.device.index))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), m, k, n, ACTS[act],
                    int(out_dtype == torch.bfloat16), int(requant),
                    float(out_inv_s) if requant else 0.0, bm, bn, stream)
    _build.check(lib, status, "qgemm")
    _build.launches["qgemm"] += 1
    return out
