"""K5: a conv's bias + activation epilogue (linear, leaky or mish) in one
pass over its output — the CUDA kernel's wrapper and its plain version.

It replaces no TPU kernel (XLA fuses the epilogue into the conv there).
On the card the folded forward ran it eagerly: ATen adds a cuDNN conv's
bias as a pass of its own, and ``ops/act.py`` runs mish as eight ops and
leaky as two, each a pass over the output. The kernel
(``csrc/bias_act.cu``) reads the output once and writes it once, rounding
to the compute type after every term where the eager ops do, so that its
output equals the eager ``activate(act, y + b)`` bit for bit in bf16 and
fp32; its design notes are in the source.

:func:`bias_act` calls the registered operator ``dyk::bias_act``
(:mod:`.library`), which launches the kernel (:func:`launch`) for a CUDA
tensor and takes :func:`plain` for a CPU tensor; its output is
channels-last. :func:`takes` says whether K5 takes a conv;
:func:`..models.graph.conv_folded` asks it once, before it leaves the
conv's bias to K5.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import act as L

ACTS = {"linear": 0, "leaky": 1, "mish": 2}    # act codes of csrc/bias_act.cu
DTYPES = (torch.bfloat16, torch.float32)
# dyk_bias_act's C signature (csrc/bias_act.cu)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def plain(y, b, act: str):
    """Plain PyTorch version, the eager ops K5 stands for: ``y`` (B, C, H,
    W) + bias ``b`` (C,) in ``y``'s dtype, then the activation."""
    return L.activate(act, y + b.to(y.dtype)[:, None, None])


def takes(y, act: str, *params) -> bool:
    """Whether K5 takes a conv output like ``y`` (B, C, H, W) with ``act``:
    a CUDA tensor, bf16 or fp32, linear, leaky or mish, and no gradient
    wanted of ``y`` or of ``params`` (K5 has no backward). Not the layout:
    ``torch.export`` traces with cuDNN off, so a traced conv's output is
    NCHW where the card's is channels-last, and a program it exports has
    to make the same choice as the eager run (:func:`launch` reads any
    layout)."""
    return (y.device.type == "cuda" and y.dtype in DTYPES and y.dim() == 4
            and act in ACTS
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (y, *params))))


def bias_act(y, b, act: str):
    """``act(y + b)`` for a conv output ``y`` (B, C, H, W) and its bias
    ``b`` (C,), in ``y``'s dtype, channels-last. An eager call on a CUDA
    tensor launches the kernel (:func:`launch`) directly: the operator's
    dispatch would cost more host time than the launch itself, once a
    conv, in every eager forward. A traced call (``torch.export``) goes
    through the registered operator ``dyk::bias_act`` (:mod:`.library`),
    which the program keeps as one node; it takes :func:`plain` for a CPU
    tensor and :func:`launch` for a CUDA one."""
    if type(y) is torch.Tensor and y.is_cuda \
            and not torch.compiler.is_compiling():
        return launch(y, b, act)
    from . import library  # noqa: F401  (registers the operators)

    return torch.ops.dyk.bias_act(y, b, act)


@functools.cache
def _kernel():
    """The C entry ``dyk_bias_act``, built, loaded and typed once."""
    fn = _build.library("bias_act.cu").dyk_bias_act
    fn.restype, fn.argtypes = ctypes.c_int, _ARGTYPES
    return fn


def launch(y, b, act: str):
    """The kernel's launch (a CUDA tensor) into a new channels-last
    tensor. The kernel walks NHWC memory: a ``y`` in another layout is
    copied to channels-last first (the port's activations on the card
    are channels-last, and so are its convs' outputs)."""
    if act not in ACTS:
        raise ValueError(f"bias_act activation must be one of {sorted(ACTS)}"
                         f", got {act!r}")
    if y.dtype not in DTYPES:
        raise ValueError(f"bias_act takes bf16 or fp32, got {y.dtype}")
    if y.dim() != 4 or b.shape != (y.shape[1],):
        raise ValueError(f"bias_act takes (B, C, H, W) and a (C,) bias, got "
                         f"{tuple(y.shape)} and {tuple(b.shape)}")
    if y.device.type != "cuda" or b.device != y.device:
        raise ValueError(f"bias_act kernel: output on device {y.device}, "
                         f"bias on {b.device}; both must be one CUDA device")
    y = y.contiguous(memory_format=torch.channels_last)
    b = b.to(y.dtype).contiguous()
    out = torch.empty_like(y)
    args = (y.data_ptr(), b.data_ptr(), out.data_ptr(), y.numel(),
            y.shape[1], int(y.dtype == torch.bfloat16), ACTS[act])
    if y.device.index == torch.cuda.current_device():
        status = _kernel()(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(y.device):
            status = _kernel()(*args,
                               torch.cuda.current_stream().cuda_stream)
    if status:
        _build.check(_build.library("bias_act.cu"), status, "bias_act")
    _build.launches["bias_act"] += 1
    return out
