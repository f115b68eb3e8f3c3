"""Inference ops of the cfg layer zoo, in PyTorch.

Counterpart of ``double_yolo_kaist_tpu/models/layers.py``. Tensors are NCHW
in shape (torch's habit) and may lie channels-last in memory; kernels are
OIHW. Formulas follow the JAX package term by term (not torch's fused
``F.hardswish`` / ``F.mish``, which round differently), so that fp32 runs
agree with the JAX functions to float rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


# ----------------------------------------------------------------- activations

def _softplus(x):
    """max(x, 0) + log1p(exp(-|x|)): the JAX package's select-free softplus."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _mish(x):
    return x * torch.tanh(_softplus(x))


def _leaky(x):
    """max(x, 0.1 x) with 0.1 in ``x``'s dtype: JAX types the Python scalar
    weakly, so in bf16 it multiplies by bf16(0.1), not by fp32(0.1)."""
    return torch.maximum(x, x * torch.tensor(0.1, dtype=x.dtype))


def _hard_sigmoid(x):
    return torch.clamp((x + 3.0) / 6.0, 0.0, 1.0)


ACTIVATIONS = {
    "linear": lambda x: x,
    "leaky": _leaky,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "mish": _mish,
    "hard-sigmoid": _hard_sigmoid,
    "hard-swish": lambda x: x * _hard_sigmoid(x),
}


def activate(name: str, x):
    return ACTIVATIONS[name](x)


# ------------------------------------------------------------------- conv ops

def conv2d(x, w, b=None, stride=(1, 1), pad: int = 0, groups: int = 1):
    """NCHW x OIHW grouped conv (+ bias), in the input's dtype. Depthwise is
    ``groups == in_ch``."""
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=tuple(stride), padding=pad, groups=groups)


def squeeze_excitation(x, params):
    """GAP -> 1x1 -> relu -> 1x1 -> hard-sigmoid -> scale, with the pooled
    path in fp32 (JAX layers.py:391-400). fc kernels are OIHW (S, C, 1, 1)."""
    pooled = x.float().mean(dim=(2, 3))                          # (B, C)
    w1, w2 = params["fc1"]["w"], params["fc2"]["w"]
    s = F.linear(pooled, w1.reshape(w1.shape[0], -1).float(),
                 params["fc1"]["b"].float())
    s = torch.relu(s)
    s = F.linear(s, w2.reshape(w2.shape[0], -1).float(),
                 params["fc2"]["b"].float())
    s = _hard_sigmoid(s)
    return x * s[:, :, None, None].to(x.dtype)


def max_pool(x, kernel: int, stride=(1, 1), pad: int = 0):
    """torch MaxPool2d: symmetric padding that never wins (-inf)."""
    return F.max_pool2d(x, kernel, tuple(stride), pad)


def adaptive_avg_pool(x, out_size: int):
    """AdaptiveAvgPool2d(out_size): bin i covers
    [floor(i*n/k), ceil((i+1)*n/k)) on each axis."""
    return F.adaptive_avg_pool2d(x, out_size)


def upsample_nearest(x, scale: int):
    """Nearest-neighbour upsampling by an integer ``scale`` (each value
    copied into a scale x scale patch). Keeps the input's memory format, so
    that the channels-last forward stays channels-last through the routes
    that concatenate an upsample with a conv output, down to the heads."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def weighted_fusion(x, extras: list, w=None):
    """Add ``x`` and earlier outputs, with optional learned sigmoid weights
    times 2/n and the channel-slice rule for mismatched widths (JAX
    layers.py:480-499; reference layers.py:63-85)."""
    n = len(extras) + 1
    if w is not None:
        ws = torch.sigmoid(w.float()) * (2.0 / n)
        x = x * ws[0].to(x.dtype)
    nx = x.shape[1]
    for i, a in enumerate(extras):
        if w is not None:
            a = a * ws[i + 1].to(a.dtype)
        na = a.shape[1]
        if nx == na:
            x = x + a
        elif nx > na:
            x = torch.cat([x[:, :na] + a, x[:, na:]], dim=1)
        else:
            x = x + a[:, :nx]
    return x


def inception(x, params):
    """Folded 4-branch GoogLeNet block: every branch conv carries its BN in
    ``w``/``b`` and ends in leaky (JAX graph.py:606-613)."""
    def branch(inp, name, pad=0):
        return activate("leaky", conv2d(inp, params[name]["w"],
                                        params[name]["b"], pad=pad))

    b1 = branch(x, "b1_1")
    b2 = branch(branch(x, "b2_1"), "b2_2", 1)
    b3 = branch(branch(branch(x, "b3_1"), "b3_2", 1), "b3_3", 1)
    b4 = branch(max_pool(x, 3, (1, 1), 1), "b4_1")
    return torch.cat([b1, b2, b3, b4], dim=1)
