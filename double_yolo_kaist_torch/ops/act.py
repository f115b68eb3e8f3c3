"""The activations of the cfg layer zoo (``models/layers.py`` re-exports
them), written term by term as the JAX package computes them (not torch's
fused ``F.hardswish`` / ``F.mish``, which round differently). They live in
``ops/`` because the kernels' plain versions apply them too, and a host
that loads an exported program imports ``ops/`` and nothing of
``models/``.
"""

from __future__ import annotations

import torch


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
