"""The JAX package's ``.npz`` encoding of bf16 arrays, which numpy has no
dtype for: each bf16 array is stored as its uint16 bit patterns and its
key listed in the array ``__bf16__``. Both of the port's writers of that
format use it: the quantized artifact (:mod:`..models.quantize`) and the
exported serving artifact's ``variables.npz`` (:mod:`..export`)."""

from __future__ import annotations

import numpy as np
import torch

BF16 = "__bf16__"


def encode(flat: dict) -> dict:
    """{key: tensor or array} -> {key: array} for ``np.savez``: tensors on
    the host, bf16 ones as uint16 bit patterns, their keys in
    ``__bf16__``."""
    out, bf16 = {}, []
    for k, a in flat.items():
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
            if a.dtype == torch.bfloat16:
                bf16.append(k)
                a = a.view(torch.int16).numpy().view(np.uint16)
            else:
                a = a.numpy()
        out[k] = a if a.flags.c_contiguous else np.ascontiguousarray(a)
    out[BF16] = np.asarray(bf16)
    return out


def bf16_keys(z) -> set:
    """The keys of a loaded ``.npz`` that hold bf16 bit patterns."""
    return set(z[BF16].tolist()) if BF16 in z.files else set()


def decode(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    """One stored array as a tensor of its own memory: bf16 from its bit
    patterns where ``bf16``, else as it is."""
    if bf16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))
