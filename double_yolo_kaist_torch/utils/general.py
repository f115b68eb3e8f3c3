"""Small shared utilities (reference build_utils/utils.py:24-37,
torch_utils.py:9-74): the JAX package's ``utils/general.py`` for the port.
"""

from __future__ import annotations

import contextlib
import glob
import os
import random

import numpy as np
import torch


def enable_compile_cache(path: str | None = None) -> None:
    """Nothing to do: the JAX package turns on XLA's persistent
    compilation cache here. The port compiles no programs; what it builds
    are the hand kernels, whose libraries are cached already, keyed by a
    hash of source and flags, in ``ops/_kernels/`` (:mod:`..ops._build`).
    Kept so that code written for either package calls it alike."""


def check_file(file: str) -> str:
    """Return ``file`` if it exists, else search the tree recursively
    (reference utils.py:30-37)."""
    if os.path.isfile(file):
        return file
    found = glob.glob(f"./**/{file}", recursive=True)
    if not found:
        raise FileNotFoundError(f"File Not Found: {file}")
    return found[0]


def init_seeds(seed: int = 0):
    """Seed Python's, numpy's and torch's global generators (the port's
    own randoms come from explicit ``torch.Generator``\\ s)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def model_info(ir, variables, verbose: bool = False) -> str:
    """Param/layer summary (reference torch_utils.py:55-74), the same
    string as the JAX package's."""
    from ..models.graph import count_params

    n_params = count_params(variables)
    lines = [f"Model: {os.path.basename(ir.cfg_path)} — "
             f"{ir.num_layers} layers, {n_params:,} parameters, "
             f"{'dual' if ir.dual_stream else 'single'}-stream, "
             f"heads at strides {[n.yolo_stride for n in ir.head_nodes()]}"]
    if verbose:
        for node in ir.nodes:
            lines.append(f"  l{node.index:3d} {node.kind:10s} "
                         f"{node.in_ch:4d}->{node.out_ch:4d}")
    return "\n".join(lines)


def load_class_names(path: str) -> list:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


@contextlib.contextmanager
def deterministic():
    """True fp32 and one summation order for a block: deterministic
    algorithms, cuDNN deterministic and not benchmarking, TF32 off for
    cuDNN and cuBLAS; the previous settings afterwards. Sets
    ``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8``) where it is unset, as
    deterministic cuBLAS needs it."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    b = torch.backends
    saved = (torch.are_deterministic_algorithms_enabled(),
             b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.allow_tf32,
             b.cuda.matmul.allow_tf32)
    torch.use_deterministic_algorithms(True)
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (det, b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.allow_tf32,
         b.cuda.matmul.allow_tf32) = saved
        torch.use_deterministic_algorithms(det)
