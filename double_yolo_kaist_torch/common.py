"""What the entry points share: a model and its weights from the command
line.

Counterpart of the JAX package's ``cli/common.py``. ``evaluate``, ``serve``,
``detect``, ``bench`` and ``train`` all take ``--cfg`` as a cfg path or a
zoo name (:mod:`.models.zoo`) and ``--weights`` as a checkpoint directory
(the JAX package's format), a reference ``.pt`` / ``.pth``, a darknet
``.weights`` file, or nothing (weights from ``graph.init``).
"""

from __future__ import annotations

import os

from .config.ir import GraphIR, compile_cfg
from .models import graph
from .models import weights as W
from .models.zoo import cfg_path
from .utils.checkpoint import load_checkpoint

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEFAULT_HYP = os.path.join(REPO_ROOT, "configs", "hyp.scratch.4.yaml")


def resolve_cfg(cfg: str) -> str:
    """A cfg path as it is, or a zoo model's name -> its cfg path."""
    return cfg if os.path.exists(cfg) else cfg_path(cfg)


def build_model(cfg: str, weights: str = "", seed: int = 0,
                cutoff: int = -1):
    """cfg path or zoo name + weights -> (ir, the port's variables).

    The variables start from :func:`.models.graph.init` with ``seed``;
    ``weights`` is grafted over them tolerantly (JAX ``cli/common.py``):
    a checkpoint directory (leaves of another shape keep their init), a
    reference ``.pt`` / ``.pth`` or a darknet ``.weights`` file read up to
    ``cutoff`` (node by node); ``""`` keeps the init."""
    ir: GraphIR = compile_cfg(resolve_cfg(cfg))
    variables = graph.init(ir, seed)
    if not weights:
        return ir, variables
    if os.path.isdir(weights):
        template = W.to_jax_variables(variables)
        ck = load_checkpoint(weights, {"params": template["params"],
                                       "bn_state": template["state"]})
        return ir, W.from_jax_variables(
            ir, {"params": ck["params"], "state": ck["bn_state"]})
    if weights.endswith((".pt", ".pth")):
        loaded = W.from_torch_checkpoint(ir, weights)
    elif weights.endswith(".weights"):
        loaded = W.from_darknet_weights(ir, weights, cutoff)
    else:
        raise ValueError(f"unrecognized weights format: {weights}")
    return ir, W.merge_variables(variables, loaded)


def card_label(device) -> str:
    """What a printed time or rate was measured on: the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (with ``torch.cuda.
    get_device_name`` where nvidia-smi cannot be read), or ``cpu``."""
    import subprocess

    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    name = torch.cuda.get_device_name(index)
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        line = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        line = ""
    return line if line else f"{name}, power limit not read"


def pyplot(tool: str):
    """matplotlib's pyplot on the Agg backend for the PNG-writing tools;
    SystemExit naming matplotlib where it is not installed (they never
    write something else in a plot's place)."""
    try:
        import matplotlib
    except ImportError:
        raise SystemExit(f"{tool} writes its PNG with matplotlib, which is "
                         f"not installed here; install matplotlib to run "
                         f"it") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
