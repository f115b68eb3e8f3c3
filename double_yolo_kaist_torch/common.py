"""What the entry points share: a model and its weights from the command
line.

Counterpart of the JAX package's ``cli/common.py``. ``evaluate``, ``serve``,
``detect`` and ``bench`` all take ``--cfg`` as a cfg path or a zoo name
(:mod:`.models.zoo`) and ``--weights`` as a checkpoint directory (the JAX
package's format), a reference ``.pt`` / ``.pth`` or a darknet ``.weights``
file.
"""

from __future__ import annotations

import os

from .config.ir import GraphIR, compile_cfg
from .models import weights as W
from .models.zoo import cfg_path
from .utils.checkpoint import load_checkpoint

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEFAULT_HYP = os.path.join(REPO_ROOT, "configs", "hyp.scratch.4.yaml")


def resolve_cfg(cfg: str) -> str:
    """A cfg path as it is, or a zoo model's name -> its cfg path."""
    return cfg if os.path.exists(cfg) else cfg_path(cfg)


def build_model(cfg: str, weights: str, cutoff: int = -1):
    """cfg path or zoo name + weights -> (ir, the port's variables).

    ``weights``: a checkpoint directory, a reference ``.pt`` / ``.pth``, or
    a darknet ``.weights`` file read up to ``cutoff`` (which must then cover
    every parameter of the model: the rest would come from ``graph.init``,
    not ported yet)."""
    if not weights:
        raise NotImplementedError(
            "random weights need graph.init, which is not ported yet "
            "(ROADMAP.md, queue 1 item 7)")
    ir: GraphIR = compile_cfg(resolve_cfg(cfg))
    if weights.endswith(".weights"):
        missing = W.missing_from_darknet(ir, cutoff)
        if missing:
            shown = ", ".join(missing[:8]) + (", ..." if len(missing) > 8
                                              else "")
            raise NotImplementedError(
                f"darknet .weights hold convs only; {len(missing)} "
                f"parameterized nodes of this model would stay without "
                f"weights ({shown}) and would need graph.init, which is not "
                f"ported yet (ROADMAP.md, queue 1 item 7)")
        return ir, W.from_darknet_weights(ir, weights, cutoff)
    if os.path.isdir(weights):
        ck = load_checkpoint(weights)
        variables = W.from_jax_variables(
            ir, {"params": ck["params"], "state": ck.get("bn_state", {})})
    elif weights.endswith((".pt", ".pth")):
        variables = W.from_torch_checkpoint(ir, weights)
    else:
        raise ValueError(f"unrecognized weights format: {weights}")
    return ir, variables
