"""The training and evaluation steps.

Counterpart of the JAX package's ``train/step.py``: one optimizer step is
the unfolded forward in ``compute_dtype`` (fp32 params, each kernel cast
to the activations' dtype at its use, BN statistics in fp32), the fixed-
shape loss, the backward (fp32 gradients through the casts), the
optimizer update and the EMA. The casts are explicit, as JAX makes them,
not ``autocast``'s.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .. import resolve_device
from ..models import graph
from ..utils import tree as TR
from . import loss as LS
from . import optim as OPT

METRICS = ("box_loss", "obj_loss", "class_loss", "loss", "grad_norm")


class TrainState(NamedTuple):
    params: Any               # tree of fp32 leaves that require grad
    bn_state: Any
    opt_state: Any
    step: int
    ema: Optional[dict] = None


def create_train_state(ir, seed, tx, ema: bool = False,
                       variables: Optional[dict] = None,
                       device=None) -> TrainState:
    """A TrainState on ``device`` (None means ``cuda``): ``variables``
    (default ``graph.init(ir, seed)``) as fp32 copies, the optimizer's
    state and, with ``ema``, the EMA of the params."""
    device = resolve_device(device)
    if variables is None:
        variables = graph.init(ir, seed)
    placed = graph.place_variables(variables, device)
    params = TR.map_leaves(lambda p: p.clone().requires_grad_(True),
                           placed["params"])
    return TrainState(params=params, bn_state=placed["state"],
                      opt_state=tx.init(params), step=0,
                      ema=OPT.ema_init(params) if ema else None)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(tensors))))


def make_train_step(ir, hyp: dict, tx, *, gr: float = 1.0,
                    compute_dtype=torch.bfloat16, ema_decay: float = 0.9999,
                    remat_segments: int = 0):
    """(state, batch, rng) -> (new state, metrics): one optimizer step.

    batch: {"v": (B, H, W, 3), "l": (B, H, W, 3) [dual-stream only],
    "targets": (B, T, 5), "tmask": (B, T)}, images uint8 or float in
    [0, 1] on the params' device. ``rng``: a torch.Generator for dropout,
    or None. The metrics (``METRICS``) are fp32 scalars on the device;
    ``grad_norm`` is the norm of the raw gradients, before the freeze mask
    and the decay. The params are updated in place."""
    specs = LS.head_specs(ir)

    def step_fn(state: TrainState, batch: dict, rng=None):
        xv = _to_float(batch["v"])
        xl = _to_float(batch["l"]) if "l" in batch else None
        leaves = TR.leaves(state.params)
        raws, new_bn = graph.apply(
            ir, {"params": state.params, "state": state.bn_state}, xv, xl,
            train=True, rng=rng, compute_dtype=compute_dtype,
            remat_segments=remat_segments)
        ld = LS.compute_loss(raws, batch["targets"], batch["tmask"], specs,
                             hyp, gr)
        total = LS.total_loss(ld)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        with torch.no_grad():
            gnorm = global_norm(grads)
            updates, opt_state = tx.update(grads, state.opt_state, leaves)
            if updates is not None:
                torch._foreach_add_(leaves, updates)
            ema = state.ema
            if ema is not None:
                ema = OPT.ema_update(ema, state.params, ema_decay)
        metrics = {k: v.detach() for k, v in ld.items()}
        metrics["loss"] = total.detach()
        metrics["grad_norm"] = gnorm
        return TrainState(state.params, new_bn, opt_state, state.step + 1,
                          ema), metrics

    return step_fn


def metrics_to_host(metrics: dict) -> dict:
    """The step's metrics as Python floats, in one device fetch."""
    vals = torch.stack([metrics[k].float() for k in METRICS]).cpu().tolist()
    return dict(zip(METRICS, vals))


def make_eval_step(ir, *, compute_dtype=torch.bfloat16, folded: bool = False):
    """(variables, xv, xl) -> decoded predictions (bs, rows, no) fp32.
    ``variables``: unfolded (``graph.place_variables``), or with ``folded``
    BN-folded and placed (``graph.place_folded``)."""
    @torch.inference_mode()
    def fwd(variables, xv, xl=None):
        xv = _to_float(xv)
        xl = None if xl is None else _to_float(xl)
        if folded:
            io, _ = graph.apply_folded(ir, variables, xv, xl,
                                       compute_dtype=compute_dtype)
        else:
            (io, _), _ = graph.apply(ir, variables, xv, xl, train=False,
                                     compute_dtype=compute_dtype)
        return io.float()
    return fwd


def _to_float(x):
    """uint8 -> fp32 in [0, 1], by a true division on every device (CUDA
    turns a division by a Python scalar into a product with its
    reciprocal, one ulp off the CPU's quotient)."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / torch.full((), 255.0, device=x.device)
    return x
