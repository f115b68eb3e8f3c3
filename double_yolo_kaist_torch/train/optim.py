"""Optimizers, the LR schedule and EMA of the reference's training recipe.

Counterpart of the JAX package's ``train/optim.py`` (reference
train.py:84-91, 133-137; distributed_utils.py:234-244), written out to
compute what its optax chain computes, in the same order:
  * a freeze mask zeroes the gradients of frozen layers *before* the
    decay, so weight decay and momentum still move a frozen leaf, as
    ``optax.masked(set_to_zero)`` in front of the chain does;
  * L2 weight decay is added to the gradient before momentum (torch's
    coupled decay, ``optax.add_decayed_weights``);
  * SGD is ``optax.trace(nesterov=True)``: t' = g + m t, update g + m t';
    Adam is ``optax.scale_by_adam(b1=momentum, b2=0.999, eps=1e-8)``;
  * the learning rate scales the result (``scale_by_learning_rate``), its
    schedule read at the count of *real* updates;
  * ``accumulate > 1`` is ``optax.MultiSteps``: a running mean of k
    gradients feeds the chain every k-th call, and only then does the
    chain's state advance.

The state has optax's nesting (tuples in place of its NamedTuples, param
trees as dicts), so that checkpoints hold it under the keys JAX's chain
flattens to and either package resumes the other's run. Param-shaped
buffers live on the params' device and are updated with ``torch._foreach``
ops; counts are int32 CPU scalars, so a step never waits on the device.

EMA mirrors the reference's ModelEMA (torch_utils.py:77-126): decay ramp
d = decay * (1 - exp(-updates / 2000)).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..utils import tree as TR


def cosine_epoch_schedule(lr0: float, lrf: float, epochs: int,
                          steps_per_epoch: int,
                          warmup: bool = True) -> Callable:
    """lr(step), an fp32 scalar: a per-epoch cosine from lr0 to lr0 * lrf
    (constant within an epoch, reference train.py:135-137) with linear
    warmup in epoch 0 from factor 1/1000 over min(1000, steps_per_epoch -
    1) steps (reference distributed_utils.py:234-244)."""
    warmup_iters = min(1000, max(steps_per_epoch - 1, 1))
    warmup_factor = 1.0 / 1000.0

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        epoch = torch.floor(step / steps_per_epoch)
        cos = ((1 + torch.cos(epoch * math.pi / epochs)) / 2) * (1 - lrf) \
            + lrf
        lr = lr0 * cos
        if warmup:
            alpha = torch.clamp(step / warmup_iters, 0.0, 1.0)
            wf = warmup_factor * (1 - alpha) + alpha
            lr = torch.where(step < warmup_iters, lr * wf, lr)
        return lr

    return schedule


def _count(n: int = 0) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


def _zeros_like(tree):
    return TR.map_leaves(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         tree)


class Optimizer:
    """The port's ``make_optimizer`` chain: ``init(params)`` -> state and
    ``update(grads, state, params)`` -> (updates or None, new state).

    ``grads`` and ``params`` are flat lists in ``tree.leaves(params)``
    order; ``updates`` is such a list, or None when nothing moves (an
    accumulation step that does not emit). Param-shaped state buffers are
    written in place; the returned state holds them."""

    def __init__(self, hyp: dict, schedule, sgd: bool = False,
                 freeze_mask=None, accumulate: int = 1):
        self.wd = hyp.get("weight_decay", 0.0)
        self.mom = hyp.get("momentum", 0.937)
        self.schedule = schedule
        self.sgd = sgd
        self.freeze_mask = freeze_mask
        self.accumulate = accumulate

    # ----------------------------------------------------------------- state

    def _core_init(self, params):
        if self.sgd:
            return ((), (_zeros_like(params),), (_count(),))
        return ((), (_count(), _zeros_like(params), _zeros_like(params)),
                (_count(),))

    def _inner_init(self, params):
        core = self._core_init(params)
        return core if self.freeze_mask is None else (((),), core)

    def init(self, params):
        inner = self._inner_init(params)
        if self.accumulate > 1:
            return (_count(), _count(), inner, _zeros_like(params), ())
        return inner

    # ---------------------------------------------------------------- update

    def _core_update(self, g, core, p):
        _, moments, (lr_count,) = core
        # add_decayed_weights: g + wd * p
        g = torch._foreach_add(g, torch._foreach_mul(p, self.wd))
        if self.sgd:
            (trace,) = moments
            t = TR.leaves(trace)
            new_t = torch._foreach_add(g, torch._foreach_mul(t, self.mom))
            u = torch._foreach_add(g, torch._foreach_mul(new_t, self.mom))
            torch._foreach_copy_(t, new_t)
            moments = (trace,)
        else:
            count, mu_t, nu_t = moments
            mu, nu = TR.leaves(mu_t), TR.leaves(nu_t)
            b1, b2 = self.mom, 0.999
            new_mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                        torch._foreach_mul(mu, b1))
            new_nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                torch._foreach_mul(nu, b2))
            count = count + 1
            c = count.to(torch.float32)
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** c)
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** c)
            den = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(new_nu, bc2)), 1e-8)
            u = torch._foreach_div(torch._foreach_div(new_mu, bc1), den)
            torch._foreach_copy_(mu, new_mu)
            torch._foreach_copy_(nu, new_nu)
            moments = (count, mu_t, nu_t)
        step_size = float(-self.schedule(lr_count))
        u = torch._foreach_mul(u, step_size)
        return u, ((), moments, (lr_count + 1,))

    def _inner_update(self, g, inner, p):
        if self.freeze_mask is None:
            return self._core_update(g, inner, p)
        masked, core = inner
        g = [gi if keep else torch.zeros_like(gi)
             for gi, keep in zip(g, TR.leaves(self.freeze_mask))]
        u, core = self._core_update(g, core, p)
        return u, (masked, core)

    def update(self, grads, state, params):
        grads = list(grads)
        if self.accumulate <= 1:
            return self._inner_update(grads, state, params)
        mini, gstep, inner, acc_t, skip = state
        n_acc = int(mini)
        acc = TR.leaves(acc_t)
        # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
        new_acc = torch._foreach_add(
            acc, torch._foreach_div(torch._foreach_sub(grads, acc),
                                    float(n_acc + 1)))
        updates = None
        if n_acc == self.accumulate - 1:
            updates, inner = self._inner_update(new_acc, inner, params)
            for a in acc:
                a.zero_()
            gstep = gstep + 1
        else:
            torch._foreach_copy_(acc, new_acc)
        mini = _count((n_acc + 1) % self.accumulate)
        return updates, (mini, gstep, inner, acc_t, skip)


def make_optimizer(hyp: dict, schedule, sgd: bool = False,
                   freeze_mask=None, accumulate: int = 1) -> Optimizer:
    """The optimizer of the reference recipe (JAX train/optim.py:48-75).
    ``freeze_mask``: a tree of bools shaped like the params, True = train
    (reference --freeze-layers, train.py:77-82); ``accumulate``: micro-
    batches per update (reference train.py:37)."""
    return Optimizer(hyp, schedule, sgd=sgd, freeze_mask=freeze_mask,
                     accumulate=accumulate)


def freeze_mask_by_layer(params: dict, max_frozen_layer: int) -> dict:
    """True = trainable. Freezes layers l0..l{max_frozen_layer} (reference
    --freeze-layers semantics, train.py:77-82)."""
    return {k: TR.map_leaves(lambda _, k=k: int(k[1:]) > max_frozen_layer, v)
            for k, v in params.items()}


# ------------------------------------------------------------------------ EMA

def ema_init(params):
    """A detached copy of the params and an update count."""
    return {"params": TR.map_leaves(lambda p: p.detach().clone(), params),
            "updates": _count()}


def ema_update(ema, params, decay: float = 0.9999):
    """e <- e d + (1 - d) p with d = decay (1 - exp(-updates / 2000)),
    d in fp32 as JAX computes it; the EMA buffers are written in place."""
    updates = ema["updates"] + 1
    d = decay * (1 - torch.exp(-updates.to(torch.float32) / 2000.0))
    e = TR.leaves(ema["params"])
    torch._foreach_mul_(e, float(d))
    torch._foreach_add_(e, torch._foreach_mul(
        [p.detach() for p in TR.leaves(params)], float(1 - d)))
    return {"params": ema["params"], "updates": updates}
