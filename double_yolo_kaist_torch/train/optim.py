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
ops.

The state lives on the params' device and a step reads none of it on
the host: every count is an int32 tensor updated in place, the learning
rate is read from a device table of the schedule's values (each entry the
fp32 the schedule gives for that count), the bias corrections and the EMA
decay are computed as tensors, and accumulation is a masked update
(``torch.where`` on a device flag, as ``optax.MultiSteps`` runs under
``jit``). So the whole step can be captured in a CUDA graph
(:func:`.step.make_multi_step`) and each replay moves the state on; the
CPU runs the same code.

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

    def table(n: int) -> torch.Tensor:
        """(n,) fp32: entry i is ``schedule(i)``, bit for bit. Past the
        warmup the value depends only on the fp32 epoch, so one call per
        epoch value serves every step of it."""
        out = torch.empty(n, dtype=torch.float32)
        w = min(n, warmup_iters) if warmup else 0
        for i in range(w):
            out[i] = schedule(i)
        if n > w:
            ep = torch.floor(torch.arange(w, n, dtype=torch.float32)
                             / steps_per_epoch)
            vals, inv = torch.unique_consecutive(ep, return_inverse=True)
            first = torch.zeros(len(vals), dtype=torch.long)
            first[inv.flip(0)] = torch.arange(len(ep) - 1, -1, -1)
            out[w:] = torch.stack([schedule(w + int(i))
                                   for i in first])[inv]
        return out

    schedule.table = table
    schedule.horizon = epochs * steps_per_epoch + 1
    return schedule


def lr_table(schedule, n: int) -> torch.Tensor:
    """(n,) fp32 values of ``schedule`` at 0..n-1, each the float the host
    schedule gives (``schedule.table`` where the schedule has one)."""
    fn = getattr(schedule, "table", None)
    if fn is not None:
        return fn(n)
    return torch.stack([torch.as_tensor(schedule(i), dtype=torch.float32)
                        for i in range(n)])


def _count(n: int = 0, device=None) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=device)


def _zeros_like(tree):
    """fp32 zeros shaped like each leaf (float64 for float64 leaves, as
    optax's state follows the params under ``jax_enable_x64``)."""
    return TR.map_leaves(lambda p: torch.zeros_like(
        p, dtype=torch.promote_types(p.dtype, torch.float32)), tree)


class Optimizer:
    """The port's ``make_optimizer`` chain: ``init(params)`` -> state and
    ``update(grads, state, params)`` -> (updates, new state).

    ``grads`` and ``params`` are flat lists in ``tree.leaves(params)``
    order; ``updates`` is such a list, zeros on an accumulation step that
    does not emit. The state is written in place; the returned state holds
    the same tensors."""

    def __init__(self, hyp: dict, schedule, sgd: bool = False,
                 freeze_mask=None, accumulate: int = 1):
        self.wd = hyp.get("weight_decay", 0.0)
        self.mom = hyp.get("momentum", 0.937)
        self.schedule = schedule
        self.sgd = sgd
        self.freeze_mask = freeze_mask
        self.accumulate = accumulate
        self.lr_table = None

    # ----------------------------------------------------------------- state

    def _core_init(self, params, dev):
        if self.sgd:
            return ((), (_zeros_like(params),), (_count(0, dev),))
        return ((), (_count(0, dev), _zeros_like(params),
                     _zeros_like(params)), (_count(0, dev),))

    def _inner_init(self, params, dev):
        core = self._core_init(params, dev)
        return core if self.freeze_mask is None else (((),), core)

    def init(self, params):
        leaves = TR.leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        self.ensure_lr_table(getattr(self.schedule, "horizon", 1024), dev)
        inner = self._inner_init(params, dev)
        if self.accumulate > 1:
            return (_count(0, dev), _count(0, dev), inner,
                    _zeros_like(params), ())
        return inner

    def ensure_lr_table(self, n: int, device=None) -> None:
        """Make the device table of learning rates hold at least ``n``
        counts (doubling it as needed). A step that reads past it would
        read the last entry, so a caller about to run up to ``n`` updates
        asks first; a table that grows is a new tensor, so graphs captured
        on the old one are captured again (:func:`.step.make_multi_step`)."""
        have = 0 if self.lr_table is None else len(self.lr_table)
        if have >= n:
            return
        device = device if device is not None else self.lr_table.device
        size = max(int(n), 2 * have, 16)
        self.lr_table = lr_table(self.schedule, size).to(device)

    # ---------------------------------------------------------------- update

    def _lr(self, lr_count):
        """-lr at ``lr_count``, a 0-dim tensor read from the table."""
        n = len(self.lr_table)
        idx = torch.clamp(lr_count, max=n - 1).reshape(1).long()
        return -torch.index_select(self.lr_table, 0, idx).reshape(())

    def _core_update(self, g, core, p, emit=None):
        """One step of the core chain. The state is written in place, and
        with ``emit`` (a device bool) only where ``emit`` holds; updates are
        zero where it does not."""
        _, moments, (lr_count,) = core
        # add_decayed_weights: g + wd * p
        g = torch._foreach_add(g, torch._foreach_mul(p, self.wd))
        if self.sgd:
            (trace,) = moments
            t = TR.leaves(trace)
            new_t = torch._foreach_add(g, torch._foreach_mul(t, self.mom))
            u = torch._foreach_add(g, torch._foreach_mul(new_t, self.mom))
            _commit(t, new_t, emit)
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
            c = (count + 1).to(torch.float32)
            bc1 = 1 - torch.full((), b1, dtype=torch.float32,
                                 device=c.device) ** c
            bc2 = 1 - torch.full((), b2, dtype=torch.float32,
                                 device=c.device) ** c
            den = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(new_nu, bc2)), 1e-8)
            u = torch._foreach_div(torch._foreach_div(new_mu, bc1), den)
            _commit(mu, new_mu, emit)
            _commit(nu, new_nu, emit)
            count.add_(1 if emit is None else emit.to(count.dtype))
            moments = (count, mu_t, nu_t)
        u = torch._foreach_mul(u, self._lr(lr_count))
        lr_count.add_(1 if emit is None else emit.to(lr_count.dtype))
        if emit is not None:
            zero = torch.zeros((), dtype=u[0].dtype, device=emit.device)
            u = [torch.where(emit, ui, zero) for ui in u]
        return u, ((), moments, (lr_count,))

    def _inner_update(self, g, inner, p, emit=None):
        if self.freeze_mask is None:
            return self._core_update(g, inner, p, emit)
        masked, core = inner
        g = [gi if keep else torch.zeros_like(gi)
             for gi, keep in zip(g, TR.leaves(self.freeze_mask))]
        u, core = self._core_update(g, core, p, emit)
        return u, (masked, core)

    def update(self, grads, state, params):
        """With ``accumulate > 1``, ``optax.MultiSteps``: every call runs
        the chain on the running mean of the gradients and keeps its result
        only where ``mini`` has reached ``accumulate - 1``; the updates are
        zero elsewhere."""
        grads = list(grads)
        if self.accumulate <= 1:
            return self._inner_update(grads, state, params)
        mini, gstep, inner, acc_t, skip = state
        acc = TR.leaves(acc_t)
        new_acc = torch._foreach_add(
            acc, torch._foreach_div(torch._foreach_sub(grads, acc),
                                    (mini + 1).to(torch.float32)))
        emit = mini == self.accumulate - 1
        updates, inner = self._inner_update(new_acc, inner, params, emit)
        zero = torch.zeros((), dtype=torch.float32, device=emit.device)
        torch._foreach_copy_(acc, [torch.where(emit, zero, a)
                                   for a in new_acc])
        gstep.add_(emit.to(gstep.dtype))
        mini.copy_(torch.remainder(mini + 1, self.accumulate))
        return updates, (mini, gstep, inner, acc_t, skip)


def _commit(dst, new, emit) -> None:
    """Write ``new`` into the buffers ``dst``, where ``emit`` holds (all of
    them when it is None)."""
    if emit is None:
        torch._foreach_copy_(dst, new)
    else:
        torch._foreach_copy_(dst, [torch.where(emit, n, d)
                                   for n, d in zip(new, dst)])


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
    """A detached copy of the params and an update count on their
    device."""
    leaves = TR.leaves(params)
    dev = leaves[0].device if leaves else None
    return {"params": TR.map_leaves(lambda p: p.detach().clone(), params),
            "updates": _count(0, dev)}


def ema_update(ema, params, decay: float = 0.9999):
    """e <- e d + (1 - d) p with d = decay (1 - exp(-updates / 2000)),
    d in fp32 as JAX computes it, as a tensor; the EMA buffers and the
    count are written in place."""
    updates = ema["updates"] + 1
    d = decay * (1 - torch.exp(-updates.to(torch.float32) / 2000.0))
    e = TR.leaves(ema["params"])
    ps = [p.detach() for p in TR.leaves(params)]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, torch._foreach_mul(ps, 1 - d))
    ema["updates"].copy_(updates)
    return {"params": ema["params"], "updates": ema["updates"]}
