"""The training and evaluation steps.

Counterpart of the JAX package's ``train/step.py``: one optimizer step is
the unfolded forward in ``compute_dtype`` (fp32 params, each kernel cast
to the activations' dtype at its use, BN statistics in fp32), the fixed-
shape loss, the backward (fp32 gradients through the casts), the
optimizer update and the EMA. The casts are explicit, as JAX makes them,
not ``autocast``'s.

Several steps per dispatch (:func:`make_multi_step`,
:func:`make_fused_multi_step`; JAX's ``lax.scan`` over K steps in one
program) are, on CUDA, one CUDA graph of the whole step (forward, loss,
backward, optimizer and EMA, the state updated in place) replayed K times
(:class:`CapturedSteps`); on the CPU, K eager steps. The fused call's
``double_buffer`` augments batch i + 1 on a side stream while step i
replays.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .. import resolve_device
from ..cuda_graphs import replay
from ..ops import _build
from ..models import graph
from ..parallel import multihost as MH
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
                    remat_segments: int = 0, group=None, space=None):
    """(state, batch, rng) -> (new state, metrics): one optimizer step.

    batch: {"v": (B, H, W, 3), "l": (B, H, W, 3) [dual-stream only],
    "targets": (B, T, 5), "tmask": (B, T)}, images uint8 or float in
    [0, 1] on the params' device. ``rng``: a torch.Generator for dropout,
    or None. The metrics (``METRICS``) are fp32 scalars on the device;
    ``grad_norm`` is the norm of the raw gradients, before the freeze mask
    and the decay. The params are updated in place.

    ``group``: data parallelism over a ``torch.distributed`` group whose
    ranks each step on an equal share of the global batch: BN and the
    loss take the global batch's statistics and normalisers, each rank's
    loss is its share of the global loss, and the gradients and loss
    terms are summed over the ranks in one all-reduce of one flat buffer
    before the update, so every rank applies the global batch's step and
    reports its metrics (JAX's jitted step over a sharded batch).

    ``space``: a :class:`..parallel.spatial.SpaceShard` (a (data, space)
    mesh): the batch is this rank's part of the global batch
    (``spatial.local_batch``: its data shard's images cut to its band of
    rows, their labels whole); the forward runs on the band, each rank's
    loss is its share of the global loss (``loss.compute_loss(space=)``)
    and the sums run over every rank of the mesh (``group`` is then
    ``space.world``). Such steps run eagerly."""
    specs = LS.head_specs(ir)
    if space is not None:
        group = space.world

    def step_fn(state: TrainState, batch: dict, rng=None):
        tx.ensure_lr_table(state.step + 1)
        xv = _to_float(batch["v"])
        xl = _to_float(batch["l"]) if "l" in batch else None
        leaves = TR.leaves(state.params)
        raws, new_bn = graph.apply(
            ir, {"params": state.params, "state": state.bn_state}, xv, xl,
            train=True, rng=rng, compute_dtype=compute_dtype,
            remat_segments=remat_segments, group=group, space=space)
        ld = LS.compute_loss(raws, batch["targets"], batch["tmask"], specs,
                             hyp, gr, group=group, space=space)
        total = LS.total_loss(ld)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        if group is not None:
            grads, ld, total = _sum_over_ranks(grads, ld, group)
        with torch.no_grad():
            gnorm = global_norm(grads)
            updates, opt_state = tx.update(grads, state.opt_state, leaves)
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


def _sum_over_ranks(grads, ld, group):
    """The gradients and loss terms summed over ``group``'s ranks, in one
    all-reduce of one flat buffer (one collective a step, inside a
    captured step's graph under NCCL)."""
    names = list(ld)
    parts = [g.reshape(-1) for g in grads] + [ld[k].detach().reshape(1)
                                              for k in names]
    dtype = parts[0].dtype
    for p in parts[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    flat = torch.cat([p.to(dtype) for p in parts])
    torch.distributed.all_reduce(flat, group=group)
    out = list(flat.split([p.numel() for p in parts]))
    grads = [o.view(g.shape).to(g.dtype) for o, g in zip(out, grads)]
    ld = {k: o.reshape(()).to(ld[k].dtype)
          for k, o in zip(names, out[len(grads):])}
    return grads, ld, LS.total_loss(ld)


def metrics_to_host(metrics: dict) -> dict:
    """The step's metrics as Python floats, in one device fetch; of stacked
    metrics (several steps), the last step's (JAX's ``ravel()[-1]``)."""
    vals = torch.stack([metrics[k].float().reshape(-1)[-1]
                        for k in METRICS]).cpu().tolist()
    return dict(zip(METRICS, vals))


# ------------------------------------------------------ several steps a call

# warm-up runs of a step on a side stream before it is captured (the state
# is put back after them)
WARMUP_STEPS = 2


class _StepGraph:
    """One captured step: the graph, its static batch buffers, the state
    trees it updates in place, and its metrics output."""

    def __init__(self, graph, batch, state, metrics, table, rng, launches):
        self.graph = graph
        self.batch = batch
        self.state = state
        self.metrics = metrics
        self.table = table
        self.rng = rng
        self.launches = launches

    def adopt(self, state: TrainState) -> None:
        """Copy the values of ``state`` into the graph's own tensors where
        they are other tensors (a state loaded from a checkpoint, or moved
        on by eager steps)."""
        mine, theirs = [], []
        for a, b in zip(_state_leaves(self.state), _state_leaves(state)):
            if a is not b:
                mine.append(a)
                theirs.append(b)
        if mine:
            with torch.no_grad():
                torch._foreach_copy_(mine, theirs)


def _state_leaves(state: TrainState) -> list:
    return (TR.leaves(state.params) + TR.leaves(state.bn_state)
            + TR.leaves(state.opt_state) + TR.leaves(state.ema))


class CapturedSteps:
    """Optimizer steps replayed from CUDA graphs: one graph per batch
    signature (the names, shapes and dtypes of a batch's tensors), of the
    whole of ``step_fn`` on static batch buffers, the state updated in
    place (:class:`.optim.Optimizer`), BN
    statistics copied into their buffers. Before capture the step runs
    :data:`WARMUP_STEPS` times on a side stream, as ``serving.capture``
    does, and the state and ``rng`` are put back, so a replay is exactly
    the eager step that would have run. A failed capture raises; nothing
    falls back to eager steps.

    ``rng``: a CUDA generator for dropout, registered with each graph so
    that every replay draws new masks, or None."""

    def __init__(self, step_fn, tx, group=None):
        self.step_fn = step_fn
        self.tx = tx
        self.group = group
        self.graphs: dict = {}
        self.pool = None
        self.replays = 0
        self.side = None         # the double buffer's stream

    def _capture(self, state: TrainState, batch: dict, rng) -> _StepGraph:
        dev = next(iter(batch.values())).device
        if self.group is not None:
            backend = MH.backend_of(self.group)
            if backend != "nccl":
                raise RuntimeError(
                    f"several steps a dispatch capture the step's "
                    f"collectives in a CUDA graph, which the {backend} "
                    f"backend cannot do: train with NCCL, or with "
                    f"steps_per_dispatch=1")
        static_batch = {k: v.clone() for k, v in batch.items()}
        static = TrainState(state.params, state.bn_state, state.opt_state,
                            state.step, state.ema)
        bn = TR.leaves(state.bn_state)
        kept = _state_leaves(static)

        def body():
            new, m = self.step_fn(static, static_batch, rng)
            torch._foreach_copy_(bn, TR.leaves(new.bn_state))
            moved = [(a, b) for t in ("params", "opt_state", "ema")
                     for a, b in zip(TR.leaves(getattr(new, t)),
                                     TR.leaves(getattr(static, t)))]
            if any(a is not b for a, b in moved):
                raise RuntimeError("a captured step must update the state "
                                   "in place")
            return torch.stack([m[k].float() for k in METRICS])

        saved = [t.detach().clone() for t in kept]
        rng_state = None if rng is None else rng.get_state()
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                body()
        current.wait_stream(side)
        with torch.no_grad():
            torch._foreach_copy_(kept, saved)
        if rng is not None:
            rng.set_state(rng_state)
        del saved
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = dict(_build.launches)
        graph = torch.cuda.CUDAGraph()
        if rng is not None:
            graph.register_generator_state(rng)
        with torch.cuda.graph(graph, pool=self.pool):
            metrics = body()
        held = {k: n - before.get(k, 0) for k, n in _build.launches.items()
                if n != before.get(k, 0)}
        for name, n in held.items():
            _build.launches[name] -= n
        return _StepGraph(graph, static_batch, static, metrics,
                          self.tx.lr_table, rng, held)

    def __call__(self, state: TrainState, batch_at, k: int, rng=None,
                 double_buffer: bool = False):
        """K steps: ``batch_at(i)`` gives step i's batch. Returns (state,
        stacked metrics (K,) a name).

        ``double_buffer``: ``batch_at(i + 1)`` is launched on a side stream
        just after step i's replay, and runs while it does (it waits only
        for batch i's copy into the graph's buffers, an event on this
        stream; its outputs are marked as used by this stream,
        ``record_stream``); it is copied into the buffers after that
        replay. The batches, and so the steps, are the plain loop's."""
        self.tx.ensure_lr_table(state.step + k)
        first = batch_at(0)
        sig = tuple((name, tuple(v.shape), v.dtype)
                    for name, v in sorted(first.items()))
        g = self.graphs.get(sig)
        if g is None or g.table is not self.tx.lr_table or g.rng is not rng:
            g = self.graphs[sig] = self._capture(state, first, rng)
        g.adopt(state)
        dev = g.metrics.device
        out = torch.empty((k, len(METRICS)), dtype=torch.float32,
                          device=dev)
        main = torch.cuda.current_stream(dev)
        if double_buffer and self.side is None:
            self.side = torch.cuda.Stream(dev)
        batch = first
        for i in range(k):
            for name, buf in g.batch.items():
                buf.copy_(batch[name], non_blocking=True)
            ahead = double_buffer and i + 1 < k
            if ahead:
                copied = torch.cuda.Event()
                copied.record(main)
            replay(g.graph, g.launches)
            self.replays += 1
            out[i].copy_(g.metrics)
            if ahead:
                # launched while the replay runs: the host's launches of
                # the augment and its kernels overlap the step's
                self.side.wait_event(copied)
                with torch.cuda.stream(self.side):
                    batch = batch_at(i + 1)
                    for t in batch.values():
                        t.record_stream(main)
                ready = torch.cuda.Event()
                ready.record(self.side)
                main.wait_event(ready)
            elif i + 1 < k:
                batch = batch_at(i + 1)
        st = g.state
        return (TrainState(st.params, st.bn_state, st.opt_state,
                           state.step + k, st.ema),
                {name: out[:, j] for j, name in enumerate(METRICS)})


def _eager_steps(step_fn, state: TrainState, batch_at, k: int, rng=None,
                 double_buffer: bool = False):
    """K eager steps; ``double_buffer``: batch i + 1 is made before step
    i runs (the CPU's form of the fused call's double buffer)."""
    ms = []
    batch = batch_at(0)
    for i in range(k):
        nxt = batch_at(i + 1) if double_buffer and i + 1 < k else None
        state, m = step_fn(state, batch, rng)
        ms.append(m)
        if i + 1 < k:
            batch = nxt if nxt is not None else batch_at(i + 1)
    return state, {name: torch.stack([m[name] for m in ms])
                   for name in METRICS}


def _on_cuda(state: TrainState) -> bool:
    leaves = TR.leaves(state.params)
    return bool(leaves) and leaves[0].is_cuda


def make_multi_step(ir, hyp: dict, tx, *, gr: float = 1.0,
                    compute_dtype=torch.bfloat16, ema_decay: float = 0.9999,
                    remat_segments: int = 0, group=None, space=None):
    """K optimizer steps a call (JAX step.py:103-133):
    (state, batches, rng) -> (state, stacked metrics), where every leaf of
    ``batches`` has a leading K axis and each metric comes back as (K,).

    On CUDA the step is captured once per batch signature as a CUDA graph
    and replayed K times, each replay on the next batch copied into its
    static buffers (:class:`CapturedSteps`, kept as ``fn.captured``); the
    metrics stay on the device until the caller fetches them. On the CPU it
    runs K eager steps of :func:`make_train_step`. ``rng``: as for
    :func:`make_train_step` (on CUDA a CUDA generator, or None).

    ``group``: as for :func:`make_train_step`. Under NCCL the collectives
    are captured in the step's graph (the warm-up steps before capture run
    them too); gloo's cannot be captured, so on CUDA a gloo group
    raises.

    ``space``: as for :func:`make_train_step`; K = 1 a call only (K > 1
    raises: a captured 2-D step is an open item of ROADMAP.md)."""
    step_fn = make_train_step(ir, hyp, tx, gr=gr,
                              compute_dtype=compute_dtype,
                              ema_decay=ema_decay,
                              remat_segments=remat_segments, group=group,
                              space=space)
    captured = CapturedSteps(step_fn, tx, group)

    def multi(state: TrainState, batches: dict, rng=None):
        k = next(iter(batches.values())).shape[0]
        if space is not None and k > 1:
            raise ValueError(
                f"{k} steps a dispatch on a (data, space) mesh: the 2-D "
                f"path runs its steps eagerly, one a call; capturing its "
                f"halo exchanges is an open item of ROADMAP.md")

        def batch_at(i):
            return {name: v[i] for name, v in batches.items()}

        if _on_cuda(state):
            return captured(state, batch_at, k, rng)
        return _eager_steps(step_fn, state, batch_at, k, rng)

    multi.captured = captured
    multi.step_fn = step_fn
    return multi


def augment_generator(seed: int, b0: int) -> torch.Generator:
    """The augment generator of the batch at offset ``b0`` of an epoch
    seeded ``seed``, as :func:`..data.pipeline.train_batches` seeds it."""
    return torch.Generator().manual_seed(int(seed) * 1_000_003 + int(b0))


def make_fused_multi_step(ir, hyp: dict, tx, aug_fn, *, gr: float = 1.0,
                          compute_dtype=torch.bfloat16,
                          ema_decay: float = 0.9999, remat_segments: int = 0,
                          images_in: bool = False, multi_step=None,
                          group=None, double_buffer: bool = False):
    """K steps a call with the augmentation in the same call (JAX
    step.py:136-238).

    ``aug_fn``: :func:`..data.pipeline.make_train_augment_fn` with
    ``from_pool=not images_in``. The call is
    ``(state, pool_v, pool_l, xs, aug_seed, rng)`` with ``xs = {"b0": (K,),
    "load": (K, 4B), "targets": (K, B, T, 5), "tmask": (K, B, T)}``, or
    with ``images_in`` ``(state, xs, aug_seed, rng)`` where ``xs`` holds
    the gathered source rows ``"v_u8"`` / ``"l_u8"`` (K, 4B, H, W, 3) in
    place of ``"load"``. Step k's augment generator is seeded from
    ``aug_seed`` and ``b0[k]`` exactly as ``train_batches`` seeds it
    (:func:`augment_generator`), so fused equals unfused. On CUDA each
    batch is augmented on the device as the step before it replays (the
    augment draws its randoms on the host) and the step is the captured
    graph of :func:`make_multi_step`; on the CPU, K eager steps.
    ``multi_step``: a :func:`make_multi_step` function whose step and
    graphs to share (the fused calls of several sizes then capture into
    one memory pool); by default a new one, over ``group``. Under data
    parallelism ``aug_fn`` is made with the rank's ``shard``: the call
    takes the global batches' plans and each rank steps on its rows.

    ``double_buffer`` (the pool path only, as in JAX: with ``images_in``
    it raises): on CUDA, batch i + 1 is augmented on a side stream while
    the captured step of batch i replays, and copied into the graph's
    batch buffers after it (:class:`CapturedSteps`); on the CPU, the
    augment of batch i + 1 runs before step i. The batches, generators
    and step order are the plain fused path's, so the two train alike."""
    if double_buffer and images_in:
        raise ValueError("double_buffer is a pool-path experiment; "
                         "combine it with images_in once it has a reason "
                         "to exist there")
    multi = multi_step or make_multi_step(
        ir, hyp, tx, gr=gr, compute_dtype=compute_dtype,
        ema_decay=ema_decay, remat_segments=remat_segments, group=group)

    def run(state, xs, aug_seed, rng, rows_at):
        k = len(xs["b0"])
        dev = xs["targets"].device

        def batch_at(i):
            gen = augment_generator(aug_seed, int(xs["b0"][i]))
            return aug_fn(gen, *rows_at(i), xs["targets"][i].to(dev),
                          xs["tmask"][i].to(dev))

        if _on_cuda(state):
            return multi.captured(state, batch_at, k, rng,
                                  double_buffer=double_buffer)
        return _eager_steps(multi.step_fn, state, batch_at, k, rng,
                            double_buffer=double_buffer)

    if images_in:
        def fused(state, xs, aug_seed, rng=None):
            return run(state, xs, aug_seed, rng,
                       lambda i: (xs["v_u8"][i], xs["l_u8"][i]))
    else:
        def fused(state, pool_v, pool_l, xs, aug_seed, rng=None):
            return run(state, xs, aug_seed, rng,
                       lambda i: (pool_v, pool_l, xs["load"][i]))

    fused.captured = multi.captured
    return fused


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
