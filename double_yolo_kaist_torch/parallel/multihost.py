"""Several processes: joining a group, rank-0 write gating, fixed-shape
gathers and the collectives of data-parallel training.

Counterpart of the JAX package's ``parallel/multihost.py``. Joining is
opt-in, as there: :func:`maybe_initialize_distributed` does nothing unless
``DYK_DISTRIBUTED=1`` is set or a coordinator is given, so one process
behaves as it always did. A process group is ``torch.distributed``'s:
NCCL for cards, gloo for the CPU. Launch one process a card with

    DYK_DISTRIBUTED=1 python -m torch.distributed.run --nproc_per_node N \\
        -m double_yolo_kaist_torch.train ...

:func:`is_main_process` gates every checkpoint, ``results.txt`` and
TensorBoard write. :func:`allgather_predictions` is an ``all_reduce`` of a
zeroed (W, ...) buffer in which each rank fills its row, so that it runs
on NCCL and on gloo with CPU or CUDA tensors (gloo has no CUDA
``all_gather``). :func:`all_reduce_sum` is differentiable: its backward
all-reduces the gradient, which is what the global BN statistics of
``models.layers.batch_norm`` need.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..utils import tree as TR


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def maybe_initialize_distributed(coordinator: str | None = None,
                                 num_processes: int | None = None,
                                 process_id: int | None = None,
                                 backend: str | None = None) -> bool:
    """Join a process group if asked to; a no-op otherwise (JAX
    multihost.py:24-52). True once this process is in a group.

    Triggered by ``coordinator`` or by ``DYK_DISTRIBUTED=1``. Without a
    coordinator the group forms through ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, which
    ``torch.distributed.run`` sets). ``coordinator``: ``host:port`` (TCP),
    or an ``init_method`` URL (``tcp://...``, ``file://...``).
    ``backend``: default NCCL where CUDA is available, else gloo. Under
    NCCL this process takes the card ``LOCAL_RANK`` names."""
    if _initialized():
        return True
    want = (coordinator is not None
            or os.environ.get("DYK_DISTRIBUTED", "0") == "1")
    if not want:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kwargs = {}
    if coordinator is not None:
        kwargs["init_method"] = (coordinator if "://" in coordinator
                                 else f"tcp://{coordinator}")
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend=backend, **kwargs)
    return True


def run_ranks(k: int, args: list, env: dict | None = None) -> int:
    """Run ``python *args`` in ``k`` processes that join one group through
    ``env://`` on a free local port (``DYK_DISTRIBUTED=1``, ``RANK`` =
    ``LOCAL_RANK`` = r, ``WORLD_SIZE`` = k, the port's package on
    ``PYTHONPATH``; ``env`` on top of this process's environment); each
    joins with :func:`maybe_initialize_distributed`. Returns 0 once every
    rank has exited 0, or the first failing rank's exit code, the others
    stopped then: no process outlives the call."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = dict(os.environ, **(env or {}), DYK_DISTRIBUTED="1",
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(k), PYTHONPATH=os.pathsep.join(
                    [root] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p]))
    procs = [subprocess.Popen([sys.executable, *args],
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(k)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    """True on the process that owns checkpoint, results and TensorBoard
    writes (rank 0, or a process in no group)."""
    return process_index() == 0


def data_group(enabled: bool = True):
    """The group data-parallel training runs over: the default group when
    it holds more than one process and ``enabled``, else None."""
    if enabled and process_count() > 1:
        return dist.group.WORLD
    return None


def backend_of(group) -> str:
    return str(dist.get_backend(group))


def collective_device(group, like: torch.device | None = None):
    """Where a collective's buffer lives: the current card under NCCL,
    else ``like`` (gloo reduces CPU and CUDA tensors), by default the
    CPU."""
    if backend_of(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return like if like is not None else torch.device("cpu")


def allgather_predictions(tree, group=None):
    """Every leaf with a leading process axis (W, ...), the same on every
    rank; the identity in one process (JAX multihost.py:63-72). Leaves
    are numpy arrays or tensors of one shape on every rank; numpy comes
    back as numpy, tensors on their device."""
    if process_count() == 1:
        return tree
    group = group or dist.group.WORLD
    w, r = dist.get_world_size(group), dist.get_rank(group)

    def gather(leaf):
        is_np = not isinstance(leaf, torch.Tensor)
        t = torch.from_numpy(np.ascontiguousarray(leaf)) if is_np else leaf
        was_bool = t.dtype == torch.bool
        if was_bool:
            t = t.to(torch.uint8)
        dev = collective_device(group, None if is_np else t.device)
        buf = torch.zeros((w,) + tuple(t.shape), dtype=t.dtype, device=dev)
        buf[r].copy_(t)
        dist.all_reduce(buf, group=group)
        if was_bool:
            buf = buf.bool()
        return buf.cpu().numpy() if is_np else buf.to(t.device)

    return TR.map_leaves(gather, tree)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable: the
    backward all-reduces the gradient, so that the sum of the ranks'
    losses gets the gradient of a statistic taken over all of them."""
    return _AllReduceSum.apply(x, group)


def exchange(table, outgoing: dict, group, ranks, me: int, device, *,
             p2p: bool) -> dict:
    """Point-to-point messages inside ``group``, whose members are the
    global ranks ``ranks`` (by their position in the group; ``me`` is this
    rank's position). ``table`` lists every message of the group as
    ``(src, dst, shape, dtype)`` by position, in one order that every
    member computes alike; ``outgoing`` holds ``{i: tensor}`` for the
    entries this rank sends. Returns ``{i: tensor}`` for the entries sent
    to it, on ``device`` (where this rank's tensors live).

    With ``p2p`` (the caller's choice for NCCL groups) the messages are
    ``dist.batch_isend_irecv`` pairs, queued on the card's stream with no
    host round trip; gloo runs them too for CPU tensors,
    which is how the CPU tests hold this path. gloo has no ``send`` /
    ``recv`` for CUDA tensors, so there the messages travel as one
    ``all_reduce`` of a zeroed byte buffer that holds every message of the
    group at its own offset, each written by its sender alone: a sum of
    one value and zeros is that value, bit for bit, in any dtype. That
    costs the group's size in bytes, but it is one collective an exchange
    and works for CPU and CUDA tensors alike (``allgather_predictions``
    gathers in the same way)."""
    if not table:
        return {}
    if p2p:
        ops, got = [], {}
        for i, (src, dst, shape, dtype) in enumerate(table):
            if src == me:
                ops.append(dist.P2POp(dist.isend,
                                      outgoing[i].contiguous(),
                                      ranks[dst], group=group))
            elif dst == me:
                got[i] = torch.empty(shape, dtype=dtype, device=device)
                ops.append(dist.P2POp(dist.irecv, got[i], ranks[src],
                                      group=group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return got
    sizes = [int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
             for _, _, shape, dtype in table]
    # each message at an offset aligned for any dtype's view
    starts = np.cumsum([0] + [-(-n // 8) * 8 for n in sizes]).tolist()
    buf = torch.zeros(starts[-1], dtype=torch.uint8, device=device)
    for i, t in outgoing.items():
        buf[starts[i]:starts[i] + sizes[i]].copy_(
            t.contiguous().reshape(-1).view(torch.uint8))
    dist.all_reduce(buf, group=group)
    return {i: buf[starts[i]:starts[i] + sizes[i]].view(dtype).reshape(shape)
            for i, (src, dst, shape, dtype) in enumerate(table)
            if dst == me}


def broadcast_tensors(tensors, group=None, src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s values."""
    group = group or dist.group.WORLD
    with torch.no_grad():
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            dev = collective_device(group, t.device)
            buf = t.detach().to(dev).contiguous()
            dist.broadcast(buf, src=src, group=group)
            t.copy_(buf)
