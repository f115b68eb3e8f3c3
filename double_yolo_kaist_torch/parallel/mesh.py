"""A device mesh for data-parallel inference in one process.

Counterpart of the JAX package's ``parallel/mesh.py``. There a 1-D
``("data",)`` mesh spans the devices, ``jax.jit`` shards the batch over
it and replicates the variables. Here a :class:`Mesh` is the list of
devices the replicas run on: the variables are copied to each replica's
device once (:func:`replicate`), a batch is split into equal shards, one
a replica (:func:`shard_batch`), each replica runs its shard, and the
outputs are concatenated in order. Per-image inference needs no
collective, so a mesh run equals the single-device run wherever each
replica runs the shapes the single run does.

A mesh may name one device more than once: two replicas on one card (or
on the CPU), the counterpart of JAX's
``--xla_force_host_platform_device_count``. Training over several cards
is :mod:`.multihost`'s: one process a card under ``torch.distributed``.

A mesh of more than one axis, e.g. ``("data", "space")``, serves one
replica a row of its first axis, as JAX shards a request over
``mesh.axis_names[0]`` alone and replicates it over the others: the
replica runs on the first device of its row (:attr:`Mesh.replicas`).
Splitting the images' rows over the other axis is training's, one
process a device (:mod:`.spatial`).

JAX's ``batch_sharding`` / ``replicated`` name shardings for
``jax.device_put``; the port has no sharding objects, and
:func:`shard_batch` and :func:`replicate` do their work directly.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import resolve_device
from ..utils import tree as TR


class Mesh:
    """Devices on named axes. ``devices`` is a numpy object array of
    ``torch.device`` of shape ``shape``; the first axis is the batch
    axis."""

    def __init__(self, devices, axis_names=("data",), shape=None):
        devs = [_indexed(resolve_device(d)) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if shape is None:
            shape = (len(devs),) + (1,) * (len(axis_names) - 1)
        shape = tuple(int(s) for s in shape)
        if int(np.prod(shape)) != len(devs):
            raise ValueError(f"mesh shape {shape} != {len(devs)} devices")
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{tuple(axis_names)}")
        arr = np.empty(len(devs), dtype=object)
        arr[:] = devs
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        """Replicas: the length of the batch axis."""
        return self.shape[self.axis_names[0]]

    @property
    def replicas(self) -> list:
        """The device of each replica, in batch order: the first device of
        each row of the batch axis, ``size`` of them."""
        return list(self.devices.reshape(self.size, -1)[:, 0])

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"axis_names={self.axis_names}, shape={self.devices.shape})")


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that one card has one name."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None, axis_names=("data",), shape=None) -> Mesh:
    """A mesh over ``devices`` (torch devices or their names), by default
    every visible card on one ``"data"`` axis. Without CUDA the devices
    must be given: the port never falls back to the CPU on its own, and a
    ``cuda`` entry raises as :func:`..resolve_device` does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass the mesh's devices, e.g. "
                "make_mesh(['cpu', 'cpu']), to run replicas on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices, axis_names, shape)


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself, or a ``TypeError`` when it is not a :class:`Mesh`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def device_scope(dev: torch.device):
    """A context in which ``dev`` is the current card (kernels and CUDA
    graphs launch on the current device's stream); nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def shard_batch(batch: dict, mesh: Mesh, batch_dim: int = 0) -> list:
    """One dict a replica: every tensor of ``batch`` split into
    ``mesh.size`` equal parts along ``batch_dim`` (0 for (B, ...)
    batches, 1 for (K, B, ...) stacked ones), part r on replica r's
    device. The batch must divide evenly (pad it first)."""
    n = mesh.size
    out = [{} for _ in range(n)]
    for name, v in batch.items():
        b = v.shape[batch_dim]
        if b % n:
            raise ValueError(f"{name}: batch {b} does not split over "
                             f"{n} replicas")
        for r, (part, dev) in enumerate(zip(v.chunk(n, dim=batch_dim),
                                            mesh.replicas)):
            out[r][name] = part.to(dev)
    return out


def per_device(devices, make) -> list:
    """``make(device)`` for each of ``devices`` (a mesh's replicas), called
    once a distinct device: replicas that share a device share what it
    returns (inference only reads it)."""
    made: dict = {}
    for dev in devices:
        if dev not in made:
            made[dev] = make(dev)
    return [made[dev] for dev in devices]


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` (a tree of tensors) a replica, on its device,
    shared by the replicas of one device (:func:`per_device`)."""
    return per_device(mesh.replicas, lambda dev: TR.map_leaves(
        lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t, tree))


def pad_to_multiple(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows appended along dim 0 up to a multiple of
    ``n`` (JAX's evaluator pads a partial batch so)."""
    extra = -x.shape[0] % n
    if not extra:
        return x
    return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])
