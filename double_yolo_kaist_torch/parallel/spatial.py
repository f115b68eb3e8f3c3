"""Data x space sharding: the images split over the batch and over their
rows, one process a position of a (data, space) mesh.

Counterpart of the JAX package's 2-D mesh (``parallel/mesh.make_mesh(
axis_names=("data", "space"), shape=(D, S))`` with the images placed as
``P("data", "space")`` and the labels as ``P("data")``,
``tests/test_spatial_sharding.py``). There GSPMD inserts the halo
exchanges; here they are written by hand.

A mesh of shape (D, S) is D*S processes of one ``torch.distributed``
group. Rank ``r = d*S + s`` holds rows ``[s*H/S, (s+1)*H/S)`` of the
images of data shard ``d`` (:func:`shard_rows`, :func:`local_batch`) and
the labels of the whole shard; the parameters are replicated. The graph
runs on the band (``models.graph.apply(space=)``):

* a k x k conv or max pool at stride ``st`` with padding ``p`` reads ``p``
  rows above its band and ``k - st - p`` below it (:func:`halo_rows`).
  They come from the ranks that own them, from as many as needed where
  the halo is taller than a band (the SPP's 13 x 13 pool at stride 32 of
  a 64-row image), or are the padding at the image's top and bottom: 0
  for convs, -inf for max pools. The columns are padded as before;
* a global pool (SE, ``avgpool`` to 1 x 1) sums its band, all-reduces the
  sums over the data row's space group and divides by the global H*W
  (:func:`band_mean`);
* BN takes its statistics over the whole world (data x space): every band
  holds as many cells as every other, so the mean of the ranks' means is
  the global mean;
* upsample, route, shortcut and the train-mode heads stay band-local;
  the loss takes each head's band with its row offset;
* in eval mode the heads of a data row are gathered whole
  (:func:`gather_rows`) and decoded as one device decodes them.

Each band's rows at stride ``st`` start at ``s * H / (S * st)``, so the
band height must split at every stride of the graph:
:func:`check_bands` refuses a graph and height that do not, naming the
node, before any collective runs. Nothing falls back to an unsharded run.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from . import multihost as MH


@dataclasses.dataclass
class SpaceShard:
    """This rank's place on a (data, space) mesh of shape ``(D, S)``:
    data shard ``d``, band ``s``; ``space_group`` holds the S ranks of its
    data row (global ranks ``space_ranks``), ``world`` every rank. ``p2p``:
    halos as point-to-point messages (NCCL), else as one all-reduce of a
    zeroed buffer (gloo; :func:`.multihost.exchange`)."""
    d: int
    s: int
    D: int
    S: int
    space_group: object = None
    world: object = None
    space_ranks: tuple = ()
    p2p: bool = False

    def band(self, height: int) -> tuple:
        """Rows [start, stop) of an image of ``height`` rows that this
        rank holds."""
        if height % self.S:
            raise ValueError(f"{height} rows do not split into {self.S} "
                             f"equal bands")
        h = height // self.S
        return self.s * h, (self.s + 1) * h

    def row_offset(self, band_rows: int) -> int:
        """The global row of this band's first row, on a map whose bands
        are ``band_rows`` high (any stride)."""
        return self.s * band_rows

    def exchange(self, table, outgoing: dict, device) -> dict:
        """:func:`.multihost.exchange` over the space group."""
        return MH.exchange(table, outgoing, self.space_group,
                           self.space_ranks, self.s, device, p2p=self.p2p)


def make_space_shard(shape) -> SpaceShard:
    """The :class:`SpaceShard` of this process on a mesh of ``shape`` =
    (D, S) over the default group, which must hold D*S processes. Every
    rank creates the space group of every data row, in one order, as
    ``dist.new_group`` needs, and runs one all-reduce on its own, so that
    a lazily created NCCL communicator exists before the first halo's
    point-to-point messages."""
    D, S = (int(n) for n in shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a (data, space) mesh needs a torch.distributed "
                           "group of D*S processes "
                           "(parallel.multihost.maybe_initialize_distributed)")
    world = dist.group.WORLD
    if dist.get_world_size() != D * S:
        raise ValueError(f"mesh {(D, S)} needs {D * S} processes, the group "
                         f"has {dist.get_world_size()}")
    d, s = divmod(dist.get_rank(), S)
    mine = None
    for row in range(D):
        ranks = tuple(row * S + t for t in range(S))
        g = dist.new_group(list(ranks))
        if row == d:
            mine, space_ranks = g, ranks
    p2p = MH.backend_of(world) == "nccl"
    dev = (torch.device("cuda", torch.cuda.current_device()) if p2p
           else torch.device("cpu"))
    dist.all_reduce(torch.zeros(1, device=dev), group=mine)
    return SpaceShard(d, s, D, S, mine, world, space_ranks, p2p)


def shard_rows(x: torch.Tensor, shard: SpaceShard) -> torch.Tensor:
    """This rank's band of an NHWC batch (B, H, W, C), contiguous; H must
    split into S equal bands."""
    a, b = shard.band(x.shape[1])
    return x[:, a:b].contiguous()


def local_batch(batch: dict, shard: SpaceShard) -> dict:
    """This rank's part of a global batch: the images (``"v"``, ``"l"``,
    NHWC) of its data shard cut to its band, every other leaf (labels,
    masks) of its data shard whole (JAX's ``P("data", "space")`` and
    ``P("data")``)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % shard.D:
            raise ValueError(f"{k}: batch {n} does not split over "
                             f"{shard.D} data shards")
        b = n // shard.D
        part = v[shard.d * b:(shard.d + 1) * b]
        out[k] = shard_rows(part, shard) if k in ("v", "l") else part
    return out


def check_bands(ir, band_rows: int, S: int) -> None:
    """Raise ``ValueError`` naming the first node of ``ir`` that a band of
    ``band_rows`` input rows (of S) cannot run: a stride that does not
    split the band, an ``avgpool`` to more than 1 x 1, or a node that
    reads the whole map an ``avgpool`` leaves on every rank."""
    stride = {}                  # node -> its output's stride, or None: whole
    cur = 1
    for node in ir.nodes:
        kind = node.kind
        src = [stride[j] for j in node.inputs] if kind == "route" else [cur]
        if kind == "shortcut":
            src += [stride[j] for j in node.inputs]
        if kind == "conv" and node.takes_second_input:
            src = [1]
        if None in src:
            raise ValueError(
                f"l{node.index} ({kind}) reads the 1 x 1 map of a global "
                f"avgpool, which the 2-D path keeps whole on every rank "
                f"of a data row; space sharding does not run it")
        cur = src[0]
        if kind in ("conv", "dwconv", "maxpool"):
            cur *= node.stride[0]
            if band_rows % cur:
                raise ValueError(
                    f"l{node.index} ({kind}, stride {node.stride[0]}): a "
                    f"band of {band_rows} input rows ({S} bands) does not "
                    f"split at stride {cur}; give an image height that "
                    f"is a multiple of {S * cur}")
        elif kind == "upsample":
            cur //= node.scale
        elif kind == "avgpool":
            if node.out_size != 1:
                raise ValueError(
                    f"l{node.index} (avgpool to {node.out_size} x "
                    f"{node.out_size}): its bins cross the bands; space "
                    f"sharding runs only the global avgpool")
            cur = None
        stride[node.index] = cur


def _halo_plan(S: int, hb: int, top: int, bottom: int) -> list:
    """The messages of one halo exchange over a space group of S bands of
    ``hb`` rows: for each band t, each run of its halo rows that one other
    band u owns, as ``(u, t, rows, slot, row)``: ``rows`` rows sent from
    u's band row ``row`` into t's halo slot ``slot`` (slots count the
    ``top`` rows above the band, then the ``bottom`` rows below it). Halo
    rows outside the image have no owner: they are the padding."""
    plan = []
    height = S * hb
    for t in range(S):
        a = t * hb
        rows = [g for g in range(a - top, a)] + \
            [g for g in range(a + hb, a + hb + bottom)]
        j = 0
        while j < len(rows):
            g = rows[j]
            if not 0 <= g < height:
                j += 1
                continue
            u = g // hb
            k = j + 1
            while (k < len(rows) and rows[k] == rows[k - 1] + 1
                   and rows[k] < height and rows[k] // hb == u):
                k += 1
            plan.append((u, t, k - j, j, g - u * hb))
            j = k
    return plan


class _Halo(torch.autograd.Function):
    """The band with ``top`` rows above it and ``bottom`` below it; the
    backward sends each halo row's gradient back to its owner, which adds
    it to its row's."""

    @staticmethod
    def forward(ctx, x, top, bottom, shard, fill):
        xh = x.permute(0, 2, 3, 1).contiguous()             # NHWC
        B, hb, W, C = xh.shape
        plan = _halo_plan(shard.S, hb, top, bottom)
        table = [(u, t, (B, n, W, C), xh.dtype) for u, t, n, _, _ in plan]
        out = {i: xh[:, r:r + n] for i, (u, _, n, _, r) in enumerate(plan)
               if u == shard.s}
        got = shard.exchange(table, out, xh.device)
        halo = xh.new_full((B, top + bottom, W, C), fill)
        for i, (_, t, n, j, _) in enumerate(plan):
            if t == shard.s:
                halo[:, j:j + n] = got[i]
        ctx.shard, ctx.plan, ctx.top, ctx.hb = shard, plan, top, hb
        y = torch.cat([halo[:, :top], xh, halo[:, top:]], dim=1)
        return y.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        shard, plan, top, hb = ctx.shard, ctx.plan, ctx.top, ctx.hb
        gh = g.permute(0, 2, 3, 1).contiguous()
        gx = gh[:, top:top + hb].contiguous()
        ghalo = torch.cat([gh[:, :top], gh[:, top + hb:]], dim=1)
        B, _, W, C = gh.shape
        table = [(t, u, (B, n, W, C), gh.dtype) for u, t, n, _, _ in plan]
        out = {i: ghalo[:, j:j + n] for i, (_, t, n, j, _) in enumerate(plan)
               if t == shard.s}
        got = shard.exchange(table, out, gh.device)
        for i, (u, _, n, _, r) in enumerate(plan):
            if u == shard.s:
                gx[:, r:r + n] += got[i]
        return gx.permute(0, 3, 1, 2), None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, shard: SpaceShard,
              fill: float = 0.0) -> torch.Tensor:
    """The NCHW band ``x`` (channels-last memory, kept) with ``top`` rows
    from above it and ``bottom`` from below, taken from the bands that
    own them, ``fill`` beyond the image's edges; differentiable (the
    gradient of a halo row goes back to its owner)."""
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, shard, fill)


def conv_rows(x, kernel: int, stride, pad: int, shard, fill: float = 0.0):
    """(input, padding) for a ``kernel`` x ``kernel`` window at ``stride``
    with ``pad`` on a band: the band with its halo rows, and the padding
    left to apply, ``(0, pad)``: columns only. Without ``shard``, ``x``
    and ``pad`` as they are."""
    if shard is None:
        return x, pad
    st = stride[0] if isinstance(stride, (tuple, list)) else int(stride)
    return (halo_rows(x, pad, max(0, kernel - st - pad), shard, fill),
            (0, pad))


def band_mean(x: torch.Tensor, shard: SpaceShard) -> torch.Tensor:
    """The mean over the whole map's rows and columns of an NCHW band,
    (B, C): the band's sum, summed over the space group (differentiably),
    over the global H*W."""
    total = MH.all_reduce_sum(x.sum(dim=(2, 3)), shard.space_group)
    return total / (x.shape[2] * shard.S * x.shape[3])


def gather_rows(x: torch.Tensor, shard: SpaceShard) -> torch.Tensor:
    """The whole NCHW map of this data row from its bands, on every rank
    of the row (channels-last memory). Not differentiable: the eval heads
    need it."""
    xh = x.permute(0, 2, 3, 1).contiguous()
    S, s = shard.S, shard.s
    table = [(u, t, tuple(xh.shape), xh.dtype)
             for u in range(S) for t in range(S) if u != t]
    got = shard.exchange(table, {i: xh for i, (u, _, _, _) in
                                 enumerate(table) if u == s}, xh.device)
    bands = [xh] * S
    for i, (u, t, _, _) in enumerate(table):
        if t == s:
            bands[u] = got[i]
    return torch.cat(bands, dim=1).permute(0, 3, 1, 2)
