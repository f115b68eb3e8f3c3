"""Graph executors: GraphIR + params -> heads.

Counterpart of ``double_yolo_kaist_tpu/models/graph.py``: :func:`init`
(with the smart bias), the unfolded :func:`apply` (train mode: raw heads
and the new BN state; eval mode: decoded boxes) with ``remat_segments``,
:func:`count_params`, and the BN-folded inference path
:func:`fold_batchnorm` and :func:`apply_folded`, with :func:`reshape_head`
and :func:`decode_head` (the plain version of kernel K1,
:mod:`..ops.decode`), and the pure IR analyses of the JAX package's
inference rewrites: :func:`stem_fusion_pairs`, :func:`s2d_candidates`,
:func:`s2d_plan` and :func:`s2d_basis`, under its switches ``_FUSE_STEM``
and ``_S2D_REGION`` (env ``DYK_FUSE_STEM``, ``DYK_S2D_REGION``, both on by
default). They give the same dicts as the JAX package's for any cfg and
size, and they set the int8 plans (``models/quantize.py``). The fused
stem and the s2d basis are exact rewrites for the TPU's 128 lanes; the
port's inference computes the same function in the plain basis, which the
H100 A/B kept (PERF.md). The JAX package's two opt-in rewrites are the
port's too, off by default as there: ``_S2D_TRAIN`` (env
``DYK_S2D_TRAIN=1``: :func:`apply` runs the s2d plan's thin-channel
regions in the s2d basis, the stem pair as an e3 entry and an x3 exit,
BN pooling the phases) and ``_SPLIT_CONCAT_CONV`` (env
``DYK_SPLIT_CONCAT_CONV``: :func:`apply_folded` leaves a route concat that
feeds one standard conv unbuilt and sums that conv over the pieces).
The stem convs (3x3, stride 2, C_in 32) run through kernel K3
(:mod:`..ops.stem`); on the card every other standard conv's bias and
activation run through kernel K5 (:mod:`..ops.bias_act`).

Activations are NCHW in shape and channels-last in memory, so the convs run
on cuDNN's NHWC kernels and the NHWC images the caller passes in are read
without a copy. Dual-stream semantics: the conv at ``second_index`` reads
the LWIR image instead of the running activation.

:func:`run_graph` walks the graph for every executor of the port (this
module's fp forward, calibration and the int8 forwards of
:mod:`.quantize`); they differ in how a standard conv is computed and in
what is done with the values (:func:`run_graph`'s hooks).
"""

from __future__ import annotations

import math
import os

import torch
from torch.utils.checkpoint import checkpoint

from ..config.ir import GraphIR, infer_shapes
from ..ops import bias_act as K5
from ..ops import decode as K1
from ..ops import stem as K3
from ..ops.act import activate
from ..ops.decode import decode_head_plain as decode_head  # noqa: F401
from ..ops.decode import reshape_head  # noqa: F401
from ..parallel import spatial as SP
from ..utils import tree as TR
from . import layers as L


# ------------------------------------------------------------------------ init

def init(ir: GraphIR, seed=0, smart_bias: bool = True) -> dict:
    """{"params", "state"} for a compiled graph: fp32 CPU tensors, kernels
    OIHW, drawn from ``seed`` (an int or a ``torch.Generator``).

    ``smart_bias`` applies the focal-loss prior to each predictor conv's
    bias: obj -4.5, cls log(0.6 / (nc - 0.99)) (JAX graph.py:34-61,
    reference models.py:133-144)."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    params: dict[str, dict] = {}
    state: dict[str, dict] = {}
    for node in ir.nodes:
        p, s = L.init_node_params(gen, node)
        if p is not None:
            params[f"l{node.index}"] = p
        if s is not None:
            state[f"l{node.index}"] = s

    if smart_bias:
        for yi in ir.yolo_indices:
            head, pred = ir.nodes[yi], ir.nodes[yi - 1]
            if pred.kind != "conv" or pred.bn:
                continue
            na, nc = len(head.anchors), head.nc
            b = params[f"l{pred.index}"]["b"].reshape(na, nc + 5).clone()
            b[:, 4] += -4.5
            b[:, 5:] += math.log(0.6 / (nc - 0.99))
            params[f"l{pred.index}"]["b"] = b.reshape(-1)
    return {"params": params, "state": state}


def count_params(variables: dict) -> int:
    """Trainable parameter count (BN running stats are buffers, not
    counted, as torch's ``Module.parameters()``)."""
    return sum(p.numel() for p in TR.leaves(variables["params"]))


def place_variables(variables: dict, device) -> dict:
    """Unfolded variables as fp32 tensors on ``device`` (params are cast to
    the activations' dtype where they are used)."""
    return TR.map_leaves(lambda t: t.to(device, torch.float32),
                         {"params": variables["params"],
                          "state": variables.get("state", {})})


# -------------------------------------------------------------- unfolded apply

class _DropoutDraws:
    """Dropout uniforms drawn from one CUDA generator, one tensor a node,
    kept for the call so that a recompute sees the same mask."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.drawn: dict = {}

    def uniforms(self, node, x, shape=None):
        """``node``'s uniforms, of ``x``'s shape or ``shape``."""
        u = self.drawn.get(node.index)
        if u is None:
            u = self.drawn[node.index] = torch.rand(
                x.shape if shape is None else shape,
                generator=self.generator, device=x.device)
        return u


def _dropout_uniforms(node, x, seed, space):
    """Dropout's uniforms for ``x``. On a band they are drawn for the
    global tensor (every data shard, every band) and the rank keeps its
    own, so that a mesh draws the mask one process draws."""
    shape = tuple(x.shape)
    if space is not None:
        shape = (shape[0] * space.D, shape[1], shape[2] * space.S, shape[3])
    if isinstance(seed, _DropoutDraws):
        u = seed.uniforms(node, x, shape)
    else:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(seed + node.index)
        u = torch.rand(shape, generator=gen, device=x.device)
    if space is not None:
        b, h = x.shape[0], x.shape[2]
        u = u[space.d * b:(space.d + 1) * b, :,
              space.s * h:(space.s + 1) * h]
    return u


def _exec_node(node, p, s, x, x2, cache, *, train, seed, group=None,
               space=None, s2d_role=None):
    """One IR node of the unfolded forward. Returns (x, new BN state entry
    or None, head conv output or None). ``group``: BN's statistics group
    (:func:`.layers.batch_norm`); ``space``: the band's
    :class:`..parallel.spatial.SpaceShard`; ``s2d_role``: a conv's role
    in the s2d basis (:func:`.layers.conv_bn_act`)."""
    kind = node.kind
    ns = head = None
    if kind == "conv":
        inp = x2 if node.takes_second_input else x
        x, bn_s = L.conv_bn_act(inp, p, s, stride=node.stride, pad=node.pad,
                                groups=node.groups, act=node.act, bn=node.bn,
                                train=train, group=group, space=space,
                                s2d_role=s2d_role)
        if node.bn and train:
            ns = bn_s
    elif kind == "dwconv":
        x, bn_s = L.depthwise_separable(x, p, s, stride=node.stride,
                                        train=train, group=group,
                                        space=space)
        if train:
            ns = bn_s
    elif kind == "se":
        x = L.squeeze_excitation(x, p, space)
    elif kind == "inception":
        x, bn_s = L.inception(x, p, s, train=train, group=group,
                              space=space)
        if train:
            ns = bn_s
    elif kind == "maxpool":
        x = L.max_pool(x, node.kernel, node.stride, node.pad, space)
    elif kind == "avgpool":
        x = L.adaptive_avg_pool(x, node.out_size, space)
    elif kind == "upsample":
        x = L.upsample_nearest(x, node.scale)
    elif kind == "route":
        feats = [cache[j] for j in node.inputs]
        x = feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)
    elif kind == "shortcut":
        extras = [cache[j] for j in node.inputs]
        x = L.weighted_fusion(x, extras, p["w"] if node.weighted else None)
    elif kind == "dropout":
        if train and seed is not None and node.p > 0:
            # one generator per node from (seed, index): a checkpointed
            # segment recomputes the same mask
            x = L.dropout(x, node.p, None,
                          u=_dropout_uniforms(node, x, seed, space))
    elif kind == "yolo":
        head = x
    else:
        raise ValueError(f"unknown node kind {kind}")
    return x, ns, head


def apply(ir: GraphIR, variables: dict, xv, xl=None, *, train: bool = False,
          rng: torch.Generator | None = None, compute_dtype=None,
          remat_segments: int = 0, group=None, space=None):
    """Run the unfolded graph (JAX graph.py:148-233).

    Args:
      variables: {"params", "state"} as :func:`init` makes them, on the
        images' device (:func:`place_variables`).
      xv / xl: visible / LWIR images, NHWC float in [0, 1]; ``xl`` is
        required for dual-stream graphs.
      train: True -> (raw heads, new state), raw heads as (B, na, ny, nx,
        no) views of the head convs' outputs (JAX's ``reshape_head``
        layout) and the new state the old one updated by every BN's batch
        statistics; False -> ((decoded (B, rows, no) fp32, raw heads),
        state), the heads decoded by :func:`..ops.decode.decode_heads`
        (kernel K1 on CUDA).
      rng: generator for dropout (train only), used only when a dropout
        node has p > 0. A CPU generator gives one number a call, which
        seeds each node's own generator; a CUDA generator gives each
        node's uniforms itself, on the device, so that a step captured in
        a CUDA graph with the generator registered draws new masks at each
        replay (a checkpointed segment's recompute reuses the draws).
      compute_dtype: dtype the activations run in; params stay fp32 and BN
        statistics are fp32.
      remat_segments: > 0 splits the layer sequence into this many
        ``torch.utils.checkpoint`` segments (train only): activations
        inside a segment are recomputed in the backward pass.
      group: a ``torch.distributed`` group over which each train-mode BN
        takes the whole batch's statistics, each rank holding an equal
        share of it (JAX's ``axis_name``; :func:`.layers.batch_norm`).
      space: a :class:`..parallel.spatial.SpaceShard`: ``xv`` / ``xl`` are
        this rank's band of rows of its data shard's images, and the
        graph runs on the band (:mod:`..parallel.spatial`), BN over the
        whole world (``group`` is then ``space.world``). Train mode returns
        the heads' bands; eval mode gathers each data row's heads whole
        and decodes them, so that every rank of the row returns what one
        device returns for its images. A graph whose strides do not split
        the band raises before any collective runs, naming the node.

    With ``_S2D_TRAIN`` (env ``DYK_S2D_TRAIN=1``, JAX graph.py:305-313) the
    convs of ``s2d_plan(ir, H, W, exclude_stems=False)`` at the input's
    size run in the s2d basis, in train and eval mode (JAX graph.py:175):
    an exact rewrite, the params and state the plain basis's. On a band
    (``space``) the plan of the image is not the band's, and the plain
    basis computes the same function: the 2-D path keeps it.
    """
    params, state = variables["params"], variables["state"]
    if space is not None:
        SP.check_bands(ir, xv.shape[1], space.S)
        group = space.world
    dtype = compute_dtype or xv.dtype
    # NHWC -> NCHW shape over channels-last memory: a view, no copy
    x = xv.to(dtype).permute(0, 3, 1, 2)
    x2 = None if xl is None else xl.to(dtype).permute(0, 3, 1, 2)
    if ir.dual_stream and x2 is None:
        raise ValueError("dual-stream graph requires the LWIR input xl")
    seed = None
    if train and rng is not None and any(
            n.kind == "dropout" and n.p > 0 for n in ir.nodes):
        if rng.device.type == "cuda":
            seed = _DropoutDraws(rng)
        else:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng))

    plan = (s2d_plan(ir, xv.shape[1], xv.shape[2], exclude_stems=False)
            if _S2D_TRAIN and space is None else {})

    n = len(ir.nodes)
    if remat_segments and train:
        bounds = [round(i * n / remat_segments)
                  for i in range(remat_segments + 1)]
        segments = [ir.nodes[bounds[i]:bounds[i + 1]]
                    for i in range(remat_segments)]
    else:
        segments = [ir.nodes]

    def run_segment(nodes, params, state, x, x2, cache):
        heads, seg_state, new_cache = [], {}, {}
        for node in nodes:
            key = f"l{node.index}"
            x, ns, head = _exec_node(node, params.get(key), state.get(key),
                                     x, x2, {**cache, **new_cache},
                                     train=train, seed=seed, group=group,
                                     space=space,
                                     s2d_role=plan.get(node.index))
            if ns is not None:
                seg_state[key] = ns
            if head is not None:
                heads.append((head, node))
            if node.index in ir.consumed:
                new_cache[node.index] = x
        return x, new_cache, seg_state, heads

    cache: dict[int, torch.Tensor] = {}
    new_state: dict[str, dict] = {}
    heads = []
    for seg_nodes in segments:
        if len(segments) > 1:
            # no RNG state to keep: dropout draws from explicit
            # generators (and its CUDA draws are kept for the recompute),
            # and reading the default generator's state is not allowed
            # while a CUDA graph is captured
            x, added, seg_state, seg_heads = checkpoint(
                run_segment, seg_nodes, params, state, x, x2, cache,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, added, seg_state, seg_heads = run_segment(
                seg_nodes, params, state, x, x2, cache)
        cache.update(added)
        new_state.update(seg_state)
        heads.extend(seg_heads)

    if train:
        merged = dict(state)
        merged.update(new_state)
        return [reshape_head(h, len(nd.anchors), nd.nc + 5)
                for h, nd in heads], merged
    if space is not None:
        heads = [(SP.gather_rows(h, space), nd) for h, nd in heads]
    return decode_heads(heads, xv.shape[0], xv.device), state


# ----------------------------------------------------------- inference folding

# The JAX package's two switches of its inference rewrites, read as it
# reads them (JAX graph.py:278, 303), with its defaults: ``DYK_FUSE_STEM``
# (the stem pairs, default on) and ``DYK_S2D_REGION`` (the thin-channel
# s2d regions, default on). They set which convs the int8 plans quantize
# (``models/quantize.py``) and which s2d kernels an int8 artifact holds.
# The port computes every conv in the plain basis (PERF.md: the H100 A/B
# of the s2d basis), the stem pair as two convs (the second through K3),
# or as the int8 pair of an artifact quantized with ``int8_stems``.
_FUSE_STEM = os.environ.get("DYK_FUSE_STEM", "1") != "0"
_S2D_REGION = os.environ.get("DYK_S2D_REGION", "1") != "0"

# The JAX package's opt-in training-path s2d (JAX graph.py:305-313): with
# ``DYK_S2D_TRAIN=1`` (and the s2d regions on) :func:`apply` runs the
# s2d plan's convs in the s2d basis, BN pooling the phases. Off by
# default, as in JAX.
_S2D_TRAIN = (os.environ.get("DYK_S2D_TRAIN", "0") == "1") and _S2D_REGION

# The JAX package's opt-in concat elimination (JAX graph.py:266-271): with
# ``DYK_SPLIT_CONCAT_CONV`` set to anything but 0, the BN-folded fp
# forward leaves a route concat that feeds one standard conv unbuilt, and
# that conv sums partial convs over input-channel slices of its kernel:
# conv(cat(a, b), W) == conv(a, W[:, :Ca]) + conv(b, W[:, Ca:]).
_SPLIT_CONCAT_CONV = os.environ.get("DYK_SPLIT_CONCAT_CONV", "0") != "0"


def stem_fusion_pairs(ir: GraphIR) -> dict:
    """Map {first conv index -> second conv index} of the stem pairs: each
    stream's 3x3 s1 conv on the image followed by a 3x3 s2 conv (JAX
    graph.py:281-296); empty when ``_FUSE_STEM`` is off, as the JAX
    package's callers see it."""
    pairs = {}
    if not _FUSE_STEM:
        return pairs
    for n1 in ir.nodes:
        if not (n1.kind == "conv" and n1.kernel == 3 and n1.stride == (1, 1)
                and n1.pad == 1 and n1.groups == 1
                and (n1.index == 0 or n1.takes_second_input)
                and n1.index not in ir.consumed
                and n1.index + 1 < len(ir.nodes)):
            continue
        n2 = ir.nodes[n1.index + 1]
        if (n2.kind == "conv" and n2.kernel == 3 and n2.stride == (2, 2)
                and n2.pad == 1 and n2.groups == 1
                and not n2.takes_second_input and n2.in_ch == n1.out_ch):
            pairs[n1.index] = n2.index
    return pairs


def s2d_candidates(ir: GraphIR) -> set:
    """Every conv that some s2d_plan(ir, h, w) may hold (JAX
    graph.py:318-337): standard 1x1 s1, 3x3 s1 p1 and 3x3 s2 p1 convs. The
    int8 quantizer keeps their fp kernels beside the int8 ones."""
    out = set()
    for n in ir.nodes:
        if n.kind != "conv" or n.groups != 1:
            continue
        k1 = n.kernel == 1 and n.stride == (1, 1)
        k3s1 = n.kernel == 3 and n.stride == (1, 1) and n.pad == 1
        k3s2 = n.kernel == 3 and n.stride == (2, 2) and n.pad == 1
        if k1 or k3s1 or k3s2:
            out.add(n.index)
    return out


def s2d_plan(ir: GraphIR, h: int, w: int,
             exclude_stems: bool = True) -> dict:
    """{conv index -> role} of the thin-channel stages the JAX package runs
    in the s2d basis at input (h, w) (JAX graph.py:339-479; roles as
    :func:`.layers._s2d_w`). A region opens at a conv whose output is thin
    (out_ch < 128), spatially even and at least 32 x 32, and closes at an
    x3 exit; anything the basis cannot carry unwinds the open region, and
    regions read from outside themselves are dropped to a fixpoint. The
    plan sets the int8 plans of ``spine`` and ``edge``."""
    shapes = infer_shapes(ir, h, w)
    stem_nodes = set()
    if exclude_stems:
        sp = stem_fusion_pairs(ir)
        stem_nodes = set(sp) | set(sp.values())

    plan: dict = {}
    basis: dict = {}                    # node index -> output basis p | s
    regions: list = []
    open_nodes: list = []               # nodes marked s in the open region
    cur = "p"

    def unwind():
        nonlocal cur
        for j in open_nodes:
            basis[j] = "p"
            plan.pop(j, None)
        open_nodes.clear()
        cur = "p"

    def want_s2d(node) -> bool:
        c, hh, ww = shapes[node.index]
        if node.index == 0 or node.takes_second_input:
            ih, iw = h, w               # reads the image, not node i - 1
        else:
            ih, iw = shapes[node.index - 1][1:]
        return (c < 128 and ih % 2 == 0 and iw % 2 == 0
                and hh * ww >= 32 * 32)

    for node in ir.nodes:
        i, kind = node.index, node.kind
        if kind == "conv":
            inb = "p" if node.takes_second_input else cur
            simple = node.groups == 1 and i not in stem_nodes
            k1 = simple and node.kernel == 1 and node.stride == (1, 1)
            k3s1 = (simple and node.kernel == 3 and node.stride == (1, 1)
                    and node.pad == 1)
            k3s2 = (simple and node.kernel == 3 and node.stride == (2, 2)
                    and node.pad == 1)
            if inb == "s":
                if k3s2:                      # exit back to plain
                    plan[i] = "x3"
                    basis[i] = "p"
                    cur = "p"
                    regions.append(set(open_nodes) | {i})
                    open_nodes.clear()
                elif k1 or k3s1:              # stay in the basis
                    plan[i] = "i1" if k1 else "i3"
                    basis[i] = "s"
                    open_nodes.append(i)
                else:                         # the basis cannot carry it
                    unwind()
                    basis[i] = "p"
            elif (k1 or k3s1) and want_s2d(node):
                plan[i] = "e1" if k1 else "e3"  # open a region
                basis[i] = "s"
                cur = "s"
                open_nodes.append(i)
            else:
                basis[i] = "p"
                cur = "p"
        elif kind == "route":
            bs = {basis.get(j, "p") for j in node.inputs}
            if len(bs) == 1:
                basis[i] = bs.pop()
                cur = basis[i]
                if cur == "s":
                    open_nodes.append(i)
            else:                             # a mixed-basis concat
                unwind()
                basis[i] = "p"
        elif kind == "shortcut":
            bs = {cur} | {basis.get(j, "p") for j in node.inputs}
            if len(bs) == 1:
                basis[i] = cur
                if cur == "s":
                    open_nodes.append(i)
            else:
                unwind()
                basis[i] = "p"
        elif kind == "dropout":
            basis[i] = cur
            if cur == "s":
                open_nodes.append(i)
        else:                                 # pools, SE, upsample, yolo
            if cur == "s":
                unwind()
            basis[i] = "p"
            cur = "p"
    if open_nodes:
        unwind()

    # fixpoint: drop the regions read from outside themselves, and those
    # whose routes or adds read an s output of a dropped region
    consumers: dict = {}
    for n in ir.nodes:
        for j in n.inputs:
            consumers.setdefault(j, set()).add(n.index)
    dropped_s: set = set()
    changed = True
    while changed:
        changed = False
        for r in regions:
            if not r:
                continue
            sset = {j for j in r if basis.get(j) == "s"}
            outside = any(c not in r
                          for j in sset for c in consumers.get(j, ()))
            reads_dropped = any(j in dropped_s
                                for m in r for j in ir.nodes[m].inputs)
            if outside or reads_dropped:
                dropped_s |= sset
                for j in r:
                    basis[j] = "p"
                    plan.pop(j, None)
                r.clear()
                changed = True
    return plan


def s2d_basis(ir: GraphIR, plan: dict) -> dict:
    """{node index -> 'p' | 's'}: each node's output basis under ``plan``
    (JAX graph.py:481-500)."""
    basis: dict = {}
    cur = "p"
    for n in ir.nodes:
        i, k = n.index, n.kind
        if k == "conv":
            cur = "s" if plan.get(i) in ("e1", "e3", "i1", "i3") else "p"
        elif k == "route":
            bs = {basis.get(j, "p") for j in n.inputs}
            cur = bs.pop() if len(bs) == 1 else "p"
        elif k not in ("shortcut", "dropout", "yolo"):
            cur = "p"
        basis[i] = cur
    return basis


# kernel height of each role's s2d kernel (JAX graph.py:529): what the JAX
# executor checks an artifact's precomputed kernel by
_S2D_KSHAPE = {"e1": 2, "e3": 4, "i1": 1, "i3": 3, "x3": 2}


def fold_batchnorm(ir: GraphIR, variables: dict) -> dict:
    """Fold BN statistics into the conv kernels and biases of every BN'd
    conv (the two convs of each depthwise-separable block and every
    inception branch too). Returns ``{"params": ..., "state": {}}``;
    kernels are OIHW, so the scale goes over axis 0."""
    params = dict(variables["params"])
    state = variables["state"]

    def fold(conv_p, bn_state):
        # the scale is computed on the CPU wherever the variables live:
        # CUDA's sqrt rounds otherwise for ~1% of inputs, and a model folded
        # on the card must equal the same checkpoint folded on the host
        scale = (conv_p["bn"]["scale"].cpu()
                 / torch.sqrt(bn_state["var"].cpu() + L.BN_EPS)).to(
                     conv_p["w"].device)
        w = conv_p["w"] * scale.reshape(-1, 1, 1, 1)
        b = conv_p["bn"]["bias"] - bn_state["mean"] * scale
        return {"w": w, "b": b}

    for node in ir.nodes:
        key = f"l{node.index}"
        if node.kind == "conv" and node.bn:
            params[key] = fold(params[key], state[key])
        elif node.kind == "dwconv":
            params[key] = {"dw": fold(params[key]["dw"], state[key]["dw"]),
                           "pw": fold(params[key]["pw"], state[key]["pw"])}
        elif node.kind == "inception":
            params[key] = {name: fold(params[key][name], state[key][name])
                           for name in params[key]}
    return {"params": params, "state": {}}


def place_folded(ir: GraphIR, folded: dict, device, compute_dtype) -> dict:
    """Move folded variables to ``device`` once. Conv kernels (channels-last)
    and biases go to ``compute_dtype``; SE and fusion weights stay fp32, as
    the JAX package computes those paths in fp32. The stem convs also
    get ``"k3"``: their kernel and bias with the packed form kernel K3 reads
    (:func:`..ops.stem.pack_weights`), made once here."""
    def conv(p):
        return {"w": p["w"].to(device, compute_dtype).contiguous(
                    memory_format=torch.channels_last),
                "b": p["b"].to(device, compute_dtype)}

    params = {}
    for node in ir.nodes:
        key = f"l{node.index}"
        p = folded["params"].get(key)
        if p is None:
            continue
        if node.kind == "conv":
            params[key] = conv(p)
            if K3.matches(node):
                params[key]["k3"] = K3.pack_weights(**params[key])
        elif node.kind in ("dwconv", "inception"):
            params[key] = {name: conv(q) for name, q in p.items()}
        else:                                    # se, weighted shortcut
            params[key] = {name: ({k: v.to(device, torch.float32)
                                   for k, v in q.items()}
                                  if isinstance(q, dict)
                                  else q.to(device, torch.float32))
                           for name, q in p.items()}
    return {"params": params, "state": {}}


def conv_folded(node, inp, p):
    """One BN-folded standard conv + activation. The convs K3 takes (3x3,
    stride 2, pad 1, C_in 32, mish or leaky) go through it; the rest go to
    ``F.conv2d``. Where K5 takes the conv (:func:`..ops.bias_act.takes`)
    and it has groups 1 (on the card ATen's cuDNN conv then adds the bias
    as a pass of its own), the conv runs without its bias and K5 adds it
    with the activation; elsewhere (the CPU, whose conv may add the bias
    before rounding, a grouped conv, any other activation or dtype, a
    gradient) the code is the eager one. ``inp`` may be a list, the
    pieces of a route concat left unbuilt (``_SPLIT_CONCAT_CONV``): the
    conv is then the sum of the pieces' convs with the kernel's
    input-channel slices, the bias added to the sum (JAX
    graph.py:545-557)."""
    if isinstance(inp, list):
        y, c0 = None, 0
        for seg in inp:
            c = seg.shape[1]
            part = L.conv2d(seg, p["w"][:, c0:c0 + c], stride=node.stride,
                            pad=node.pad)
            y = part if y is None else y + part
            c0 += c
        epilogue = K5.bias_act if K5.takes(y, node.act, p["b"]) else K5.plain
        return epilogue(y, p["b"], node.act)
    if K3.matches(node):
        return K3.stem_conv_s2(inp, p["k3"], node.act)
    if node.groups == 1 and K5.takes(inp, node.act, p["w"], p["b"]):
        return K5.bias_act(L.conv2d(inp, p["w"], stride=node.stride,
                                    pad=node.pad), p["b"], node.act)
    return activate(node.act, L.conv2d(inp, p["w"], p["b"],
                                         stride=node.stride, pad=node.pad,
                                         groups=node.groups))


def _defer_concat(ir: GraphIR, node) -> bool:
    """A route concat that ``_SPLIT_CONCAT_CONV`` leaves unbuilt (JAX
    graph.py:559-567): several inputs, read by no later node but the next,
    and the next a standard conv (groups 1) on the running activation."""
    nxt = (ir.nodes[node.index + 1]
           if node.index + 1 < len(ir.nodes) else None)
    return (len(node.inputs) > 1 and node.index not in ir.consumed
            and nxt is not None and nxt.kind == "conv" and nxt.groups == 1
            and not nxt.takes_second_input)


def run_graph(ir: GraphIR, params: dict, xv, xl=None, *, dtype,
              conv=conv_folded, read=None, carry=None, after=None,
              split_concat: bool = False):
    """Walk the graph on NHWC images ``xv`` / ``xl`` in ``dtype``.
    ``conv(node, input, params)`` computes each standard conv node; every
    other node kind reads ``params["l<i>"]`` as BN-folded fp params.
    ``read(value)``, if given, maps each value an fp node reads (the int8
    executors dequantize there); ``carry(node, values)``, if given, may
    run a maxpool, upsample or route on the values as they are and returns
    its output, or None for the fp path (the int8 edges carry their codes);
    ``after(node, x)``, if given, sees each node's output and returns what
    goes on (calibration records it, the int8 executors re-emit s8 there).
    ``split_concat``: the route concats :func:`_defer_concat` picks stay
    lists of their pieces, which ``conv`` then receives (only
    :func:`conv_folded` takes them; JAX's int8 forward never defers).
    Returns [(head conv output (bs, na*no, ny, nx), yolo node)]."""
    # NHWC -> NCHW shape over channels-last memory: a view, no copy
    x = xv.to(dtype).permute(0, 3, 1, 2)
    x2 = None if xl is None else xl.to(dtype).permute(0, 3, 1, 2)
    if ir.dual_stream and x2 is None:
        raise ValueError("dual-stream graph requires the LWIR input xl")

    def rd(v):
        return v if read is None else read(v)

    cache: dict[int, torch.Tensor] = {}
    heads = []                      # (conv output, node) per yolo node
    for node in ir.nodes:
        kind = node.kind
        p = params.get(f"l{node.index}")
        if kind == "conv":
            x = conv(node, x2 if node.takes_second_input else x, p)
        elif kind == "dwconv":
            y = L.conv2d(rd(x), p["dw"]["w"], p["dw"]["b"],
                         stride=node.stride, pad=1, groups=node.in_ch)
            y = activate("relu6", y)
            x = activate("relu6", L.conv2d(y, p["pw"]["w"], p["pw"]["b"]))
        elif kind == "se":
            x = L.squeeze_excitation(rd(x), p)
        elif kind == "inception":
            x = L.inception(rd(x), p)
        elif kind in ("maxpool", "upsample", "route"):
            vals = ([cache[j] for j in node.inputs] if kind == "route"
                    else [x])
            y = None if carry is None else carry(node, vals)
            if y is not None:
                x = y
            elif kind == "maxpool":
                x = L.max_pool(rd(x), node.kernel, node.stride, node.pad)
            elif kind == "upsample":
                x = L.upsample_nearest(rd(x), node.scale)
            else:
                feats = [rd(v) for v in vals]
                if len(feats) == 1:
                    x = feats[0]
                elif split_concat and _defer_concat(ir, node):
                    x = feats        # the next conv sums over the pieces
                else:
                    x = torch.cat(feats, dim=1)
        elif kind == "avgpool":
            x = L.adaptive_avg_pool(rd(x), node.out_size)
        elif kind == "shortcut":
            extras = [rd(cache[j]) for j in node.inputs]
            x = L.weighted_fusion(rd(x), extras,
                                  p["w"] if node.weighted else None)
        elif kind == "dropout":
            pass
        elif kind == "yolo":
            heads.append((rd(x), node))
        else:
            raise ValueError(f"unknown node kind {kind}")
        if after is not None:
            x = after(node, x)
        if node.index in ir.consumed:
            cache[node.index] = x
    return heads


def decode_heads(heads, bs: int, device):
    """Head conv outputs -> (decoded (bs, total rows, no) fp32, raw heads as
    (bs, na, ny, nx, no) views). One call of
    :func:`..ops.decode.decode_heads` decodes every head into its slice of
    the decoded output (kernel K1 on CUDA, one launch; the plain version on
    the CPU)."""
    decoded = K1.decode_heads([(h, n.anchors, n.yolo_stride)
                               for h, n in heads],
                              [n.bf_type for _, n in heads])
    return decoded, [reshape_head(h, len(n.anchors), n.nc + 5)
                     for h, n in heads]


def apply_folded(ir: GraphIR, variables: dict, xv, xl=None, *,
                 compute_dtype=None):
    """Inference forward on BN-folded params.

    Args:
      xv / xl: visible / LWIR images, NHWC float in [0, 1]; ``xl`` is
        required for dual-stream graphs.
      compute_dtype: dtype the activations run in (default: ``xv``'s).

    Returns (decoded (bs, total rows, no) fp32, raw heads), raw heads as
    (bs, na, ny, nx, no) views of the head convs' outputs. Under
    ``_SPLIT_CONCAT_CONV`` the concats feeding one standard conv stay
    unbuilt (:func:`conv_folded`).
    """
    heads = run_graph(ir, variables["params"], xv, xl,
                      dtype=compute_dtype or xv.dtype,
                      split_concat=_SPLIT_CONCAT_CONV)
    return decode_heads(heads, xv.shape[0], xv.device)
