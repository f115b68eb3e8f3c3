"""Graph executors: GraphIR + params -> heads.

Counterpart of ``double_yolo_kaist_tpu/models/graph.py``: :func:`init`
(with the smart bias), the unfolded :func:`apply` (train mode: raw heads
and the new BN state; eval mode: decoded boxes) with ``remat_segments``,
:func:`count_params`, and the BN-folded inference path
:func:`fold_batchnorm` and :func:`apply_folded`, with :func:`reshape_head`
and :func:`decode_head` (the plain version of kernel K1,
:mod:`..ops.decode`), and :func:`stem_fusion_pairs` (a pure IR analysis the
int8 planner needs). The JAX package's stem-fusion, s2d-region and
split-concat rewrites are left out: they are exact rewrites for the TPU's
128 lanes, and the plain path computes the same function. The stem convs
(3x3, stride 2, C_in 32) run through kernel K3 (:mod:`..ops.stem`).

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

import torch
from torch.utils.checkpoint import checkpoint

from ..config.ir import GraphIR
from ..ops import decode as K1
from ..ops import stem as K3
from ..ops.decode import decode_head_plain as decode_head  # noqa: F401
from ..ops.decode import reshape_head  # noqa: F401
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

def _exec_node(node, p, s, x, x2, cache, *, train, seed):
    """One IR node of the unfolded forward. Returns (x, new BN state entry
    or None, head conv output or None)."""
    kind = node.kind
    ns = head = None
    if kind == "conv":
        inp = x2 if node.takes_second_input else x
        x, bn_s = L.conv_bn_act(inp, p, s, stride=node.stride, pad=node.pad,
                                groups=node.groups, act=node.act, bn=node.bn,
                                train=train)
        if node.bn and train:
            ns = bn_s
    elif kind == "dwconv":
        x, bn_s = L.depthwise_separable(x, p, s, stride=node.stride,
                                        train=train)
        if train:
            ns = bn_s
    elif kind == "se":
        x = L.squeeze_excitation(x, p)
    elif kind == "inception":
        x, bn_s = L.inception(x, p, s, train=train)
        if train:
            ns = bn_s
    elif kind == "maxpool":
        x = L.max_pool(x, node.kernel, node.stride, node.pad)
    elif kind == "avgpool":
        x = L.adaptive_avg_pool(x, node.out_size)
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
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed + node.index)
            x = L.dropout(x, node.p, gen)
    elif kind == "yolo":
        head = x
    else:
        raise ValueError(f"unknown node kind {kind}")
    return x, ns, head


def apply(ir: GraphIR, variables: dict, xv, xl=None, *, train: bool = False,
          rng: torch.Generator | None = None, compute_dtype=None,
          remat_segments: int = 0):
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
      rng: generator for dropout (train only); one number is drawn from it
        per call, and only when a dropout node has p > 0.
      compute_dtype: dtype the activations run in; params stay fp32 and BN
        statistics are fp32.
      remat_segments: > 0 splits the layer sequence into this many
        ``torch.utils.checkpoint`` segments (train only): activations
        inside a segment are recomputed in the backward pass.
    """
    params, state = variables["params"], variables["state"]
    dtype = compute_dtype or xv.dtype
    # NHWC -> NCHW shape over channels-last memory: a view, no copy
    x = xv.to(dtype).permute(0, 3, 1, 2)
    x2 = None if xl is None else xl.to(dtype).permute(0, 3, 1, 2)
    if ir.dual_stream and x2 is None:
        raise ValueError("dual-stream graph requires the LWIR input xl")
    seed = None
    if train and rng is not None and any(
            n.kind == "dropout" and n.p > 0 for n in ir.nodes):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng))

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
                                     train=train, seed=seed)
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
            x, added, seg_state, seg_heads = checkpoint(
                run_segment, seg_nodes, params, state, x, x2, cache,
                use_reentrant=False)
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
    return decode_heads(heads, xv.shape[0], xv.device), state


# ----------------------------------------------------------- inference folding

def stem_fusion_pairs(ir: GraphIR) -> dict:
    """Map {first conv index -> second conv index} of the stem pairs: each
    stream's 3x3 s1 conv on the image followed by a 3x3 s2 conv (JAX
    graph.py:281-296). The port runs such a pair as two convs; the int8
    planner keeps both out of its targets, as the JAX package does with its
    default fused stem."""
    pairs = {}
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
    ``F.conv2d``."""
    if K3.matches(node):
        return K3.stem_conv_s2(inp, p["k3"], node.act)
    return L.activate(node.act, L.conv2d(inp, p["w"], p["b"],
                                         stride=node.stride, pad=node.pad,
                                         groups=node.groups))


def run_graph(ir: GraphIR, params: dict, xv, xl=None, *, dtype,
              conv=conv_folded, read=None, carry=None, after=None):
    """Walk the graph on NHWC images ``xv`` / ``xl`` in ``dtype``.
    ``conv(node, input, params)`` computes each standard conv node; every
    other node kind reads ``params["l<i>"]`` as BN-folded fp params.
    ``read(value)``, if given, maps each value an fp node reads (the int8
    executors dequantize there); ``carry(node, values)``, if given, may
    run a maxpool, upsample or route on the values as they are and returns
    its output, or None for the fp path (the int8 edges carry their codes);
    ``after(node, x)``, if given, sees each node's output and returns what
    goes on (calibration records it, the int8 executors re-emit s8 there).
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
            y = L.activate("relu6", y)
            x = L.activate("relu6", L.conv2d(y, p["pw"]["w"], p["pw"]["b"]))
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
                x = feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)
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
    rows = sum(len(n.anchors) * h.shape[2] * h.shape[3] for h, n in heads)
    decoded = torch.empty((bs, rows, heads[0][1].nc + 5),
                          dtype=torch.float32, device=device)
    K1.decode_heads([(h, n.anchors, n.yolo_stride) for h, n in heads],
                    [n.bf_type for _, n in heads], out=decoded)
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
    (bs, na, ny, nx, no) views of the head convs' outputs.
    """
    heads = run_graph(ir, variables["params"], xv, xl,
                      dtype=compute_dtype or xv.dtype)
    return decode_heads(heads, xv.shape[0], xv.device)
