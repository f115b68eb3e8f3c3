"""Post-training int8 quantization for the inference path.

Counterpart of ``double_yolo_kaist_tpu/models/quantize.py`` in every mode it
has: ``seed``, ``chain``, ``all``, ``spine``, ``spineall`` and ``edge``.
Scheme: symmetric int8; weights per output channel from the BN-folded
kernels, activations per tensor with scales from a calibration pass
(max-abs over sample batches). Quantized convs run int8 x int8 -> int32 and
dequantize into the bias add; a chain-emitting conv requantizes its output
straight to int8 for the next conv. SE blocks, head predictors, the stem
pairs and decode stay full precision.

  * ``spine`` / ``spineall``: the chain plan plus the residual adds whose
    output can carry int8 (:func:`_plan_spine`). Such an add emits s8 with
    one per-tensor scale, the next conv's calibrated input scale; quantized
    consumers read the codes, every other consumer dequantizes at read.
  * ``edge``: (nearly) every activation edge stored int8 with per-channel
    scales (:func:`plan_edges`); a conv whose input edge is int8 has the
    edge's scales folded into its weights, fp consumers dequantize at read
    and compute nodes re-emit int8.

Flow (the same as the JAX package's):
    folded = graph.fold_batchnorm(ir, variables)           # CPU, fp32
    stats  = calibrate(ir, placed_folded, [(xv, xl), ...])
    qvars  = quantize(ir, folded, stats, mode=...)         # CPU
    qp     = place_quantized(ir, qvars, device, dtype)
    io, _  = apply_quantized(ir, qp, xv, xl, compute_dtype=dtype, mode=...)

Quantized 1x1 stride-1 convs go through kernel K4 (:mod:`..ops.qgemm`),
with K4's own s8 requant in the chains and, in ``edge`` mode, with the
per-channel re-emission after it (:func:`_req`); kxk int8 convs are an int8
im2col and ``torch._int_mm``, as the JAX package leaves them to XLA.
Calibration stats (:func:`save_calibration`) and quantized variables
(:func:`save_quantized`) are saved and loaded in the JAX package's
``.npz`` formats, so that either package reads the other's files.

The port plans as the JAX package does by default (the stem pairs kept out
of the int8 targets, as under its fused stem) and runs each stem pair as
two fp convs, the second through K3. It has none of the JAX package's
TPU-only rewrites: no space-to-depth regions and no int8 fused stem
(``_q_fused_stem``, ROADMAP.md queue 1 item 14). So it computes what the
JAX package computes with ``graph._S2D_REGION = False`` and its default
``int8_stems=False``; in particular ``spine`` places no int8 add (the JAX
plan confines them to s2d regions) and equals ``chain``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..config.ir import GraphIR
from ..ops import qgemm as K4
from . import graph as G
from . import layers as L

MODES = ("seed", "chain", "all", "edge", "spine", "spineall")


# ----------------------------------------------------------------------- plan

def _standard_convs(ir: GraphIR) -> set:
    """Standard convs that could carry int8: head predictors and stem pairs
    excluded (JAX quantize.py:39-48 with its default fused stem)."""
    skip = {ir.nodes[yi - 1].index for yi in ir.yolo_indices}
    pairs = G.stem_fusion_pairs(ir)
    skip |= set(pairs) | set(pairs.values())
    return {n.index for n in ir.nodes
            if n.kind == "conv" and n.groups == 1 and n.index not in skip}


def _thick(ir: GraphIR) -> set:
    """Standard convs with a thick input (in_ch >= 16): a thin-input conv
    never pays back its boundary passes, in any mode."""
    return {i for i in _standard_convs(ir) if ir.nodes[i].in_ch >= 16}


def _quantizable(ir: GraphIR, min_kernel: int = 3,
                 min_in_ch: int = 16) -> set:
    """Standard convs with kernel >= 3 and a thick input (in_ch >= 16): the
    convs worth int8 on their own (JAX quantize.py:51-71)."""
    return {i for i in _standard_convs(ir)
            if ir.nodes[i].kernel >= min_kernel
            and ir.nodes[i].in_ch >= min_in_ch}


def _chain_edge(ir: GraphIR, i: int, targets: set) -> bool:
    """True if node i's output can stay int8 into node i + 1: both are
    quantized convs, node i's only consumer is node i + 1, and node i + 1
    reads the running stream (not the LWIR entry)."""
    j = i + 1
    return (i in targets and j in targets
            and ir.nodes[i].kind == "conv"
            and i not in ir.consumed
            and not ir.nodes[j].takes_second_input)


def _grow_chains(ir: GraphIR, targets: set) -> set:
    """Add, to a fixpoint, the convs whose input arrives as int8 from a
    sole-consumer quantized predecessor."""
    standard = _thick(ir)
    changed = True
    while changed:
        changed = False
        for j in sorted(standard - targets):
            if _chain_edge(ir, j - 1, targets | {j}):
                targets.add(j)
                changed = True
    return targets


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")


def _plan_spine(ir: GraphIR, targets: set, everywhere: bool) -> list:
    """The residual adds whose output can carry int8 (JAX quantize.py:86-127):
    an unweighted single-partner add whose producing conv (node s - 1) is
    quantized and whose next node is a thick standard conv reading the
    running stream. ``spine`` keeps those inside s2d regions, of which the
    port has none; ``spineall`` (``everywhere``) takes them all."""
    if not everywhere:
        return []
    standard = _thick(ir)
    out = []
    for node in ir.nodes:
        if (node.kind != "shortcut" or node.weighted
                or len(node.inputs) != 1):
            continue
        nxt = node.index + 1
        if nxt >= len(ir.nodes) or (node.index - 1) not in targets:
            continue
        nn = ir.nodes[nxt]
        if (nn.kind == "conv" and nn.index in standard
                and not nn.takes_second_input):
            out.append(node.index)
    return out


def _plan_with_spine(ir: GraphIR, mode: str):
    """spine / spineall: the chain plan plus the spine adds, the convs after
    them joining the targets and the chains re-grown over the enlarged set
    (JAX quantize.py:180-198) -> (targets, emits, spine indices)."""
    targets, _ = plan_quantization(ir, "chain")
    spine = _plan_spine(ir, targets, everywhere=(mode == "spineall"))
    targets = _grow_chains(ir, targets | {si + 1 for si in spine})
    emits = {i for i in targets if _chain_edge(ir, i, targets)}
    return targets, emits, spine


def plan_quantization(ir: GraphIR, mode: str = "chain"):
    """-> (targets: set of quantized conv indices, emits: set of targets
    whose output is requantized to int8 for the next conv; in ``edge``
    mode, the targets stored int8).

    ``seed``: kernel >= 3 convs, each dequantizing to the compute dtype;
    ``chain``: the seed set grown to a fixpoint by the 1x1 convs whose input
    arrives as int8 from a sole-consumer predecessor; ``all``: every
    standard conv; ``spine`` / ``spineall``: chain plus the int8 residual
    adds (:func:`_plan_with_spine`); ``edge``: :func:`plan_edges`. The
    thin-input rule (in_ch >= 16) holds in every mode."""
    _check_mode(mode)
    if mode == "edge":
        targets, int8_out, _ = plan_edges(ir)
        return targets, {i for i, v in int8_out.items() if v}
    if mode in ("spine", "spineall"):
        targets, emits, _ = _plan_with_spine(ir, mode)
        return targets, emits
    if mode == "seed":
        return _quantizable(ir), set()
    if mode == "all":
        targets = _thick(ir)
    else:                                    # chain
        targets = _grow_chains(ir, set(_quantizable(ir)))
    emits = {i for i in targets if _chain_edge(ir, i, targets)}
    return targets, emits


def warn_if_empty_plan(ir: GraphIR, mode: str, fallback: str) -> bool:
    """True (with a one-line warning) if ``mode``'s plan has no targets,
    as for the MobileNet family: the caller then serves ``fallback``."""
    if plan_quantization(ir, mode)[0]:
        return False
    warnings.warn(
        f"int8 plan for this model ({mode!r} mode) is empty — no conv "
        f"benefits from int8 here; {fallback}", stacklevel=3)
    return True


# ------------------------------------------------------------------ edge plan

_PASS = ("maxpool", "upsample", "dropout")


def _stream_consumers(ir: GraphIR, i: int) -> list:
    """Indices of the nodes reading node i's output as the running stream
    (JAX quantize.py:237-255)."""
    cc = []
    j = i + 1
    n = len(ir.nodes)
    while j < n:
        nj = ir.nodes[j]
        if nj.kind == "route" or (nj.kind == "conv"
                                  and nj.takes_second_input):
            break              # replaces x without reading it
        if nj.kind == "dropout":
            j += 1             # inference alias: neither reads nor writes
            continue
        cc.append(j)
        if nj.kind == "yolo":
            j += 1             # reads x but passes it through
            continue
        break
    return cc


def _stream_producer(ir: GraphIR, j: int):
    """Index of the node whose output is the running stream when node j
    runs (None when j reads an image)."""
    nj = ir.nodes[j]
    if j == 0 or (nj.kind == "conv" and nj.takes_second_input):
        return None
    k = j - 1
    while k >= 0 and ir.nodes[k].kind in ("dropout", "yolo"):
        k -= 1
    return k if k >= 0 else None


def plan_edges(ir: GraphIR, hw: tuple | None = None):
    """Static plan of mode ``edge`` (JAX quantize.py:270-355) ->
    (targets, int8_out, folded_in):
      targets: the convs running int8 math (``all``'s targets);
      int8_out: {node index -> bool} whether its output is stored int8;
      folded_in: the targets whose running-stream input arrives int8 (their
        weights are quantized with the input's per-channel scales folded
        in).

    ``hw``: the deployment size. The JAX package vetoes int8 edges inside
    its space-to-depth regions at that size; the port has no such regions,
    so the plan is the same at every size, as the JAX package's is with
    ``graph._S2D_REGION = False``. The argument keeps its meaning in the
    artifacts (:func:`save_quantized`)."""
    del hw
    targets = _thick(ir)
    head_pred = {ir.nodes[yi - 1].index for yi in ir.yolo_indices}
    stem_seconds = set(G.stem_fusion_pairs(ir).values())
    cons: dict = {}
    for n in ir.nodes:
        for j in n.inputs:
            cons.setdefault(j, []).append(n.index)

    def out_consumers(i):
        return _stream_consumers(ir, i) + cons.get(i, [])

    # backward: edges feeding an fp head through format-preserving nodes
    # stay in the compute dtype
    feeds_head: dict = {}
    for n in reversed(ir.nodes):
        i = n.index
        fh = False
        for c in out_consumers(i):
            nc = ir.nodes[c]
            if c in head_pred or nc.kind == "yolo":
                fh = True
            elif nc.kind in _PASS or nc.kind == "route":
                fh = fh or feeds_head.get(c, False)
        feeds_head[i] = fh

    int8_out: dict = {}
    cur = False                       # int8ness of the running stream
    for n in ir.nodes:
        i, k = n.index, n.kind
        can = bool(out_consumers(i)) and not feeds_head[i]
        if k == "conv":
            cur = can and (i in targets or i in stem_seconds)
        elif k in ("shortcut", "se"):
            cur = can                 # fp compute, requantized store
        elif k == "route":
            cur = bool(n.inputs) and all(int8_out.get(j, False)
                                         for j in n.inputs)
        elif k in ("maxpool", "upsample"):
            cur = cur and not feeds_head[i]   # carrier follows its input
        elif k in ("dropout", "yolo"):
            pass                      # x passes through unchanged
        else:                         # avgpool / inception / dwconv
            cur = False
        int8_out[i] = cur

    folded_in = set()
    for i in targets:
        p = _stream_producer(ir, i)
        if p is not None and int8_out.get(p, False):
            folded_in.add(i)
    return targets, int8_out, folded_in


def edge_scale_vectors(ir: GraphIR, stats: dict, int8_out: dict) -> dict:
    """{node index -> per-channel scale vector (amax / 127, fp32 numpy)} for
    every int8-stored output, carried through pools, upsamples and concats
    (JAX quantize.py:358-381)."""
    svec: dict = {}
    cur = None
    for n in ir.nodes:
        i, k = n.index, n.kind
        if k in ("dropout", "yolo"):
            svec[i] = cur if int8_out.get(i, False) else None
            continue
        if not int8_out.get(i, False):
            svec[i] = cur = None
            continue
        if k in ("conv", "shortcut", "se"):
            v = np.maximum(np.asarray(stats[f"l{i}.out"], np.float32),
                           1e-12) / 127.0
        elif k == "route":
            v = np.concatenate([svec[j] for j in n.inputs])
        elif k in ("maxpool", "upsample"):
            v = cur
        else:
            v = None
        svec[i] = cur = v
    return svec


# ------------------------------------------------------------------ calibrate

def _abs_stat(a, pct: float):
    """max |a| (pct 100) or its ``pct`` percentile with linear
    interpolation, as ``jnp.percentile`` computes it; a 0-dim fp32 tensor.
    The percentile takes the top ``n - floor(pos)`` values only."""
    return _abs_stat_rows(a.reshape(1, -1), pct)[0]


def _abs_stat_rows(a, pct: float):
    """:func:`_abs_stat` of each row of a 2-D tensor -> (rows,) fp32."""
    a = a.float().abs()
    if pct >= 100.0:
        return a.amax(dim=1)
    n = a.shape[1]
    # the position and weights in fp32, as jnp.percentile computes them
    # inside the JAX package's jitted calibration: (q / 100) * (n - 1)
    pos = np.float32(pct) / np.float32(100.0) * np.float32(n - 1)
    lo = int(np.floor(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(1.0) - w_hi
    top = torch.topk(a, n - lo, dim=1).values       # descending
    v_lo = top[:, -1]
    v_hi = top[:, -2] if n - lo >= 2 else top[:, -1]
    return v_lo * torch.tensor(w_lo) + v_hi * torch.tensor(w_hi)


def calibrate(ir: GraphIR, folded: dict, batches,
              compute_dtype=torch.bfloat16, pct: float = 100.0) -> dict:
    """Activation statistics over ``batches`` of (xv, xl-or-None) NHWC
    images, a superset that every mode reads (JAX quantize.py:386-507):
      * ``l<i>``: the per-tensor input amax of every standard conv (head
        predictors excluded, stem pairs included), a float;
      * ``l<i>.out``: the per-channel output amax of every conv, shortcut
        and SE node but the head predictors (the edge scales), a float64
        vector.
    Each is the max over batches of each batch's ``pct``-percentile
    max-abs. ``folded``: BN-folded params placed for the executor
    (:func:`.graph.place_folded`). The forward is :func:`.graph.run_graph`
    with the fp convs, K3 included, and no head decode."""
    skip = {ir.nodes[yi - 1].index for yi in ir.yolo_indices}
    targets = {n.index for n in ir.nodes
               if n.kind == "conv" and n.groups == 1 and n.index not in skip}
    out_track = {n.index for n in ir.nodes
                 if n.kind in ("conv", "shortcut", "se")
                 and n.index not in skip}
    acc: dict = {}
    with torch.inference_mode():
        for xv, xl in batches:
            stats = {}

            def conv(node, inp, p):
                if node.index in targets:
                    stats[f"l{node.index}"] = _abs_stat(inp, pct)
                return G.conv_folded(node, inp, p)

            def after(node, x):
                if node.index in out_track:
                    stats[f"l{node.index}.out"] = _abs_stat_rows(
                        x.transpose(0, 1).reshape(x.shape[1], -1), pct)
                return x

            G.run_graph(ir, folded["params"], xv, xl, dtype=compute_dtype,
                        conv=conv, after=after)
            keys = sorted(stats)
            # one device -> host copy for the batch
            flat = torch.cat([stats[k].reshape(-1) for k in keys]).double()
            flat = flat.cpu().numpy()
            at = 0
            for k in keys:
                n = stats[k].numel()
                if k.endswith(".out"):
                    v = flat[at:at + n].copy()
                    prev = acc.get(k)
                    acc[k] = v if prev is None else np.maximum(prev, v)
                else:
                    acc[k] = max(acc.get(k, 0.0), float(flat[at]))
                at += n
    return acc


def save_calibration(path: str, stats: dict, *, pct: float = 100.0) -> None:
    """Save :func:`calibrate` stats as a calibration artifact (``.npz``, the
    JAX package's format: one array per stat key, and the percentile under
    ``__pct__``)."""
    arrs = {k: np.asarray(v) for k, v in stats.items()}
    arrs["__pct__"] = np.asarray(float(pct), np.float64)
    np.savez(path, **arrs)


def load_calibration(path: str) -> tuple[dict, float]:
    """Load a :func:`save_calibration` artifact (the port's or the JAX
    package's) -> (stats, pct); per-channel ``l<i>.out`` stats come back as
    arrays."""
    with np.load(path) as z:
        pct = float(z["__pct__"]) if "__pct__" in z.files else 100.0
        stats = {}
        for k in z.files:
            if k == "__pct__":
                continue
            v = z[k]
            stats[k] = float(v) if v.ndim == 0 else v
    return stats, pct


# ---------------------------------------------------------- quantized files

# keys that only the JAX package's TPU rewrites write: the s2d kernels of
# DYK_S2D_REGION and the int8 fused stem of DYK_FUSE_STEM (int8_stems)
_TPU_ONLY_KEYS = frozenset({"wq_t", "sw_t", "bt", "wt", "stem_q", "amax_in",
                            "amax_mid", "stem_out_s", "stem_out_inv"})
# 4-D leaves under these names are conv kernels: OIHW here, HWIO on disk
_KERNEL_KEYS = ("w", "wq")


def _to_numpy_tree(tree, key=None):
    """The port's quantized variables -> the JAX layout as numpy (HWIO
    kernels, every other leaf as it is; bf16 leaves stay torch tensors for
    :func:`save_quantized` to write as bit patterns)."""
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v, k) for k, v in tree.items()}
    t = tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree
    if isinstance(t, torch.Tensor) and key in _KERNEL_KEYS and t.dim() == 4:
        t = t.permute(2, 3, 1, 0).contiguous()
    if isinstance(t, torch.Tensor) and t.dtype != torch.bfloat16:
        return t.numpy()
    return t if isinstance(t, torch.Tensor) else np.asarray(t)


def save_quantized(path: str, qvars: dict, *, mode: str,
                   hw: tuple | None = None) -> None:
    """Save :func:`quantize`'s output as one ``.npz`` deployment artifact in
    the JAX package's layout (JAX quantize.py:537-565): ``/``-joined keys
    under ``q`` with HWIO kernels, bf16 leaves as uint16 bit patterns listed
    in ``__bf16__``, the plan mode in ``__mode__`` and the prepare size in
    ``__hw__`` (empty when none). A server that loads it skips fold,
    calibration and quantization."""
    _check_mode(mode)
    flat: dict = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
        elif t is not None:
            flat[prefix[:-1]] = t

    walk({"q": _to_numpy_tree(qvars)}, "")
    bf16_keys = [k for k, a in flat.items() if isinstance(a, torch.Tensor)]
    for k in bf16_keys:
        flat[k] = flat[k].view(torch.int16).numpy().view(np.uint16)
    flat["__bf16__"] = np.asarray(bf16_keys)
    flat["__mode__"] = np.asarray(mode)
    flat["__hw__"] = (np.asarray(hw, np.int64) if hw is not None
                      else np.asarray([], np.int64))
    np.savez(path, **flat)


def load_quantized(path: str) -> tuple[dict, str, tuple | None]:
    """Load a :func:`save_quantized` artifact, the port's or the JAX
    package's -> (qvars in the port's layout, mode, hw). bf16 leaves come
    back bit-exact. An artifact holding keys of the JAX package's TPU-only
    rewrites (s2d kernels, the int8 fused stem) is refused: the port cannot
    run them and must not drop them silently."""
    meta = ("__mode__", "__hw__", "__bf16__")
    with np.load(path) as z:
        mode = str(z["__mode__"])
        hw_arr = z["__hw__"]
        hw = tuple(int(x) for x in hw_arr) if hw_arr.size else None
        bf16 = set(z["__bf16__"].tolist()) if "__bf16__" in z.files else set()
        tpu_only = sorted(k for k in z.files if k not in meta
                          and _TPU_ONLY_KEYS & set(k.split("/")))
        if tpu_only:
            raise ValueError(
                f"quantized artifact {path} holds keys of the JAX package's "
                f"TPU-only rewrites (space-to-depth kernels or the int8 "
                f"fused stem, e.g. {tpu_only[0]}), which the port does not "
                f"run (ROADMAP.md, queue 1 item 14); export it with "
                f"DYK_S2D_REGION=0 and without int8 stems, or quantize with "
                f"the port")
        tree: dict = {}
        for key in z.files:
            if key in meta:
                continue
            arr = z[key]
            parts = key.split("/")
            if key in bf16:
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr, copy=True))
            if parts[-1] in _KERNEL_KEYS and t.dim() == 4:
                t = t.permute(3, 2, 0, 1).contiguous()
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    _check_mode(mode)
    return tree["q"], mode, hw


# ------------------------------------------------------------------- quantize

def _quant_weight(w):
    """OIHW fp kernel -> (int8 kernel, per-output-channel scale fp32):
    amax over (I, H, W) / 127, at least 1e-12; round half to even, clip to
    [-127, 127]."""
    w = w.float()
    sw = torch.clamp_min(torch.amax(torch.abs(w), dim=(1, 2, 3)) / 127.0,
                         1e-12)
    wq = torch.clamp(torch.round(w / sw.reshape(-1, 1, 1, 1)), -127, 127)
    return wq.to(torch.int8), sw


def _qconv_params(p, amax: float) -> dict:
    wq, sw = _quant_weight(p["w"])
    sx = max(float(amax), 1e-12) / 127.0
    # JAX multiplies by the Python float as an fp32 scalar
    return {"wq": wq, "scale": sw * torch.tensor(sx, dtype=torch.float32),
            "inv_sx": np.float32(1.0 / sx), "b": p["b"].float()}


def _quantize_edge(ir: GraphIR, folded: dict, stats: dict) -> dict:
    """mode ``edge`` variables (JAX quantize.py:610-693): the weights of a
    ``folded_in`` conv carry its input edge's per-channel scales (``in_s``,
    ``in_inv``); every int8-emitting node carries ``out_s`` / ``out_inv``."""
    params = folded["params"]
    targets, int8_out, folded_in = plan_edges(ir)
    missing = sorted(f"l{i}.out" for i, v in int8_out.items()
                     if v and ir.nodes[i].kind in ("conv", "shortcut", "se")
                     and f"l{i}.out" not in stats)
    if missing:
        raise ValueError(
            f"calibration stats lack the per-channel output amax that edge "
            f"mode needs ({missing[:3]} ...): they were made before these "
            f"were recorded; re-calibrate (python -m "
            f"double_yolo_kaist_torch.calibrate)")
    svec = edge_scale_vectors(ir, stats, int8_out)

    def out_scales(i):
        v = np.asarray(svec[i], np.float32)
        return {"out_s": torch.from_numpy(v.copy()),
                "out_inv": torch.from_numpy(1.0 / v)}

    q: dict = {}
    for node in ir.nodes:
        i = node.index
        key = f"l{i}"
        p = params.get(key)
        ent: dict = {}
        if node.kind == "conv" and i in targets:
            in_s = None
            if i in folded_in:
                in_s = np.asarray(svec[_stream_producer(ir, i)], np.float32)
            w = p["w"].float()
            if in_s is not None:
                w = w * torch.from_numpy(in_s).reshape(1, -1, 1, 1)
            wq, sw = _quant_weight(w)
            qp = {"wq": wq, "b": p["b"].float()}
            if in_s is None:
                sx = max(float(stats[key]), 1e-12) / 127.0
                qp["scale"] = sw * torch.tensor(np.float32(sx))
                qp["inv_sx"] = np.float32(1.0 / sx)
            else:
                qp["scale"] = sw
                qp["in_s"] = torch.from_numpy(in_s.copy())
                qp["in_inv"] = torch.from_numpy(1.0 / in_s)
            if int8_out.get(i) and svec[i] is not None:
                qp.update(out_scales(i))
            ent["q"] = qp
        else:
            if p is not None:
                ent["fp"] = p
            if (node.kind in ("shortcut", "se") and int8_out.get(i)
                    and svec.get(i) is not None):
                ent.update(out_scales(i))
        if ent:
            q[key] = ent
    return {"params": q}


def quantize(ir: GraphIR, folded: dict, stats: dict,
             mode: str = "chain") -> dict:
    """BN-folded params (CPU, fp32, OIHW; :func:`.graph.fold_batchnorm`) +
    calibration stats -> quantized variables ``{"params": {"l<i>": ...}}``
    (JAX quantize.py:696-784), each entry one of
      * ``{"q": {wq, scale, b, inv_sx[, out_inv_s]}}``: a quantized conv; a
        chain-emitting one carries ``out_inv_s`` = 127 / amax(next conv's
        input);
      * ``{"fp": folded params}``: a node left in full precision;
      * ``{"spine": {inv_sy, sy}}`` (spine modes): an add that emits s8
        with the next conv's input scale;
      * in ``edge`` mode (:func:`_quantize_edge`) also ``in_s`` / ``in_inv``
        on the quantized convs and ``out_s`` / ``out_inv`` on every node
        stored int8.
    The JAX package's ``hw`` (the size its s2d kernels are prepared for)
    has no counterpart: the port's plans do not depend on the size;
    :func:`save_quantized` records it."""
    _check_mode(mode)
    if mode == "edge":
        return _quantize_edge(ir, folded, stats)
    params = folded["params"]
    if mode in ("spine", "spineall"):
        targets, emits, spine = _plan_with_spine(ir, mode)
    else:
        targets, emits = plan_quantization(ir, mode)
        spine = []
    q: dict = {}
    for node in ir.nodes:
        key = f"l{node.index}"
        p = params.get(key)
        if p is None:
            continue
        if node.index in targets and node.kind == "conv":
            qp = _qconv_params(p, stats[key])
            if node.index in emits:
                nxt = float(stats[f"l{node.index + 1}"])
                qp["out_inv_s"] = np.float32(127.0 / max(nxt, 1e-12))
            q[key] = {"q": qp}
        else:
            q[key] = {"fp": p}
    for si in spine:
        # the next conv's entry-quantize scale: it reads the codes unchanged
        sx = max(float(stats[f"l{si + 1}"]), 1e-12) / 127.0
        q.setdefault(f"l{si}", {})["spine"] = {
            "inv_sy": np.float32(1.0 / sx), "sy": np.float32(sx)}
    return {"params": q}


def _gemm_conv(node) -> bool:
    """The quantized convs K4 computes: 1x1, stride 1, no pad, groups 1,
    K and N multiples of 16 (the kernel's tile), an activation its
    epilogue has (MNv3's hard-swish is not one)."""
    return (node.kernel == 1 and tuple(node.stride) == (1, 1)
            and node.pad == 0 and node.groups == 1
            and node.in_ch % 16 == 0 and node.out_ch % 16 == 0
            and node.act in K4.ACTS)


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _vec(t, device, dtype):
    """A per-channel vector, placed once as (1, C, 1, 1) for NCHW math."""
    return torch.as_tensor(t).to(device, dtype).reshape(1, -1, 1, 1)


def place_quantized(ir: GraphIR, qvars: dict, device,
                    compute_dtype) -> dict:
    """Move :func:`quantize`'s output (or :func:`load_quantized`'s) to
    ``device`` once, in the layouts the executors read: a 1x1 int8 kernel
    packed for K4 (``"k4"``: :func:`..ops.qgemm.pack_weights`, the (N, K)
    form), any other as (N, kh*kw*C) in (kh, kw, c) order for the im2col
    product (``"w_nk"``), zero-padded to multiples of 16 in N and K (the
    card's int8 GEMM refuses MNv3's N = 40); scale and bias fp32,
    contiguous; per-tensor
    scales as Python floats (read here once, so that a captured forward
    never syncs on one); the per-channel edge scales in ``compute_dtype``
    as (1, C, 1, 1); fp entries as :func:`.graph.place_folded` places them.
    Returns ``{"params": {"l<i>": {"q": ...}, {"spine": ...} or fp params
    (with ``out_s`` / ``out_inv`` beside them in edge mode)}}``."""
    entries = qvars["params"]
    fp = {k: e["fp"] for k, e in entries.items()
          if "fp" in e and "q" not in e}
    placed = G.place_folded(ir, {"params": fp}, device,
                            compute_dtype)["params"]
    params = {}
    for node in ir.nodes:
        key = f"l{node.index}"
        e = entries.get(key)
        if e is None:
            continue
        if "spine" in e:
            params[key] = {"spine": {k: float(v)
                                     for k, v in e["spine"].items()}}
            continue
        if "q" not in e:
            params[key] = dict(placed.get(key, {}))
            for name in ("out_s", "out_inv"):
                if name in e:
                    params[key][name] = _vec(e[name], device, compute_dtype)
            continue
        qp, wq = e["q"], e["q"]["wq"]
        ent = {"scale": qp["scale"].to(device, torch.float32).contiguous(),
               "b": qp["b"].to(device, torch.float32).contiguous()}
        for name in ("inv_sx", "out_inv_s"):
            if name in qp:
                ent[name] = float(qp[name])
        for name in ("in_inv", "out_s", "out_inv"):
            if name in qp:
                ent[name] = _vec(qp[name], device, compute_dtype)
        if _gemm_conv(node):
            ent["k4"] = K4.pack_weights(wq[:, :, 0, 0].t().to(device))
        else:
            w = wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)
            n, k = w.shape
            ent["w_nk"] = F.pad(w, (0, _pad16(k) - k, 0, _pad16(n) - n)
                                ).contiguous().to(device)
        params[key] = {"q": ent}
    return {"params": params}


# ---------------------------------------------------------------------- apply

def _quantize_input(x, inv_sx):
    """round(x * inv_sx) clipped to [-127, 127] as s8, in x's dtype;
    ``inv_sx`` a scalar or a placed per-channel vector."""
    if isinstance(inv_sx, torch.Tensor):
        inv = inv_sx.to(x.dtype)
    else:
        inv = torch.tensor(inv_sx, dtype=torch.float32).to(x.dtype)
    return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)


def _im2col(xn, k: int, stride, pad: int, width: int):
    """NHWC s8 (B, H, W, C) -> (B*Ho*Wo, width) patches in (kh, kw, c)
    order, from a pad and k*k strided slices, zero columns after them up to
    ``width``."""
    b, h, w, c = xn.shape
    sy, sx = stride
    ho = (h + 2 * pad - k) // sy + 1
    wo = (w + 2 * pad - k) // sx + 1
    xp = F.pad(xn, (0, 0, pad, pad, pad, pad))
    cols = [xp[:, i:i + sy * (ho - 1) + 1:sy, j:j + sx * (wo - 1) + 1:sx, :]
            for i in range(k) for j in range(k)]
    if width > k * k * c:
        cols.append(xn.new_zeros((b, ho, wo, width - k * k * c)))
    return torch.cat(cols, dim=-1).reshape(b * ho * wo, width), ho, wo


def _int8_conv(node, xq, qp, out_inv_s, out_dtype):
    """The int8 product of one quantized conv on s8 input ``xq`` and its
    epilogue: a 1x1 through K4 (:func:`..ops.qgemm.qgemm`), a kxk as im2col
    + int32 product + the same epilogue. s8 out when ``out_inv_s`` is
    given, else ``out_dtype``; NCHW-shaped, channels-last."""
    xn = xq.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    if "k4" in qp:
        y = K4.qgemm(xn, qp["k4"], qp["scale"], qp["b"], node.act,
                     out_inv_s=out_inv_s, out_dtype=out_dtype)
    else:
        a, ho, wo = _im2col(xn, node.kernel, node.stride, node.pad,
                            qp["w_nk"].shape[1])
        acc = K4.int_mm(a, qp["w_nk"])[:, :qp["scale"].shape[0]]
        y = K4.epilogue_plain(acc, qp["scale"], qp["b"], node.act, out_inv_s,
                              out_dtype).reshape(xn.shape[0], ho, wo, -1)
    return y.permute(0, 3, 1, 2)


def qconv(node, x, qp, out_dtype):
    """One quantized conv (JAX quantize._qconv): quantize the input unless
    it arrives as s8, then :func:`_int8_conv`. Returns s8 when the conv
    emits into a chain, else ``out_dtype``."""
    xq = x if x.dtype == torch.int8 else _quantize_input(x, qp["inv_sx"])
    return _int8_conv(node, xq, qp, qp.get("out_inv_s"), out_dtype)


class QVal:
    """An int8 activation on the running stream or in the cache: the s8
    codes and their scale. A spine add's scale is one Python float (JAX
    quantize._SpineVal); an edge's is a (1, C, 1, 1) vector in the compute
    dtype, one per channel (JAX quantize._apply_edge's (x, xs) pairs)."""

    __slots__ = ("q", "s")

    def __init__(self, q, s):
        self.q, self.s = q, s

    def deq(self, dtype):
        """Full precision at read: codes times the scale, in ``dtype``."""
        s = self.s if isinstance(self.s, torch.Tensor) else torch.tensor(
            self.s, dtype=torch.float32)
        return self.q.to(dtype) * s.to(dtype)


def _reader(dtype):
    """run_graph's ``read``: int8 values dequantize where an fp node reads
    them (JAX quantize._fv / _deq)."""
    return lambda v: v.deq(dtype) if isinstance(v, QVal) else v


def _apply_chain(ir: GraphIR, params: dict, xv, xl, dtype):
    """seed / chain / all / spine / spineall executor (JAX
    quantize._apply_q_chain): :func:`.graph.run_graph` with quantized convs
    and spine adds that emit s8 with a per-tensor scale."""
    read = _reader(dtype)

    def conv(node, inp, p):
        if isinstance(inp, QVal):
            # quantized consumers read the codes: the spine scale is their
            # entry-quantize scale (_plan_spine)
            inp = inp.q if "q" in p else inp.deq(dtype)
        if "q" in p:
            return qconv(node, inp, p["q"], dtype)
        return G.conv_folded(node, inp, p)

    def after(node, x):
        sp = params.get(f"l{node.index}", {}).get("spine")
        if node.kind == "shortcut" and sp is not None:
            return QVal(_quantize_input(x, sp["inv_sy"]), sp["sy"])
        return x

    return G.run_graph(ir, params, xv, xl, dtype=dtype, conv=conv,
                       read=read, after=after)


def _req(y, out_inv):
    """fp activation -> s8 on its per-channel grid, in ``y``'s dtype (JAX
    quantize._req)."""
    return torch.clamp(torch.round(y * out_inv), -127, 127).to(torch.int8)


def qconv_edge(node, x, qp, dtype):
    """Edge-mode quantized conv (JAX quantize._qconv_e) of ``x``, a tensor
    or a per-channel :class:`QVal`, -> a :class:`QVal` where the conv
    re-emits int8, else a ``dtype`` tensor. A ``folded_in`` conv takes int8
    codes as they are (its weights carry the input scales); an input that
    arrived in full precision is quantized per channel on the same grid.
    Other convs dequantize and quantize per tensor. A 1x1 runs through K4
    without its requant; the per-channel re-emission follows in
    ``dtype``."""
    if "in_inv" in qp:
        xq = x.q if isinstance(x, QVal) else _quantize_input(
            x.to(dtype), qp["in_inv"])
    else:
        xq = _quantize_input(x.deq(dtype) if isinstance(x, QVal) else x,
                             qp["inv_sx"])
    y = _int8_conv(node, xq, qp, None, dtype)
    if "out_inv" in qp:
        return QVal(_req(y, qp["out_inv"]), qp["out_s"])
    return y


def _apply_edge(ir: GraphIR, params: dict, xv, xl, dtype):
    """mode ``edge`` executor (JAX quantize._apply_edge):
    :func:`.graph.run_graph` with activations kept as per-channel int8
    wherever :func:`plan_edges` allows. Max pools, upsamples and routes
    carry the codes (the max of codes is the code of the max, the scales
    being positive); SE blocks and adds re-emit int8."""
    read = _reader(dtype)

    def conv(node, inp, p):
        if "q" in p:
            return qconv_edge(node, inp, p["q"], dtype)
        return G.conv_folded(node, read(inp), p)

    def carry(node, vals):
        if node.kind == "route":
            if len(vals) == 1:
                return vals[0]
            if all(isinstance(v, QVal) for v in vals):
                return QVal(torch.cat([v.q for v in vals], dim=1),
                            torch.cat([v.s for v in vals], dim=1))
            return None
        v = vals[0]
        if not isinstance(v, QVal):
            return None
        if node.kind == "maxpool":      # exact through bf16: it holds codes
            q = L.max_pool(v.q.to(torch.bfloat16), node.kernel, node.stride,
                           node.pad).to(torch.int8)
        else:
            q = v.q.repeat_interleave(node.scale, 2).repeat_interleave(
                node.scale, 3)
        return QVal(q, v.s)

    def after(node, x):
        p = params.get(f"l{node.index}", {})
        if node.kind in ("se", "shortcut") and "out_inv" in p:
            return QVal(_req(x, p["out_inv"]), p["out_s"])
        return x

    return G.run_graph(ir, params, xv, xl, dtype=dtype, conv=conv,
                       read=read, carry=carry, after=after)


def apply_quantized(ir: GraphIR, qvars: dict, xv, xl=None, *,
                    compute_dtype=torch.bfloat16, mode: str = "chain"):
    """int8 inference forward -> (decoded (bs, total, no) fp32, raw heads).
    ``qvars`` from :func:`place_quantized`; ``mode`` must match the
    :func:`quantize` call that built them (``edge`` has its own hooks of
    :func:`.graph.run_graph`, the other five share one set). The stem pairs
    run as two fp convs (the second through K3), the heads through K1."""
    _check_mode(mode)
    run = _apply_edge if mode == "edge" else _apply_chain
    heads = run(ir, qvars["params"], xv, xl, compute_dtype)
    return G.decode_heads(heads, xv.shape[0], xv.device)
