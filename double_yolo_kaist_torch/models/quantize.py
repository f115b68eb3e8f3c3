"""Post-training int8 quantization for the inference path.

Counterpart of ``double_yolo_kaist_tpu/models/quantize.py`` in every mode it
has: ``seed``, ``chain``, ``all``, ``spine``, ``spineall`` and ``edge``.
Scheme: symmetric int8; weights per output channel from the BN-folded
kernels, activations per tensor with scales from a calibration pass
(max-abs over sample batches). Quantized convs run int8 x int8 -> int32 and
dequantize into the bias add; a chain-emitting conv requantizes its output
straight to int8 for the next conv. SE blocks, head predictors and decode
stay full precision, and so do the stem pairs unless quantized with
``int8_stems``.

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

The port plans as the JAX package does at its defaults. Its stem pairs
(``graph._FUSE_STEM``) stay out of the int8 targets, and the s2d plan of
the deployment size ``hw`` (``graph._S2D_REGION``, :func:`.graph.s2d_plan`)
sets two plans: ``spine``'s int8 adds are the ones inside the s2d regions
(:func:`_plan_spine`), and ``edge`` keeps the edges inside the regions in
the compute dtype, with the region convs quantized as ``chain`` quantizes
them (:func:`plan_edges`). :func:`quantize` writes every leaf the JAX
package writes: the planned convs' s2d kernels (``wq_t`` / ``sw_t`` /
``bt`` on int8 ones, ``wt`` / ``bt`` on fp ones) and, with
``int8_stems``, the int8 stem pair's scales and kernels (``amax_in``,
``amax_mid``, ``stem_q``, in ``edge`` mode ``stem_out_s`` /
``stem_out_inv``). The executors compute every conv in the plain basis
(the H100 A/B of the s2d basis, PERF.md): the int32 sums are the integers
the s2d kernels give, and :func:`load_quantized` checks that an
artifact's s2d and stem kernels are the transforms of its plain ones.
Where an entry holds the int8 stem's scales, the pair runs int8 (two int8
im2col convs, the image quantized with ``amax_in``, the mid activation
requantized with ``amax_mid``); otherwise as two fp convs, the second
through K3.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..config.ir import GraphIR
from ..ops import qgemm as K4
from ..utils import npz as NPZ
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


def _plan_spine(ir: GraphIR, targets: set, plan: dict,
                everywhere: bool = False) -> list:
    """The residual adds whose output can carry int8 (JAX quantize.py:86-127):
    an unweighted single-partner add whose producing conv (node s - 1) is
    quantized and whose next node is a thick standard conv reading the
    running stream. ``spine`` keeps those inside the s2d regions of
    ``plan`` (both neighbours planned); ``spineall`` (``everywhere``) takes
    them all."""
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
        if (nn.kind != "conv" or nn.index not in standard
                or nn.takes_second_input):
            continue
        if everywhere or ((node.index - 1) in plan and nxt in plan):
            out.append(node.index)
    return out


def _plan_with_spine(ir: GraphIR, mode: str, s2d_plan: dict | None = None):
    """spine / spineall: the chain plan plus the spine adds (``spine``'s
    those inside the regions of ``s2d_plan``), the convs after them joining
    the targets and the chains re-grown over the enlarged set (JAX
    quantize.py:180-198) -> (targets, emits, spine indices)."""
    targets, _ = plan_quantization(ir, "chain")
    spine = _plan_spine(ir, targets, s2d_plan or {},
                        everywhere=(mode == "spineall"))
    targets = _grow_chains(ir, targets | {si + 1 for si in spine})
    emits = {i for i in targets if _chain_edge(ir, i, targets)}
    return targets, emits, spine


def plan_quantization(ir: GraphIR, mode: str = "chain",
                      s2d_plan: dict | None = None):
    """-> (targets: set of quantized conv indices, emits: set of targets
    whose output is requantized to int8 for the next conv; in ``edge``
    mode, the targets stored int8).

    ``seed``: kernel >= 3 convs, each dequantizing to the compute dtype;
    ``chain``: the seed set grown to a fixpoint by the 1x1 convs whose input
    arrives as int8 from a sole-consumer predecessor; ``all``: every
    standard conv; ``spine`` / ``spineall``: chain plus the int8 residual
    adds (:func:`_plan_with_spine`, ``spine``'s inside the regions of
    ``s2d_plan``); ``edge``: :func:`plan_edges` with no deployment size, as
    the JAX package's. The thin-input rule (in_ch >= 16) holds in every
    mode."""
    _check_mode(mode)
    if mode == "edge":
        targets, int8_out, _ = plan_edges(ir)
        return targets, {i for i, v in int8_out.items() if v}
    if mode in ("spine", "spineall"):
        targets, emits, _ = _plan_with_spine(ir, mode, s2d_plan)
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

    ``hw``: the deployment size. With ``graph._S2D_REGION`` on, the nodes
    whose output lies in the s2d basis at that size keep edges in the
    compute dtype, and the planned convs and those in the basis are
    quantized only where ``chain`` quantizes them (the JAX package measured
    int8 edges to lose inside its regions); the regions' x3 exits emit int8
    as any conv does."""
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

    in_basis: dict = {}
    if hw is not None and G._S2D_REGION:
        plan = G.s2d_plan(ir, *hw)
        in_basis = {i: b == "s" for i, b in G.s2d_basis(ir, plan).items()}
        chain_targets, _ = plan_quantization(ir, "chain")
        targets = {i for i in targets
                   if not (in_basis.get(i, False) or i in plan)
                   or i in chain_targets}

    int8_out: dict = {}
    cur = False                       # int8ness of the running stream
    for n in ir.nodes:
        i, k = n.index, n.kind
        can = (bool(out_consumers(i)) and not feeds_head[i]
               and not in_basis.get(i, False))
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


def make_calibration_fn(ir: GraphIR, compute_dtype=torch.bfloat16,
                        pct: float = 100.0):
    """fn(folded, xv, xl) -> {key: statistic} of one batch (JAX
    quantize.py:386-470): the BN-folded forward (:func:`.graph.run_graph`
    with the fp convs, K3 included, and no head decode) records
      * ``l<i>``: the per-tensor input ``pct``-percentile max-abs of every
        standard conv (head predictors excluded, stem pairs included), a
        0-dim fp32 tensor;
      * ``l<i>.out``: the per-channel output statistic of every conv,
        shortcut and SE node but the head predictors (the edge scales),
        an fp32 vector.
    ``folded``: BN-folded params placed for the executor
    (:func:`.graph.place_folded`); the tensors stay on their device."""
    skip = {ir.nodes[yi - 1].index for yi in ir.yolo_indices}
    targets = {n.index for n in ir.nodes
               if n.kind == "conv" and n.groups == 1 and n.index not in skip}
    out_track = {n.index for n in ir.nodes
                 if n.kind in ("conv", "shortcut", "se")
                 and n.index not in skip}

    @torch.inference_mode()
    def fn(folded, xv, xl=None):
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
        return stats

    return fn


def calibrate(ir: GraphIR, folded: dict, batches,
              compute_dtype=torch.bfloat16, pct: float = 100.0) -> dict:
    """Activation statistics over ``batches`` of (xv, xl-or-None) NHWC
    images, a superset that every mode reads (JAX quantize.py:473-489):
    each key of :func:`make_calibration_fn`, the max over batches of each
    batch's statistic, a float for ``l<i>``, a float64 vector for
    ``l<i>.out``."""
    fn = make_calibration_fn(ir, compute_dtype, pct)
    acc: dict = {}
    for xv, xl in batches:
        stats = fn(folded, xv, xl)
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

# 4-D leaves under these names are conv kernels: OIHW here, HWIO on disk
_KERNEL_KEYS = ("w", "wq", "wq_t", "wt", "wbq", "w2q")
# (plain kernel size, s2d kernel size) -> the role that makes one from the
# other (layers._s2d_w): an artifact's s2d kernels name no role
_ROLE_OF = {(1, 2): "e1", (1, 1): "i1", (3, 4): "e3", (3, 3): "i3",
            (3, 2): "x3"}
# fp32 rounding of a weight scale rebuilt from a conv's scale and inv_sx
_SCALE_RTOL = 2.0 ** -21


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
    flat = NPZ.encode(flat)
    flat["__mode__"] = np.asarray(mode)
    flat["__hw__"] = (np.asarray(hw, np.int64) if hw is not None
                      else np.asarray([], np.int64))
    np.savez(path, **flat)


def _check_rewrites(params: dict, path: str) -> None:
    """Refuse an artifact whose s2d or int8-stem leaves are not what the
    port makes from the plain leaves beside them, naming the leaf: an int8
    conv's ``wq_t`` must be its ``wq`` transformed (bit for bit), ``sw_t``
    its weight scale (``scale``, times ``inv_sx`` without ``in_s``) on the
    output basis (to fp32 rounding) and ``bt`` its bias on that basis; an
    fp conv's ``wt`` / ``bt`` its kernel and bias transformed; ``stem_q``
    the pair's kernels (this conv's and the next one's) transformed and
    quantized, int8 leaves bit for bit and scales to fp32 rounding. The
    executors compute the plain basis, so an artifact whose s2d kernels
    say otherwise is not served."""
    def refuse(leaf, what):
        raise ValueError(f"quantized artifact {path}: {leaf} is not {what}; "
                         f"refused")

    def hold(leaf, got, want, exact=True):
        ok = got is not None and got.shape == want.shape and (
            torch.equal(got.float(), want.float()) if exact else
            torch.allclose(got.float(), want.float(), rtol=_SCALE_RTOL,
                           atol=0.0))
        if not ok:
            refuse(leaf, "what the port computes from the plain leaves")

    def role(leaf, w, wt):
        r = _ROLE_OF.get((w.shape[-1], wt.shape[-1]))
        if r is None:
            refuse(leaf, "an s2d kernel of this conv's kernel")
        return r

    for key, ent in params.items():
        q, fp = ent.get("q", {}), ent.get("fp", {})
        if any(k in q for k in ("wq_t", "sw_t", "bt")):
            r = role(f"{key}/q/wq_t", q["wq"], q.get("wq_t", q["wq"]))
            hold(f"{key}/q/wq_t", q.get("wq_t"), L._s2d_w(q["wq"], r))
            sw = (q["scale"] if "in_s" in q
                  else q["scale"] * torch.tensor(np.float32(q["inv_sx"])))
            hold(f"{key}/q/sw_t", q.get("sw_t"), L.s2d_bias(sw, r),
                 exact=False)
            hold(f"{key}/q/bt", q.get("bt"), L.s2d_bias(q["b"], r))
        if any(k in fp for k in ("wt", "bt")):
            r = role(f"{key}/fp/wt", fp["w"], fp.get("wt", fp["w"]))
            hold(f"{key}/fp/wt", fp.get("wt"), L._s2d_w(fp["w"], r))
            hold(f"{key}/fp/bt", fp.get("bt"), L.s2d_bias(fp["b"], r))
        if "stem_q" in ent:
            nxt = params.get(f"l{int(key[1:]) + 1}", {}).get("fp", {})
            if "w" not in fp or "w" not in nxt:
                refuse(f"{key}/stem_q", "beside the stem pair's fp kernels")
            wb, w2s = L.stem_pair_weights(fp["w"], nxt["w"])
            sq = ent["stem_q"]
            for name, w in (("b", wb), ("2", w2s)):
                wq, sw = _quant_weight(w)
                hold(f"{key}/stem_q/w{name}q", sq.get(f"w{name}q"), wq)
                hold(f"{key}/stem_q/sw{name}", sq.get(f"sw{name}"), sw,
                     exact=False)


def load_quantized(path: str) -> tuple[dict, str, tuple | None]:
    """Load a :func:`save_quantized` artifact, the port's or the JAX
    package's -> (qvars in the port's layout, mode, hw). bf16 leaves come
    back bit-exact. The s2d and int8-stem leaves must be the transforms of
    the plain leaves beside them (:func:`_check_rewrites`), or the
    artifact is refused."""
    meta = ("__mode__", "__hw__", NPZ.BF16)
    with np.load(path) as z:
        mode = str(z["__mode__"])
        hw_arr = z["__hw__"]
        hw = tuple(int(x) for x in hw_arr) if hw_arr.size else None
        bf16 = NPZ.bf16_keys(z)
        tree: dict = {}
        for key in z.files:
            if key in meta:
                continue
            arr = z[key]
            parts = key.split("/")
            t = NPZ.decode(arr, key in bf16)
            if parts[-1] in _KERNEL_KEYS and t.dim() == 4:
                t = t.permute(3, 2, 0, 1).contiguous()
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    _check_mode(mode)
    _check_rewrites(tree["q"]["params"], path)
    return tree["q"], mode, hw


# ------------------------------------------------------------------- quantize

def _quant_weight(w):
    """OIHW fp kernel -> (int8 kernel, per-output-channel scale fp32):
    amax over (I, H, W) / 127, at least 1e-12; round half to even, clip to
    [-127, 127]; in ``w``'s dtype, as the JAX package computes it (the
    bf16 kernels of its bf16 artifacts in bf16)."""
    sw = torch.clamp_min(torch.amax(torch.abs(w), dim=(1, 2, 3)) / 127.0,
                         1e-12)
    wq = torch.clamp(torch.round(w / sw.reshape(-1, 1, 1, 1)), -127, 127)
    return wq.to(torch.int8), sw.float()


def _qconv_params(p, amax: float) -> dict:
    wq, sw = _quant_weight(p["w"])
    sx = max(float(amax), 1e-12) / 127.0
    # JAX multiplies by the Python float as an fp32 scalar
    return {"wq": wq, "scale": sw * torch.tensor(sx, dtype=torch.float32),
            "inv_sx": np.float32(1.0 / sx), "b": p["b"].float()}


def _s2d_int8(qp: dict, w, b, role: str) -> None:
    """A planned int8 conv's s2d leaves (JAX quantize.py:748-753): its fp
    kernel ``w`` (in ``edge`` mode with the input scales folded in: fold,
    then s2d) transformed and quantized, and its bias on the output
    basis."""
    qp["wq_t"], qp["sw_t"] = _quant_weight(L._s2d_w(w, role))
    qp["bt"] = L.s2d_bias(b, role)


def _s2d_fp(p: dict, role: str) -> dict:
    """A planned fp conv's params with its s2d kernel and bias beside
    them (JAX quantize.py:756-761)."""
    return {**p, "wt": L._s2d_w(p["w"], role), "bt": L.s2d_bias(p["b"], role)}


def _int8_stem(params: dict, stats: dict, i: int, j: int) -> dict:
    """The int8 stem pair's leaves on its first conv l<i> (JAX
    quantize.py:762-774): the image's amax ``amax_in`` and, where the
    second conv l<j>'s input was calibrated, its ``amax_mid`` and the
    pair's transformed kernels quantized (``stem_q``)."""
    ent = {"amax_in": np.float32(stats[f"l{i}"])}
    mid = stats.get(f"l{j}")
    if mid is not None:
        ent["amax_mid"] = np.float32(mid)
        wb, w2s = L.stem_pair_weights(params[f"l{i}"]["w"],
                                      params[f"l{j}"]["w"])
        wbq, swb = _quant_weight(wb)
        w2q, sw2 = _quant_weight(w2s)
        ent["stem_q"] = {"wbq": wbq, "swb": swb, "w2q": w2q, "sw2": sw2}
    return ent


def _s2d_setup(ir: GraphIR, hw):
    """(s2d candidates, stem pairs, s2d plan at ``hw``) as the quantizer
    reads them under the switches."""
    cands = G.s2d_candidates(ir) if G._S2D_REGION else set()
    plan = G.s2d_plan(ir, *hw) if (hw and G._S2D_REGION) else {}
    return cands, G.stem_fusion_pairs(ir), plan


def _quantize_edge(ir: GraphIR, folded: dict, stats: dict,
                   hw: tuple | None = None, int8_stems: bool = False) -> dict:
    """mode ``edge`` variables (JAX quantize.py:610-693): the weights of a
    ``folded_in`` conv carry its input edge's per-channel scales (``in_s``,
    ``in_inv``); every int8-emitting node carries ``out_s`` / ``out_inv``;
    the s2d and int8-stem leaves as :func:`quantize` writes them, an int8
    stem emitting ``stem_out_s`` / ``stem_out_inv`` where its second
    conv's output edge is int8."""
    params = folded["params"]
    targets, int8_out, folded_in = plan_edges(ir, hw)
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
    s2d_cands, stem, plan = _s2d_setup(ir, hw)

    def out_scales(i, prefix=""):
        v = np.asarray(svec[i], np.float32)
        return {f"{prefix}out_s": torch.from_numpy(v.copy()),
                f"{prefix}out_inv": torch.from_numpy(1.0 / v)}

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
            if i in s2d_cands:
                ent["fp"] = p
            if i in plan:
                _s2d_int8(qp, w, p["b"], plan[i])
        else:
            if p is not None:
                ent["fp"] = p
            if node.kind == "conv" and i in plan and p is not None:
                ent["fp"] = _s2d_fp(p, plan[i])
            if (node.kind == "conv" and i in stem and key in stats
                    and int8_stems):
                ent.update(_int8_stem(params, stats, i, stem[i]))
                if int8_out.get(stem[i]) and svec.get(stem[i]) is not None:
                    ent.update(out_scales(stem[i], "stem_"))
            if (node.kind in ("shortcut", "se") and int8_out.get(i)
                    and svec.get(i) is not None):
                ent.update(out_scales(i))
        if ent:
            q[key] = ent
    return {"params": q}


def quantize(ir: GraphIR, folded: dict, stats: dict,
             mode: str = "chain", hw: tuple | None = None,
             int8_stems: bool = False) -> dict:
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
    ``hw``: the deployment size, whose s2d plan (with ``graph._S2D_REGION``
    on) sets ``spine``'s and ``edge``'s plans and gives each planned conv
    its s2d leaves (``wq_t`` / ``sw_t`` / ``bt`` on an int8 one, ``wt`` /
    ``bt`` beside an fp one's kernel); every conv an s2d plan may hold
    keeps its fp kernel beside its int8 one (``fp``). ``int8_stems``: the
    stem pairs' first convs carry the int8 pair's leaves
    (:func:`_int8_stem`), and the executors run the pair int8."""
    _check_mode(mode)
    if mode == "edge":
        return _quantize_edge(ir, folded, stats, hw, int8_stems)
    params = folded["params"]
    s2d_cands, stem, plan = _s2d_setup(ir, hw)
    if mode in ("spine", "spineall"):
        targets, emits, spine = _plan_with_spine(ir, mode, plan)
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
            if node.index in s2d_cands:
                q[key]["fp"] = p
            if node.index in plan:
                _s2d_int8(qp, p["w"], p["b"], plan[node.index])
        else:
            q[key] = {"fp": (_s2d_fp(p, plan[node.index])
                             if node.index in plan else p)}
            if node.index in stem and key in stats and int8_stems:
                q[key].update(_int8_stem(params, stats, node.index,
                                         stem[node.index]))
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


def _place_kxk(wq, device):
    """An int8 OIHW kernel as the im2col product's (N, kh*kw*C) matrix in
    (kh, kw, c) order, zero-padded to multiples of 16 in N and K."""
    w = wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)
    n, k = w.shape
    return F.pad(w, (0, _pad16(k) - k, 0, _pad16(n) - n)).contiguous().to(
        device)


def _inv_scale(amax) -> tuple:
    """(sx, 1 / sx) of a calibrated amax in fp32, as the JAX package's
    int8 stem computes them: max(amax, 1e-12) / 127, then its inverse."""
    sx = np.maximum(np.float32(amax), np.float32(1e-12)) / np.float32(127.0)
    return sx, np.float32(1.0) / sx


def _place_stem(first: dict, second: dict, device, compute_dtype) -> dict:
    """The int8 stem pair of a first conv's entry ``first`` and its second
    conv's ``second`` (JAX quantize._q_fused_stem), placed for the plain
    basis: each conv's int8 kernel (its plain form, which ``stem_q``
    scatters) as an im2col matrix with the epilogue scale weight scale x
    sx of its input; the image's and the mid activation's inverse scales
    as Python floats; ``stem_out_*`` as (1, C, 1, 1) vectors."""
    out = {}
    for name, ent, amax in (("q1", first, first["amax_in"]),
                            ("q2", second, first["amax_mid"])):
        wq, sw = _quant_weight(ent["fp"]["w"])
        sx, inv = _inv_scale(amax)
        out[name] = {"w_nk": _place_kxk(wq, device),
                     "scale": (sw * torch.tensor(sx)).to(device).contiguous(),
                     "b": ent["fp"]["b"].to(device, torch.float32)}
        out["inv_in" if name == "q1" else "inv_mid"] = float(inv)
    for name in ("out_s", "out_inv"):
        if f"stem_{name}" in first:
            out[name] = _vec(first[f"stem_{name}"], device, compute_dtype)
    return out


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
    as (1, C, 1, 1); fp entries as :func:`.graph.place_folded` places them;
    the s2d leaves are not placed (the executors compute the plain basis).
    Returns ``{"params": {"l<i>": {"q": ...}, {"spine": ...} or fp params
    (with ``out_s`` / ``out_inv`` beside them in edge mode, and the int8
    stem pair as ``"stem8"`` (:func:`_place_stem`) on the first conv of
    each :func:`.graph.stem_fusion_pairs` pair, as the JAX executors gate
    on ``stem_pairs``: with ``_FUSE_STEM`` off an int8-stem artifact's
    stems run as fp convs)}}``."""
    entries = qvars["params"]
    fp = {k: e["fp"] for k, e in entries.items()
          if "fp" in e and "q" not in e}
    placed = G.place_folded(ir, {"params": fp}, device,
                            compute_dtype)["params"]
    pairs = G.stem_fusion_pairs(ir)     # empty with the stem switch off
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
            if node.index in pairs and "amax_in" in e and "amax_mid" in e:
                params[key]["stem8"] = _place_stem(
                    e, entries[f"l{pairs[node.index]}"], device,
                    compute_dtype)
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
            ent["w_nk"] = _place_kxk(wq, device)
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


def _stem8(ir: GraphIR, node, x, p, dtype, fused: set):
    """The int8 stem pair starting at ``node`` (JAX quantize._q_fused_stem,
    in the plain basis) when its entry holds it (``"stem8"``) and ``x`` is
    even in H and W, else None. The image quantized with its inverse scale,
    conv 1 as an int8 im2col product whose epilogue requantizes the mid
    activation to s8, conv 2 likewise to ``dtype``; in ``edge`` mode
    re-emitted per channel as a :class:`QVal` where ``stem_out_*`` are
    given. Adds the second conv to ``fused``: its hook passes the pair's
    output on."""
    st = p.get("stem8")
    if st is None or x.shape[2] % 2 or x.shape[3] % 2:
        return None
    n2 = ir.nodes[node.index + 1]
    fused.add(n2.index)
    y = _int8_conv(node, _quantize_input(x, st["inv_in"]), st["q1"],
                   st["inv_mid"], dtype)
    y = _int8_conv(n2, y, st["q2"], None, dtype)
    if "out_inv" in st:
        return QVal(_req(y, st["out_inv"]), st["out_s"])
    return y


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
    fused: set = set()

    def conv(node, inp, p):
        if node.index in fused:         # the int8 stem pair's second conv
            return inp
        if isinstance(inp, QVal):
            # quantized consumers read the codes: the spine scale is their
            # entry-quantize scale (_plan_spine)
            inp = inp.q if "q" in p else inp.deq(dtype)
        y = _stem8(ir, node, inp, p, dtype, fused)
        if y is not None:
            return y
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
    fused: set = set()

    def conv(node, inp, p):
        if node.index in fused:         # the int8 stem pair's second conv
            return inp
        if "q" in p:
            return qconv_edge(node, inp, p["q"], dtype)
        y = _stem8(ir, node, read(inp), p, dtype, fused)
        if y is not None:
            return y
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
    run as the int8 pair where their entries hold it, else as two fp convs
    (the second through K3); the heads go through K1."""
    _check_mode(mode)
    run = _apply_edge if mode == "edge" else _apply_chain
    heads = run(ir, qvars["params"], xv, xl, compute_dtype)
    return G.decode_heads(heads, xv.shape[0], xv.device)
