"""Post-training int8 quantization for the inference path.

Counterpart of ``double_yolo_kaist_tpu/models/quantize.py`` for the modes
``seed``, ``chain`` and ``all``. Scheme: symmetric int8; weights per output
channel from the BN-folded kernels, activations per tensor with scales from
a calibration pass (max-abs over sample batches). Quantized convs run
int8 x int8 -> int32 and dequantize into the bias add; a chain-emitting
conv requantizes its output straight to int8 for the next conv. SE blocks,
head predictors, the stem pairs and decode stay full precision.

Flow (the same as the JAX package's):
    folded = graph.fold_batchnorm(ir, variables)           # CPU, fp32
    stats  = calibrate(ir, placed_folded, [(xv, xl), ...])
    qvars  = quantize(ir, folded, stats)                   # CPU
    qp     = place_quantized(ir, qvars, device, dtype)
    io, _  = apply_quantized(ir, qp, xv, xl, compute_dtype=dtype)

Quantized 1x1 stride-1 convs go through kernel K4 (:mod:`..ops.qgemm`);
kxk int8 convs are an int8 im2col and ``torch._int_mm``, as the JAX package
leaves them to XLA. Calibration stats are saved and loaded in the JAX
package's ``.npz`` format (:func:`save_calibration`, :func:`load_calibration`).
Modes ``spine``, ``spineall`` and ``edge``, the quantized-variables
artifacts and the int8 stems are not ported yet (ROADMAP.md, queue 1 item
11).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..config.ir import GraphIR
from ..ops import qgemm as K4
from . import graph as G

MODES = ("seed", "chain", "all")
_NOT_PORTED = ("spine", "spineall", "edge")


# ----------------------------------------------------------------------- plan

def _standard_convs(ir: GraphIR) -> set:
    """Standard convs that could carry int8: head predictors and stem pairs
    excluded (JAX quantize.py:39-48 with its default fused stem)."""
    skip = {ir.nodes[yi - 1].index for yi in ir.yolo_indices}
    pairs = G.stem_fusion_pairs(ir)
    skip |= set(pairs) | set(pairs.values())
    return {n.index for n in ir.nodes
            if n.kind == "conv" and n.groups == 1 and n.index not in skip}


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


def _check_mode(mode: str) -> None:
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"int8 mode {mode!r} is not ported yet (ROADMAP.md, queue 1 "
            f"item 11); the port has {MODES}")
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")


def plan_quantization(ir: GraphIR, mode: str = "chain"):
    """-> (targets: set of quantized conv indices, emits: set of targets
    whose output is requantized to int8 for the next conv).

    ``seed``: kernel >= 3 convs, each dequantizing to the compute dtype;
    ``chain``: the seed set grown to a fixpoint by the 1x1 convs whose input
    arrives as int8 from a sole-consumer predecessor; ``all``: every
    standard conv. The thin-input rule (in_ch >= 16) holds in every mode."""
    _check_mode(mode)
    standard = {i for i in _standard_convs(ir) if ir.nodes[i].in_ch >= 16}
    if mode == "seed":
        return _quantizable(ir), set()
    if mode == "all":
        targets = set(standard)
    else:                                    # chain
        targets = set(_quantizable(ir))
        changed = True
        while changed:
            changed = False
            for j in sorted(standard - targets):
                if _chain_edge(ir, j - 1, targets | {j}):
                    targets.add(j)
                    changed = True
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


# ------------------------------------------------------------------ calibrate

def _abs_stat(a, pct: float):
    """max |a| (pct 100) or its ``pct`` percentile with linear
    interpolation, as ``jnp.percentile`` computes it; a 0-dim fp32 tensor.
    The percentile takes the top ``n - floor(pos)`` values only."""
    a = a.float().abs().reshape(-1)
    if pct >= 100.0:
        return a.amax()
    n = a.numel()
    pos = pct / 100.0 * (n - 1)
    lo = int(math.floor(pos))
    frac = pos - lo
    top = torch.topk(a, n - lo).values          # descending
    v_lo = top[-1]
    v_hi = top[-2] if n - lo >= 2 else top[-1]
    return v_lo * (1.0 - frac) + v_hi * frac


def calibrate(ir: GraphIR, folded: dict, batches,
              compute_dtype=torch.bfloat16, pct: float = 100.0) -> dict:
    """Per-tensor input amax of every standard conv (head predictors
    excluded, stem pairs included) over ``batches`` of (xv, xl-or-None)
    NHWC images: the max over batches of each batch's ``pct``-percentile
    max-abs (JAX quantize.py:386-507). ``folded``: BN-folded params placed
    for the executor (:func:`.graph.place_folded`). The forward is
    :func:`.graph.run_graph` with the fp convs, K3 included, and no head
    decode. Returns {"l<i>": float}."""
    skip = {ir.nodes[yi - 1].index for yi in ir.yolo_indices}
    targets = {n.index for n in ir.nodes
               if n.kind == "conv" and n.groups == 1 and n.index not in skip}
    acc: dict = {}
    with torch.inference_mode():
        for xv, xl in batches:
            stats = {}

            def conv(node, inp, p):
                if node.index in targets:
                    stats[f"l{node.index}"] = _abs_stat(inp, pct)
                return G.conv_folded(node, inp, p)

            G.run_graph(ir, folded["params"], xv, xl, dtype=compute_dtype,
                        conv=conv)
            keys = sorted(stats)
            values = torch.stack([stats[k] for k in keys]).double().cpu()
            for k, v in zip(keys, values.tolist()):
                acc[k] = max(acc.get(k, 0.0), v)
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
    package's) -> (stats, pct). Per-channel stats (the JAX package's ``edge``
    mode writes ``l<i>.out`` vectors) come back as arrays; no mode of the
    port reads them."""
    with np.load(path) as z:
        pct = float(z["__pct__"]) if "__pct__" in z.files else 100.0
        stats = {}
        for k in z.files:
            if k == "__pct__":
                continue
            v = z[k]
            stats[k] = float(v) if v.ndim == 0 else v
    return stats, pct


# ------------------------------------------------------------------- quantize

def _quant_weight(w):
    """OIHW fp32 kernel -> (int8 kernel, per-output-channel scale fp32):
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


def quantize(ir: GraphIR, folded: dict, stats: dict,
             mode: str = "chain") -> dict:
    """BN-folded params (CPU, fp32, OIHW; :func:`.graph.fold_batchnorm`) +
    calibration stats -> quantized variables ``{"params": {"l<i>": {"q":
    {wq, scale, inv_sx, b[, out_inv_s]}} or {"fp": folded params}}}``.
    A chain-emitting conv carries ``out_inv_s`` = 127 / amax(next conv's
    input)."""
    params = folded["params"]
    targets, emits = plan_quantization(ir, mode)
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
    return {"params": q}


def _gemm_conv(node) -> bool:
    """The quantized convs K4 computes: 1x1, stride 1, no pad, groups 1."""
    return (node.kernel == 1 and tuple(node.stride) == (1, 1)
            and node.pad == 0 and node.groups == 1)


def place_quantized(ir: GraphIR, qvars: dict, device,
                    compute_dtype) -> dict:
    """Move :func:`quantize`'s output to ``device`` once, in the layouts the
    executor reads: a 1x1 int8 kernel packed for K4 (``"k4"``:
    :func:`..ops.qgemm.pack_weights`, the (N, K) form, made once here), a
    kxk one as (N, kh*kw*C) in (kh, kw, c) order for the im2col product
    (``"w_nk"``); scale and bias fp32, contiguous; fp entries as
    :func:`.graph.place_folded` places them.
    Returns ``{"params": {"l<i>": {"q": ...} or fp params}}``."""
    entries = qvars["params"]
    fp = {k: e["fp"] for k, e in entries.items() if "fp" in e}
    placed = G.place_folded(ir, {"params": fp}, device,
                            compute_dtype)["params"]
    params = {}
    for node in ir.nodes:
        key = f"l{node.index}"
        e = entries.get(key)
        if e is None:
            continue
        if "q" not in e:
            params[key] = placed[key]
            continue
        qp, wq = e["q"], e["q"]["wq"]
        ent = {"scale": qp["scale"].to(device, torch.float32).contiguous(),
               "b": qp["b"].to(device, torch.float32).contiguous(),
               "inv_sx": float(qp["inv_sx"])}
        if "out_inv_s" in qp:
            ent["out_inv_s"] = float(qp["out_inv_s"])
        if _gemm_conv(node):
            ent["k4"] = K4.pack_weights(wq[:, :, 0, 0].t().to(device))
        else:
            ent["w_nk"] = wq.permute(0, 2, 3, 1).reshape(
                wq.shape[0], -1).contiguous().to(device)
        params[key] = {"q": ent}
    return {"params": params}


# ---------------------------------------------------------------------- apply

def _quantize_input(x, inv_sx: float):
    """round(x * inv_sx) clipped to [-127, 127] as s8, in x's dtype."""
    inv = torch.tensor(inv_sx, dtype=torch.float32).to(x.dtype)
    return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)


def _im2col(xn, k: int, stride, pad: int):
    """NHWC s8 (B, H, W, C) -> (B*Ho*Wo, k*k*C) patches in (kh, kw, c)
    order, from a pad and k*k strided slices."""
    b, h, w, c = xn.shape
    sy, sx = stride
    ho = (h + 2 * pad - k) // sy + 1
    wo = (w + 2 * pad - k) // sx + 1
    xp = F.pad(xn, (0, 0, pad, pad, pad, pad))
    cols = [xp[:, i:i + sy * (ho - 1) + 1:sy, j:j + sx * (wo - 1) + 1:sx, :]
            for i in range(k) for j in range(k)]
    return torch.cat(cols, dim=-1).reshape(b * ho * wo, k * k * c), ho, wo


def qconv(node, x, qp, out_dtype):
    """One quantized conv (JAX quantize._qconv): quantize the input unless
    it arrives as s8, then a 1x1 through K4 (:func:`..ops.qgemm.qgemm`) or
    a kxk as im2col + int32 product + the same epilogue. Returns s8 when
    the conv emits into a chain, else ``out_dtype``; NCHW-shaped,
    channels-last."""
    xq = x if x.dtype == torch.int8 else _quantize_input(x, qp["inv_sx"])
    xn = xq.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    inv = qp.get("out_inv_s")
    if "k4" in qp:
        y = K4.qgemm(xn, qp["k4"], qp["scale"], qp["b"], node.act,
                     out_inv_s=inv, out_dtype=out_dtype)
    else:
        a, ho, wo = _im2col(xn, node.kernel, node.stride, node.pad)
        acc = K4.int_mm(a, qp["w_nk"])
        y = K4.epilogue_plain(acc, qp["scale"], qp["b"], node.act, inv,
                              out_dtype).reshape(xn.shape[0], ho, wo, -1)
    return y.permute(0, 3, 1, 2)


def apply_quantized(ir: GraphIR, qvars: dict, xv, xl=None, *,
                    compute_dtype=torch.bfloat16, mode: str = "chain"):
    """int8 inference forward -> (decoded (bs, total, no) fp32, raw heads).
    ``qvars`` from :func:`place_quantized`; ``mode`` must match the
    :func:`quantize` call that built them. The stem pairs run as two fp
    convs (the second through K3), the heads through K1."""
    _check_mode(mode)

    def conv(node, inp, p):
        if "q" in p:
            return qconv(node, inp, p["q"], compute_dtype)
        return G.conv_folded(node, inp, p)

    heads = G.run_graph(ir, qvars["params"], xv, xl, dtype=compute_dtype,
                        conv=conv)
    return G.decode_heads(heads, xv.shape[0], xv.device)
