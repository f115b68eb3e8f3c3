"""The plain float32 forward of a cfg model, in PyTorch, for the
comparisons that decide ``correct``.

One function walks the layers of :mod:`.cfg` on NCHW tensors, with BN
in inference form from the raw seeded weights' running statistics.
:func:`forward_bf16` runs the folded forward in bf16, as a bf16 program
does. Matrix products and convs run in full float32: TF32 is switched
off by :func:`strict_fp32`, which the callers enter.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


@contextlib.contextmanager
def strict_fp32():
    """cuBLAS and cuDNN in full float32 (TF32 off) inside the block."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32, c.allow_tf32 = False, False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def act(name: str, x):
    if name == "linear":
        return x
    if name == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if name == "relu":
        return torch.clamp_min(x, 0.0)
    if name == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if name == "mish":
        return x * torch.tanh(F.softplus(x))
    if name == "hard-swish":
        return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0
    raise ValueError(f"unknown activation {name}")


def bn_scale(p):
    return p["scale"] / torch.sqrt(p["var"] + BN_EPS)


def conv_bn(x, p, *, stride, pad, groups):
    """Conv, then BN in inference form (or the bias of a conv without
    BN)."""
    y = F.conv2d(x, p["w"], None, stride, pad, 1, groups)
    if "b" in p:
        return y + p["b"][:, None, None]
    s = bn_scale(p)
    return y * s[:, None, None] + (p["bias"] - p["mean"] * s)[:, None, None]


def forward(model, W: dict, xv, xl):
    """Visible / LWIR images NHWC in [0, 1] -> each head's raw output
    (B, na, ny, nx, no), float32. ``W``: the seeded weights by layer
    index (:mod:`perfbench.weights`)."""
    x = xv.float().permute(0, 3, 1, 2)
    x2 = None if xl is None else xl.float().permute(0, 3, 1, 2)
    cache: dict = {}
    heads = []
    keep = {j for L in model.layers for j in L.inputs}
    for L in model.layers:
        p = W.get(L.i)
        if L.kind == "conv":
            inp = x2 if L.second else x
            x = act(L.act, conv_bn(inp, p, stride=L.stride, pad=L.pad,
                                   groups=L.groups))
        elif L.kind == "dwconv":
            y = act("relu6", conv_bn(x, p["dw"], stride=L.stride, pad=1,
                                     groups=L.cin))
            x = act("relu6", conv_bn(y, p["pw"], stride=1, pad=0, groups=1))
        elif L.kind == "se":
            s = x.mean(dim=(2, 3))
            s = torch.clamp_min(s @ p["w1"].t() + p["b1"], 0.0)
            s = s @ p["w2"].t() + p["b2"]
            s = torch.clamp((s + 3.0) / 6.0, 0.0, 1.0)
            x = x * s[:, :, None, None]
        elif L.kind == "maxpool":
            x = F.max_pool2d(x, L.k, L.stride, L.pad)
        elif L.kind == "upsample":
            x = x.repeat_interleave(L.stride, 2).repeat_interleave(
                L.stride, 3)
        elif L.kind == "route":
            x = torch.cat([cache[j] for j in L.inputs], dim=1)
        elif L.kind == "shortcut":
            ins = [cache[j] for j in L.inputs]
            n = len(ins) + 1
            ws = (torch.sigmoid(p["w"]) * (2.0 / n) if L.weighted
                  else torch.ones(n, device=x.device))
            y = x * ws[0]
            for a, wa in zip(ins, ws[1:]):
                c = min(y.shape[1], a.shape[1])
                y = torch.cat([y[:, :c] + a[:, :c] * wa, y[:, c:]], dim=1)
            x = y
        elif L.kind == "yolo":
            na, no = len(L.anchors), L.nc + 5
            b, _, ny, nx = x.shape
            heads.append(x.reshape(b, na, no, ny, nx).permute(0, 1, 3, 4, 2))
        if L.i in keep:
            cache[L.i] = x
    return heads


def act_lowp(name: str, x):
    """The activations term by term in ``x``'s own dtype (bf16 below),
    each operation rounding as a bf16 program's does."""
    if name == "mish":
        sp = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))
        return x * torch.tanh(sp)
    if name == "leaky":
        return torch.maximum(x, x * torch.tensor(0.1, dtype=x.dtype))
    if name == "hard-swish":
        return x * torch.clamp((x + 3.0) / 6.0, 0.0, 1.0)
    return act(name, x)


def forward_bf16(model, W: dict, xv, xl):
    """The BN-folded inference forward run in bfloat16, as a bf16 program
    runs it: the BN folded into each kernel and bias in float32, both cast
    to bf16; convs on bf16 tensors (float32 accumulation), activations
    term by term in bf16, SE's pooled path and the shortcut weights in
    float32. Returns the heads as :func:`forward` does, in float32."""
    bf = torch.bfloat16

    def fold(p):
        if "b" in p:
            return p["w"].to(bf), p["b"].to(bf)
        s = bn_scale(p)
        return ((p["w"] * s[:, None, None, None]).to(bf),
                (p["bias"] - p["mean"] * s).to(bf))

    x = xv.to(bf).permute(0, 3, 1, 2)
    x2 = None if xl is None else xl.to(bf).permute(0, 3, 1, 2)
    cache: dict = {}
    heads = []
    keep = {j for L in model.layers for j in L.inputs}
    for L in model.layers:
        p = W.get(L.i)
        if L.kind == "conv":
            w, b = fold(p)
            x = act_lowp(L.act, F.conv2d(x2 if L.second else x, w, b,
                                         L.stride, L.pad, 1, L.groups))
        elif L.kind == "dwconv":
            w, b = fold(p["dw"])
            y = act("relu6", F.conv2d(x, w, b, L.stride, 1, 1, L.cin))
            w, b = fold(p["pw"])
            x = act("relu6", F.conv2d(y, w, b))
        elif L.kind == "se":
            s = x.float().mean(dim=(2, 3))
            s = torch.clamp_min(s @ p["w1"].t() + p["b1"], 0.0)
            s = torch.clamp((s @ p["w2"].t() + p["b2"] + 3.0) / 6.0, 0.0, 1.0)
            x = x * s[:, :, None, None].to(bf)
        elif L.kind == "maxpool":
            x = F.max_pool2d(x, L.k, L.stride, L.pad)
        elif L.kind == "upsample":
            x = x.repeat_interleave(L.stride, 2).repeat_interleave(
                L.stride, 3)
        elif L.kind == "route":
            x = torch.cat([cache[j] for j in L.inputs], dim=1)
        elif L.kind == "shortcut":
            ins = [cache[j] for j in L.inputs]
            n = len(ins) + 1
            ws = (torch.sigmoid(p["w"]) * (2.0 / n) if L.weighted
                  else torch.ones(n, device=x.device))
            y = x * ws[0].to(bf) if L.weighted else x
            for a, wa in zip(ins, ws[1:]):
                a = a * wa.to(bf) if L.weighted else a
                c = min(y.shape[1], a.shape[1])
                y = torch.cat([y[:, :c] + a[:, :c], y[:, c:]], dim=1)
            x = y
        elif L.kind == "yolo":
            na, no = len(L.anchors), L.nc + 5
            b, _, ny, nx = x.shape
            heads.append(x.float().reshape(b, na, no, ny, nx).permute(
                0, 1, 3, 4, 2))
        if L.i in keep:
            cache[L.i] = x
    return heads


def decode(model, heads):
    """Raw heads -> (B, rows, 5 + nc): xywh in input pixels, objectness
    and class probabilities."""
    out = []
    for L, p in zip(model.heads, heads):
        b, na, ny, nx, no = p.shape
        gy, gx = torch.meshgrid(torch.arange(ny, device=p.device),
                                torch.arange(nx, device=p.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).float()[None, None]
        anc = torch.tensor(L.anchors, dtype=torch.float32,
                           device=p.device).reshape(1, na, 1, 1, 2) \
            / L.stride_px
        s = torch.sigmoid(p)
        if model.bf_type == "yolov4":
            xy = s[..., :2] * 2.0 - 0.5 + grid
            wh = torch.square(s[..., 2:4] * 2.0) * anc
        else:
            xy = s[..., :2] + grid
            wh = torch.exp(p[..., 2:4]) * anc
        io = torch.cat([xy * L.stride_px, wh * L.stride_px, s[..., 4:]], -1)
        out.append(io.reshape(b, -1, no))
    return torch.cat(out, 1)

