"""Ops of the cfg layer zoo, in PyTorch: the BN-folded inference ops and
the unfolded, trainable ones (init, BatchNorm in train mode, conv + BN +
activation, depthwise-separable, inception, dropout).

Counterpart of ``double_yolo_kaist_tpu/models/layers.py``. Tensors are NCHW
in shape (torch's habit) and may lie channels-last in memory; kernels are
OIHW. Formulas follow the JAX package term by term (not torch's fused
``F.hardswish`` / ``F.mish`` / ``F.batch_norm``, which round differently),
so that fp32 runs agree with the JAX functions to float rounding.

Parameters stay fp32; each kernel is cast to the activations' dtype where
it is used (autograd returns fp32 gradients through the cast), and BN
statistics are taken in fp32. BatchNorm returns its new running state as a
value and never updates it in place, so a segment that
``torch.utils.checkpoint`` runs twice updates nothing twice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1   # torch convention: new = (1 - m) * old + m * batch


# ----------------------------------------------------------------- activations

def _softplus(x):
    """max(x, 0) + log1p(exp(-|x|)): the JAX package's select-free softplus."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _mish(x):
    return x * torch.tanh(_softplus(x))


def _leaky(x):
    """max(x, 0.1 x) with 0.1 in ``x``'s dtype: JAX types the Python scalar
    weakly, so in bf16 it multiplies by bf16(0.1), not by fp32(0.1)."""
    return torch.maximum(x, x * torch.tensor(0.1, dtype=x.dtype))


def _hard_sigmoid(x):
    return torch.clamp((x + 3.0) / 6.0, 0.0, 1.0)


ACTIVATIONS = {
    "linear": lambda x: x,
    "leaky": _leaky,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "mish": _mish,
    "hard-sigmoid": _hard_sigmoid,
    "hard-swish": lambda x: x * _hard_sigmoid(x),
}


def activate(name: str, x):
    return ACTIVATIONS[name](x)


# ------------------------------------------------------------------- conv ops

def conv2d(x, w, b=None, stride=(1, 1), pad: int = 0, groups: int = 1):
    """NCHW x OIHW grouped conv (+ bias), in the input's dtype. Depthwise is
    ``groups == in_ch``."""
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=tuple(stride), padding=pad, groups=groups)


def _at_least_f32(x):
    """fp32, or wider when ``x`` is already float64."""
    return x if x.dtype == torch.float64 else x.float()


def squeeze_excitation(x, params):
    """GAP -> 1x1 -> relu -> 1x1 -> hard-sigmoid -> scale, with the pooled
    path in fp32, or wider for float64 inputs (JAX layers.py:391-400). fc kernels are OIHW (S, C, 1, 1)."""
    pooled = _at_least_f32(x).mean(dim=(2, 3))                   # (B, C)
    dt = pooled.dtype
    w1, w2 = params["fc1"]["w"], params["fc2"]["w"]
    s = F.linear(pooled, w1.reshape(w1.shape[0], -1).to(dt),
                 params["fc1"]["b"].to(dt))
    s = torch.relu(s)
    s = F.linear(s, w2.reshape(w2.shape[0], -1).to(dt),
                 params["fc2"]["b"].to(dt))
    s = _hard_sigmoid(s)
    return x * s[:, :, None, None].to(x.dtype)


def max_pool(x, kernel: int, stride=(1, 1), pad: int = 0):
    """torch MaxPool2d: symmetric padding that never wins (-inf)."""
    return F.max_pool2d(x, kernel, tuple(stride), pad)


def adaptive_avg_pool(x, out_size: int):
    """AdaptiveAvgPool2d(out_size): bin i covers
    [floor(i*n/k), ceil((i+1)*n/k)) on each axis."""
    return F.adaptive_avg_pool2d(x, out_size)


def upsample_nearest(x, scale: int):
    """Nearest-neighbour upsampling by an integer ``scale`` (each value
    copied into a scale x scale patch). Keeps the input's memory format, so
    that the channels-last forward stays channels-last through the routes
    that concatenate an upsample with a conv output, down to the heads."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def weighted_fusion(x, extras: list, w=None):
    """Add ``x`` and earlier outputs, with optional learned sigmoid weights
    times 2/n and the channel-slice rule for mismatched widths (JAX
    layers.py:480-499; reference layers.py:63-85)."""
    n = len(extras) + 1
    if w is not None:
        # fp32, as JAX computes them; float64 activations keep float64
        ws = torch.sigmoid(w.to(torch.promote_types(x.dtype,
                                                    torch.float32))) \
            * (2.0 / n)
        x = x * ws[0].to(x.dtype)
    nx = x.shape[1]
    for i, a in enumerate(extras):
        if w is not None:
            a = a * ws[i + 1].to(a.dtype)
        na = a.shape[1]
        if nx == na:
            x = x + a
        elif nx > na:
            x = torch.cat([x[:, :na] + a, x[:, na:]], dim=1)
        else:
            x = x + a[:, :nx]
    return x


def inception(x, params, state=None, *, train: bool = False):
    """4-branch GoogLeNet block, every branch conv + BN + leaky (JAX
    layers.py:452-478). With ``state`` None the params are BN-folded (each
    branch conv carries ``w``/``b``, JAX graph.py:606-613) and the block
    returns its output; otherwise it runs BN from ``state`` (batch
    statistics when ``train``) and returns (output, new state)."""
    if state is None:
        def branch(inp, name, pad=0):
            return activate("leaky", conv2d(inp, params[name]["w"],
                                            params[name]["b"], pad=pad))

        b1 = branch(x, "b1_1")
        b2 = branch(branch(x, "b2_1"), "b2_2", 1)
        b3 = branch(branch(branch(x, "b3_1"), "b3_2", 1), "b3_3", 1)
        b4 = branch(max_pool(x, 3, (1, 1), 1), "b4_1")
        return torch.cat([b1, b2, b3, b4], dim=1)

    new_state = {}

    def cba(inp, name, pad=0):
        y, new_state[name] = conv_bn_act(inp, params[name], state[name],
                                         pad=pad, act="leaky", train=train)
        return y

    b1 = cba(x, "b1_1")
    b2 = cba(cba(x, "b2_1"), "b2_2", 1)
    b3 = cba(cba(cba(x, "b3_1"), "b3_2", 1), "b3_3", 1)
    b4 = cba(max_pool(x, 3, (1, 1), 1), "b4_1")
    return torch.cat([b1, b2, b3, b4], dim=1), new_state


# ------------------------------------------------------- trainable conv ops

def batch_norm(x, params, state, train: bool):
    """BatchNorm2d over NCHW. Returns (y in ``x``'s dtype, new state).

    In train mode the statistics are the batch's, in fp32 (or wider): the
    mean, then a two-pass variance E[(x - mean)^2]; the running state moves
    by momentum 0.1 towards the mean and the *unbiased* variance (JAX
    layers.py:297-341). The batch statistics carry gradients into ``y``;
    the returned state is detached."""
    if train:
        xf = _at_least_f32(x)
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.square(xf - mean[:, None, None]).mean(dim=(0, 2, 3))
        n = x.shape[0] * x.shape[2] * x.shape[3]
        unbiased = var.detach() * (n / max(n - 1, 1))
        new_state = {
            "mean": (1 - BN_MOMENTUM) * state["mean"]
            + BN_MOMENTUM * mean.detach(),
            "var": (1 - BN_MOMENTUM) * state["var"] + BN_MOMENTUM * unbiased,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + BN_EPS) * params["scale"]
    y = ((_at_least_f32(x) - mean[:, None, None]) * inv[:, None, None]
         + params["bias"][:, None, None])
    return y.to(x.dtype), new_state


def conv_bn_act(x, params, state, *, stride=(1, 1), pad=0, groups=1,
                act="linear", bn=True, train=False):
    """Conv (output in ``x``'s dtype) + BN or bias + activation (JAX
    layers.py:344-374). Returns (y, new BN state or ``state``)."""
    y = conv2d(x, params["w"], stride=stride, pad=pad, groups=groups)
    if bn:
        y, state = batch_norm(y, params["bn"], state, train)
    else:
        y = y + params["b"].to(y.dtype)[:, None, None]
    return activate(act, y.to(x.dtype)), state


def depthwise_separable(x, params, state, *, stride=(1, 1), train=False):
    """3x3 depthwise + BN + ReLU6, then 1x1 pointwise + BN + ReLU6 (JAX
    layers.py:377-388, reference layers.py:218-234)."""
    y = conv2d(x, params["dw"]["w"], stride=stride, pad=1, groups=x.shape[1])
    y, s_dw = batch_norm(y, params["dw"]["bn"], state["dw"], train)
    y = activate("relu6", y)
    y = conv2d(y, params["pw"]["w"])
    y, s_pw = batch_norm(y, params["pw"]["bn"], state["pw"], train)
    y = activate("relu6", y)
    return y.to(x.dtype), {"dw": s_dw, "pw": s_pw}


def dropout(x, p: float, generator: torch.Generator):
    """Zero each element with probability ``p``, scale the rest by
    1 / (1 - p); the mask comes from ``generator`` (on ``x``'s device)."""
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device)).to(x.dtype)


# ------------------------------------------------------------ initialization

def _kaiming_uniform(generator, shape, fan_in):
    """torch Conv2d's default init, kaiming_uniform_(a=sqrt(5)):
    U(+-sqrt(1 / fan_in)), fp32 on the CPU."""
    bound = math.sqrt(1.0 / fan_in)
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def init_conv(generator, kernel: int, in_ch: int, out_ch: int,
              groups: int = 1, bias: bool = False) -> dict:
    """OIHW kernel (+ optional bias), torch-default init."""
    fan_in = (in_ch // groups) * kernel * kernel
    p = {"w": _kaiming_uniform(generator,
                               (out_ch, in_ch // groups, kernel, kernel),
                               fan_in)}
    if bias:
        p["b"] = _kaiming_uniform(generator, (out_ch,), fan_in)
    return p


def init_bn(ch: int) -> tuple[dict, dict]:
    params = {"scale": torch.ones(ch), "bias": torch.zeros(ch)}
    state = {"mean": torch.zeros(ch), "var": torch.ones(ch)}
    return params, state


def init_node_params(generator, node) -> tuple[dict | None, dict | None]:
    """(params, BN state) of one IR node, None where it has none (JAX
    layers.py:510-550)."""
    kind = node.kind
    if kind == "conv":
        p = init_conv(generator, node.kernel, node.in_ch, node.out_ch,
                      groups=node.groups, bias=not node.bn)
        s = None
        if node.bn:
            p["bn"], s = init_bn(node.out_ch)
        return p, s
    if kind == "dwconv":
        dw = init_conv(generator, node.kernel, node.in_ch, node.in_ch,
                       groups=node.in_ch)
        pw = init_conv(generator, 1, node.in_ch, node.out_ch)
        dw["bn"], s_dw = init_bn(node.in_ch)
        pw["bn"], s_pw = init_bn(node.out_ch)
        return {"dw": dw, "pw": pw}, {"dw": s_dw, "pw": s_pw}
    if kind == "se":
        return {"fc1": init_conv(generator, 1, node.in_ch, node.squeeze_ch,
                                 bias=True),
                "fc2": init_conv(generator, 1, node.squeeze_ch, node.in_ch,
                                 bias=True)}, None
    if kind == "inception":
        icp, c = node.icp, node.in_ch
        specs = {"b1_1": (1, c, icp["n1x1"]),
                 "b2_1": (1, c, icp["n3x3_reduce"]),
                 "b2_2": (3, icp["n3x3_reduce"], icp["n3x3"]),
                 "b3_1": (1, c, icp["n5x5_reduce"]),
                 "b3_2": (3, icp["n5x5_reduce"], icp["n5x5"]),
                 "b3_3": (3, icp["n5x5"], icp["n5x5"]),
                 "b4_1": (1, c, icp["pool_proj"])}
        params, state = {}, {}
        for name, (ksz, ci, co) in specs.items():
            params[name] = init_conv(generator, ksz, ci, co)
            params[name]["bn"], state[name] = init_bn(co)
        return params, state
    if kind == "shortcut" and node.weighted:
        return {"w": torch.zeros(len(node.inputs) + 1)}, None
    return None, None
