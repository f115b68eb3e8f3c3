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

``space``: a :class:`..parallel.spatial.SpaceShard`; the unfolded ops then
run on a band of rows: every k x k window takes its halo rows first
(``spatial.conv_rows``) and pads only the columns, and SE's global pool
sums over the bands (``spatial.band_mean``).

The JAX module's ``set_precision`` and ``set_conv_out_dtype`` are not
ported. They set XLA-global switches: the MXU's precision for fp32 convs
and matmuls, and the dtype of every conv's output. The port takes the
dtype per call (``compute_dtype``, a conv's output in its input's
dtype), and fp32 convs and matmuls on the card follow torch's TF32 flags
(``torch.backends.cudnn.allow_tf32``, ``torch.backends.cuda.matmul.
allow_tf32``; ``utils.general.deterministic`` turns both off), which are
their analogue.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.act import _hard_sigmoid, activate
from ..parallel.spatial import band_mean, conv_rows

BN_EPS = 1e-5
BN_MOMENTUM = 0.1   # torch convention: new = (1 - m) * old + m * batch


# ------------------------------------------------------------------- conv ops

def conv2d(x, w, b=None, stride=(1, 1), pad=0, groups: int = 1,
           space=None):
    """NCHW x OIHW grouped conv (+ bias), in the input's dtype. Depthwise is
    ``groups == in_ch``. ``pad``: an int, or (rows, columns)."""
    x, pad = conv_rows(x, w.shape[2], stride, pad, space)
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=tuple(stride), padding=pad, groups=groups)


def _at_least_f32(x):
    """fp32, or wider when ``x`` is already float64."""
    return x if x.dtype == torch.float64 else x.float()


def squeeze_excitation(x, params, space=None):
    """GAP -> 1x1 -> relu -> 1x1 -> hard-sigmoid -> scale, with the pooled
    path in fp32, or wider for float64 inputs (JAX layers.py:391-400). fc kernels are OIHW (S, C, 1, 1)."""
    xf = _at_least_f32(x)
    pooled = (xf.mean(dim=(2, 3)) if space is None
              else band_mean(xf, space))                         # (B, C)
    dt = pooled.dtype
    w1, w2 = params["fc1"]["w"], params["fc2"]["w"]
    s = F.linear(pooled, w1.reshape(w1.shape[0], -1).to(dt),
                 params["fc1"]["b"].to(dt))
    s = torch.relu(s)
    s = F.linear(s, w2.reshape(w2.shape[0], -1).to(dt),
                 params["fc2"]["b"].to(dt))
    s = _hard_sigmoid(s)
    return x * s[:, :, None, None].to(x.dtype)


def max_pool(x, kernel: int, stride=(1, 1), pad: int = 0, space=None):
    """torch MaxPool2d: symmetric padding that never wins (-inf)."""
    x, pad = conv_rows(x, kernel, stride, pad, space, float("-inf"))
    return F.max_pool2d(x, kernel, tuple(stride), pad)


def adaptive_avg_pool(x, out_size: int, space=None):
    """AdaptiveAvgPool2d(out_size): bin i covers
    [floor(i*n/k), ceil((i+1)*n/k)) on each axis. On a band only the
    global pool runs (``spatial.check_bands`` refuses the others)."""
    if space is not None:
        return band_mean(_at_least_f32(x), space)[:, :, None, None].to(
            x.dtype)
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


def inception(x, params, state=None, *, train: bool = False, group=None,
              space=None):
    """4-branch GoogLeNet block, every branch conv + BN + leaky (JAX
    layers.py:452-478). With ``state`` None the params are BN-folded (each
    branch conv carries ``w``/``b``, JAX graph.py:606-613) and the block
    returns its output; otherwise it runs BN from ``state`` (batch
    statistics when ``train``, over ``group`` when one is given) and
    returns (output, new state); ``space``: on a band, the 3x3 convs and
    the 3x3 pool take their halos."""
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
                                         pad=pad, act="leaky", train=train,
                                         group=group, space=space)
        return y

    b1 = cba(x, "b1_1")
    b2 = cba(cba(x, "b2_1"), "b2_2", 1)
    b3 = cba(cba(cba(x, "b3_1"), "b3_2", 1), "b3_3", 1)
    b4 = cba(max_pool(x, 3, (1, 1), 1, space), "b4_1")
    return torch.cat([b1, b2, b3, b4], dim=1), new_state


# ------------------------------------------------------- trainable conv ops

def batch_norm(x, params, state, train: bool, group=None, phases: int = 1):
    """BatchNorm2d over NCHW. Returns (y in ``x``'s dtype, new state).

    In train mode the statistics are the batch's, in fp32 (or wider): the
    mean, then a two-pass variance E[(x - mean)^2]; the running state moves
    by momentum 0.1 towards the mean and the *unbiased* variance (JAX
    layers.py:297-341). The batch statistics carry gradients into ``y``;
    the returned state is detached.

    ``group``: a ``torch.distributed`` group whose ranks each hold an
    equal share of the batch. The statistics are then the whole batch's,
    as JAX's ``pmean`` branch takes them (layers.py:320-329): the mean of
    the ranks' means, the mean of the ranks' squared deviations from it,
    and ``n`` the global count. The all-reduces are differentiable
    (:func:`..parallel.multihost.all_reduce_sum`), so the gradient flows
    through the global statistics to every rank.

    ``phases``: 4 when ``x`` is a phase-minor s2d tensor (B, 4C, H/2,
    W/2), channel 4c + phase (:func:`_s2d_w`'s order): the statistics
    pool each channel's four phases with the batch and the plane, so that
    they are the plain basis's per-channel ones, and broadcast back to the
    phases; the state stays C-shaped. With ``group`` the phases are pooled
    first, then the ranks."""

    def pool(v):                # per channel: mean over N, H, W (+ phases)
        if phases == 1:
            return v.mean(dim=(0, 2, 3))
        b, c, h, w = v.shape
        return v.reshape(b, c // phases, phases, h, w).mean(
            dim=(0, 2, 3, 4))

    def bcast(v):               # (C,) -> (C phases, 1, 1)
        if phases != 1:
            v = v.repeat_interleave(phases)
        return v[:, None, None]

    if train:
        xf = _at_least_f32(x)
        mean = pool(xf)
        n = x.shape[0] * x.shape[2] * x.shape[3] * phases
        if group is not None:
            from ..parallel.multihost import all_reduce_sum
            w = torch.distributed.get_world_size(group)
            mean = all_reduce_sum(mean, group) / w
        var = pool(torch.square(xf - bcast(mean)))
        if group is not None:
            var = all_reduce_sum(var, group) / w
            n = n * w
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
    y = ((_at_least_f32(x) - bcast(mean)) * bcast(inv)
         + bcast(params["bias"]))
    return y.to(x.dtype), new_state


def conv_bn_act(x, params, state, *, stride=(1, 1), pad=0, groups=1,
                act="linear", bn=True, train=False, group=None, space=None,
                s2d_role=None):
    """Conv (output in ``x``'s dtype) + BN or bias + activation (JAX
    layers.py:344-374). Returns (y, new BN state or ``state``).

    ``s2d_role``: the conv runs in the phase-minor s2d basis as that role
    (:func:`_s2d_w`, :data:`_S2D_GEOM`; ``graph.s2d_plan``), its kernel
    transformed from the plain one on every call (so the gradient reaches
    the plain kernel and the params, optimizer and checkpoints are the
    plain basis's), and BN pools the phases (``phases=4``, an x3 exit's
    plain output 1). An exact rewrite of the plain conv; not on a band
    (``space``)."""
    if s2d_role:
        s, ((pt, pb), (pl, pr)) = _S2D_GEOM[s2d_role]
        wt = _s2d_w(params["w"], s2d_role)
        y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), wt.to(x.dtype), stride=s)
        phases = 1 if s2d_role == "x3" else 4
        if bn:
            y, state = batch_norm(y, params["bn"], state, train, group,
                                  phases=phases)
        else:
            y = y + s2d_bias(params["b"], s2d_role).to(y.dtype)[:, None,
                                                               None]
        return activate(act, y.to(x.dtype)), state
    y = conv2d(x, params["w"], stride=stride, pad=pad, groups=groups,
               space=space)
    if bn:
        y, state = batch_norm(y, params["bn"], state, train, group)
    else:
        y = y + params["b"].to(y.dtype)[:, None, None]
    return activate(act, y.to(x.dtype)), state


def depthwise_separable(x, params, state, *, stride=(1, 1), train=False,
                        group=None, space=None):
    """3x3 depthwise + BN + ReLU6, then 1x1 pointwise + BN + ReLU6 (JAX
    layers.py:377-388, reference layers.py:218-234)."""
    y = conv2d(x, params["dw"]["w"], stride=stride, pad=1, groups=x.shape[1],
               space=space)
    y, s_dw = batch_norm(y, params["dw"]["bn"], state["dw"], train, group)
    y = activate("relu6", y)
    y = conv2d(y, params["pw"]["w"])
    y, s_pw = batch_norm(y, params["pw"]["bn"], state["pw"], train, group)
    y = activate("relu6", y)
    return y.to(x.dtype), {"dw": s_dw, "pw": s_pw}


def dropout(x, p: float, generator: torch.Generator, u=None):
    """Zero each element with probability ``p``, scale the rest by
    1 / (1 - p); the mask comes from ``generator`` (on ``x``'s device), or
    from the uniforms ``u`` when they are given."""
    keep = 1.0 - p
    if u is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    mask = u < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device)).to(x.dtype)


# ------------------------------------------------- space-to-depth rewrites
#
# The kernels of the JAX package's exact rewrites for the TPU's 128 lanes
# (JAX layers.py:143-265), on OIHW kernels. A tensor in the phase-minor
# space-to-depth basis is (B, 4C, H/2, W/2) with channel 4c + (2p + q), p and
# q the row and column phase. A planned conv (graph.s2d_plan) transforms by
# role: e1 / e3 enter the basis from a plain input (a 2x2 / 4x4 stride-2
# conv), i1 / i3 stay inside (a 1x1 with kron(w, I4) / a 3x3 on 4C), x3 (a
# 3x3 stride-2 conv) exits to plain (a 2x2 stride-1 conv). Each transformed
# kernel scatters the plain one among zeros, so every output channel holds
# all of its plain channel's weights: quantizing either per output channel
# gives the same scale and the same codes. The int8 artifacts hold these
# kernels (``models/quantize.py`` writes them and checks them on load). The
# port's inference executes every conv in the plain basis (on the H100 the
# s2d basis lost its A/B, PERF.md, Findings); the training path runs the
# basis under JAX's opt-in ``DYK_S2D_TRAIN`` (``conv_bn_act(s2d_role=)``,
# ``batch_norm(phases=4)``, ``graph.apply``).

def stem_pair_weights(w1, w2):
    """(O1, C, 3, 3) + (O2, O1, 3, 3) -> the fused stem pair's kernels (JAX
    layers.py:143-161): ``wb`` (4 O1, C, 4, 4), a 4x4 stride-2 conv whose
    output channels are phase-major ((2p + q) O1 + o), and ``w2s`` (O2,
    4 O1, 2, 2), a 2x2 stride-1 conv reading that basis."""
    o1, o2 = w1.shape[0], w2.shape[0]
    wb = w1.new_zeros((4 * o1, w1.shape[1], 4, 4))
    for p in range(2):
        for q in range(2):
            k = 2 * p + q
            wb[k * o1:(k + 1) * o1, :, p:p + 3, q:q + 3] = w1
    w2s = w2.new_zeros((o2, 4 * o1, 2, 2))
    for di in range(3):
        for dj in range(3):
            u, p = divmod(di - 1, 2)
            v, q = divmod(dj - 1, 2)
            k = 2 * p + q
            w2s[:, k * o1:(k + 1) * o1, u + 1, v + 1] = w2[:, :, di, dj]
    return wb, w2s


def _s2d_w(w, role: str):
    """An OIHW kernel -> its s2d-basis kernel for ``role`` (JAX
    layers.py:220-256), in ``w``'s dtype (int8 kernels too)."""
    o, c = w.shape[0], w.shape[1]
    if role == "i1":
        m = w.new_zeros((4 * o, 4 * c, 1, 1))
        for a in range(4):
            m[a::4, a::4] = w
        return m
    if role in ("e1", "e3"):
        k = 2 if role == "e1" else 4
        m = w.new_zeros((4 * o, c, k, k))
        for p in range(2):
            for q in range(2):
                if role == "e1":
                    m[2 * p + q::4, :, p, q] = w[:, :, 0, 0]
                else:
                    m[2 * p + q::4, :, p:p + 3, q:q + 3] = w
        return m
    if role == "i3":
        m = w.new_zeros((4 * o, 4 * c, 3, 3))
        for p in range(2):
            for q in range(2):
                for di in range(3):
                    for dj in range(3):
                        u, pp = divmod(p + di - 1, 2)
                        v, qq = divmod(q + dj - 1, 2)
                        m[2 * p + q::4, 2 * pp + qq::4, u + 1, v + 1] = \
                            w[:, :, di, dj]
        return m
    if role == "x3":
        m = w.new_zeros((o, 4 * c, 2, 2))
        for di in range(3):
            for dj in range(3):
                u, p = divmod(di - 1, 2)
                v, q = divmod(dj - 1, 2)
                m[:, 2 * p + q::4, u + 1, v + 1] = w[:, :, di, dj]
        return m
    raise ValueError(f"unknown s2d role {role!r}")


_S2D_GEOM = {                      # role -> (stride, ((pt, pb), (pl, pr)))
    "e1": (2, ((0, 0), (0, 0))),
    "e3": (2, ((1, 1), (1, 1))),
    "i1": (1, ((0, 0), (0, 0))),
    "i3": (1, ((1, 1), (1, 1))),
    "x3": (1, ((1, 0), (1, 0))),
}


def s2d_bias(b, role: str):
    """A planned conv's bias in its output basis: each channel's bias on
    its four phases (``jnp.repeat(b, 4)``); an x3 exit's bias unchanged."""
    return b if role == "x3" else b.repeat_interleave(4)


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
