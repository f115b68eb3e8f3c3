"""Seeded weights of a cfg model, made on the device from ``--seed`` in
two large draws, in float32.

The rule is the gain-by-family one the program's own bench uses
(``double_yolo_kaist_torch/bench.py::seeded_gain`` and
``seeded_variables``), copied here: conv kernels uniform in +-gain *
sqrt(1 / fan_in), the gain 2.2 for a stack with mish, 2.5 for one with
depthwise convs, 1.8 otherwise, so that the heads move with the input
and stay finite through every layer; BN scale U(0.5, 1.5), bias N(0,
0.2), running mean N(0, 0.2), running variance U(0.5, 2); SE and head
biases U(+-sqrt(1 / fan_in)); weighted shortcuts at 0.

The heads' last convs are then set from one seeded frame pair through
the float32 reference (:func:`calibrate`), channel by channel: the box
offsets spread with standard deviation 1, the sizes 1 about 1 (boxes
about twice their anchor), the class logits 1 about 3, and objectness 2
about a level that ``PASS_SHARE`` of a head's rows clear at the
confidence ``CONF``. As a trained detector's, the scores of what passes
then spread from the threshold up, most rows hold nothing, and
neighbouring candidates overlap, so that NMS suppresses a good share of
them, and which box it keeps is decided by scores that differ, not by
rounding among hundreds of near ties (the raw rule's logits, of standard
deviation 3 to 13, fill every frame to ``max_det`` with scores near 1).

The result is a dict by layer index that the reference reads as it is
and that :mod:`perfbench.program` hands to the program in its own tree.
"""

from __future__ import annotations

import math

import torch

CONF = 0.1           # the served confidence threshold
PASS_SHARE = 0.01    # of a head's rows: about 140 of a 448x512 pair's 14112
BOX_STD, WH_MEAN, CLASS_MEAN, CLASS_STD, OBJ_STD = 1.0, 1.0, 3.0, 1.0, 2.0


def gain(model) -> float:
    if any(L.act == "mish" for L in model.layers):
        return 2.2
    if any(L.kind == "dwconv" for L in model.layers):
        return 2.5
    return 1.8


def _plan(model):
    """[(path, kind, shape, a, b)]: each leaf, drawn uniform in [a, b)
    (``kind`` "u"), normal with std ``a`` ("n") or set to zeros ("z")."""
    g = gain(model)
    out = []

    def conv(path, k, cin, cout, groups=1, bn=True):
        fan_in = cin // groups * k * k
        bound = g * math.sqrt(1.0 / fan_in)
        out.append((path + ("w",), "u", (cout, cin // groups, k, k),
                    -bound, bound))
        if bn:
            out.append((path + ("scale",), "u", (cout,), 0.5, 1.5))
            out.append((path + ("bias",), "n", (cout,), 0.2, 0))
            out.append((path + ("mean",), "n", (cout,), 0.2, 0))
            out.append((path + ("var",), "u", (cout,), 0.5, 2.0))
        else:
            bb = math.sqrt(1.0 / fan_in)
            out.append((path + ("b",), "u", (cout,), -bb, bb))

    for L in model.layers:
        p = (L.i,)
        if L.kind == "conv":
            conv(p, L.k, L.cin, L.cout, L.groups, L.bn)
        elif L.kind == "dwconv":
            conv(p + ("dw",), L.k, L.cin, L.cin, groups=L.cin)
            conv(p + ("pw",), 1, L.cin, L.cout)
        elif L.kind == "se":
            c, s = L.cin, L.squeeze
            b1, b2 = math.sqrt(1.0 / c), math.sqrt(1.0 / s)
            out += [(p + ("w1",), "u", (s, c), -b1, b1),
                    (p + ("b1",), "u", (s,), -b1, b1),
                    (p + ("w2",), "u", (c, s), -b2, b2),
                    (p + ("b2",), "u", (c,), -b2, b2)]
        elif L.kind == "shortcut" and L.weighted:
            out.append((p + ("w",), "z", (len(L.inputs) + 1,), 0, 0))
    return out


def seeded(model, seed: int, device) -> dict:
    """The weights of ``model`` for ``seed`` on ``device``, float32."""
    plan = _plan(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    n_u = sum(math.prod(s) for _, k, s, _, _ in plan if k == "u")
    n_n = sum(math.prod(s) for _, k, s, _, _ in plan if k == "n")
    u = torch.rand(n_u, generator=gen, device=device)
    z = torch.randn(n_n, generator=gen, device=device)
    W: dict = {}
    iu = iz = 0
    for path, kind, shape, a, b in plan:
        n = math.prod(shape)
        if kind == "u":
            t = u[iu:iu + n].reshape(shape) * (b - a) + a
            iu += n
        elif kind == "n":
            t = z[iz:iz + n].reshape(shape) * a
            iz += n
        else:
            t = torch.zeros(shape, device=device)
        node = W
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return W


def calibrate(model, W: dict, xv, xl) -> None:
    """Set each head's last conv in ``W`` as the module says, from the
    float32 reference's heads on the pair (xv, xl) (NHWC in [0, 1])."""
    from .reference import model as RM

    with RM.strict_fp32(), torch.no_grad():
        heads = RM.forward(model, W, xv, xl)
    for L, h in zip(model.heads, heads):
        no = L.nc + 5
        y = h.permute(0, 2, 3, 1, 4).reshape(-1, len(L.anchors), no)
        mean, std = y.mean(0), y.std(0).clamp_min(1e-6)
        target_std = torch.full_like(mean, BOX_STD)
        target_std[:, 4], target_std[:, 5:] = OBJ_STD, CLASS_STD
        target_mean = torch.zeros_like(mean)
        target_mean[:, 2:4], target_mean[:, 5:] = WH_MEAN, CLASS_MEAN
        obj = (y[..., 4] - mean[:, 4]) / std[:, 4] * OBJ_STD
        cls = torch.sigmoid(torch.tensor(CLASS_MEAN))
        level = math.log(CONF / cls / (1 - CONF / cls))
        target_mean[:, 4] = level - torch.quantile(obj.flatten(),
                                                   1 - PASS_SHARE)
        a = (target_std / std).reshape(-1)
        p = W[L.i - 1]
        p["w"] *= a[:, None, None, None]
        p["b"].copy_((p["b"] - mean.reshape(-1)) * a
                     + target_mean.reshape(-1))
