"""The multiply-add count (x 2) of one forward of a cfg model, from its
shapes: a copy of the program's ``utils/profiling.py::flops_estimate``
over the benchmark's own cfg reader. Convs count 2 Ho Wo k^2 (Cin / g)
Cout, a depthwise-separable block its 3x3 depthwise and its 1x1, an SE
block its two small products; activations, BN, pools and adds are not
counted."""

from __future__ import annotations

from .reference.cfg import shapes


def forward_flops(model, h: int, w: int) -> float:
    """FLOPs of one forward of one frame (pair) at input (h, w)."""
    out = shapes(model, h, w)
    total = 0.0
    for L in model.layers:
        _, ho, wo = out[L.i]
        if L.kind == "conv":
            total += 2 * ho * wo * L.k ** 2 * (L.cin // L.groups) * L.cout
        elif L.kind == "dwconv":
            total += 2 * ho * wo * (L.k ** 2 * L.cin + L.cin * L.cout)
        elif L.kind == "se":
            total += 2 * 2 * L.cin * L.squeeze
    return total

