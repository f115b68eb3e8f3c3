"""Serialize parsed cfg blocks back to darknet-dialect ``.cfg`` text.

The port's copy of the JAX package's ``config/writer.py`` (numpy only):
the inverse of :func:`.parser.parse_model_cfg`, so that
``parse(format_cfg(parse(f))) == parse(f)``. Used by
``train/anchors.py``'s cfg-rewrite path.
"""

from __future__ import annotations

import numpy as np


def _fmt_num(x) -> str:
    """Format a number the way darknet cfgs write it (ints without .0)."""
    if isinstance(x, float) and x.is_integer():
        return str(int(x))
    return str(x)


def _fmt_val(key: str, val) -> str:
    if key == "anchors":
        a = np.asarray(val).reshape(-1, 2)
        return ", ".join(f"{_fmt_num(float(w))},{_fmt_num(float(h))}"
                         for w, h in a)
    if isinstance(val, (list, tuple)):
        return ",".join(_fmt_num(v) for v in val)
    if isinstance(val, (int, float, np.integer, np.floating)):
        return _fmt_num(float(val) if isinstance(val, (float, np.floating))
                        else int(val))
    return str(val)


def format_cfg(net: dict, blocks: list[dict], header: str = "") -> str:
    """Render ``(net, blocks)`` (parser.parse_model_cfg output) as cfg text."""
    lines: list[str] = []
    if header:
        lines.extend(f"# {h}".rstrip() for h in header.splitlines())
        lines.append("")
    for blk in [dict(net, type="net")] + [dict(b) for b in blocks]:
        lines.append(f"[{blk.pop('type')}]")
        for key, val in blk.items():
            lines.append(f"{key} = {_fmt_val(key, val)}")
        lines.append("")
    return "\n".join(lines)


def write_cfg(path: str, net: dict, blocks: list[dict],
              header: str = "") -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(format_cfg(net, blocks, header))


def blocks_equal(a, b) -> bool:
    """Structural equality of two parsed (net, blocks) pairs."""
    net_a, blks_a = a
    net_b, blks_b = b
    if net_a != net_b or len(blks_a) != len(blks_b):
        return False
    for x, y in zip(blks_a, blks_b):
        if set(x) != set(y):
            return False
        for k in x:
            vx, vy = x[k], y[k]
            if isinstance(vx, np.ndarray) or isinstance(vy, np.ndarray):
                if not np.array_equal(np.asarray(vx), np.asarray(vy)):
                    return False
            elif vx != vy:
                return False
    return True
