"""Weights into the port's layout.

The port keeps the JAX package's variables structure —
``{"params": {"l{i}": ...}, "state": {"l{i}": ...}}`` with the same leaf
names — but holds torch tensors, and conv kernels in torch's OIHW layout
(the JAX package uses HWIO).

* :func:`from_jax_variables` takes JAX variables (numpy arrays or anything
  ``np.asarray`` reads) and is the inverse of the JAX package's
  ``import_weights._oihw_to_hwio``; :func:`to_jax_variables` goes the other
  way, so that checkpoints (:mod:`..utils.checkpoint`, kept in the JAX
  layout) move between the packages in both directions.
* :func:`from_torch_state_dict` is the port's copy of the JAX package's
  reference-checkpoint key mapping (``import_weights.from_torch_state_dict``),
  kept in OIHW. It reads the fp16 ``.npz`` fixture directly, and
  :func:`from_torch_checkpoint` reads a reference ``.pt`` / ``.pth``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..config.ir import GraphIR


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _hwio_to_oihw(w) -> torch.Tensor:
    return _tensor(w).permute(3, 2, 0, 1).contiguous()


def from_jax_variables(ir: GraphIR, variables: dict) -> dict:
    """JAX ``{"params", "state"}`` (HWIO kernels) -> the port's variables
    (OIHW kernels, fp32 CPU tensors). Every 4-D leaf named ``w`` is a conv
    kernel; every other leaf is copied as it is."""
    del ir  # the layout rule is the same for every node kind

    def convert(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = convert(v)
            elif k == "w" and np.ndim(v) == 4:
                out[k] = _hwio_to_oihw(v)
            else:
                out[k] = _tensor(v)
        return out

    return {"params": convert(variables["params"]),
            "state": convert(variables.get("state", {}))}


def to_jax_variables(variables: dict) -> dict:
    """The port's variables (OIHW kernels) -> JAX ``{"params", "state"}``
    (HWIO kernels, fp32 numpy arrays): the inverse of
    :func:`from_jax_variables`."""
    def convert(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = convert(v)
                continue
            a = (v.detach().to("cpu", torch.float32).numpy()
                 if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))
            out[k] = np.ascontiguousarray(
                a.transpose(2, 3, 1, 0) if k == "w" and a.ndim == 4 else a)
        return out

    return {"params": convert(variables["params"]),
            "state": convert(variables.get("state", {}))}


def to_jax_tree(tree):
    """Any tree of the port's (dicts, tuples, tensors: optimizer state,
    EMA) -> the JAX layout as numpy: 4-D leaves named ``w`` go OIHW ->
    HWIO, every other leaf keeps its dtype."""
    def convert(t, key=None):
        if isinstance(t, Mapping):
            return {k: convert(v, k) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(convert(v) for v in t)
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) \
            if key == "w" and a.ndim == 4 else a
    return convert(tree)


def from_jax_tree(tree, like):
    """The inverse of :func:`to_jax_tree`: a JAX-layout tree of arrays ->
    tensors shaped, typed and placed like the leaves of ``like``."""
    def convert(t, ref, key=None):
        if isinstance(ref, Mapping):
            return {k: convert(t[k], v, k) for k, v in ref.items()}
        if isinstance(ref, (tuple, list)):
            return type(ref)(convert(a, b) for a, b in zip(t, ref))
        a = torch.from_numpy(np.array(t, copy=True))
        if key == "w" and a.ndim == 4:
            a = a.permute(3, 2, 0, 1).contiguous()
        return a.to(ref.device, ref.dtype)
    return convert(tree, like)


def _bn(sd, prefix):
    params = {"scale": _tensor(sd[f"{prefix}.weight"]),
              "bias": _tensor(sd[f"{prefix}.bias"])}
    state = {"mean": _tensor(sd[f"{prefix}.running_mean"]),
             "var": _tensor(sd[f"{prefix}.running_var"])}
    return params, state


def _cba(sd, conv_key, bn_key):
    p = {"w": _tensor(sd[f"{conv_key}.weight"])}
    p["bn"], s = _bn(sd, bn_key)
    return p, s


def from_torch_state_dict(ir: GraphIR, sd: Mapping) -> dict:
    """Reference ``model.state_dict()`` (tensors or arrays; an ``np.load``-ed
    ``.npz`` works as it is) -> the port's variables. Key layout per
    reference models.py:create_modules."""
    params: dict[str, dict] = {}
    state: dict[str, dict] = {}
    for node in ir.nodes:
        i, kind = node.index, node.kind
        key = f"l{i}"
        base = f"module_list.{i}"
        if kind == "conv":
            p = {"w": _tensor(sd[f"{base}.Conv2d.weight"])}
            if node.bn:
                p["bn"], state[key] = _bn(sd, f"{base}.BatchNorm2d")
            else:
                p["b"] = _tensor(sd[f"{base}.Conv2d.bias"])
            params[key] = p
        elif kind == "dwconv":
            # DepthwiseSeparableConv2d: conv.0 dw / conv.1 BN / conv.3 pw /
            # conv.4 BN (reference layers.py:222-231)
            dw, s_dw = _cba(sd, f"{base}.conv.0", f"{base}.conv.1")
            pw, s_pw = _cba(sd, f"{base}.conv.3", f"{base}.conv.4")
            params[key] = {"dw": dw, "pw": pw}
            state[key] = {"dw": s_dw, "pw": s_pw}
        elif kind == "se":
            params[key] = {
                name: {"w": _tensor(sd[f"{base}.{name}.weight"]),
                       "b": _tensor(sd[f"{base}.{name}.bias"])}
                for name in ("fc1", "fc2")}
        elif kind == "inception":
            # branch module paths per reference layers.py:148-169; each
            # ConvBnActivation holds conv at .conv.0 and BN at .conv.1
            paths = {"b1_1": "branch1.0", "b2_1": "branch2.0",
                     "b2_2": "branch2.1", "b3_1": "branch3.0",
                     "b3_2": "branch3.1", "b3_3": "branch3.2",
                     "b4_1": "branch4.1"}
            params[key], state[key] = {}, {}
            for name, path in paths.items():
                params[key][name], state[key][name] = _cba(
                    sd, f"{base}.{path}.conv.0", f"{base}.{path}.conv.1")
        elif kind == "shortcut" and node.weighted:
            params[key] = {"w": _tensor(sd[f"{base}.w"])}
    return {"params": params, "state": state}


def load_state_dict_npz(ir: GraphIR, path: str) -> dict:
    """The port's variables from a reference state dict saved as ``.npz``
    (e.g. ``tests/fixtures/fullparity/mnv3_selftrained.fp16.npz``)."""
    with np.load(path) as sd:
        return from_torch_state_dict(ir, sd)


def from_torch_checkpoint(ir: GraphIR, path: str) -> dict:
    """The port's variables from a reference ``.pt`` / ``.pth`` checkpoint
    (``{"model": state_dict, ...}`` or a bare state dict, reference
    train.py:225-231). The file is unpickled: load only checkpoints this
    project or the reference wrote."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    return from_torch_state_dict(ir, sd)


def _darknet_convs(ir: GraphIR, cutoff: int = -1):
    """The conv nodes a darknet ``.weights`` file holds, up to ``cutoff``."""
    nodes = ir.nodes if cutoff < 0 else ir.nodes[:cutoff]
    return [n for n in nodes if n.kind == "conv"]


def missing_from_darknet(ir: GraphIR, cutoff: int = -1) -> list:
    """The parameterized nodes (``"l<i>"``) that a darknet ``.weights`` file
    read with ``cutoff`` leaves without weights: convs past ``cutoff`` and
    every node kind darknet does not store (depthwise-separable, SE,
    inception, weighted shortcut)."""
    have = {f"l{n.index}" for n in _darknet_convs(ir, cutoff)}
    need = [f"l{n.index}" for n in ir.nodes
            if n.kind in ("conv", "dwconv", "se", "inception")
            or (n.kind == "shortcut" and n.weighted)]
    return [k for k in need if k not in have]


def from_darknet_weights(ir: GraphIR, path: str, cutoff: int = -1) -> dict:
    """Read a darknet ``.weights`` binary (3x int32 header + int64 seen +
    fp32 stream; per BN conv: BN bias, scale, mean, var, then the OIHW
    kernel; per plain conv: bias, then the kernel — reference
    models.py:318-364, the JAX package's ``import_weights.
    from_darknet_weights``). Returns partial variables in the port's
    layout covering the convs up to ``cutoff``."""
    with open(path, "rb") as f:
        np.fromfile(f, dtype=np.int32, count=3)   # version
        np.fromfile(f, dtype=np.int64, count=1)   # images seen
        stream = np.fromfile(f, dtype=np.float32)

    ptr = 0

    def take(n):
        nonlocal ptr
        if ptr + n > len(stream):
            raise ValueError(f"{path}: the file ends after {len(stream)} "
                             f"values; the model's convs need more")
        out = torch.from_numpy(stream[ptr:ptr + n].copy())
        ptr += n
        return out

    params: dict[str, dict] = {}
    state: dict[str, dict] = {}
    for node in _darknet_convs(ir, cutoff):
        key = f"l{node.index}"
        co, ci, k = node.out_ch, node.in_ch // node.groups, node.kernel
        p: dict = {}
        if node.bn:
            b, w, mean, var = take(co), take(co), take(co), take(co)
            p["bn"] = {"scale": w, "bias": b}
            state[key] = {"mean": mean, "var": var}
        else:
            p["b"] = take(co)
        p["w"] = take(co * ci * k * k).reshape(co, ci, k, k)
        params[key] = p
    return {"params": params, "state": state}


def merge_variables(base: dict, loaded: dict) -> dict:
    """Overlay loaded (possibly partial) variables onto a full set, node by
    node (the tolerant load of reference train.py:102-104)."""
    out = {"params": dict(base["params"]), "state": dict(base["state"])}
    out["params"].update(loaded["params"])
    out["state"].update(loaded["state"])
    return out
