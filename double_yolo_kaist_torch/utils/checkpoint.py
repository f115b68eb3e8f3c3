"""Checkpoint I/O in the JAX package's format.

Counterpart of the JAX package's ``utils/checkpoint.py``: a directory with
one ``arrays.npz`` of flattened arrays (keys ``params/l3/w``, ...) and a
``manifest.json`` (step, epoch, best_map, training_results, keys). Trees
are kept in the JAX layout (HWIO kernels), so a checkpoint written by
either package loads in the other: the port's variables go through
:func:`..models.weights.to_jax_variables` before :func:`save_checkpoint`
and through :func:`..models.weights.from_jax_variables` after
:func:`load_checkpoint`. The ``opt_state`` and ``ema`` subtrees are
written and read back as they are stored; the trainer converts them with
:func:`..models.weights.to_jax_tree` / ``from_jax_tree``, so that they sit
under the keys JAX's optax chain flattens to.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _leaf(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        pass
    else:
        out[prefix[:-1]] = _leaf(tree)
    return out


def _unflatten_into(template, flat, prefix=""):
    """Rebuild ``template``'s structure from flat arrays; leaves missing from
    ``flat`` or with a mismatched shape keep the template value (tolerant
    load, reference train.py:102-104)."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_into(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(template)]
        return type(template)(vals) if not hasattr(template, "_fields") \
            else type(template)(*vals)
    if template is None:
        return None
    key = prefix[:-1]
    if key in flat and flat[key].shape == tuple(np.shape(_leaf(template))):
        return flat[key]
    return template


def _is_main_process() -> bool:
    # looked up at each call, so that a test can stand in for it
    from ..parallel import multihost
    return multihost.is_main_process()


def save_checkpoint(path: str, *, params, bn_state, opt_state=None,
                    step: int = 0, epoch: int = -1, best_map: float = 0.0,
                    training_results: str = "", ema=None):
    """Write ``path/arrays.npz`` and ``path/manifest.json``. ``params`` and
    ``bn_state`` are trees in the JAX layout (numpy arrays or tensors; see
    :func:`..models.weights.to_jax_variables`). With several processes,
    only rank 0 writes."""
    if not _is_main_process():
        return
    os.makedirs(path, exist_ok=True)
    tree = {"params": params, "bn_state": bn_state}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    if ema is not None:
        tree["ema"] = ema
    flat = _flatten(tree)
    np.savez(os.path.join(path, "arrays.npz"), **flat)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": int(step), "epoch": int(epoch),
                   "best_map": float(best_map),
                   "training_results": training_results,
                   "keys": sorted(flat)}, f)


def load_checkpoint(path: str, template: dict | None = None) -> dict:
    """Returns {params?, bn_state?, opt_state?, ema?, step, epoch, best_map,
    training_results}. With ``template`` (the same outer structure, JAX
    layout), arrays are grafted tolerantly; without, the flat trees are
    rebuilt exactly, as numpy arrays."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}

    if template is not None:
        tree = _unflatten_into(template, flat)
    else:
        tree = {}
        for key, arr in flat.items():
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return {**tree, "step": manifest["step"], "epoch": manifest["epoch"],
            "best_map": manifest["best_map"],
            "training_results": manifest["training_results"]}
