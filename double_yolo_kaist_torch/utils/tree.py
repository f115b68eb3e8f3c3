"""Nested containers of tensors (the port's stand-in for ``jax.tree``).

A tree is a dict, tuple or list of trees, or a leaf (anything else);
``None`` and empty containers hold no leaves. Leaves are ordered by dict
insertion order and sequence position, so trees built from one template
flatten alike.
"""

from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree``, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def unflatten(template, values):
    """A tree shaped like ``template`` holding ``values`` (an iterable in
    :func:`leaves` order) in place of its leaves."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(template)


def map_leaves(fn, tree):
    """``tree`` with ``fn`` applied to each of its leaves."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])
