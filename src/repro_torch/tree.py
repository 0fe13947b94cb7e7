"""Nested dict / list trees of tensors, walked in the JAX package's order.

``jax.tree_util`` visits dict keys in sorted order; ``leaves`` and
``map_`` do the same, so a tree's i-th leaf is the same parameter in both
packages (and sums over leaves run in the same order)."""
from __future__ import annotations


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_(fn, tree, *rest):
    """A tree of fn(leaf, *matching leaves of `rest`), shaped as `tree`;
    fn meets the leaves in ``leaves``' order."""
    if isinstance(tree, dict):
        return {k: map_(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
