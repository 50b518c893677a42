"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

A tree is a dict whose values are tensors or trees, e.g. the PaperMLP
parameters ``{"layer_i": {"kernel": [n, in, out], "bias": [n, out]}}``.
Leaves are visited in sorted-key order, the order ``jax.tree.leaves``
uses for dicts, so reductions over leaves sum in the reference's order.
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn(leaf, *matching_leaves)`` over trees of one shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """The tree of ``like``'s shape holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
