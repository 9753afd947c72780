"""Nested dict/list/tuple containers of tensors, flattened the way
``jax.tree_util`` flattens them (dict keys in sorted order), so a flat
index names the same leaf in the port and in the JAX package."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_unflatten(tree, leaves: List[Any]):
    """A tree shaped like ``tree`` whose leaves are ``leaves`` in order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out

