"""Nested dict/list/tuple containers of tensors, flattened the way
``jax.tree_util`` flattens them, so a flat index names the same leaf in
the port and in the JAX package: dict keys in sorted order, NamedTuples
(optax states) by field, and ``None`` as an empty subtree with no leaves
(Wide ResNet's ``shortcut: None``)."""

from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure; a
    ``None`` subtree stays ``None`` and ``fn`` never sees it."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(tree, leaves: List[Any]):
    """A tree shaped like ``tree`` whose leaves are ``leaves`` in order."""
    leaves = list(leaves)
    n = len(tree_leaves(tree))
    if n != len(leaves):
        raise ValueError(f"the tree holds {n} leaves, got {len(leaves)}")
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_structure(tree):
    """``tree`` with every leaf replaced by 0: a template for
    :func:`tree_unflatten` that holds no tensor."""
    return tree_map(lambda _: 0, tree)
