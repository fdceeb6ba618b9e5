"""Minimal pytree helpers over nested dicts, lists and tuples of tensors.

The port keeps parameters as plain dict trees with the JAX package's leaf
names; these helpers are the few ``jax.tree`` operations it needs.
"""
from __future__ import annotations

from typing import Any, Callable

Pytree = Any


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """Apply ``fn`` leaf-wise over trees of the same structure (``None``
    leaves map to ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Pytree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    if tree is None:
        return []
    return [tree]


def tree_paths(tree: Pytree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` with ``/``-joined keys, in :func:`tree_leaves`
    order."""
    if isinstance(tree, dict):
        return [x for k in tree
                for x in tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in tree_paths(t, f"{prefix}/{i}" if prefix else str(i))]
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_index(tree: Pytree, i) -> Pytree:
    """Index the leading dim of every leaf."""
    return tree_map(lambda x: x[i], tree)
