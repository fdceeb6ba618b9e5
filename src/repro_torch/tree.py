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


def tree_map_paths(fn: Callable, tree: Pytree, prefix: str = "") -> Pytree:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, the path
    its ``/``-joined keys (``None`` leaves map to ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_map_paths(fn, v, f"{prefix}/{k}" if prefix
                                  else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_paths(fn, t, f"{prefix}/{i}" if prefix
                                         else str(i))
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def tree_paths(tree: Pytree) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` with ``/``-joined keys, in :func:`tree_leaves`
    order."""
    out: list = []
    tree_map_paths(lambda path, x: out.append((path, x)), tree)
    return out


def tree_index(tree: Pytree, i) -> Pytree:
    """Index the leading dim of every leaf."""
    return tree_map(lambda x: x[i], tree)


# ---------------------------------------------------------------------------
# JAX's leaf order, for checkpoints
# ---------------------------------------------------------------------------

_LEAF = object()            # marks a leaf in a TreeDef's skeleton


class TreeDef:
    """The structure :func:`tree_flatten` took apart: a skeleton of the
    tree with every leaf replaced by a marker (dicts keep their insertion
    order; the leaves are numbered in JAX's order)."""

    def __init__(self, skeleton: Any, num_leaves: int):
        self.skeleton = skeleton
        self.num_leaves = num_leaves

    def __repr__(self) -> str:
        return f"TreeDef({self.num_leaves} leaves)"


def _skeleton(t: Pytree, leaves: list) -> Any:
    if isinstance(t, dict):
        done = {k: _skeleton(t[k], leaves) for k in sorted(t)}
        return {k: done[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_skeleton(c, leaves) for c in t)
    if t is None:
        return None
    leaves.append(t)
    return _LEAF


def _build(s: Any, leaves: list, pos: list) -> Pytree:
    if isinstance(s, dict):
        done = {k: _build(s[k], leaves, pos) for k in sorted(s)}
        return {k: done[k] for k in s}
    if isinstance(s, (list, tuple)):
        return type(s)(_build(c, leaves, pos) for c in s)
    if s is None:
        return None
    pos[0] += 1
    return leaves[pos[0] - 1]


# (module-level recursion, no closures: a recursive closure is a reference
# cycle, which would keep every leaf it saw alive until the next cyclic
# collection -- a full copy of the training state on the card)
def tree_flatten(tree: Pytree) -> tuple[list, TreeDef]:
    """``(leaves, treedef)`` in ``jax.tree_util.tree_flatten``'s order: dict
    keys sorted, lists and tuples in order, ``None`` a node without
    leaves.  A checkpoint numbers its leaves ``a{i}`` in this order, so the
    port's and the JAX package's checkpoints of the same tree agree leaf
    for leaf (:func:`tree_leaves` walks dicts in insertion order instead)."""
    leaves: list = []
    skeleton = _skeleton(tree, leaves)
    return leaves, TreeDef(skeleton, len(leaves))


def tree_unflatten(treedef: TreeDef, leaves) -> Pytree:
    """Inverse of :func:`tree_flatten`: ``leaves`` in JAX's order."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{treedef.num_leaves}")
    return _build(treedef.skeleton, leaves, [0])
