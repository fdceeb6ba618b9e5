"""ZeRO over the data replicas of a pipeline (the port of the parts of
``repro.runtime.sharding`` the pipeline path uses).

The JAX package shards with ``PartitionSpec``s that ``shard_map`` applies;
the port runs one process per (data, model) grid point and keeps a rank's
shard itself.  What is the same is the choice of which dim of which leaf
shards over ``data``: :func:`zero_stack_dims` returns, leaf for leaf, the
gather dims of ``zero_stack_specs`` (its own copy of ``LM_RULES``;
nothing here imports the JAX package).  A sharded leaf
splits into ``dp`` contiguous blocks along its dim, data index ``i``
holding block ``i``, as a ``NamedSharding`` over a mesh axis of size
``dp`` places them.

:func:`batch_shard` is the ``P(None, "data")`` of ``CompiledPipeline.bind``
on the microbatches: data index ``i`` takes the ``i``-th contiguous block
of every microbatch's batch dim.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.tree import tree_map

Pytree = Any

# rule tables: name -> logical axes of the *trailing* dims ("tp" tensor
# parallel, "fsdp" parameter sharding over data, "ep" expert parallel, None
# replicated); a copy of the JAX package's table
LM_RULES: dict[str, tuple] = {
    "embed": ("fsdp", "tp"),
    "head": ("fsdp", "tp"),
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # MoE expert tensors (E, d, f) / (E, f, d): experts over 'ep'
    "ffn/w_gate": ("ep", "fsdp", None),
    "ffn/w_up": ("ep", "fsdp", None),
    "ffn/w_down": ("ep", None, "fsdp"),
    "shared/w_gate": ("fsdp", "tp"),
    "shared/w_up": ("fsdp", "tp"),
    "shared/w_down": ("tp", "fsdp"),
    "router": (None, None),
    # MLA
    "wq_a": ("fsdp", None),
    "wq_b": (None, "tp"),
    "wkv_a": ("fsdp", None),
    "wkv_b": (None, "tp"),
    # conv / misc
    "conv": (None, None),
    "proj": ("fsdp", None),
}

# the per-block size under which a stacked leaf stays replicated (the JAX
# package's ``zero_stack_specs`` default)
MIN_SHARD_SIZE = 2 ** 8


def zero_stack_dims(stacks: Pytree, *, dp: int) -> Pytree:
    """The ZeRO dim of every leaf of a whole plan's stage stacks
    ``[D, V, pad, ...]``: the dim of the slot view ``[pad, ...]`` that
    shards over ``dp`` data replicas, or ``-1`` (replicated).  The JAX
    package's ``zero_stack_specs`` rules: the right-aligned ``fsdp`` entry
    of the leaf's ``LM_RULES`` rule (by ``parent/leaf``, then ``leaf``,
    else ``("fsdp",)``) if ``dp`` divides it, else the largest block dim
    ``dp`` divides; replicated when a block has fewer than
    ``MIN_SHARD_SIZE`` elements or no block dim divides."""
    def dim_for(path: tuple[str, ...], leaf) -> int:
        block = tuple(leaf.shape)[3:]
        nblock = len(block)
        if dp <= 1 or nblock < 1 or math.prod(block) < MIN_SHARD_SIZE:
            return -1
        rule = (LM_RULES.get("/".join(path[-2:])) or LM_RULES.get(path[-1])
                or ("fsdp",))
        # right-align the rule against the block dims; tp/ep are off here
        entries = [r if r == "fsdp" else None for r in rule][-nblock:]
        entries = [None] * (nblock - len(entries)) + entries
        j = next((k for k, e in enumerate(entries)
                  if e == "fsdp" and block[k] % dp == 0), None)
        if j is None:
            divisible = [k for k in range(nblock) if block[k] % dp == 0]
            if not divisible:
                return -1
            j = max(divisible, key=lambda k: block[k])
        return 1 + j

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        return dim_for(path, node)

    return walk(stacks, ())


def leaf_dims(tree: Pytree, dims: Pytree | None) -> list[tuple]:
    """``[(leaf, dim)]`` in ``tree``'s leaf order, each leaf beside its
    ZeRO dim in ``dims`` (matched by key, not by position: the two trees'
    dicts may list their keys in other orders), or beside -1 when
    ``dims`` is None."""
    out: list = []
    tree_map(lambda x, d: out.append((x, d)), tree,
             dims if dims is not None else tree_map(lambda _: -1, tree))
    return out


def shard(stack: Pytree, dims: Pytree, dp: int, index: int) -> Pytree:
    """Data index ``index``'s copy of its shard of a rank's ``[V, pad,
    ...]`` stack (a replicated leaf is the leaf itself)."""
    return tree_map(
        lambda v, d: v if d < 0 else v.clone(
            memory_format=torch.contiguous_format),
        shard_view(stack, dims, dp, index), dims)


def shard_view(stack: Pytree, dims: Pytree, dp: int, index: int) -> Pytree:
    """Views of data index ``index``'s shard of a rank's ``[V, pad, ...]``
    stack (the leaf itself where replicated): writing to a view writes the
    rows."""
    def f(x, d):
        if d < 0:
            return x
        n = x.shape[d + 1] // dp
        return x.narrow(d + 1, index * n, n)
    return tree_map(f, stack, dims)


def batch_shard(tree: Pytree, dp: int, index: int) -> Pytree:
    """Data index ``index``'s contiguous block of dim 1 (the batch dim of
    ``[M, b, ...]`` microbatches) of every leaf with two dims or more; the
    others are replicated (``P(None, "data")`` where ``ndim >= 2``)."""
    if dp <= 1:
        return tree

    def f(x):
        if x.ndim < 2:
            return x
        n = x.shape[1] // dp
        if n * dp != x.shape[1]:
            raise ValueError(f"a batch of {x.shape[1]} does not split over "
                             f"{dp} data replicas")
        return x.narrow(1, index * n, n)
    return tree_map(f, tree)
