"""The sharding rules of the JAX package's ``repro.runtime.sharding``, as
data, and ZeRO over the data replicas of a pipeline.

The JAX package shards with ``PartitionSpec``s that GSPMD or ``shard_map``
apply; the port runs one process per (data, model) grid point and keeps a
rank's block itself.  What is the same is the choice of which dim of which
leaf splits over which mesh axes:

- :class:`Spec` is a partition spec as a plain tuple (one entry per dim:
  ``None``, an axis name or a tuple of them), normalized as
  ``PartitionSpec`` normalizes; :func:`fit_spec`, :func:`build_param_specs`
  (with its own copy of ``LM_RULES`` and ``DENSE_ONLY_KEYS``),
  :func:`batch_specs`, :func:`cache_specs` and :func:`zero_stack_specs`
  give the JAX functions' specs leaf for leaf (``to_shardings`` has no
  counterpart);
- :func:`block_index`, :func:`spec_view`, :func:`spec_block` and
  :func:`sharded_dims` place a grid point's block
  of a leaf as a ``NamedSharding`` places it: a dim over axes ``(a, b)``
  splits into ``|a| x |b|`` contiguous blocks, the first axis major;
- :func:`zero_stack_dims` returns, leaf for leaf, the gather dims of
  ``zero_stack_specs``: a sharded stage-stack leaf splits into ``dp``
  contiguous blocks along its dim, data index ``i`` holding block ``i``
  (:func:`shard`, :func:`shard_view`).

:func:`batch_shard` is the ``P(None, "data")`` of ``CompiledPipeline.bind``
on the microbatches: data index ``i`` takes the ``i``-th contiguous block
of every microbatch's batch dim.  Nothing here imports the JAX package.
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


@torch.no_grad()
def gather_shards_(stack: Pytree, dims: Pytree, data) -> None:
    """A rank's ``[V, pad, ...]`` rows whole again after an update of its
    data index's shards (:func:`shard_view`'s): every sharded leaf's
    shards all-gathered over ``data`` (a ``runtime.ring.DataGroup``) into
    the rows in place, one collective for the stack."""
    sharded = [(x, d + 1) for x, d in leaf_dims(stack, dims) if d >= 0]
    if not sharded:
        return
    xs, ds = zip(*sharded)
    data.all_gather([x.narrow(d, data.index * (x.shape[d] // data.size),
                              x.shape[d] // data.size) for x, d in sharded],
                    list(ds), out=list(xs))


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


# ===========================================================================
# The rules as data: specs of params, batches and caches
# ===========================================================================

DENSE_ONLY_KEYS = {"dense_layers"}   # deepseek prelude uses dense ffn rules
MIN_FSDP_SIZE = 2 ** 12


def _entry(e):
    """A spec entry as ``PartitionSpec`` normalizes it: ``None``, one axis
    name, or a tuple of two names or more (a list is a tuple, an empty
    tuple ``None``, a one-name tuple the name)."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class Spec(tuple):
    """A partition spec: a plain tuple with one entry per leading dim of a
    leaf -- ``None`` (whole), an axis name, or a tuple of axis names (the
    dim splits over their product, the first axis major) -- normalized as
    ``jax.sharding.PartitionSpec`` normalizes its entries, and equal to
    the plain tuple of them.  Trailing dims it does not name are whole.
    A tuple subclass only so that :func:`spec_map` can tell a spec from a
    tuple of specs."""

    def __new__(cls, entries=()):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


def spec_map(fn, specs, *rest):
    """``fn(spec, *leaves)`` over a tree of :class:`Spec` leaves and trees
    of the same structure (``tree_map`` with specs as leaves)."""
    if isinstance(specs, Spec):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: spec_map(fn, specs[k], *(r[k] for r in rest))
                for k in specs}
    if isinstance(specs, (list, tuple)):
        return type(specs)(spec_map(fn, s, *(r[i] for r in rest))
                           for i, s in enumerate(specs))
    if specs is None:
        return None
    raise TypeError(f"not a spec tree: {specs!r}")


def spec_items(specs, tree=None, prefix: str = "") -> list:
    """``[(path, spec, leaf)]`` of a spec tree and the tree beside it
    (matched by key; ``leaf`` None without a tree), with ``/``-joined
    keys, in the spec tree's order."""
    if isinstance(specs, Spec):
        return [(prefix, specs, tree)]
    if isinstance(specs, dict):
        items = specs.items()
    elif isinstance(specs, (list, tuple)):
        items = enumerate(specs)
    else:
        return []
    out = []
    for k, s in items:
        out += spec_items(s, None if tree is None else tree[k],
                          f"{prefix}/{k}" if prefix else str(k))
    return out


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axes_product(entry, axis_sizes: dict) -> int:
    return math.prod(axis_sizes.get(a, 1) for a in _axes_of(entry))


def fit_spec(spec, shape, axis_sizes: dict | None) -> Spec:
    """Drop sharding on any dim the mesh axes do not divide evenly (and
    on any whose axes have size 1); with no ``axis_sizes`` the spec as it
    is."""
    if axis_sizes is None:
        return Spec(spec)
    spec = tuple(spec)
    fitted = []
    for dim, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        n = _axes_product(entry, axis_sizes)
        fitted.append(entry if entry is not None and n > 1 and dim % n == 0
                      else None)
    return Spec(fitted)


def _is_moe_leaf(path: tuple) -> bool:
    return len(path) >= 2 and path[-2] == "ffn"


def build_param_specs(params: Pytree, *, tp_axis: str | None = "model",
                      fsdp_axes: tuple | str | None = ("data",),
                      ep_axis: str | None = None,
                      rules: dict | None = None,
                      min_fsdp_size: int = MIN_FSDP_SIZE,
                      axis_sizes: dict | None = None) -> Pytree:
    """The :class:`Spec` tree of ``params`` (tensors, meta ones too): the
    JAX package's ``build_param_specs`` rules.  A rule names the logical
    axes of a leaf's *trailing* dims -- ``"tp"`` -> ``tp_axis``,
    ``"fsdp"`` -> ``fsdp_axes``, ``"ep"`` -> ``ep_axis`` (else
    ``tp_axis``), any other name a mesh axis itself -- and is the first
    match of ``parent/leaf`` (stacked expert tensors, ndim >= 4 under
    ``ffn``, with ``ep_axis``) or ``leaf`` in ``LM_RULES`` updated by
    ``rules``; else FSDP over the trailing dim.  Leading dims stay whole;
    leaves under ``min_fsdp_size`` elements are replicated (``Spec()``);
    with ``axis_sizes`` every spec is fitted (:func:`fit_spec`)."""
    rules = dict(LM_RULES, **(rules or {}))
    if isinstance(fsdp_axes, str):
        fsdp_axes = (fsdp_axes,)

    def logical_to_mesh(name):
        if name == "tp":
            return tp_axis
        if name == "fsdp":
            return fsdp_axes if fsdp_axes else None
        if name == "ep":
            return ep_axis if ep_axis else tp_axis
        return name          # a literal mesh axis (or tuple of them), None

    def spec_for(path: tuple, leaf) -> Spec:
        if leaf.ndim == 0 or leaf.numel() < min_fsdp_size:
            return Spec()
        key2, key1 = "/".join(path[-2:]), path[-1]
        rule = None
        if ep_axis is not None and key2 in rules and _is_moe_leaf(path) \
                and leaf.ndim >= 4:
            rule = rules[key2]          # stacked (L, E, d, f) expert tensors
        elif key1 in rules:
            rule = rules[key1]
        if rule is None:
            rule = ("fsdp",)
        axes = [logical_to_mesh(r) for r in rule]
        pad = leaf.ndim - len(axes)
        if pad < 0:
            axes, pad = axes[-leaf.ndim:], 0
        return fit_spec(Spec([None] * pad + axes), tuple(leaf.shape),
                        axis_sizes)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        return spec_for(path, node)

    return walk(params, ())


def batch_specs(batch: Pytree, dp_axes=("pod", "data"),
                axis_sizes: dict | None = None) -> Pytree:
    """The leading (batch) dim of every leaf over the DP axes the mesh has
    (all of ``dp_axes`` without ``axis_sizes``), divisibility-checked."""
    axes = tuple(a for a in dp_axes
                 if axis_sizes is None or a in axis_sizes)

    def f(x):
        if x.ndim < 1 or not axes:
            return Spec()
        return fit_spec(Spec([axes] + [None] * (x.ndim - 1)),
                        tuple(x.shape), axis_sizes)

    return tree_map(f, batch)


def cache_specs(caches: Pytree, *, dp_axes=("pod", "data"),
                tp_axis: str | None = "model",
                seq_shard_axis: str | None = None,
                axis_sizes: dict | None = None) -> Pytree:
    """Decode-state specs, by the leaf's name and right-aligned (the JAX
    package's ``cache_specs``): GQA ``k``/``v`` ``[..., B, S, H, Dh]``
    batch over DP, heads over TP (with ``seq_shard_axis`` the sequence
    too); MLA ``kv``/``k_rope`` batch and sequence; Mamba ``ssm`` and
    mLSTM ``C`` batch over DP, heads over TP; ``conv``/``h``/``c``/``n``/
    ``m`` batch over DP; ``pos`` (a host int here) and scalars
    replicated; anything else batch over DP."""
    axes = tuple(a for a in dp_axes
                 if axis_sizes is None or a in axis_sizes)
    bspec = axes if axes else None

    def ralign(x, trailing):
        pad = x.ndim - len(trailing)
        return fit_spec(Spec([None] * pad + list(trailing)), tuple(x.shape),
                        axis_sizes)

    def f(name, x):
        if not isinstance(x, torch.Tensor) or name == "pos" or x.ndim == 0:
            return Spec()
        if name in ("k", "v") and x.ndim >= 4:
            return ralign(x, (bspec, seq_shard_axis, tp_axis, None))
        if name == "kv" and x.ndim >= 3:
            return ralign(x, (bspec, seq_shard_axis, None))
        if name == "k_rope" and x.ndim >= 4:
            return ralign(x, (bspec, seq_shard_axis, None, None))
        if name in ("ssm", "C") and x.ndim >= 4:
            return ralign(x, (axes, tp_axis, None, None))
        if name in ("conv", "h", "c", "n", "m") and x.ndim >= 2:
            return ralign(x, (axes,) + (None,) * (min(x.ndim, 3) - 1))
        return ralign(x, (axes,) + (None,) * (x.ndim - 1))

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return f(name, node)

    return walk(caches, "")


# ===========================================================================
# A rank's block of a leaf under a spec
# ===========================================================================

def block_index(entry, coords: dict, axis_sizes: dict) -> tuple[int, int]:
    """``(index, count)`` of the block a grid point holds of a dim whose
    spec entry is ``entry``: the dim splits into ``count`` (the product of
    the entry's axis sizes) contiguous blocks, and the point at
    ``coords`` (axis -> index) holds block ``index``, the entry's first
    axis major (a ``NamedSharding``'s placement)."""
    index, count = 0, 1
    for a in _axes_of(entry):
        n = axis_sizes.get(a, 1)
        index = index * n + (coords.get(a, 0) if n > 1 else 0)
        count *= n
    return index, count


def spec_view(x, spec, coords: dict, axis_sizes: dict):
    """The view of ``x`` that the grid point at ``coords`` holds under
    ``spec`` (``x`` itself where whole; writing to the view writes ``x``);
    a leaf that is not a tensor (a cache's host ``pos``) passes through."""
    if not isinstance(x, torch.Tensor):
        return x
    for d, entry in enumerate(spec):
        i, n = block_index(entry, coords, axis_sizes)
        if n > 1:
            k = x.shape[d] // n
            x = x.narrow(d, i * k, k)
    return x


def spec_block(x, spec, coords: dict, axis_sizes: dict):
    """A contiguous copy of :func:`spec_view` (``x`` itself where whole)."""
    v = spec_view(x, spec, coords, axis_sizes)
    if v is x or not isinstance(x, torch.Tensor):
        return x
    return v.clone(memory_format=torch.contiguous_format)


def sharded_dims(spec, axis_sizes: dict) -> list[tuple[int, tuple]]:
    """``[(dim, axes)]``: the dims ``spec`` splits (over axes of size > 1),
    each with its axes in the spec's order."""
    return [(d, tuple(a for a in _axes_of(e) if axis_sizes.get(a, 1) > 1))
            for d, e in enumerate(spec) if _axes_product(e, axis_sizes) > 1]


def split_kinds(spec, axis_sizes: dict, tp_axis: str | None,
                coords: dict | None = None) -> tuple[list, list]:
    """``(fsdp, tp)``: the dims ``spec`` splits (over axes of size > 1),
    told apart by the plan's ``tp_axis``.  A dim whose entry is exactly
    ``tp_axis`` is a tensor-parallel dim: ``tp`` lists it as ``(dim,
    index, count)``, the block the grid point at ``coords`` holds of it
    (``index`` 0 without ``coords``).  Every other split dim is an FSDP
    dim, ``(dim, axes)`` in ``fsdp`` as :func:`sharded_dims` gives it --
    also an entry naming the TP axis's mesh axis among others, or when
    the plan has no TP axis (the SDv2 plan's FSDP over ``("model",
    "data")``)."""
    fsdp, tp = [], []
    for d, axes in sharded_dims(spec, axis_sizes):
        if tp_axis is not None and spec[d] == tp_axis:
            i, n = block_index(spec[d], coords or {}, axis_sizes)
            tp.append((d, i, n))
        else:
            fsdp.append((d, axes))
    return fsdp, tp


def zero_stack_specs(stacks: Pytree, *, dp: int, axis: str = "model",
                     data_axes: tuple = ("data",)) -> Pytree:
    """The JAX package's ``zero_stack_specs`` specs of a whole plan's
    ``[D, V, pad, ...]`` stage stacks: ``Spec(axis)`` where a leaf stays
    whole over the data replicas, else ``Spec(axis, None, None, ...)``
    with its :func:`zero_stack_dims` dim over ``data_axes``."""
    def f(x, g):
        if g < 0:
            return Spec([axis])
        trailing = [None] * (x.ndim - 3)
        trailing[g - 1] = tuple(data_axes)
        return Spec([axis, None, None] + trailing)
    return tree_map(f, stacks, zero_stack_dims(stacks, dp=dp))
