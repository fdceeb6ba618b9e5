"""Train/serve step builders for a bundle's :class:`ParallelPlan` (the port
of ``repro.train.steps``).

- :func:`build_sharded_train_step`, :func:`build_forward_step` and
  :func:`build_sharded_serve_step`: the JAX package's GSPMD ("sharded")
  strategy;
- :func:`build_pp_train_step`: the PULSE pipeline strategies (``pp_1f1b``,
  ``pp_wave``) over an adapter's executor: an ``LMPipelineAdapter``, a
  ``DiffusionPipelineAdapter`` or a ``CompiledPipeline``.

Each builder returns ``(step, example)``: the step, and its example
inputs as tensors on the meta device (the JAX builders'
ShapeDtypeStructs).  A step runs on the device of the tensors it is given,
and updates params and optimizer state IN PLACE (the JAX steps donate
them), returning them with the loss.  ``step.in_specs`` and
``step.out_specs`` are the JAX builder's ``in_shardings`` and
``out_shardings`` as data (``runtime.sharding.Spec`` trees; a generator
or a scalar takes ``Spec()``).

``mesh`` is a dict of axis sizes, such as ``{"data": 1, "model": 4}``
(everything in this process: a pipeline's D devices, axes of size 1
no-ops), or a ``launch.mesh.RankGrid``, one process per (data, model)
grid point.  Over a grid of ranks:

- the sharded steps hold each param leaf as the rank's block of it under
  :func:`param_specs_for`, gather its FSDP dims whole on use over the
  group of their axes (``RankGrid.axis_group``) and reduce-scatter its
  gradient back; a replicated leaf's gradient is all-reduced.  AdamW runs
  on the blocks.  Data (a batch, its draws, a token) comes whole and each
  rank reads its rows under ``batch_specs``; state (params, moments,
  caches) comes as the rank's blocks (``step.shard`` cuts them).  Every
  rank computes the loss of its rows, so the ranks that share rows (an
  FSDP axis that does not split the batch) compute them again, as
  GSPMD's specs place them; the gradient and the loss are the sums over
  the grid divided by the world, the global batch's mean;
- tensor parallelism (a plan's ``tp_axis`` larger than 1): a dim whose
  spec entry is the TP axis stays the rank's block, and the bundle's loss
  or decode function computes on it, given ``tp=``, the rank's
  ``runtime.tensor_parallel.TensorParallel`` (``step.tp``); the ranks
  along the axis compute their data index's loss together, so a
  gradient is summed over the other axes only (``GridComm``);
- the pipeline step runs the adapter's rank executor over the rank's ring
  and data group (ZeRO as the plan and the adapter's ``pcfg`` say; the
  edge params and their moments stay whole on every rank).

Refused with ``NotImplementedError`` naming what is missing: expert
parallelism and the sequence sharding of the caches over an axis larger
than 1, int8 moments over a grid with FSDP (and under the pipeline over
ranks), FSDP of the stage stacks over the pipeline axis, and in one
process, tensor or data parallelism or FSDP over an axis larger than 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               int8_adamw_init, int8_adamw_update)
from repro_torch.runtime import sharding as shard_rules
from repro_torch.runtime.sharding import Spec, spec_map
from repro_torch.runtime.tensor_parallel import TensorParallel, greedy
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    strategy: str = "sharded"           # sharded | pp_1f1b | pp_wave
    batch_axes: tuple = ("pod", "data")
    tp_axis: str | None = "model"
    fsdp_axes: tuple = ("data",)
    ep: bool = False                    # expert parallelism over tp_axis
    pp_degree: int = 16
    microbatches: int = 16
    int8_optimizer: bool = False
    # ZeRO stage for the pp strategies: 0 = replicate per DP rank,
    # 1 = shard optimizer state over fsdp_axes (leaf-wise stack specs),
    # 2 = additionally shard the stage param stacks at rest (requires an
    #     adapter compiled with the matching PipelineConfig.zero_stage).
    zero_stage: int = 0
    seq_shard_axis: str | None = None   # decode-cache sequence sharding
    custom_rules: dict | None = None
    notes: str = ""


def rank_grid(mesh):
    """``mesh`` if it is a ``RankGrid`` of more than one rank, else None."""
    if mesh is None or isinstance(mesh, dict) or mesh.world == 1:
        return None
    return mesh


def axis_sizes(mesh) -> dict:
    """The axis sizes of ``mesh`` (a dict of them, ``None`` for none, or a
    ``RankGrid``)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    from repro_torch.launch.mesh import mesh_axis_sizes
    return mesh_axis_sizes(mesh)


def _filter_axes(sizes: dict, axes) -> tuple:
    return tuple(a for a in axes if a in sizes)


def check_one_process(mesh, plan: ParallelPlan, *,
                      pipeline_axis: str | None = None) -> dict:
    """The axis sizes of ``mesh``, after refusing what one process cannot
    run: every axis the plan shards over must have size 1, except the
    pipeline's ``pipeline_axis`` (its D devices live in this process)."""
    sizes = axis_sizes(mesh)
    size = lambda a: sizes.get(a, 1) if a is not None else 1
    if pipeline_axis is None and size(plan.tp_axis) > 1:
        what = "expert and tensor" if plan.ep else "tensor"
        raise NotImplementedError(
            f"{what} parallelism over {plan.tp_axis!r} "
            f"(size {size(plan.tp_axis)}) in one process: "
            + ("expert parallelism is not ported" if plan.ep else
               "run it over ranks (a RankGrid of one process per (data, "
               "model) grid point)"))
    if size(plan.seq_shard_axis) > 1:
        raise NotImplementedError(
            f"sequence sharding of the caches over {plan.seq_shard_axis!r} "
            f"(size {size(plan.seq_shard_axis)}) is not ported")
    for kind, axes in (("data parallelism", plan.batch_axes),
                       ("FSDP", plan.fsdp_axes)):
        for a in axes:
            if a != pipeline_axis and size(a) > 1:
                raise NotImplementedError(
                    f"{kind} over {a!r} (size {size(a)}) in one process: "
                    "run it over ranks (a RankGrid of one process per "
                    "(data, model) grid point)")
    return sizes


def check_ranks(grid, plan: ParallelPlan, *,
                pipeline_axis: str | None = None) -> dict:
    """The axis sizes of the grid of ranks ``grid``, after refusing what
    the port does not run over ranks yet: expert parallelism, the sequence
    sharding of the caches, and int8 moments with FSDP (the JAX package
    shards their flat block dim, which does not line up with a param's
    block when the param shards on a trailing dim) -- or, under the
    pipeline (``pipeline_axis``), int8 moments at all and FSDP over the
    pipeline axis.  Tensor parallelism over ``plan.tp_axis`` runs (the
    dense decoder LMs' layers: ``models.lm``)."""
    sizes = axis_sizes(grid)
    size = lambda a: sizes.get(a, 1) if a is not None else 1
    where = f"on a grid of {grid.world} ranks"
    if pipeline_axis is None and plan.ep and size(plan.tp_axis) > 1:
        raise NotImplementedError(
            f"expert and tensor parallelism over {plan.tp_axis!r} (size "
            f"{size(plan.tp_axis)}) {where}: expert parallelism (the MoE "
            "dispatch as the model group's all-to-all) is not ported yet")
    if size(plan.seq_shard_axis) > 1:
        raise NotImplementedError(
            f"sequence sharding of the caches over {plan.seq_shard_axis!r} "
            f"(size {size(plan.seq_shard_axis)}) {where} is not ported yet")
    fsdp = math.prod(size(a) for a in plan.fsdp_axes)
    if pipeline_axis is not None:
        if size(pipeline_axis) > 1 and pipeline_axis in plan.fsdp_axes:
            raise NotImplementedError(
                f"FSDP of the stage stacks over the pipeline axis "
                f"{pipeline_axis!r} (the JAX builder's extra_stack_fsdp) "
                f"{where} is not ported")
        if plan.int8_optimizer:
            raise NotImplementedError(
                f"int8 AdamW moments under the pipeline {where} are not "
                "ported yet")
    elif plan.int8_optimizer and fsdp > 1:
        raise NotImplementedError(
            f"int8 AdamW moments with FSDP over {plan.fsdp_axes} (size "
            f"{fsdp}) {where} are not ported yet: the JAX package shards "
            "their flat block dim, which does not line up with a param's "
            "block")
    return sizes


def _optimizer(plan: ParallelPlan) -> tuple[Callable, Callable]:
    if plan.int8_optimizer:
        return int8_adamw_init, int8_adamw_update
    return adamw_init, adamw_update


def _meta_params(init_fn: Callable) -> Pytree:
    return init_fn(torch.Generator(), "meta")


def _value_and_grad(loss_of: Callable, params: Pytree, *args, **kw):
    """``loss_of(params, *args, **kw)`` and its gradient by every leaf of
    ``params`` (zeros for a leaf the loss does not read), the leaves made
    differentiable for the call only."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        for x in leaves:
            x.requires_grad_(True)
        try:
            loss = loss_of(params, *args, **kw)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for x in leaves:
                x.requires_grad_(False)
    grads = iter([torch.zeros_like(x) if g is None else g
                  for x, g in zip(leaves, grads)])
    return loss.detach(), tree_map(lambda _: next(grads), params)


# ===========================================================================
# the specs (the JAX builders' shardings, as data)
# ===========================================================================

def param_specs_for(params_struct: Pytree, mesh, plan: ParallelPlan
                    ) -> Pytree:
    """The :class:`Spec` tree of a plan's params on ``mesh`` (an axis-size
    dict or a ``RankGrid``): ``build_param_specs`` with the plan's TP axis
    where the mesh has it, its FSDP axes the mesh has, EP over the TP axis
    under ``plan.ep``, its custom rules, fitted to the mesh."""
    sizes = axis_sizes(mesh)
    fsdp = _filter_axes(sizes, plan.fsdp_axes)
    return shard_rules.build_param_specs(
        params_struct,
        tp_axis=plan.tp_axis if plan.tp_axis in sizes else None,
        fsdp_axes=fsdp or None,
        ep_axis=(plan.tp_axis if plan.ep else None),
        rules=plan.custom_rules, axis_sizes=sizes)


def opt_specs_like(param_specs: Pytree, int8: bool,
                   fsdp_axes: tuple = ()) -> Pytree:
    """The optimizer state's specs: fp32 moments as the params; int8
    moments' flat ``(nblocks, 256)`` codes and ``(nblocks, 1)`` scales
    with the block dim over ``fsdp_axes`` (the block count is padded to
    stay divisible)."""
    if not int8:
        return {"m": param_specs, "v": param_specs, "step": Spec()}
    zspec = Spec([tuple(fsdp_axes)]) if fsdp_axes else Spec()
    q = spec_map(lambda _: {"q": zspec, "s": zspec}, param_specs)
    return {"m": q, "v": q, "step": Spec()}


def _batch_specs(struct: Pytree, sizes: dict, plan: ParallelPlan) -> Pytree:
    return shard_rules.batch_specs(
        struct, dp_axes=_filter_axes(sizes, plan.batch_axes),
        axis_sizes=sizes)


# ===========================================================================
# a rank's collectives over a grid's axes
# ===========================================================================

def _pairs(tree: Pytree, specs: Pytree) -> list:
    """``[(leaf, spec)]`` of ``tree`` in ``specs``' order (matched by key)."""
    return [(x, s) for _, s, x in shard_rules.spec_items(specs, tree)]


def _rebuild(specs: Pytree, tree: Pytree, values: list) -> Pytree:
    """``tree``'s structure with its leaves taken from ``values``, in
    ``specs``' order (as :func:`_pairs` listed them)."""
    it = iter(values)
    return spec_map(lambda s, x: next(it), specs, tree)


class GridComm:
    """A rank's FSDP and data-parallel collectives over the axes of its
    grid: one ``runtime.ring.DataGroup`` per axis tuple, made on first use
    on the device of the tensors it moves (over gloo with CUDA tensors
    staged through pinned host memory, the one-card case), holding its
    members in that tuple's block order.  ``groups`` maps each axis tuple
    to its group: their ``bytes``, ``calls`` and ``seconds`` count what
    the steps moved (tensor parallelism's collectives too, on the group
    of ``(tp_axis,)``).

    ``tp_axis``: the plan's tensor-parallel axis.  When it is larger than
    1, a leaf's dim whose spec entry is exactly that axis is a TP dim
    (``sharding.split_kinds``): the rank keeps and computes on its block
    of it, never gathers it, and the ranks along the axis compute one loss
    together (each the loss of its data index's rows)."""

    def __init__(self, grid, tp_axis: str | None = None):
        from repro_torch.launch.mesh import mesh_axis_sizes
        self.grid = grid
        self.sizes = mesh_axis_sizes(grid)
        self.coords = grid.coords
        self.tp_axis = (tp_axis if tp_axis is not None
                        and self.sizes.get(tp_axis, 1) > 1 else None)
        self.groups: dict = {}

    @property
    def world_axes(self) -> tuple:
        return tuple(a for a in ("data", "model") if self.sizes[a] > 1)

    @property
    def row_axes(self) -> tuple:
        """The axes a gradient sums over: every axis of the world but the
        TP axis (along which the ranks hold blocks of one computation, not
        the computations of other rows or copies of them)."""
        return tuple(a for a in self.world_axes if a != self.tp_axis)

    def group(self, axes, device, *, any_order: bool = False):
        """The data group over ``axes`` (size-1 axes dropped; None when
        none is left).  ``any_order``: a group over the same axes in
        another order will do (an all-reduce)."""
        import torch.distributed as dist

        from repro_torch.runtime.ring import DataGroup
        axes = tuple(a for a in axes if self.sizes.get(a, 1) > 1)
        if not axes:
            return None
        if any_order:
            for k, g in self.groups.items():
                if set(k) == set(axes):
                    return g
        if axes not in self.groups:
            device = torch.device(device)
            group, members = self.grid.axis_group(axes)
            staged = (device.type == "cuda"
                      and str(dist.get_backend(group)).lower() == "gloo")
            self.groups[axes] = DataGroup(
                group, members.index(self.grid.rank), len(members), device,
                staged=staged, members=members)
        return self.groups[axes]

    def _split(self, spec) -> tuple:
        """``(dim, axes, tp_blocks)``: the one FSDP dim ``spec`` splits and
        its axes (``(-1, ())`` for none), and the number of TP blocks of
        the leaf (1 for none)."""
        fsdp, tp = shard_rules.split_kinds(spec, self.sizes, self.tp_axis)
        if len(fsdp) > 1:
            raise NotImplementedError(
                f"a leaf split on {len(fsdp)} FSDP dims ({spec}): one FSDP "
                "dim a leaf is ported")
        d, axes = fsdp[0] if fsdp else (-1, ())
        return d, axes, math.prod(n for _, _, n in tp)

    def local(self, tree: Pytree, specs: Pytree) -> Pytree:
        """Views of this rank's blocks of ``tree`` (whole leaves as they
        are)."""
        return spec_map(lambda s, x: shard_rules.spec_view(
            x, s, self.coords, self.sizes), specs, tree)

    def shard(self, tree: Pytree, specs: Pytree) -> Pytree:
        """Contiguous copies of this rank's blocks of ``tree`` (whole
        leaves as they are)."""
        return spec_map(lambda s, x: shard_rules.spec_block(
            x, s, self.coords, self.sizes), specs, tree)

    def gather(self, tree: Pytree, specs: Pytree) -> Pytree:
        """``tree`` of this rank's blocks with their FSDP dims gathered
        whole (their TP blocks kept): one all-gather a (axes, dtype) over
        the group of the axes, in ``specs``' leaf order; leaves with no
        FSDP dim are the leaves themselves."""
        pairs = _pairs(tree, specs)
        out = [x for x, _ in pairs]
        buckets: dict = {}
        for i, (x, s) in enumerate(pairs):
            d, axes, _ = self._split(s)
            if d >= 0:
                buckets.setdefault((axes, x.dtype), []).append((i, d))
        for (axes, _), items in buckets.items():
            grp = self.group(axes, pairs[items[0][0]][0].device)
            whole = grp.all_gather([pairs[i][0].detach() for i, _ in items],
                                   [d for _, d in items])
            for (i, _), w in zip(items, whole):
                out[i] = w
        return _rebuild(specs, tree, out)

    def reduce_grads(self, grads: Pytree, specs: Pytree
                     ) -> tuple[Pytree, torch.Tensor]:
        """The gradients of every rank's loss (each leaf's FSDP dims whole,
        its TP block) -> this rank's blocks of their sum over the
        :attr:`row_axes` divided by those axes' size, the global batch's
        mean (a leaf split over FSDP axes: reduce-scattered over them and
        all-reduced over the other row axes; a leaf with no FSDP dim
        all-reduced over the row axes), and this rank's share of the
        squared global norm (its blocks' squares over their copies: the
        ranks that hold the same block).

        Over the row axes every rank holds the whole gradient of its own
        rows' loss, or a copy of another rank's (the SDv2 plan's model
        ranks compute the same rows), so the sum over them divided by
        their size is the mean.  Along the TP axis nothing is summed: a
        TP block's gradient is complete on its rank, and a leaf whole over
        the TP axis has the same whole gradient on each rank of it (the
        TP context's copies all-reduce the partial ones in the backward:
        ``runtime.tensor_parallel``)."""
        world = self.grid.world
        rows = self.row_axes
        scale = math.prod(self.sizes[a] for a in rows)
        pairs = _pairs(grads, specs)
        out = [g for g, _ in pairs]
        split: dict = {}
        whole: list = []
        for i, (g, s) in enumerate(pairs):
            d, axes, _ = self._split(s)
            if d >= 0:
                split.setdefault((axes, g.dtype), []).append((i, d))
            else:
                whole.append(i)
        dev = pairs[0][0].device
        rest: dict = {}
        for (axes, _), items in split.items():
            grp = self.group(axes, dev)
            blocks = grp.reduce_scatter([pairs[i][0] for i, _ in items],
                                        [d for _, d in items])
            others = tuple(a for a in rows if a not in axes)
            for (i, _), b in zip(items, blocks):
                out[i] = b
                rest.setdefault(others, []).append(i)
        if whole:
            rest.setdefault(rows, []).extend(whole)
        for others, idx in rest.items():
            grp = self.group(others, dev, any_order=True)
            if grp is not None:
                grp.all_reduce_([out[i] for i in idx])
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for i, g in enumerate(out):
            g.div_(scale)
            _, axes, tp_blocks = self._split(pairs[i][1])
            copies = world // (math.prod(self.sizes[a] for a in axes)
                               * tp_blocks)
            sq = sq + torch.linalg.vector_norm(
                g, dtype=torch.float32).square() / copies
        return _rebuild(specs, grads, out), sq

    def loss_and_norm(self, loss: torch.Tensor, sq: torch.Tensor | None
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The mean of every rank's loss and the global norm from each
        rank's share of its square: one all-reduce over the world (the
        ranks along the TP axis hold the same loss, their data index's)."""
        parts = [loss.detach().float().reshape(())]
        if sq is not None:
            parts.append(sq.reshape(()).to(parts[0].device))
        buf = torch.stack(parts)
        self.group(self.world_axes, buf.device, any_order=True).all_reduce_(
            [buf])
        norm = torch.sqrt(buf[1]) if sq is not None else None
        return buf[0] / self.grid.world, norm


class Step:
    """A built step: call it as the function it wraps.  ``in_specs`` and
    ``out_specs`` are the JAX builder's shardings as data; ``local``,
    ``shard`` and ``gather`` cut a tree into this rank's blocks (views,
    copies) and gather its FSDP dims whole, TP blocks kept (one process:
    the tree itself); ``comm`` is the rank's :class:`GridComm` and ``tp``
    its tensor-parallel context (None in one process, or without TP on
    the grid).  A train step
    over ranks keeps its last gradient norm over the grid in
    ``grad_norm`` (and the pipeline's, whether every rank's loss and
    gradient were finite, in ``finite``)."""

    def __init__(self, fn: Callable, in_specs, out_specs,
                 comm: GridComm | None = None, **extra):
        self._fn = fn
        self.in_specs, self.out_specs, self.comm = in_specs, out_specs, comm
        self.__dict__.update(extra)

    def __call__(self, *args, **kw):
        return self._fn(*args, **kw)

    def local(self, tree: Pytree, specs: Pytree) -> Pytree:
        return tree if self.comm is None else self.comm.local(tree, specs)

    def shard(self, tree: Pytree, specs: Pytree) -> Pytree:
        return tree if self.comm is None else self.comm.shard(tree, specs)

    def gather(self, tree: Pytree, specs: Pytree) -> Pytree:
        return tree if self.comm is None else self.comm.gather(tree, specs)


def _rows(comm: GridComm | None, sizes: dict, plan: ParallelPlan, rng,
          batch: Pytree, draws: dict) -> tuple[Pytree, dict]:
    """This rank's rows of a whole batch and of its draws (one process:
    them as they are).  A loss that draws from ``rng`` would draw for the
    rank's rows alone, so over ranks that split the batch ``rng`` is
    refused: pass the global batch's draws."""
    if comm is None:
        return batch, draws
    b_specs = _batch_specs(batch, sizes, plan)
    if rng is not None and any(shard_rules.sharded_dims(s, sizes)
                               for _, s, _ in shard_rules.spec_items(b_specs)):
        raise ValueError(
            "over ranks that split the batch a loss drawing from rng would "
            "draw for the rank's rows alone: pass the global batch's draws "
            "(t=, noise=) instead")
    return (comm.local(batch, b_specs),
            comm.local(draws, _batch_specs(draws, sizes, plan)))


def _device(tree: Pytree) -> torch.device:
    return next(x.device for x in tree_leaves(tree)
                if isinstance(x, torch.Tensor))


# ===========================================================================
# GSPMD ("sharded") strategy
# ===========================================================================

def _sharded_setup(init_fn: Callable, mesh, plan: ParallelPlan):
    """``(comm, tp, sizes, params_struct, p_specs)``: the rank's
    :class:`GridComm` and, where the plan's TP axis is larger than 1, its
    ``runtime.tensor_parallel.TensorParallel`` (None in one process)."""
    grid = rank_grid(mesh)
    sizes = (check_one_process(mesh, plan) if grid is None
             else check_ranks(grid, plan))
    params_struct = _meta_params(init_fn)
    p_specs = param_specs_for(params_struct, sizes, plan)
    comm = None if grid is None else GridComm(grid, plan.tp_axis)
    tp = (TensorParallel(comm, comm.tp_axis)
          if comm is not None and comm.tp_axis is not None else None)
    return comm, tp, sizes, params_struct, p_specs


def _tp_kw(tp) -> dict:
    """The keyword a bundle's loss or decode function takes the TP context
    by: given only where there is one (a bundle without TP rules is never
    given it)."""
    return {} if tp is None else {"tp": tp}


def build_sharded_train_step(loss_fn: Callable, init_fn: Callable,
                             batch_struct: Pytree, mesh, plan: ParallelPlan,
                             opt_cfg: AdamWConfig = AdamWConfig(),
                             on_grads: Callable | None = None):
    """``step(params, opt_state, batch, rng=None, **draws) -> (params,
    opt_state, loss)``: ``loss_fn(params, batch, rng, **draws)``, its
    gradient and an AdamW step (int8 moments under
    ``plan.int8_optimizer``).  ``on_grads(grads)``, when given, sees each
    step's gradient before the update (the port's own hook: a caller's
    gradient norm; over ranks, the rank's blocks of it).  Over a grid of
    ranks ``params`` and ``opt_state`` are the rank's blocks
    (``step.shard(whole, step.in_specs[0])``; moments of a block are the
    block's: ``adamw_init(blocks)``), ``batch`` and the draws the global
    batch's, and the loss the global batch's mean on every rank.  Example
    inputs: ``(params, opt_state, batch)`` on the meta device."""
    comm, tp, sizes, params_struct, p_specs = _sharded_setup(init_fn, mesh,
                                                             plan)
    o_init, o_update = _optimizer(plan)
    opt_struct = o_init(params_struct)
    o_specs = opt_specs_like(p_specs, plan.int8_optimizer,
                             _filter_axes(sizes, plan.fsdp_axes))
    b_specs = _batch_specs(batch_struct, sizes, plan)

    def train_step(params, opt_state, batch, rng=None, **draws):
        if comm is None:
            loss, grads = _value_and_grad(loss_fn, params, batch, rng,
                                          **draws)
            norm = None
        else:
            rows, draws = _rows(comm, sizes, plan, rng, batch, draws)
            whole = comm.gather(params, p_specs)
            loss, grads = _value_and_grad(loss_fn, whole, rows, rng,
                                          **draws, **_tp_kw(tp))
            del whole
            grads, sq = comm.reduce_grads(grads, p_specs)
            loss, norm = comm.loss_and_norm(loss, sq)
            step.grad_norm = norm
        if on_grads is not None:
            on_grads(grads)
        if plan.int8_optimizer:
            o_update(params, grads, opt_state, opt_cfg)
        else:
            o_update(params, grads, opt_state, opt_cfg, norm=norm)
        return params, opt_state, loss

    step = Step(train_step, (p_specs, o_specs, b_specs, Spec()),
                (p_specs, o_specs, Spec()), comm, grad_norm=None, tp=tp)
    return step, (params_struct, opt_struct, batch_struct)


def build_forward_step(loss_fn: Callable, init_fn: Callable,
                       batch_struct: Pytree, mesh, plan: ParallelPlan):
    """Inference-prefill proxy: ``step(params, batch, rng=None, **draws)
    -> loss``, the forward pass only (no grad, no optimizer); over a grid
    of ranks the params are the rank's blocks, their FSDP dims gathered
    whole for the call (TP blocks kept: the loss computes on them), and
    the loss the global batch's mean.  Example inputs: ``(params, batch)``
    on the meta device."""
    comm, tp, sizes, params_struct, p_specs = _sharded_setup(init_fn, mesh,
                                                             plan)
    b_specs = _batch_specs(batch_struct, sizes, plan)

    @torch.no_grad()
    def forward_step(params, batch, rng=None, **draws):
        if comm is None:
            return loss_fn(params, batch, rng, **draws)
        rows, draws = _rows(comm, sizes, plan, rng, batch, draws)
        loss = loss_fn(comm.gather(params, p_specs), rows, rng, **draws,
                       **_tp_kw(tp))
        return comm.loss_and_norm(loss, None)[0]

    step = Step(forward_step, (p_specs, b_specs, Spec()), Spec(), comm,
                tp=tp)
    return step, (params_struct, batch_struct)


def build_sharded_serve_step(decode_fn: Callable, init_fn: Callable,
                             cache_struct: Pytree, token_struct: Pytree,
                             mesh, plan: ParallelPlan):
    """``decode_fn(params, token, caches) -> (logits, caches)`` as
    ``step(params, token, caches) -> (next_token, caches)``: the greedy
    next token ``(B, 1)`` int32 of the last position's logits; the caches
    are written in place (the JAX step donates them).  Over a grid of
    ranks the params are the rank's blocks (their FSDP dims gathered whole
    each call), the caches its blocks (``step.shard(caches,
    step.in_specs[2])``: its rows, and under TP its kv heads where
    ``cache_specs`` splits them), the token the whole batch's, and the
    next token the rank's rows (``step.out_specs[0]``; ``step.gather_rows``
    gathers it whole).  Under TP ``decode_fn`` is called with ``tp=`` and
    returns ``VocabLogits``; the greedy token is then the vocab-parallel
    argmax.  Example inputs: ``(params, token, caches)`` on the meta
    device."""
    comm, tp, sizes, params_struct, p_specs = _sharded_setup(init_fn, mesh,
                                                             plan)
    dp_axes = _filter_axes(sizes, plan.batch_axes)
    c_specs = shard_rules.cache_specs(
        cache_struct, dp_axes=dp_axes,
        tp_axis=plan.tp_axis if plan.tp_axis in sizes else None,
        seq_shard_axis=plan.seq_shard_axis, axis_sizes=sizes)
    t_specs = shard_rules.batch_specs(token_struct, dp_axes=dp_axes,
                                      axis_sizes=sizes)
    tok_leaf = tree_leaves(token_struct)[0]
    tok_spec = shard_rules.fit_spec(
        Spec([dp_axes, None]) if dp_axes else Spec(),
        tuple(tok_leaf.shape), sizes)

    @torch.inference_mode()
    def serve_step(params, token, caches):
        if comm is not None:
            params = comm.gather(params, p_specs)
            token = comm.local(token, t_specs)
        logits, caches = decode_fn(params, token, caches, **_tp_kw(tp))
        return greedy(logits, tp), caches

    step = Step(serve_step, (p_specs, t_specs, c_specs), (tok_spec, c_specs),
                comm, tp=tp)
    step.gather_rows = lambda tok: step.gather(tok, tok_spec)
    return step, (params_struct, token_struct, cache_struct)


# ===========================================================================
# PULSE pipeline strategies
# ===========================================================================

def _pp_specs(adapter, sizes: dict, batch_struct: Pytree,
              plan: ParallelPlan, params_struct) -> tuple:
    """The JAX builder's param, optimizer and batch specs of a pipeline
    step, and its ZeRO stages ``(zero_stage, zs_exec, zdp, fsdp)``: the
    optimizer state shards over the FSDP axes from ZeRO-1 on (the plan's
    stage or the adapter's ``pcfg``'s), the stage stacks at rest only
    when the adapter's executor gathers on use (its ``pcfg`` at ZeRO-2)."""
    fsdp = _filter_axes(sizes, plan.fsdp_axes)
    zdp = math.prod(sizes.get(a, 1) for a in fsdp)
    zs_exec = getattr(getattr(adapter, "pcfg", None), "zero_stage", 0)
    zero_stage = max(zs_exec, plan.zero_stage) if (fsdp and zdp > 1) else 0
    stacks_struct, edge_struct = params_struct
    zstack = (tuple(shard_rules.zero_stack_specs(
        s, dp=zdp, axis="model", data_axes=fsdp) for s in stacks_struct)
        if zero_stage >= 1 else None)
    edge_specs = shard_rules.build_param_specs(edge_struct, tp_axis=None,
                                               fsdp_axes=fsdp or None)
    stack_specs = (zstack if zs_exec >= 2 else tuple(
        tree_map(lambda _: Spec(["model"]), s) for s in stacks_struct))
    p_specs = (stack_specs, edge_specs)
    o_like = (zstack, edge_specs) if zero_stage >= 1 else p_specs
    o_specs = opt_specs_like(o_like, plan.int8_optimizer, fsdp)
    b_specs = _batch_specs(batch_struct, sizes, plan)
    return p_specs, o_specs, b_specs, (zero_stage, zs_exec, zdp, fsdp)


def build_pp_train_step(adapter, mesh, batch_struct: Pytree,
                        plan: ParallelPlan, make_microbatches: Callable,
                        opt_cfg: AdamWConfig = AdamWConfig(),
                        on_grads: Callable | None = None):
    """``adapter``: an ``LMPipelineAdapter``, a ``DiffusionPipelineAdapter``
    or a ``CompiledPipeline``, built for the mesh's ``"model"`` axis (D
    pipeline devices: in this process, or one rank each of a grid).

    ``step(params, opt_state, batch, rng=None, **draws) -> (params,
    opt_state, loss)``, params in pipeline form ``(stacks, edge)``:
    ``make_microbatches(batch, rng, edge, **draws)`` gives the executor's
    arguments after the stacks and the edge (``(mbs,)`` or ``(mb, aux)``);
    the step differentiates the loss by the stacks and the edge and takes
    an AdamW step (int8 moments under ``plan.int8_optimizer``);
    ``on_grads`` as in :func:`build_sharded_train_step`.  Example inputs:
    ``(params, opt_state, batch)`` on the meta device.

    Over a grid of ranks the step is the rank's executor over its ring
    and data group (``for_rank(pipe, data).build(ring, data)`` of a
    ``CompiledPipeline``, ``build(ring, data)`` of an adapter); ``params``
    are the rank's (``step.split_params(whole)``), the batch the global
    batch, the loss the global mean on every rank, and the optimizer
    state covers ``step.optimizer_view(params)``: from ZeRO-1 on (the
    plan's or the adapter's) its data replica's shard of each sharded
    stage leaf, which the step gathers back after the update (at ZeRO-2
    of the executor the rows rest sharded).  The edge params and their
    moments stay whole on every rank.  (The JAX builder's
    ``extra_stack_fsdp``, FSDP of the stacks over the pipeline axis, has
    no counterpart.)"""
    grid = rank_grid(mesh)
    sizes = (check_one_process(mesh, plan, pipeline_axis="model")
             if grid is None else
             check_ranks(grid, plan, pipeline_axis="model"))
    D = adapter.pcfg.num_devices
    if sizes.get("model", 1) != D:
        raise ValueError(f"the adapter pipelines over {D} devices; the "
                         f"mesh's 'model' axis has {sizes.get('model', 1)}")
    o_init, o_update = _optimizer(plan)
    params_struct = adapter.init_pipeline_params(torch.Generator(), "meta")
    opt_struct = o_init(params_struct)
    p_specs, o_specs, b_specs, zero = _pp_specs(adapter, sizes, batch_struct,
                                                plan, params_struct)
    specs = ((p_specs, o_specs, b_specs, Spec()), (p_specs, o_specs, Spec()))
    if grid is not None:
        step = _pp_rank_step(adapter, grid, plan, make_microbatches, opt_cfg,
                             on_grads, params_struct, zero)
        step.in_specs, step.out_specs = specs
        return step, (params_struct, opt_struct, batch_struct)
    pipe_fn = adapter.build()

    def loss_of(params, batch, rng, **draws):
        stacks, edge = params
        args = make_microbatches(batch, rng, edge, **draws)
        return pipe_fn(*stacks, edge, *args)

    def train_step(params, opt_state, batch, rng=None, **draws):
        loss, grads = _value_and_grad(loss_of, params, batch, rng, **draws)
        if on_grads is not None:
            on_grads(grads)
        o_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, loss

    return Step(train_step, *specs), (params_struct, opt_struct,
                                      batch_struct)


def _pp_rank_step(adapter, grid, plan: ParallelPlan,
                  make_microbatches: Callable, opt_cfg: AdamWConfig,
                  on_grads, params_struct, zero) -> Step:
    """The rank ``grid.rank``'s pipeline step (see
    :func:`build_pp_train_step`)."""
    zero_stage, zs_exec, zdp, _ = zero
    pcfg = adapter.pcfg
    dp = grid.dp
    if pcfg.dp_size != dp:
        raise ValueError(f"the adapter runs {pcfg.dp_size} data replicas; "
                         f"the grid has {dp}")
    compiled = hasattr(adapter, "for_rank")
    if compiled:
        if adapter.rank is not None:
            raise ValueError("build_pp_train_step takes the whole plan; it "
                             "takes the rank's view (for_rank) itself")
        rank_adapter = adapter.for_rank(grid.pipe_index, grid.data_index)
    else:
        rank_adapter = adapter
    # the moments' ZeRO dims (the step's, where the executor keeps the
    # rows whole): a rank leaf's dim from the whole plan's stack dims
    mdims = None
    if zero_stage >= 1 and not (compiled and zs_exec >= 1):
        stacks_struct, _ = params_struct
        off = 1 if compiled else 2          # [V, pad, ...] or [1, rows, ...]
        mdims = tuple(tree_map(lambda g: g + off - 1 if g >= 0 else -1,
                               shard_rules.zero_stack_dims(s, dp=zdp))
                      for s in stacks_struct)
    state: dict = {}

    def setup(device):
        from repro_torch.runtime.ring import DataGroup, Ring
        import torch.distributed as dist
        staged = (device.type == "cuda" and str(dist.get_backend(
            grid.model_group)).lower() == "gloo")
        ring = Ring(grid.model_group, grid.pipe_index, grid.pp, device,
                    staged=staged)
        data = (DataGroup(grid.data_group, grid.data_index, dp, device,
                          staged=staged) if dp > 1 else None)
        fn = rank_adapter.build(ring, data)
        state.update(ring=ring, data=data, fn=fn)

    def split_params(whole: Pytree) -> tuple:
        """The rank's pipeline-form params of the whole model's."""
        if compiled:
            return rank_adapter.split_params(whole)
        stacks, edge = adapter.split_params(whole)
        p = grid.pipe_index
        return (tuple(tree_map(lambda x: x.narrow(0, p, 1).clone(), s)
                      for s in stacks), tree_map(torch.clone, edge))

    def optimizer_view(params: tuple) -> tuple:
        """What the rank's AdamW updates of its ``(stacks, edge)`` (or of
        their gradients)."""
        if compiled and mdims is None:
            return rank_adapter.optimizer_view(params)
        if mdims is None:
            return params
        stacks, edge = params
        return tuple(shard_rules.shard_view(st, dims, dp, grid.data_index)
                     for st, dims in zip(stacks, mdims)), edge

    def regather(params: tuple) -> None:
        """The rows whole again after the update of the shards' views."""
        if compiled and mdims is None:
            rank_adapter.gather_params_(params, state["data"])
        elif mdims is not None:
            for st, dims in zip(params[0], mdims):
                shard_rules.gather_shards_(st, dims, state["data"])

    def grid_norm(loss, grads: tuple) -> tuple[bool, torch.Tensor]:
        """(finite, the global norm) over the grid: a stage leaf's shard (of
        the rows, or of the moments' view) on every rank, a whole one on
        data index 0, the edge on rank 0."""
        from repro_torch.runtime.ring import grid_grad_norm
        dims = (mdims if mdims is not None else
                rank_adapter.zero_dims() if compiled else None)
        return grid_grad_norm(loss, grads, optimizer_view(grads), dims,
                              first=grid.data_index == 0,
                              leader=grid.rank == 0, ring=state["ring"],
                              data=state["data"])

    def train_step(params, opt_state, batch, rng=None, **draws):
        if not state:
            setup(_device(params))
        leaves = tree_leaves(params)
        for x in leaves:
            x.grad = None
            x.requires_grad_(True)
        try:
            stacks, edge = params
            args = make_microbatches(batch, rng, edge, **draws)
            loss = state["fn"](*stacks, edge, *args)
            grads = tree_map(lambda x: x.grad if x.grad is not None
                             else torch.zeros_like(x), params)
        finally:
            for x in leaves:
                x.grad = None
                x.requires_grad_(False)
        step.finite, norm = grid_norm(loss, grads)
        step.grad_norm = norm
        if on_grads is not None:
            on_grads(grads)
        o_update(optimizer_view(params), optimizer_view(grads), opt_state,
                 opt_cfg, norm=norm)
        regather(params)
        return params, opt_state, loss.detach()

    o_update = adamw_update
    step = Step(train_step, None, None, None, split_params=split_params,
                optimizer_view=optimizer_view, rank_adapter=rank_adapter,
                grad_norm=None, finite=None)
    step.state = state          # the ring, data group and executor
    return step
