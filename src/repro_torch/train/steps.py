"""Train/serve step builders for a bundle's :class:`ParallelPlan` (the port
of ``repro.train.steps``).

- :func:`build_sharded_train_step`, :func:`build_forward_step` and
  :func:`build_sharded_serve_step`: the JAX package's GSPMD ("sharded")
  strategy, the whole model in one process;
- :func:`build_pp_train_step`: the PULSE pipeline strategies (``pp_1f1b``,
  ``pp_wave``) over an adapter's executor: an ``LMPipelineAdapter``, a
  ``DiffusionPipelineAdapter`` or a ``CompiledPipeline``, whose D pipeline
  devices share this process.

Each builder returns ``(step, example)``: the step, and its example
inputs as tensors on the meta device (the JAX builders' ShapeDtypeStructs;
their NamedShardings have no counterpart here).  A step runs on the
device of the tensors it is given, and updates params and optimizer state
IN PLACE (the JAX steps donate them), returning them with the loss.

This port builds in one process.  ``mesh`` is a dict of axis sizes, such
as ``{"data": 1, "model": 4}`` (a pipeline's D devices in this process),
or a ``launch.mesh.RankGrid`` of one rank.  A plan's axes of size 1 are
no-ops; a grid of more than one rank, or a plan that needs tensor, expert
or sequence parallelism, data parallelism or FSDP over an axis larger
than 1, raises ``NotImplementedError`` naming what is missing (the
trainer's ``--dp --pp --zero-stage`` under ``torchrun`` runs data
parallelism and ZeRO over ranks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               int8_adamw_init, int8_adamw_update)
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


def axis_sizes(mesh) -> dict:
    """The axis sizes of ``mesh`` (a dict of them, ``None`` for none, or a
    ``RankGrid`` of one rank)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    from repro_torch.launch.mesh import mesh_axis_sizes
    if mesh.world > 1:
        raise NotImplementedError(
            f"a grid of {mesh.world} ranks (dp={mesh.dp}, pp={mesh.pp}): "
            "the step builders build in one process; the trainer runs "
            "ranks (launch/train.py --dp --pp under torchrun)")
    return mesh_axis_sizes(mesh)


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
            f"(size {size(plan.tp_axis)}) is not ported")
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
                    "the trainer runs it over ranks (launch/train.py --dp "
                    "under torchrun)")
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
# the whole model in one process ("sharded" plans)
# ===========================================================================

def build_sharded_train_step(loss_fn: Callable, init_fn: Callable,
                             batch_struct: Pytree, mesh, plan: ParallelPlan,
                             opt_cfg: AdamWConfig = AdamWConfig(),
                             on_grads: Callable | None = None):
    """``step(params, opt_state, batch, rng=None, **draws) -> (params,
    opt_state, loss)``: ``loss_fn(params, batch, rng, **draws)``, its
    gradient and an AdamW step (int8 moments under
    ``plan.int8_optimizer``).  ``on_grads(grads)``, when given, sees each
    step's gradient before the update (the port's own hook: a caller's
    gradient norm).  Example inputs: ``(params, opt_state, batch)`` on the
    meta device."""
    check_one_process(mesh, plan)
    o_init, o_update = _optimizer(plan)
    params_struct = _meta_params(init_fn)
    opt_struct = o_init(params_struct)

    def train_step(params, opt_state, batch, rng=None, **draws):
        loss, grads = _value_and_grad(loss_fn, params, batch, rng, **draws)
        if on_grads is not None:
            on_grads(grads)
        o_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, loss

    return train_step, (params_struct, opt_struct, batch_struct)


def build_forward_step(loss_fn: Callable, init_fn: Callable,
                       batch_struct: Pytree, mesh, plan: ParallelPlan):
    """Inference-prefill proxy: ``step(params, batch, rng=None, **draws)
    -> loss``, the forward pass only (no grad, no optimizer).  Example
    inputs: ``(params, batch)`` on the meta device."""
    check_one_process(mesh, plan)

    @torch.no_grad()
    def forward_step(params, batch, rng=None, **draws):
        return loss_fn(params, batch, rng, **draws)

    return forward_step, (_meta_params(init_fn), batch_struct)


def build_sharded_serve_step(decode_fn: Callable, init_fn: Callable,
                             cache_struct: Pytree, token_struct: Pytree,
                             mesh, plan: ParallelPlan):
    """``decode_fn(params, token, caches) -> (logits, caches)`` as
    ``step(params, token, caches) -> (next_token, caches)``: the greedy
    next token ``(B, 1)`` int32 of the last position's logits; the caches
    are written in place (the JAX step donates them).  Example inputs:
    ``(params, token, caches)`` on the meta device."""
    check_one_process(mesh, plan)

    @torch.inference_mode()
    def serve_step(params, token, caches):
        logits, caches = decode_fn(params, token, caches)
        next_tok = torch.argmax(logits[..., -1:, :], dim=-1).to(torch.int32)
        return next_tok, caches

    return serve_step, (_meta_params(init_fn), token_struct, cache_struct)


# ===========================================================================
# PULSE pipeline strategies
# ===========================================================================

def build_pp_train_step(adapter, mesh, batch_struct: Pytree,
                        plan: ParallelPlan, make_microbatches: Callable,
                        opt_cfg: AdamWConfig = AdamWConfig(),
                        on_grads: Callable | None = None):
    """``adapter``: an ``LMPipelineAdapter``, a ``DiffusionPipelineAdapter``
    or a ``CompiledPipeline``, built for the mesh's ``"model"`` axis (its
    D pipeline devices, all in this process).

    ``step(params, opt_state, batch, rng=None, **draws) -> (params,
    opt_state, loss)``, params in pipeline form ``(stacks, edge)``:
    ``make_microbatches(batch, rng, edge, **draws)`` gives the executor's
    arguments after the stacks and the edge (``(mbs,)`` or ``(mb, aux)``);
    the step differentiates the loss by the stacks and the edge and takes
    an AdamW step (int8 moments under ``plan.int8_optimizer``);
    ``on_grads`` as in :func:`build_sharded_train_step`.  Example inputs:
    ``(params, opt_state, batch)`` on the meta device.  (The JAX
    builder's ``extra_stack_fsdp``, FSDP of the stacks over ranks, has no
    counterpart.)"""
    sizes = check_one_process(mesh, plan, pipeline_axis="model")
    D = adapter.pcfg.num_devices
    if sizes.get("model", 1) != D:
        raise ValueError(f"the adapter pipelines over {D} devices; the "
                         f"mesh's 'model' axis has {sizes.get('model', 1)}")
    o_init, o_update = _optimizer(plan)
    params_struct = adapter.init_pipeline_params(torch.Generator(), "meta")
    opt_struct = o_init(params_struct)
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

    return train_step, (params_struct, opt_struct, batch_struct)

