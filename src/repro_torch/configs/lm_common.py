"""Shared bundle builder for the decoder-LM family (the port of
``repro.configs.lm_common``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (SHAPES, ArchBundle, ShapeSpec,
                                      pipeline_config, token_batch_struct)
from repro_torch.models import lm as lm_mod
from repro_torch.models.lm import LMConfig
from repro_torch.runtime.adapters import LMPipelineAdapter
from repro_torch.train.steps import ParallelPlan

FULL_ATTN_SKIP = ("skipped: full quadratic attention — long_500k requires "
                  "sub-quadratic context handling (DESIGN.md §4)")


def lm_bundle(
    name: str,
    cfg: LMConfig,
    plans: dict[str, ParallelPlan],
    *,
    long_ok: bool = False,
    long_reason: str = FULL_ATTN_SKIP,
    vision_prefix_struct=None,
    notes: str = "",
) -> ArchBundle:
    support = {s: "ok" for s in SHAPES}
    if not long_ok:
        support["long_500k"] = long_reason

    def batch_struct(shape: ShapeSpec, plan: ParallelPlan | None = None):
        """Tokens ``(B, S)``, or ``(M, B/M, S)`` under a ``pp_*`` plan;
        with the vision prefix's patch embeddings for a train shape."""
        plan = plan or plans.get(shape.name)
        mb = (plan.microbatches if plan and plan.strategy.startswith("pp")
              else None)
        bs = token_batch_struct(shape, cfg.vocab, microbatched=mb)
        if vision_prefix_struct is not None and shape.kind == "train":
            bs["prefix_embeds"] = vision_prefix_struct(shape, mb)
        return bs

    def loss_fn(params, batch, rng=None, tp=None):
        """``tp``: the sharded builders' tensor-parallel context, where the
        plan's TP axis is larger than 1 (``models.lm``)."""
        return lm_mod.lm_loss(params, batch, cfg, tp=tp)

    def make_decode_fn(shape: ShapeSpec):
        def decode(params, token, caches, tp=None):
            return lm_mod.decode_step(params, token, caches, cfg, tp=tp)
        return decode

    def cache_struct(shape: ShapeSpec):
        """``lm.init_caches`` on the meta device (``pos`` a host int)."""
        return lm_mod.init_caches(cfg, shape.global_batch, shape.seq_len,
                                  dtype=cfg.dtype, device="meta")

    def make_adapter(plan: ParallelPlan, mesh):
        return LMPipelineAdapter(cfg, pipeline_config(plan, mesh),
                                 wave=plan.strategy == "pp_wave")

    def make_microbatches(batch, rng=None, edge=None):
        return (batch,)       # batch already arrives microbatch-stacked

    def scaled_cfg(n_layers: int) -> LMConfig:
        n_dense = min(cfg.n_dense_layers, max(n_layers - 1, 0)) \
            if cfg.moe else 0
        return dataclasses.replace(cfg, n_layers=n_layers,
                                   n_dense_layers=n_dense)

    return ArchBundle(
        name=name, family="lm", cfg=cfg,
        init_fn=lambda gen, device="cuda": lm_mod.init_lm(gen, cfg, device),
        loss_fn=loss_fn,
        batch_struct=batch_struct,
        plans=plans,
        shape_support=support,
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
        make_decode_fn=make_decode_fn,
        cache_struct=cache_struct,
        make_adapter=make_adapter,
        make_microbatches=make_microbatches,
        scaled_cfg=scaled_cfg,
        notes=notes,
    )
