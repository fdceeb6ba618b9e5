"""UViT-2.7B, the paper's own model (§VII-B): 32 blocks (16 enc + 16 dec
with long skips), d=2560, 20 heads (head_dim 128), d_ff=10240, latent
32x32x4 (258 tokens), class-conditional; bf16 params and activations.

About 2.73e9 parameters: bf16 params and grads take 5.5 GB each and the
fp32 AdamW moments 21.8 GB, so the model trains at full width and depth on
one 80 GB card, with the pipeline's D devices sharing it.  The trainer
(``launch/train.py --arch uvit-h``) takes it through ``auto_pipeline``;
the bundle's ``train_4k`` plan is the paper's folded wave over
``DiffusionPipelineAdapter``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (ArchBundle, ShapeSpec, ddpm_draws,
                                      flatten_microbatches, meta,
                                      pipeline_config)
from repro_torch.models import diffusion as dm
from repro_torch.models.diffusion import UViTConfig
from repro_torch.runtime.adapters import (DiffusionPipelineAdapter,
                                          make_diffusion_microbatches)
from repro_torch.train.steps import ParallelPlan

CFG = UViTConfig(
    name="uvit-h", img_size=32, in_ch=4, patch=2, d_model=2560,
    n_layers=32, n_heads=20, d_ff=10240, n_classes=1001,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16)
KIND = "uvit"

PLANS = {
    "train_4k": ParallelPlan(strategy="pp_wave", pp_degree=16,
                             microbatches=16, batch_axes=("pod", "data"),
                             fsdp_axes=("data",),
                             notes="paper's wave: S=32 folded, skip-local"),
}
SUPPORT = {"train_4k": "ok",
           "prefill_32k": "n/a: diffusion training arch (no LM serving)",
           "decode_32k": "n/a: diffusion training arch",
           "long_500k": "n/a: diffusion training arch"}


def batch_struct(shape: ShapeSpec, plan=None):
    plan = plan or PLANS["train_4k"]
    M = plan.microbatches
    B = shape.global_batch
    return {
        "latents": meta((M, B // M, CFG.img_size, CFG.img_size, CFG.in_ch),
                        torch.bfloat16),
        "labels": meta((M, B // M), torch.int32),
    }


def loss_fn(params, batch, rng=None, *, t=None, noise=None):
    """The DDPM loss of the whole (microbatch-stacked) batch; the draws
    ``t`` and ``noise`` as given, else from ``rng``."""
    flat = flatten_microbatches(batch)
    t, noise = ddpm_draws(flat["latents"], rng, t, noise)
    return dm.uvit_loss(params, flat, t, noise, CFG)


def make_adapter(plan: ParallelPlan, mesh):
    return DiffusionPipelineAdapter(CFG, pipeline_config(plan, mesh), KIND)


def make_microbatches(batch, rng=None, edge=None, *, t=None, noise=None):
    """The pipeline's ``(mb, aux)`` of a microbatch-stacked batch: its DDPM
    draws (as given, else from ``rng``) over the flattened batch, split
    again into the plan's M microbatches."""
    M = batch["latents"].shape[0]
    flat = flatten_microbatches(batch)
    t, noise = ddpm_draws(flat["latents"], rng, t, noise)
    return make_diffusion_microbatches(flat, M, CFG, KIND, t=t, noise=noise)


def get_bundle():
    return ArchBundle(
        name="uvit-h", family="diffusion", cfg=CFG,
        init_fn=lambda gen, device="cuda": dm.init_uvit(gen, CFG, device),
        loss_fn=loss_fn, batch_struct=batch_struct, plans=PLANS,
        shape_support=dict(SUPPORT), param_count=CFG.param_count(),
        active_param_count=CFG.param_count(),
        make_adapter=make_adapter, make_microbatches=make_microbatches,
        notes="paper model; wave pipeline flagship")
