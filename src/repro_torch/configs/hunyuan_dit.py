"""Hunyuan-DiT-3B, the paper's own model, scaled: 32 DiT blocks (16 enc +
16 dec with long skips), d=2048, 16 heads (head_dim 128), d_ff=8192, adaLN
time conditioning, cross-attention over 77 text tokens of width 1024
(CLIP+T5 stub embeddings), latent 64x64x4 with patch 2 (1024 tokens); bf16
params and activations.

``CFG.param_count()`` gives 3,221,225,472 parameters (the edge params bring
the model to about 3.26e9): bf16 params and grads take 6.5 GB each and the
fp32 AdamW moments 26 GB, so the model trains at full width and depth on
one 80 GB card, with the pipeline's D devices sharing it.  The trainer
(``launch/train.py --arch hunyuan-dit``) takes it through
``auto_pipeline`` (:func:`auto_plan`); the bundle's ``train_4k`` plan is
the folded wave over ``DiffusionPipelineAdapter``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (ArchBundle, ShapeSpec, ddpm_draws,
                                      flatten_microbatches, meta,
                                      pipeline_config)
from repro_torch.models import diffusion as dm
from repro_torch.models.diffusion import HunyuanDiTConfig
from repro_torch.runtime.adapters import (DiffusionPipelineAdapter,
                                          make_diffusion_microbatches)
from repro_torch.train.steps import ParallelPlan

CFG = HunyuanDiTConfig(
    name="hunyuan-dit", img_size=64, in_ch=4, patch=2, d_model=2048,
    n_layers=32, n_heads=16, d_ff=8192, ctx_dim=1024, ctx_len=77,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16)
KIND = "hunyuan"

PLANS = {
    "train_4k": ParallelPlan(strategy="pp_wave", pp_degree=16,
                             microbatches=16, batch_axes=("pod", "data"),
                             fsdp_axes=("data",)),
}
SUPPORT = {"train_4k": "ok",
           "prefill_32k": "n/a: diffusion training arch",
           "decode_32k": "n/a: diffusion training arch",
           "long_500k": "n/a: diffusion training arch"}


def batch_struct(shape: ShapeSpec, plan=None):
    plan = plan or PLANS["train_4k"]
    M = plan.microbatches
    B = shape.global_batch
    return {
        "latents": meta((M, B // M, CFG.img_size, CFG.img_size, CFG.in_ch),
                        torch.bfloat16),
        "text_embeds": meta((M, B // M, CFG.ctx_len, CFG.ctx_dim),
                            torch.bfloat16),
    }


def loss_fn(params, batch, rng=None, *, t=None, noise=None):
    """The DDPM loss of the whole (microbatch-stacked) batch; the draws
    ``t`` and ``noise`` as given, else from ``rng``."""
    flat = flatten_microbatches(batch)
    t, noise = ddpm_draws(flat["latents"], rng, t, noise)
    return dm.hunyuan_loss(params, flat, t, noise, CFG)


def make_adapter(plan: ParallelPlan, mesh):
    return DiffusionPipelineAdapter(CFG, pipeline_config(plan, mesh), KIND)


def make_microbatches(batch, rng=None, edge=None, *, t=None, noise=None):
    """The pipeline's ``(mb, aux)`` of a microbatch-stacked batch, as
    UViT's, with the text tokens and the adaLN conditioning ``temb`` from
    the edge's ``time_mlp`` in ``aux``; ``temb`` keeps its graph, so
    ``time_mlp`` is trained through the stages, as under the JAX
    ``build_pp_train_step``."""
    M = batch["latents"].shape[0]
    flat = flatten_microbatches(batch)
    t, noise = ddpm_draws(flat["latents"], rng, t, noise)
    return make_diffusion_microbatches(flat, M, CFG, KIND, t=t, noise=noise,
                                       params=edge, temb_grad=True)


def pipeline_graph(batch: int = 1, fwd_times=None):
    """Runtime-aligned block graph for the auto-pipeline compile path
    (one block per enc/dec row, fully-paired skips)."""
    return dm.hunyuan_pipeline_graph(CFG, batch, fwd_times=fwd_times)


def pipeline_model_fns():
    """Block-level compile-path callables for this config's model."""
    from repro_torch.runtime.adapters import diffusion_model_fns
    return diffusion_model_fns(CFG, KIND)


def auto_plan(N: int, **kwargs):
    """Plan + lower this config through the full compile path
    (graph -> skip-aware partition -> validated schedule -> executor).

    ``N`` is the total device budget; keyword arguments forward to
    :func:`repro_torch.runtime.compile.auto_pipeline` (e.g.
    ``pipeline_devices`` to pin the pipeline degree, ``microbatches``,
    ``use_ilp``).
    """
    from repro_torch.runtime.compile import auto_pipeline
    return auto_pipeline(pipeline_graph(), pipeline_model_fns(), N, **kwargs)


def get_bundle():
    return ArchBundle(
        name="hunyuan-dit", family="diffusion", cfg=CFG,
        init_fn=lambda gen, device="cuda": dm.init_hunyuan(gen, CFG, device),
        loss_fn=loss_fn, batch_struct=batch_struct, plans=PLANS,
        shape_support=dict(SUPPORT), param_count=CFG.param_count(),
        active_param_count=CFG.param_count(),
        make_adapter=make_adapter, make_microbatches=make_microbatches,
        notes="paper model; adaLN + cross-attn wave pipeline")
