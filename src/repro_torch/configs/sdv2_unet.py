"""SDv2-style UNet, the paper's third model: conv res blocks and attention
blocks at four resolutions, base_ch=448, mults (1,2,4,4), two blocks per
level (three on the way up), attention at levels 1-3 and in the middle
(8 heads: head dim 112 at level 1, 224 at levels 2, 3 and the middle),
cross-attention over 77 CLIP text tokens of width 1024, latent 32x32x4;
bf16 params and activations, the norm leaves fp32 as in the JAX package.

Heterogeneous blocks (paper Fig. 6: ~3x per-block cost spread): the
skip-aware partitioner's showcase (``unet_block_graph``: 29 blocks, 12
skip edges).

:func:`init_unet` makes 1,839,817,728 parameters; ``CFG.param_count()``,
the JAX package's closed form kept as it is, gives 980,008,960 (it counts
neither the up path's third block per level nor the wider skip-in convs).
bf16 params and grads take 3.7 GB each and the fp32 AdamW moments 14.7
GB, so the model trains unsharded on one 80 GB card: the trainer's
``--arch sdv2-unet-full`` (without ``--pipeline``) runs it through
:func:`factory`, the bundle the smoke configs' factories give.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchBundle, ShapeSpec, ddpm_draws, meta
from repro_torch.configs.smoke import bundle
from repro_torch.models import diffusion as dm
from repro_torch.models.diffusion import UNetConfig
from repro_torch.train.steps import ParallelPlan

CFG = UNetConfig(
    name="sdv2-unet", img_size=32, in_ch=4, base_ch=448,
    ch_mults=(1, 2, 4, 4), blocks_per_level=2, attn_levels=(1, 2, 3),
    ctx_dim=1024, ctx_len=77, n_heads=8,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16)


PLANS = {
    "train_4k": ParallelPlan(tp_axis=None, fsdp_axes=("model", "data"),
                             batch_axes=("pod", "data")),
}
SUPPORT = {"train_4k": "ok",
           "prefill_32k": "n/a: diffusion training arch",
           "decode_32k": "n/a: diffusion training arch",
           "long_500k": "n/a: diffusion training arch"}


def batch_struct(shape: ShapeSpec, plan=None):
    B = shape.global_batch
    return {
        "latents": meta((B, CFG.img_size, CFG.img_size, CFG.in_ch),
                        torch.bfloat16),
        "text_embeds": meta((B, CFG.ctx_len, CFG.ctx_dim), torch.bfloat16),
    }


def loss_fn(params, batch, rng=None, *, t=None, noise=None):
    """The DDPM loss; the draws ``t`` and ``noise`` as given, else from
    ``rng``."""
    t, noise = ddpm_draws(batch["latents"], rng, t, noise)
    return dm.unet_loss(params, batch, t, noise, CFG)


def factory(kernels: bool = False):
    """``(loss_fn, init_fn, make_batch, cfg)`` of ``CFG``, as
    :mod:`repro_torch.configs.smoke`'s factories give theirs (batch 2);
    ``kernels=True`` sends attention through the flash kernel."""
    return bundle(dataclasses.replace(CFG, use_flash=kernels), dm.unet_loss,
                  dm.init_unet,
                  {k: tuple(x.shape) for k, x in batch_struct(
                      ShapeSpec("smoke", "train", 0, 2)).items()})


def get_bundle():
    return ArchBundle(
        name="sdv2-unet", family="diffusion", cfg=CFG,
        init_fn=lambda gen, device="cuda": dm.init_unet(gen, CFG, device),
        loss_fn=loss_fn, batch_struct=batch_struct, plans=PLANS,
        shape_support=dict(SUPPORT), param_count=CFG.param_count(),
        active_param_count=CFG.param_count(),
        notes="heterogeneous UNet; partitioner showcase")
