"""Reduced smoke variants of the diffusion architectures (the port of
``repro.configs.smoke``, its three diffusion keys; the LM, whisper, xLSTM
and Mamba keys are not ported yet).

The same configs as the JAX package's.  Each factory returns ``(loss_fn,
init_fn, make_batch, cfg)``: ``loss_fn(params, batch, t, noise)`` is a
scalar (the port's losses take the DDPM draws as tensors),
``init_fn(gen, device)`` draws the params and ``make_batch(gen, device)``
a batch of the config's shapes.  ``kernels=True`` (the trainer's choice)
switches on the model's kernels: flash attention, and for UViT and
Hunyuan-DiT the fused skip-concat matmul.
"""
from __future__ import annotations

import torch

from repro_torch.models import diffusion as dm
from repro_torch.models.diffusion import (HunyuanDiTConfig, UNetConfig,
                                          UViTConfig)


def bundle(cfg, loss, init, shapes: dict):
    """A factory's ``(loss_fn, init_fn, make_batch, cfg)`` for ``cfg``:
    ``shapes`` maps each batch key to its shape."""
    def make_batch(gen: torch.Generator, device="cuda") -> dict:
        out = {}
        for k, shape in shapes.items():
            if k == "labels":
                out[k] = torch.randint(0, cfg.n_classes, shape, generator=gen,
                                       device=device, dtype=torch.int32)
            else:
                out[k] = torch.randn(shape, generator=gen, device=device)
        return out
    return (lambda p, b, t, n: loss(p, b, t, n, cfg),
            lambda gen, device="cuda": init(gen, cfg, device), make_batch, cfg)


def smoke_uvit(kernels: bool = False):
    cfg = UViTConfig("uvit-smoke", img_size=8, in_ch=4, patch=2, d_model=32,
                     n_layers=4, n_heads=4, d_ff=64, n_classes=10,
                     use_skip_kernel=kernels, use_flash=kernels)
    return bundle(cfg, dm.uvit_loss, dm.init_uvit,
                  {"latents": (2, 8, 8, 4), "labels": (2,)})


def smoke_hunyuan(kernels: bool = False):
    cfg = HunyuanDiTConfig("hunyuan-smoke", img_size=8, in_ch=4, patch=2,
                           d_model=32, n_layers=4, n_heads=4, d_ff=64,
                           ctx_dim=16, ctx_len=7, use_skip_kernel=kernels,
                           use_flash=kernels)
    return bundle(cfg, dm.hunyuan_loss, dm.init_hunyuan,
                  {"latents": (2, 8, 8, 4), "text_embeds": (2, 7, 16)})


def smoke_sdv2(kernels: bool = False):
    cfg = UNetConfig("sdv2-smoke", img_size=16, in_ch=4, base_ch=16,
                     ch_mults=(1, 2), blocks_per_level=2, attn_levels=(1,),
                     ctx_dim=16, n_heads=4, use_flash=kernels)
    return bundle(cfg, dm.unet_loss, dm.init_unet,
                  {"latents": (2, 16, 16, 4), "text_embeds": (2, 7, 16)})


SMOKE_FACTORIES = {
    "uvit-h": smoke_uvit,
    "sdv2-unet": smoke_sdv2,
    "hunyuan-dit": smoke_hunyuan,
}
