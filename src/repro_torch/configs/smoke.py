"""Reduced smoke variants (the port of ``repro.configs.smoke``: every key).

The same configs as the JAX package's, the diffusion keys in
``SMOKE_FACTORIES``, the decoder-LM keys in ``LM_FACTORIES`` and whisper,
xLSTM and Zamba2 in ``RECURRENT_FACTORIES`` (the JAX package keeps all in
one dict).  Each factory returns ``(loss_fn,
init_fn, make_batch, cfg)``: ``init_fn(gen, device)`` draws the params and
``make_batch(gen, device)`` a batch of the config's shapes.  A diffusion
``loss_fn(params, batch, t, noise)`` is a scalar (the port's losses take
the DDPM draws as tensors); an LM's is ``loss_fn(params, batch)``, its
batch ``{"tokens"}`` (internvl2: and ``prefix_embeds``; whisper:
``{"frames", "tokens"}``).  ``kernels=True`` (the trainer's choice)
switches on the model's kernels: flash attention (every LM but deepseek's
MLA, whisper, and Zamba2's shared attention), and for UViT and
Hunyuan-DiT the fused skip-concat matmul.  Zamba2's Mamba2 blocks always run their carry across chunks
through the gated linear scan (there is no other route).
"""
from __future__ import annotations

import torch

from repro_torch.models import diffusion as dm
from repro_torch.models import lm as lm_mod
from repro_torch.models import mamba as zm
from repro_torch.models import whisper as wh
from repro_torch.models import xlstm as xm
from repro_torch.models.diffusion import (HunyuanDiTConfig, UNetConfig,
                                          UViTConfig)
from repro_torch.models.layers import AttnConfig, MLAConfig, MoEConfig
from repro_torch.models.lm import LMConfig
from repro_torch.models.mamba import Mamba2Config, Zamba2Config
from repro_torch.models.whisper import WhisperConfig
from repro_torch.models.xlstm import XLSTMConfig


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


def _lm(cfg: LMConfig, seq: int = 32, batch: int = 2, prefix: int = 0):
    def make_batch(gen: torch.Generator, device="cuda") -> dict:
        b = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                                     device=device, dtype=torch.int32)}
        if prefix:
            b["prefix_embeds"] = torch.randn(
                (batch, prefix, cfg.d_model), generator=gen,
                device=device).to(cfg.dtype)
        return b
    return (lambda p, b: lm_mod.lm_loss(p, b, cfg),
            lambda gen, device="cuda": lm_mod.init_lm(gen, cfg, device),
            make_batch, cfg)


def smoke_smollm(kernels: bool = False):
    cfg = LMConfig("smollm-smoke", vocab=256, d_model=64, n_layers=4,
                   attn=AttnConfig(64, 4, 2, 16, use_flash=kernels),
                   d_ff=128, tied_embeddings=True)
    return _lm(cfg)


def smoke_danube(kernels: bool = False):
    cfg = LMConfig("danube-smoke", vocab=256, d_model=64, n_layers=4,
                   attn=AttnConfig(64, 4, 2, 16, window=8, use_flash=kernels),
                   d_ff=128)
    return _lm(cfg)


def smoke_internlm2(kernels: bool = False):
    cfg = LMConfig("internlm2-smoke", vocab=256, d_model=64, n_layers=4,
                   attn=AttnConfig(64, 4, 2, 16, use_flash=kernels),
                   d_ff=128)
    return _lm(cfg)


def smoke_granite(kernels: bool = False):
    cfg = LMConfig("granite-smoke", vocab=256, d_model=64, n_layers=6,
                   attn=AttnConfig(64, 4, 1, 16, use_flash=kernels),   # MQA
                   d_ff=192)
    return _lm(cfg)


def smoke_internvl2(kernels: bool = False):
    cfg = LMConfig("internvl2-smoke", vocab=256, d_model=64, n_layers=3,
                   attn=AttnConfig(64, 4, 2, 16, use_flash=kernels),
                   d_ff=128, vision_prefix=8)
    return _lm(cfg, prefix=8)


def smoke_qwen3_moe(kernels: bool = False):
    cfg = LMConfig("qwen3-smoke", vocab=256, d_model=64, n_layers=3,
                   attn=AttnConfig(64, 4, 2, 16, qk_norm=True,
                                   use_flash=kernels),
                   moe=MoEConfig(64, 32, n_experts=8, top_k=2,
                                 capacity_factor=2.0),
                   moe_dispatch="scatter")
    return _lm(cfg)


def smoke_deepseek(kernels: bool = False):
    # MLA: q/k heads of 24, v heads of 16 -- the dense attention, as in JAX
    cfg = LMConfig("deepseek-smoke", vocab=256, d_model=64, n_layers=4,
                   mla=MLAConfig(64, 4, q_lora_rank=32, kv_lora_rank=16,
                                 qk_nope_dim=16, qk_rope_dim=8,
                                 v_head_dim=16),
                   d_ff=128,
                   moe=MoEConfig(64, 32, n_experts=4, top_k=2, n_shared=1,
                                 capacity_factor=2.0),
                   moe_dispatch="scatter", n_dense_layers=1, mtp=True)
    return _lm(cfg)


def _tokens(gen, device, vocab: int, shape) -> torch.Tensor:
    return torch.randint(0, vocab, shape, generator=gen, device=device,
                         dtype=torch.int32)


def smoke_whisper(kernels: bool = False):
    # head dim 8: flash on the SIMT route
    cfg = WhisperConfig("whisper-smoke", vocab=256, d_model=32,
                        n_enc_layers=2, n_dec_layers=2, n_heads=4, d_ff=64,
                        use_flash=kernels)

    def make_batch(gen: torch.Generator, device="cuda") -> dict:
        return {"frames": torch.randn((2, 12, 32), generator=gen,
                                      device=device),
                "tokens": _tokens(gen, device, 256, (2, 10))}
    return (lambda p, b: wh.whisper_loss(p, b, cfg),
            lambda gen, device="cuda": wh.init_whisper(gen, cfg, device),
            make_batch, cfg)


def smoke_xlstm(kernels: bool = False):
    # no attention: no kernel to switch on
    cfg = XLSTMConfig("xlstm-smoke", vocab=256, d_model=32, n_layers=4,
                      n_heads=2, slstm_every=3)

    def make_batch(gen: torch.Generator, device="cuda") -> dict:
        return {"tokens": _tokens(gen, device, 256, (2, 16))}
    return (lambda p, b: xm.xlstm_loss(p, b, cfg),
            lambda gen, device="cuda": xm.init_xlstm(gen, cfg, device),
            make_batch, cfg)


def smoke_zamba2(kernels: bool = False):
    # the shared attention (head dim 8) on flash, as the full config's;
    # every Mamba2 block runs the scan (no switch)
    cfg = Zamba2Config("zamba2-smoke", vocab=256, d_model=32, n_layers=6,
                       mamba=Mamba2Config(d_model=32, d_state=8, head_dim=8,
                                          chunk=4),
                       shared_attn=AttnConfig(32, 4, 4, 8, use_flash=kernels),
                       shared_d_ff=64,
                       shared_every=3, n_shared_blocks=2)

    def make_batch(gen: torch.Generator, device="cuda") -> dict:
        return {"tokens": _tokens(gen, device, 256, (2, 16))}
    return (lambda p, b: zm.zamba2_loss(p, b, cfg),
            lambda gen, device="cuda": zm.init_zamba2(gen, cfg, device),
            make_batch, cfg)


LM_FACTORIES = {          # the decoder-LM keys
    "smollm-360m": smoke_smollm,
    "h2o-danube-1.8b": smoke_danube,
    "internlm2-20b": smoke_internlm2,
    "granite-34b": smoke_granite,
    "internvl2-2b": smoke_internvl2,
    "qwen3-moe-30b-a3b": smoke_qwen3_moe,
    "deepseek-v3-671b": smoke_deepseek,
}

RECURRENT_FACTORIES = {  # the encoder-decoder, xLSTM and hybrid SSM keys
    "whisper-base": smoke_whisper,
    "xlstm-125m": smoke_xlstm,
    "zamba2-2.7b": smoke_zamba2,
}

SMOKE_FACTORIES = {       # the diffusion keys
    "uvit-h": smoke_uvit,
    "sdv2-unet": smoke_sdv2,
    "hunyuan-dit": smoke_hunyuan,
}
