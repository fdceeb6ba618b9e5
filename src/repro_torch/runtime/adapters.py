"""Model -> compile-path adapters (the port of ``repro.runtime.adapters``
for UViT): block-level callables for :func:`runtime.compile.auto_pipeline`
and the DDPM microbatch split.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import diffusion as diff_mod
from repro_torch.runtime.compile import PipelineModelFns

Pytree = Any


def make_diffusion_microbatches(batch: dict, M: int, cfg=None,
                                kind: str = "uvit", *,
                                t: torch.Tensor | None = None,
                                noise: torch.Tensor | None = None,
                                generator: torch.Generator | None = None
                                ) -> tuple[dict, dict]:
    """DDPM (t, noise) for a batch, split [B, ...] -> [M, B/M, ...].

    ``t`` (B,) and ``noise`` (like the latents) are taken as given, or
    drawn from ``generator`` (uniform t, standard normal noise) where
    missing.  Returns ``(mb, aux)``: ``mb`` holds ``xt``, ``noise`` and
    ``labels``; ``aux`` holds ``t`` (the time token is built in embed).
    """
    if kind != "uvit":
        raise NotImplementedError(f"{kind!r} microbatches are not yet ported")
    lat = batch["latents"]
    B = lat.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    if (t is None or noise is None) and generator is None:
        raise ValueError("pass t and noise, or a generator to draw them")
    if t is None:
        t = torch.rand((B,), generator=generator, device=lat.device)
    if noise is None:
        noise = torch.randn(lat.shape, generator=generator,
                            device=lat.device, dtype=lat.dtype)
    xt = diff_mod.noisy_latents(lat, t, noise)
    split = lambda x: x.reshape(M, B // M, *x.shape[1:])
    mb = {"xt": split(xt), "noise": split(noise),
          "labels": split(batch["labels"])}
    return mb, {"t": split(t)}


def diffusion_model_fns(cfg: Any, kind: str = "uvit") -> PipelineModelFns:
    """UViT as block-level compile-path callables.

    Pairs with :func:`repro_torch.models.diffusion.uvit_pipeline_graph`:
    every encoder block emits its output as a skip; the mirror decoder
    block consumes it (fully-paired graph -> mirror-symmetric folded
    partitions).
    """
    if kind != "uvit":
        raise NotImplementedError(f"{kind!r} model fns are not yet ported")

    def embed_fn(edge_p, mb, aux):
        return diff_mod.uvit_embed(edge_p, mb["xt"], aux["t"], mb, cfg)

    def enc_block_fn(bp, x, aux):
        y = diff_mod._apply_vit_block(bp, x, cfg)
        return y, y

    def dec_block_fn(bp, x, skip, aux):
        return diff_mod._apply_vit_block(bp, x, cfg, skip=skip)

    def loss_fn(edge_p, x, mb, aux):
        pred = diff_mod.uvit_output(edge_p, x, cfg)
        return torch.mean(torch.square(pred.float() - mb["noise"].float()))

    def split_blocks(params):
        edge = {k: v for k, v in params.items()
                if k not in ("enc_blocks", "dec_blocks")}
        return (params["enc_blocks"], params["dec_blocks"]), edge

    def merge_blocks(stacks, edge):
        return {**edge, "enc_blocks": stacks[0], "dec_blocks": stacks[1]}

    return PipelineModelFns(
        init_fn=lambda gen, device: diff_mod.init_uvit(gen, cfg, device),
        embed_fn=embed_fn, loss_fn=loss_fn,
        enc_block_fn=enc_block_fn, dec_block_fn=dec_block_fn,
        split_blocks=split_blocks, merge_blocks=merge_blocks)
