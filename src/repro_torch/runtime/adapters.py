"""Model -> compile-path adapters (the port of ``repro.runtime.adapters``
for UViT and Hunyuan-DiT): block-level callables for
:func:`runtime.compile.auto_pipeline` and the DDPM microbatch split.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import diffusion as diff_mod
from repro_torch.runtime.compile import PipelineModelFns

Pytree = Any
KINDS = ("uvit", "hunyuan")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"{kind!r} diffusion models are not yet "
                                  f"ported (ported: {KINDS})")


def make_diffusion_microbatches(batch: dict, M: int, cfg=None,
                                kind: str = "uvit", *,
                                t: torch.Tensor, noise: torch.Tensor,
                                params: Pytree | None = None
                                ) -> tuple[dict, dict]:
    """DDPM (t, noise) for a batch, split [B, ...] -> [M, B/M, ...].

    ``t`` (B,) and ``noise`` (like the latents) are the step's draws (the
    trainer's :func:`repro_torch.models.diffusion.ddpm_draw`).  Returns
    ``(mb, aux)``: ``mb`` holds ``xt`` and ``noise``
    (and UViT's ``labels``); ``aux`` holds ``t`` (UViT builds its time
    token in embed).

    For Hunyuan-DiT (``kind="hunyuan"``, with ``cfg`` and the edge
    ``params``) ``aux`` also carries the text tokens ``ctx`` and the adaLN
    conditioning ``temb`` to every stage.  ``temb`` is computed here from
    ``params["time_mlp"]`` under ``no_grad``: it enters the pipeline as
    data, as it does in the JAX package, whose compile-path loss gives
    ``time_mlp`` a zero gradient for the same reason.
    """
    _check_kind(kind)
    lat = batch["latents"]
    B = lat.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    if kind == "hunyuan" and (cfg is None or params is None):
        raise ValueError("hunyuan microbatches need cfg and the edge params "
                         "(time_mlp) to compute temb")
    xt = diff_mod.noisy_latents(lat, t, noise)
    split = lambda x: x.reshape(M, B // M, *x.shape[1:])
    mb = {"xt": split(xt), "noise": split(noise)}
    aux = {"t": split(t)}
    if kind == "uvit":
        mb["labels"] = split(batch["labels"])
    else:
        with torch.no_grad():
            temb = diff_mod.hunyuan_temb(params, t, cfg)
        aux["ctx"] = split(batch["text_embeds"].to(cfg.dtype))
        aux["temb"] = split(temb)
    return mb, aux


def diffusion_model_fns(cfg: Any, kind: str = "uvit") -> PipelineModelFns:
    """UViT / Hunyuan-DiT as block-level compile-path callables.

    Pairs with :func:`repro_torch.models.diffusion.uvit_pipeline_graph` /
    :func:`~repro_torch.models.diffusion.hunyuan_pipeline_graph`: every
    encoder block emits its output as a skip; the mirror decoder block
    consumes it (fully-paired graph -> mirror-symmetric folded
    partitions).  Hunyuan blocks read ``ctx`` and ``temb`` from ``aux``.
    """
    _check_kind(kind)
    if kind == "uvit":
        def embed_fn(edge_p, mb, aux):
            return diff_mod.uvit_embed(edge_p, mb["xt"], aux["t"], mb, cfg)

        output, init = diff_mod.uvit_output, diff_mod.init_uvit
        blk_kwargs = lambda aux: {}
    else:
        def embed_fn(edge_p, mb, aux):
            return diff_mod.hunyuan_embed(edge_p, mb["xt"], cfg)

        output, init = diff_mod.hunyuan_output, diff_mod.init_hunyuan
        blk_kwargs = lambda aux: {"ctx": aux["ctx"], "temb": aux["temb"]}

    def enc_block_fn(bp, x, aux):
        y = diff_mod._apply_vit_block(bp, x, cfg, **blk_kwargs(aux))
        return y, y

    def dec_block_fn(bp, x, skip, aux):
        return diff_mod._apply_vit_block(bp, x, cfg, skip=skip,
                                         **blk_kwargs(aux))

    def loss_fn(edge_p, x, mb, aux):
        pred = output(edge_p, x, cfg)
        return torch.mean(torch.square(pred.float() - mb["noise"].float()))

    def split_blocks(params):
        edge = {k: v for k, v in params.items()
                if k not in ("enc_blocks", "dec_blocks")}
        return (params["enc_blocks"], params["dec_blocks"]), edge

    def merge_blocks(stacks, edge):
        return {**edge, "enc_blocks": stacks[0], "dec_blocks": stacks[1]}

    return PipelineModelFns(
        init_fn=lambda gen, device: init(gen, cfg, device),
        embed_fn=embed_fn, loss_fn=loss_fn,
        enc_block_fn=enc_block_fn, dec_block_fn=dec_block_fn,
        split_blocks=split_blocks, merge_blocks=merge_blocks,
        num_param_stacks=2)
