"""Model -> pipeline adapters (the port of ``repro.runtime.adapters`` for
UViT, Hunyuan-DiT, SkipViT and the decoder LMs):
:class:`DiffusionPipelineAdapter`, which regroups a model's block stacks
into even per-device stage stacks for the closed-form wave executor and
for the paper's skip-carry baseline; :class:`LMPipelineAdapter`, the same
for the decoder LMs over the closed-form linear and folded executors (the
executors of the registry's ``pp_1f1b`` and ``pp_wave`` plans); block-level
callables for
:func:`runtime.compile.auto_pipeline` (:func:`lm_model_fns` for the LMs,
whose skip-free graph plans linear, or folded under ``force_wave``); and
the DDPM and token microbatch splits.  SkipViT's microbatches are UViT's
(class labels and a time token), as in the JAX trainer; :func:`model_fns`
picks the callables of a model kind.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import diffusion as diff_mod
from repro_torch.models import lm as lm_mod
from repro_torch.runtime.compile import PipelineModelFns
from repro_torch.runtime.pipeline import (PipelineConfig, check_one_replica,
                                          make_linear_pipeline,
                                          make_skip_carry_pipeline,
                                          make_wave_pipeline)
from repro_torch.tree import tree_map

Pytree = Any
KINDS = ("uvit", "hunyuan")
DIFFUSION_KINDS = (*KINDS, "skipvit")
MODEL_KINDS = (*DIFFUSION_KINDS, "lm")


def _check_kind(kind: str, kinds: tuple = KINDS) -> None:
    if kind not in kinds:
        raise NotImplementedError(f"{kind!r} models are not yet ported "
                                  f"here (ported: {kinds})")


def _regroup(stack: Pytree, D: int, reverse: bool = False) -> Pytree:
    """[L, ...] stacked params -> [D, L/D, ...]; optionally flip device order
    (decoder stacks execute in reverse device order under the fold)."""

    def f(x):
        L = x.shape[0]
        assert L % D == 0, f"layer count {L} not divisible by {D} stages"
        y = x.reshape(D, L // D, *x.shape[1:])
        return y.flip(0) if reverse else y

    return tree_map(f, stack)


def _ungroup(stack: Pytree, reverse: bool = False) -> Pytree:
    def f(x):
        y = x.flip(0) if reverse else x
        return y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])
    return tree_map(f, stack)


# ===========================================================================
# LM family
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class LMPipelineAdapter:
    """Linear (1F1B) or folded-wave pipeline for the decoder LMs, over the
    closed-form executors: ``wave=False`` regroups ``params["layers"]``
    evenly into D stages (``make_linear_pipeline``), ``wave=True`` folds
    them symmetrically, S = 2D (``make_wave_pipeline``): device d runs
    layer group d of the first half and, in reverse order, group 2D-1-d of
    the second, so the embedding and the (tied) readout share device 0.

    Every other param is an edge param.  As in JAX the loss is
    ``softmax_xent`` alone (no MoE aux, no MTP term) and deepseek's dense
    prelude does not run; each stage call is recomputed in the backward
    when ``pcfg.remat`` (the layers themselves are not, as in JAX's scan).
    Microbatches: ``{"tokens": (M, b, S)}``.
    """

    cfg: lm_mod.LMConfig
    pcfg: PipelineConfig
    wave: bool = False       # True: fold layers symmetrically (S = 2D)

    def init_pipeline_params(self, gen: torch.Generator,
                             device="cuda") -> tuple:
        return self.split_params(lm_mod.init_lm(gen, self.cfg, device))

    def split_params(self, params: Pytree) -> tuple:
        """-> ``(stacks, edge)``: ``([D, L/D, ...],)`` or, folded, the
        first half's and the second half's ``[D, L/2D, ...]`` stacks."""
        D = self.pcfg.num_devices
        layers = params["layers"]
        edge = {k: v for k, v in params.items() if k != "layers"}
        if not self.wave:
            return (_regroup(layers, D),), edge
        half = tree_map(lambda x: x[: x.shape[0] // 2], layers)
        rest = tree_map(lambda x: x[x.shape[0] // 2:], layers)
        return (_regroup(half, D), _regroup(rest, D, reverse=True)), edge

    def merge_params(self, stacks: tuple, edge: Pytree) -> Pytree:
        if not self.wave:
            layers = _ungroup(stacks[0])
        else:
            enc = _ungroup(stacks[0])
            dec = _ungroup(stacks[1], reverse=True)
            layers = tree_map(lambda a, b: torch.cat([a, b], 0), enc, dec)
        return {**edge, "layers": layers}

    # ---- callbacks ----
    def embed_fn(self, edge_p, mb, aux=None):
        return lm_mod.embed_tokens(edge_p, mb["tokens"], self.cfg)

    def _run_layers(self, rows, x):
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for lp in rows:
            x, _, _ = lm_mod.apply_layer(lp, x, self.cfg, dense_ffn=False,
                                         positions=positions)
        return x

    def stage_fn(self, rows, x, d=None):
        return self._run_layers(rows, x)

    def enc_stage_fn(self, rows, x, aux, d=None):
        return self._run_layers(rows, x), {}

    def dec_stage_fn(self, rows, x, skips, aux, d=None):
        return self._run_layers(rows, x)

    def loss_fn(self, edge_p, x, mb, aux=None):
        logits = lm_mod.unembed(edge_p, x[:, :-1], self.cfg)
        return lm_mod.softmax_xent(logits, mb["tokens"][:, 1:])

    # ---- builders ----
    def build(self, ring=None, data=None) -> Callable:
        """``fn(stack, edge, mbs)`` (linear) or ``fn(enc, dec, edge, mbs)``
        (folded) -> the mean loss over the M microbatches.  With ``ring``
        (``runtime.ring.Ring``) rank ``ring.index``'s closed-form executor
        over its ``[1, rows, ...]`` stacks, and with ``pcfg.dp_size > 1``
        its ``data`` group: the loss reduced over both, every leaf's
        ``.grad`` filled (``runtime.pipeline``)."""
        if ring is None:
            check_one_replica(self.pcfg)
        if self.wave:
            wave = make_wave_pipeline(
                self.pcfg,
                embed_fn=lambda e, mb, aux: self.embed_fn(e, mb),
                enc_stage_fn=self.enc_stage_fn,
                dec_stage_fn=self.dec_stage_fn,
                loss_fn=lambda e, x, mb, aux: self.loss_fn(e, x, mb),
                ring=ring, data=data)
            # LM graphs have no skip tensors: aux rides along empty
            return lambda enc, dec, edge, mbs: wave(enc, dec, edge, mbs, {})
        return make_linear_pipeline(
            self.pcfg, embed_fn=self.embed_fn, stage_fn=self.stage_fn,
            loss_fn=self.loss_fn, ring=ring, data=data)


# ===========================================================================
# UViT / Hunyuan-DiT (wave with real skip tensors)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class DiffusionPipelineAdapter:
    """Closed-form folded wave pipeline (and the skip-carry baseline) for
    UViT / Hunyuan-DiT.

    Microbatch inputs (all stacked [M, b, ...]):
      mb:  {"xt", "noise", plus model conditioning ("labels" | nothing)}
      aux: {"t"} for UViT (time token built in embed); Hunyuan additionally
           carries {"temb", "ctx"} to every stage.

    ``pcfg=None`` gives the callbacks only (:func:`diffusion_model_fns`
    borrows embed / loss / ``_blk_kwargs``); ``build`` and the splits need
    a real :class:`PipelineConfig`.  Decoder blocks go through
    ``diffusion._skip_project``, so the card's path launches the skip
    matmul kernel, and every block's attention flash attention when the
    config turns them on.
    """

    cfg: Any                     # UViTConfig | HunyuanDiTConfig
    pcfg: PipelineConfig | None
    kind: str = "uvit"           # "uvit" | "hunyuan"

    def __post_init__(self):
        _check_kind(self.kind)

    def init_pipeline_params(self, gen: torch.Generator,
                             device="cuda") -> tuple:
        init = (diff_mod.init_uvit if self.kind == "uvit"
                else diff_mod.init_hunyuan)
        return self.split_params(init(gen, self.cfg, device))

    def split_params(self, params: Pytree) -> tuple:
        """Even ``[D, L/D, ...]`` stage stacks: encoder stage d on device
        d, decoder stage 2D-1-d beside it."""
        D = self.pcfg.num_devices
        enc = _regroup(params["enc_blocks"], D)
        dec = _regroup(params["dec_blocks"], D, reverse=True)
        edge = {k: v for k, v in params.items()
                if k not in ("enc_blocks", "dec_blocks")}
        return (enc, dec), edge

    def merge_params(self, stacks: tuple, edge: Pytree) -> Pytree:
        return {**edge,
                "enc_blocks": _ungroup(stacks[0]),
                "dec_blocks": _ungroup(stacks[1], reverse=True)}

    # ---- callbacks ----
    def embed_fn(self, edge_p, mb, aux):
        if self.kind == "uvit":
            return diff_mod.uvit_embed(edge_p, mb["xt"], aux["t"], mb,
                                       self.cfg)
        return diff_mod.hunyuan_embed(edge_p, mb["xt"], self.cfg)

    def _blk_kwargs(self, aux):
        if self.kind == "uvit":
            return {}
        return {"ctx": aux["ctx"], "temb": aux["temb"]}

    def enc_stage_fn(self, rows, x, aux, d=None):
        """A stage's encoder blocks in order; each block's output is its
        skip."""
        kw = self._blk_kwargs(aux)
        skips = []
        for bp in rows:
            x = diff_mod._apply_vit_block(bp, x, self.cfg, **kw)
            skips.append(x)
        return x, skips

    def dec_stage_fn(self, rows, x, skips, aux, d=None):
        """A stage's decoder blocks, consuming the collocated encoder
        stage's skips last-first."""
        kw = self._blk_kwargs(aux)
        for bp, skip in zip(rows, skips[::-1]):
            x = diff_mod._apply_vit_block(bp, x, self.cfg, skip=skip, **kw)
        return x

    def loss_fn(self, edge_p, x, mb, aux):
        output = (diff_mod.uvit_output if self.kind == "uvit"
                  else diff_mod.hunyuan_output)
        pred = output(edge_p, x, self.cfg)
        return torch.mean(torch.square(pred.float() - mb["noise"].float()))

    # ---- builders ----
    def build(self, ring=None, data=None) -> Callable:
        """The closed-form wave executor on :meth:`split_params`' stacks;
        with ``ring`` (and ``data``) a rank's, as
        :meth:`LMPipelineAdapter.build`'s."""
        return make_wave_pipeline(
            self.pcfg, embed_fn=self.embed_fn,
            enc_stage_fn=self.enc_stage_fn, dec_stage_fn=self.dec_stage_fn,
            loss_fn=self.loss_fn, ring=ring, data=data)

    def build_skip_carry_baseline(self, ring=None, data=None) -> Callable:
        """Paper-baseline executor: sequential partition + skip payload,
        on :meth:`split_params_skip_carry`' stacks; with ``ring``, rank
        ``ring.index``'s executor on its rows (``rank=`` there), and with
        ``pcfg.dp_size > 1`` that rank's data group ``data``
        (``runtime.ring.DataGroup``)."""
        D = self.pcfg.num_devices
        half = self.cfg.half
        assert half % (D // 2) == 0
        k = half // (D // 2)
        return make_skip_carry_pipeline(
            self.pcfg, n_skip_slots=half,
            embed_fn=self.embed_fn,
            enc_stage_fn=self.enc_stage_fn, dec_stage_fn=self.dec_stage_fn,
            loss_fn=self.loss_fn, skips_per_stage=k, ring=ring, data=data)

    def split_params_skip_carry(self, params: Pytree,
                                rank: int | None = None) -> tuple:
        """Sequential layout for the baseline: devices 0..D/2-1 hold enc
        stages, D/2..D-1 hold dec stages; stacks are padded to D rows.
        ``rank``: that device's rows alone (``[rows, ...]``, copies)."""
        D = self.pcfg.num_devices
        enc = _regroup(params["enc_blocks"], D // 2)
        dec = _regroup(params["dec_blocks"], D // 2)
        edge = {k: v for k, v in params.items()
                if k not in ("enc_blocks", "dec_blocks")}
        if rank is not None:
            def own(x, lo):
                i = rank - lo
                return (x[i].clone() if 0 <= i < D // 2
                        else torch.zeros_like(x[0]))
            return (tree_map(lambda x: own(x, 0), enc),
                    tree_map(lambda x: own(x, D // 2), dec)), edge
        enc_padded = tree_map(
            lambda x: torch.cat([x, torch.zeros_like(x)], 0), enc)
        dec_padded = tree_map(
            lambda x: torch.cat([torch.zeros_like(x), x], 0), dec)
        return (enc_padded, dec_padded), edge


def make_diffusion_microbatches(batch: dict, M: int, cfg=None,
                                kind: str = "uvit", *,
                                t: torch.Tensor, noise: torch.Tensor,
                                params: Pytree | None = None,
                                temb_grad: bool = False
                                ) -> tuple[dict, dict]:
    """DDPM (t, noise) for a batch, split [B, ...] -> [M, B/M, ...].

    ``t`` (B,) and ``noise`` (like the latents) are the step's draws (the
    trainer's :func:`repro_torch.models.diffusion.ddpm_draw`).  Returns
    ``(mb, aux)``: ``mb`` holds ``xt`` and ``noise``
    (and UViT's ``labels``); ``aux`` holds ``t`` (UViT builds its time
    token in embed).  ``kind="skipvit"`` splits as ``"uvit"``.

    For Hunyuan-DiT (``kind="hunyuan"``, with ``cfg`` and the edge
    ``params``) ``aux`` also carries the text tokens ``ctx`` and the adaLN
    conditioning ``temb`` to every stage.  ``temb`` is computed here from
    ``params["time_mlp"]`` under ``no_grad``: it enters the pipeline as
    data, as it does in the JAX package, whose compile-path loss gives
    ``time_mlp`` a zero gradient for the same reason.  ``temb_grad=True``
    keeps its graph instead, so ``time_mlp`` gets the gradient the stages
    send back through it, as under the JAX ``build_pp_train_step``, which
    draws the microbatches inside its differentiated loss.
    """
    _check_kind(kind, DIFFUSION_KINDS)
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
    if kind != "hunyuan":
        mb["labels"] = split(batch["labels"])
    else:
        with torch.set_grad_enabled(temb_grad and torch.is_grad_enabled()):
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
    ad = DiffusionPipelineAdapter(cfg, None, kind)   # callbacks only
    init = diff_mod.init_uvit if kind == "uvit" else diff_mod.init_hunyuan

    def enc_block_fn(bp, x, aux):
        y = diff_mod._apply_vit_block(bp, x, cfg, **ad._blk_kwargs(aux))
        return y, y

    def dec_block_fn(bp, x, skip, aux):
        return diff_mod._apply_vit_block(bp, x, cfg, skip=skip,
                                         **ad._blk_kwargs(aux))

    def split_blocks(params):
        edge = {k: v for k, v in params.items()
                if k not in ("enc_blocks", "dec_blocks")}
        return (params["enc_blocks"], params["dec_blocks"]), edge

    def merge_blocks(stacks, edge):
        return {**edge, "enc_blocks": stacks[0], "dec_blocks": stacks[1]}

    return PipelineModelFns(
        init_fn=lambda gen, device: init(gen, cfg, device),
        embed_fn=ad.embed_fn, loss_fn=ad.loss_fn,
        enc_block_fn=enc_block_fn, dec_block_fn=dec_block_fn,
        split_blocks=split_blocks, merge_blocks=merge_blocks,
        num_param_stacks=2)


def skipvit_model_fns(cfg: Any) -> PipelineModelFns:
    """SkipViT (homogeneous stack, arbitrary skip topology) as compile-path
    callables.

    Pairs with :func:`repro_torch.models.diffusion.skipvit_pipeline_graph`.
    One parameter stack covers emitters, bottleneck blocks and consumers:
    every encoder-half block emits its output to the stash, every
    decoder-half block consumes additively (``x + skip @ skip_in``) -- rows
    the layout's skip pairing marks skip-less receive zeros and reduce to
    plain blocks.  This is the model family whose partitions exercise
    asymmetric folds (the fold's turnaround cut may land anywhere,
    including inside the bottleneck run).
    """
    def embed_fn(edge_p, mb, aux):
        return diff_mod.uvit_embed(edge_p, mb["xt"], aux["t"], mb, cfg)

    def enc_block_fn(bp, x, aux):
        y = diff_mod._apply_vit_block(bp, x, cfg)
        return y, y

    def dec_block_fn(bp, x, skip, aux):
        x = x + skip @ bp["skip_in"].to(x.dtype)
        return diff_mod._apply_vit_block(bp, x, cfg)

    def loss_fn(edge_p, x, mb, aux):
        pred = diff_mod.uvit_output(edge_p, x, cfg)
        return torch.mean(torch.square(pred.float() - mb["noise"].float()))

    def split_blocks(params):
        edge = {k: v for k, v in params.items() if k != "blocks"}
        return (params["blocks"],), edge

    def merge_blocks(stacks, edge):
        return {**edge, "blocks": stacks[0]}

    return PipelineModelFns(
        init_fn=lambda gen, device: diff_mod.init_skipvit(gen, cfg, device),
        embed_fn=embed_fn, loss_fn=loss_fn,
        enc_block_fn=enc_block_fn, dec_block_fn=dec_block_fn,
        split_blocks=split_blocks, merge_blocks=merge_blocks,
        num_param_stacks=1)


def lm_model_fns(cfg: lm_mod.LMConfig) -> PipelineModelFns:
    """The decoder-LM family as block-level compile-path callables.

    Pairs with :func:`repro_torch.models.lm.lm_pipeline_graph` (skip-free:
    ``auto_pipeline`` lowers a linear S=D pipeline, or a folded S=2D wave
    under ``force_wave``, whose first and last stages share device 0 with
    the embedding and the (tied) readout).  Only ``params["layers"]`` is
    pipelined; the rest (deepseek's ``dense_layers`` and ``mtp`` among
    them) are edge params.  As in JAX, the pipeline's loss is the next-token
    cross-entropy alone: no MoE aux and no MTP term, and the dense prelude
    does not run.  Microbatches: :func:`make_lm_microbatches`.
    """
    def embed_fn(edge_p, mb, aux):
        return lm_mod.embed_tokens(edge_p, mb["tokens"], cfg)

    def block_fn(lp, x, aux):
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, _, _ = lm_mod.apply_layer(lp, x, cfg, dense_ffn=False,
                                     positions=positions)
        return x

    def loss_fn(edge_p, x, mb, aux):
        logits = lm_mod.unembed(edge_p, x[:, :-1], cfg)
        return lm_mod.softmax_xent(logits, mb["tokens"][:, 1:])

    def split_blocks(params):
        edge = {k: v for k, v in params.items() if k != "layers"}
        return (params["layers"],), edge

    def merge_blocks(stacks, edge):
        return {**edge, "layers": stacks[0]}

    return PipelineModelFns(
        init_fn=lambda gen, device: lm_mod.init_lm(gen, cfg, device),
        embed_fn=embed_fn, loss_fn=loss_fn, block_fn=block_fn,
        split_blocks=split_blocks, merge_blocks=merge_blocks,
        num_param_stacks=1)


def make_lm_microbatches(batch: dict, M: int) -> dict:
    """``{"tokens": (B, S)}`` -> ``{"tokens": (M, B/M, S)}``, the linear
    executor's ``mbs`` (the folded one takes ``aux={}`` beside it)."""
    tok = batch["tokens"]
    B = tok.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    return {"tokens": tok.reshape(M, B // M, *tok.shape[1:])}


def model_fns(cfg: Any, kind: str) -> PipelineModelFns:
    """The compile-path callables of a model ``kind`` (``"uvit"``,
    ``"hunyuan"``, ``"skipvit"`` or ``"lm"``)."""
    _check_kind(kind, MODEL_KINDS)
    if kind == "lm":
        return lm_model_fns(cfg)
    return (skipvit_model_fns(cfg) if kind == "skipvit"
            else diffusion_model_fns(cfg, kind))
