"""UViT and Hunyuan-DiT diffusion backbones and the DDPM objective (the
port of ``repro.models.diffusion``; SkipViT and the SDv2 UNet are not
ported yet).

Same structure as the JAX module: ``enc_blocks`` and ``dec_blocks`` are
stacked ``[L/2, ...]`` parameter trees (the decoder's with an extra
``skip_proj``), decoder block j consumes the skip of encoder block
``L/2-1-j``, and :func:`uvit_pipeline_graph` / :func:`hunyuan_pipeline_graph`
export the runtime-aligned block graphs the PULSE planner partitions.
Hunyuan-DiT blocks add adaLN modulation from the time embedding ``temb``
and cross-attention over the text tokens ``ctx``.

``use_skip_kernel`` routes the decoder skip-in through the fused
skip-concat matmul kernel for every CUDA tensor (no TPU tiling gate: the
CUDA kernel masks ragged edges); ``use_flash`` routes self- and
cross-attention through the flash-attention kernel.  On CPU tensors both
take their plain versions.

Unlike the JAX ``ddpm_loss``, which draws ``t`` and the noise inside, the
port's loss takes them as tensors, so a test can feed both the same numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.graph import Block, BlockGraph, SkipEdge
from repro_torch.core.hw import Hardware, H100_SXM
from repro_torch.core.profiler import analytic_block_costs
from repro_torch.kernels.skip_matmul import skip_concat_matmul
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnConfig, Params
from repro_torch.tree import tree_index


# --------------------------------------------------------------------------
# DDPM objective
# --------------------------------------------------------------------------

def cosine_alpha_bar(t: torch.Tensor, s: float = 0.008) -> torch.Tensor:
    """t in [0,1] -> cumulative alpha (Nichol & Dhariwal cosine schedule)."""
    f = torch.cos((t + s) / (1 + s) * math.pi / 2) ** 2
    f0 = math.cos(s / (1 + s) * math.pi / 2) ** 2
    return torch.clamp(f / f0, 1e-5, 1.0)


def noisy_latents(x0: torch.Tensor, t: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """``x_t = sqrt(ab) x0 + sqrt(1 - ab) noise`` for (B,H,W,C) latents."""
    ab = cosine_alpha_bar(t)[:, None, None, None]
    return torch.sqrt(ab) * x0 + torch.sqrt(1 - ab) * noise


def ddpm_loss(apply_fn, params: Params, batch: dict, t: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """batch: {"latents": (B,H,W,C), ...conditioning...}; t: (B,) in [0, 1];
    noise: like the latents."""
    xt = noisy_latents(batch["latents"], t, noise)
    pred = apply_fn(params, xt, t, batch)
    return torch.mean(torch.square(pred.float() - noise.float()))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t in [0,1] -> (B, dim) sinusoidal features."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=t.device) / half)
    ang = t[:, None] * 1000.0 * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


# --------------------------------------------------------------------------
# UViT (paper [8]): ViT with symmetric long skips
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UViTConfig:
    name: str
    img_size: int = 32
    in_ch: int = 4
    patch: int = 2
    d_model: int = 512
    n_layers: int = 12            # even: L/2 enc + L/2 dec
    n_heads: int = 8
    d_ff: int = 2048
    n_classes: int = 1001         # class-conditional (UViT on ImageNet)
    norm_eps: float = 1e-6
    use_skip_kernel: bool = False  # fused skip-in kernel (see _skip_project)
    use_flash: bool = False        # flash-attention kernel in every block
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def n_tokens(self) -> int:
        return (self.img_size // self.patch) ** 2 + 2  # + time + class tokens

    @property
    def half(self) -> int:
        return self.n_layers // 2

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_heads,
                          self.d_model // self.n_heads, rope_theta=0.0,
                          causal=False, use_flash=self.use_flash)

    def param_count(self) -> int:
        d = self.d_model
        per = 4 * d * d + 2 * d * self.d_ff
        skip = d * 2 * d
        return (self.n_layers * per + self.half * skip
                + self.n_classes * d + self.patch ** 2 * self.in_ch * d * 2)


def _init_vit_block(gen: torch.Generator, cfg, d_ff: int, with_skip: bool,
                    device="cuda", stack=(), cross_dim: int = 0,
                    ada: bool = False) -> Params:
    d, pd = cfg.d_model, cfg.param_dtype
    ones = lambda: torch.ones((*stack, d), dtype=pd, device=device)
    p: Params = {
        "ln1": ones(),
        "attn": L.init_attention(gen, cfg.attn_cfg(), pd, device, stack),
        "ln2": ones(),
        "mlp": L.init_gelu_mlp(gen, d, d_ff, pd, device, stack),
    }
    if with_skip:
        p["skip_proj"] = L.dense_init(gen, 2 * d, d, pd, device, stack)
    if cross_dim:
        p["lnx"] = ones()
        p["xattn"] = L.init_attention(gen, cfg.attn_cfg(), pd, device, stack)
        p["ctx_kv"] = L.dense_init(gen, cross_dim, 2 * d, pd, device, stack)
    if ada:
        p["ada"] = L.normal(gen, (*stack, d, 6 * d), 0.02 / math.sqrt(d), pd,
                            device)
    return p


def _skip_project(p: Params, x: torch.Tensor, skip: torch.Tensor,
                  cfg) -> torch.Tensor:
    """Decoder skip-in projection: ``y = [x | skip] @ skip_proj``.

    With ``cfg.use_skip_kernel`` the fused kernel (``x @ W1 + skip @ W2``,
    fp32 accumulation) replaces the concat matmul, so the ``(.., 2D)``
    concat never reaches device memory.  It takes every shape: the CUDA
    kernel masks ragged edges, so there is no tiling gate.
    """
    w = p["skip_proj"].to(x.dtype)
    if cfg.use_skip_kernel:
        return skip_concat_matmul(x, skip.to(x.dtype), w)
    return torch.cat([x, skip], dim=-1) @ w


def _apply_vit_block(p: Params, x: torch.Tensor, cfg, *,
                     skip: torch.Tensor | None = None,
                     ctx: torch.Tensor | None = None,
                     temb: torch.Tensor | None = None) -> torch.Tensor:
    """One ViT block.  With ``temb`` (and ``ada`` params: Hunyuan-DiT),
    ``silu(temb) @ ada`` splits six ways into adaLN shift/scale/gate for
    the attention and MLP halves; with ``ctx`` (and ``xattn``) an ungated
    cross-attention over the text tokens sits between them."""
    if skip is not None:
        x = _skip_project(p, x, skip, cfg)
    ada = temb is not None and "ada" in p
    if ada:
        mods = (F.silu(temb) @ p["ada"].to(temb.dtype))[:, None]
        s1, b1, g1, s2, b2, g2 = torch.chunk(mods, 6, dim=-1)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if ada:
        h = h * (1 + s1) + b1
    a, _ = L.apply_attention(p["attn"], h, cfg.attn_cfg())
    x = x + (g1 * a if ada else a)
    if ctx is not None and "xattn" in p:
        h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
        kv = ctx @ p["ctx_kv"].to(ctx.dtype)
        d = cfg.d_model
        B, T = ctx.shape[0], ctx.shape[1]
        hd = cfg.attn_cfg().head_dim
        kx = kv[..., :d].reshape(B, T, cfg.n_heads, hd)
        vx = kv[..., d:].reshape(B, T, cfg.n_heads, hd)
        a, _ = L.apply_attention(p["xattn"], h, cfg.attn_cfg(),
                                 cross_kv=(kx, vx))
        x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if ada:
        h = h * (1 + s2) + b2
    m = L.apply_gelu_mlp(p["mlp"], h)
    return x + (g2 * m if ada else m)


def init_uvit(gen: torch.Generator, cfg: UViTConfig,
              device="cuda") -> Params:
    d, pd = cfg.d_model, cfg.param_dtype
    pp = cfg.patch ** 2 * cfg.in_ch
    return {
        "patch_embed": L.dense_init(gen, pp, d, pd, device),
        "pos_embed": L.normal(gen, (cfg.n_tokens, d), 0.02, pd, device),
        "time_mlp": L.init_gelu_mlp(gen, d, 4 * d, pd, device),
        "class_embed": L.dense_init(gen, cfg.n_classes, d, pd, device),
        "enc_blocks": _init_vit_block(gen, cfg, cfg.d_ff, False, device,
                                      (cfg.half,)),
        "dec_blocks": _init_vit_block(gen, cfg, cfg.d_ff, True, device,
                                      (cfg.half,)),
        "out_norm": torch.ones((d,), dtype=pd, device=device),
        "out_proj": L.dense_init(gen, d, pp, pd, device),
    }


def _patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // patch, patch, W // patch, patch, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        B, (H // patch) * (W // patch), patch * patch * C)


def _unpatchify(x: torch.Tensor, patch: int, img: int, ch: int) -> torch.Tensor:
    B = x.shape[0]
    g = img // patch
    x = x.reshape(B, g, g, patch, patch, ch)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, img, img, ch)


def uvit_embed(params: Params, xt: torch.Tensor, t: torch.Tensor,
               batch: dict, cfg: UViTConfig) -> torch.Tensor:
    dt = cfg.dtype
    tok = _patchify(xt.to(dt), cfg.patch) @ params["patch_embed"].to(dt)
    temb = L.apply_gelu_mlp(params["time_mlp"],
                            timestep_embedding(t, cfg.d_model).to(dt))
    cemb = params["class_embed"][batch["labels"].long()].to(dt)
    x = torch.cat([temb[:, None], cemb[:, None], tok], dim=1)
    return x + params["pos_embed"].to(dt)[None]


def uvit_output(params: Params, x: torch.Tensor,
                cfg: UViTConfig) -> torch.Tensor:
    x = L.rms_norm(x, params["out_norm"], cfg.norm_eps)
    pix = x[:, 2:] @ params["out_proj"].to(x.dtype)
    return _unpatchify(pix, cfg.patch, cfg.img_size, cfg.in_ch)


def uvit_apply(params: Params, xt: torch.Tensor, t: torch.Tensor,
               batch: dict, cfg: UViTConfig) -> torch.Tensor:
    """Reference (non-pipelined) forward; the wave executor replicates this
    computation distributed over stages and is tested for agreement."""
    x = uvit_embed(params, xt, t, batch, cfg)
    skips = []
    for i in range(cfg.half):
        x = _apply_vit_block(tree_index(params["enc_blocks"], i), x, cfg)
        skips.append(x)
    # decoder block j consumes the skip of encoder block half-1-j
    for j in range(cfg.half):
        x = _apply_vit_block(tree_index(params["dec_blocks"], j), x, cfg,
                             skip=skips[cfg.half - 1 - j])
    return uvit_output(params, x, cfg)


def uvit_loss(params: Params, batch: dict, t: torch.Tensor,
              noise: torch.Tensor, cfg: UViTConfig) -> torch.Tensor:
    return ddpm_loss(lambda p, xt, tt, b: uvit_apply(p, xt, tt, b, cfg),
                     params, batch, t, noise)


# --------------------------------------------------------------------------
# Hunyuan-DiT (paper [7]): DiT with adaLN + text cross-attention + skips
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HunyuanDiTConfig:
    name: str
    img_size: int = 64
    in_ch: int = 4
    patch: int = 2
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    ctx_dim: int = 1024           # CLIP+T5 text embedding dim (stub input)
    ctx_len: int = 77
    norm_eps: float = 1e-6
    use_skip_kernel: bool = False  # fused skip-in kernel (see _skip_project)
    use_flash: bool = False        # flash attention, self and cross
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def n_tokens(self) -> int:
        return (self.img_size // self.patch) ** 2

    @property
    def half(self) -> int:
        return self.n_layers // 2

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_heads,
                          self.d_model // self.n_heads, rope_theta=0.0,
                          causal=False, use_flash=self.use_flash)

    def param_count(self) -> int:
        d = self.d_model
        per = 4 * d * d + 2 * d * self.d_ff + 4 * d * d + 6 * d * d \
            + self.ctx_dim * 2 * d
        return self.n_layers * per + self.half * 2 * d * d


def init_hunyuan(gen: torch.Generator, cfg: HunyuanDiTConfig,
                 device="cuda") -> Params:
    d, pd = cfg.d_model, cfg.param_dtype
    pp = cfg.patch ** 2 * cfg.in_ch
    blocks = lambda skip: _init_vit_block(gen, cfg, cfg.d_ff, skip, device,
                                          (cfg.half,), cross_dim=cfg.ctx_dim,
                                          ada=True)
    return {
        "patch_embed": L.dense_init(gen, pp, d, pd, device),
        "pos_embed": L.normal(gen, (cfg.n_tokens, d), 0.02, pd, device),
        "time_mlp": L.init_gelu_mlp(gen, d, 4 * d, pd, device),
        "enc_blocks": blocks(False),
        "dec_blocks": blocks(True),
        "out_norm": torch.ones((d,), dtype=pd, device=device),
        "out_proj": L.dense_init(gen, d, pp, pd, device),
    }


def hunyuan_embed(params: Params, xt: torch.Tensor,
                  cfg: HunyuanDiTConfig) -> torch.Tensor:
    """Patch tokens plus positions (no time or class token: the time
    enters every block through adaLN)."""
    dt = cfg.dtype
    tok = _patchify(xt.to(dt), cfg.patch) @ params["patch_embed"].to(dt)
    return tok + params["pos_embed"].to(dt)[None]


def hunyuan_temb(params: Params, t: torch.Tensor,
                 cfg: HunyuanDiTConfig) -> torch.Tensor:
    """The adaLN conditioning every block reads: ``time_mlp`` of the
    sinusoidal features of t, (B, d)."""
    return L.apply_gelu_mlp(params["time_mlp"],
                            timestep_embedding(t, cfg.d_model).to(cfg.dtype))


def hunyuan_output(params: Params, x: torch.Tensor,
                   cfg: HunyuanDiTConfig) -> torch.Tensor:
    x = L.rms_norm(x, params["out_norm"], cfg.norm_eps)
    pix = x @ params["out_proj"].to(x.dtype)
    return _unpatchify(pix, cfg.patch, cfg.img_size, cfg.in_ch)


def hunyuan_apply(params: Params, xt: torch.Tensor, t: torch.Tensor,
                  batch: dict, cfg: HunyuanDiTConfig) -> torch.Tensor:
    """Reference (non-pipelined) forward; batch: {"text_embeds": (B,T,c)}."""
    x = hunyuan_embed(params, xt, cfg)
    kw = {"ctx": batch["text_embeds"].to(cfg.dtype),
          "temb": hunyuan_temb(params, t, cfg)}
    skips = []
    for i in range(cfg.half):
        x = _apply_vit_block(tree_index(params["enc_blocks"], i), x, cfg,
                             **kw)
        skips.append(x)
    for j in range(cfg.half):
        x = _apply_vit_block(tree_index(params["dec_blocks"], j), x, cfg,
                             skip=skips[cfg.half - 1 - j], **kw)
    return hunyuan_output(params, x, cfg)


def hunyuan_loss(params: Params, batch: dict, t: torch.Tensor,
                 noise: torch.Tensor, cfg: HunyuanDiTConfig) -> torch.Tensor:
    return ddpm_loss(lambda p, xt, tt, b: hunyuan_apply(p, xt, tt, b, cfg),
                     params, batch, t, noise)


# --------------------------------------------------------------------------
# Block graphs for the compile path
# --------------------------------------------------------------------------

def uvit_pipeline_graph(cfg: UViTConfig, batch: int = 1,
                        fwd_times=None, hw: Hardware = H100_SXM) -> BlockGraph:
    """Runtime-aligned UViT graph for the auto-pipeline compile path.

    Exactly one block per enc/dec transformer block — matching
    ``params["enc_blocks"]`` / ``params["dec_blocks"]`` rows — with the
    fully-paired skip edges (enc i -> dec mirror) the partitioner
    collocates.  ``fwd_times`` (length 2*half) injects profiled per-block
    times.
    """
    d, n, ff = cfg.d_model, cfg.n_tokens, cfg.d_ff
    act = batch * n * d * 2
    attn_fl = 2 * batch * (4 * n * d * d + 2 * n * n * d)
    mlp_fl = 2 * batch * (2 * n * d * ff)
    per_param = (4 * d * d + 2 * d * ff) * 2
    blocks = []
    for i in range(cfg.half):
        blocks.append(Block(f"enc{i}", 0.0, per_param, act, act,
                            attn_fl + mlp_fl))
    for i in range(cfg.half):
        blocks.append(Block(f"dec{i}", 0.0, per_param + 2 * d * d * 2, act, 0,
                            attn_fl + mlp_fl + 2 * batch * n * 2 * d * d))
    return _runtime_graph(blocks,
                          _paired_skips(2 * cfg.half, cfg.half, act),
                          fwd_times, hw)


def hunyuan_pipeline_graph(cfg: HunyuanDiTConfig, batch: int = 1,
                           fwd_times=None,
                           hw: Hardware = H100_SXM) -> BlockGraph:
    """Runtime-aligned Hunyuan-DiT graph for the auto-pipeline compile path.

    Like :func:`uvit_pipeline_graph`: exactly one block per
    ``enc_blocks``/``dec_blocks`` row (embed/out live in edge params), with
    the fully-paired skip edges enc i -> dec mirror.  ``fwd_times``
    (length 2*half) injects profiled per-block times.
    """
    d, n, ff, lt = cfg.d_model, cfg.n_tokens, cfg.d_ff, cfg.ctx_len
    act = batch * n * d * 2
    blk_fl = 2 * batch * (4 * n * d * d + 2 * n * n * d + 2 * n * d * ff
                          + 2 * n * d * d + cfg.ctx_dim * 2 * d * lt
                          + 2 * n * lt * d)
    per_param = (4 * d * d + 2 * d * ff + 2 * d * d + cfg.ctx_dim * 2 * d
                 + 6 * d * d) * 2
    blocks = []
    for i in range(cfg.half):
        blocks.append(Block(f"enc{i}", 0.0, per_param, act, act, blk_fl))
    for i in range(cfg.half):
        blocks.append(Block(f"dec{i}", 0.0, per_param + 2 * d * d * 2, act,
                            0, blk_fl + 2 * batch * n * 2 * d * d))
    return _runtime_graph(blocks,
                          _paired_skips(2 * cfg.half, cfg.half, act),
                          fwd_times, hw)


def _runtime_graph(blocks, skip_edges, fwd_times, hw) -> BlockGraph:
    """Analytic block costs, optional profiled fwd-time injection, skip-edge
    attachment."""
    blocks = list(analytic_block_costs(tuple(blocks), hw))
    if fwd_times is not None:
        if len(fwd_times) != len(blocks):
            raise ValueError("fwd_times must have one entry per block")
        blocks = [dataclasses.replace(b, fwd_time=float(t))
                  for b, t in zip(blocks, fwd_times)]
    return BlockGraph(tuple(blocks), tuple(skip_edges))


def _paired_skips(n_total: int, n_pairs: int, act: int
                  ) -> tuple[SkipEdge, ...]:
    """Fully-paired UNet edges: block i -> its mirror ``n_total-1-i``."""
    return tuple(SkipEdge(i, n_total - 1 - i, act) for i in range(n_pairs))
