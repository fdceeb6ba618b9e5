"""UViT, Hunyuan-DiT, SkipViT and the SDv2 UNet diffusion backbones and
the DDPM objective (the port of ``repro.models.diffusion``).

Same structure as the JAX module: ``enc_blocks`` and ``dec_blocks`` are
stacked ``[L/2, ...]`` parameter trees (the decoder's with an extra
``skip_proj``), decoder block j consumes the skip of encoder block
``L/2-1-j``, and :func:`uvit_pipeline_graph` / :func:`hunyuan_pipeline_graph`
export the runtime-aligned block graphs the PULSE planner partitions.
Hunyuan-DiT blocks add adaLN modulation from the time embedding ``temb``
and cross-attention over the text tokens ``ctx``.

SkipViT is one homogeneous ``blocks`` stack with an arbitrary (possibly
sparse, mid-block) skip topology; every block carries ``skip_in`` and
consumes additively (``x + skip @ skip_in``), so it never reaches the
skip-concat kernel, in JAX or here.  Unlike the JAX config, the port's
``SkipViTConfig`` has ``use_flash`` (every block's attention through the
flash kernel), and :func:`skipvit_pipeline_graph` defaults to
``H100_SXM`` where the JAX one defaults to its TPU preset.

The UNet keeps the JAX package's leaf layouts: NHWC activations and HWIO
conv weights (``conv2d`` permutes to PyTorch's NCHW/OIHW views inside),
nested ``down``/``up`` lists of dicts whose keys differ per entry, and
fp32 norm leaves (``gn*``/``gb*``, ``lnx``, ``ln2``) beside
``param_dtype`` ones, so a JAX params tree or checkpoint carries over with
no transposes.

``use_skip_kernel`` routes the decoder skip-in through the fused
skip-concat matmul kernel for every CUDA tensor (no TPU tiling gate: the
CUDA kernel masks ragged edges); ``use_flash`` routes self- and
cross-attention through the flash-attention kernel (the UNet's attention
blocks too).  On CPU tensors both take their plain versions.

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


def ddpm_draw(latents: torch.Tensor, step: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training step ``step``'s DDPM draws for a batch of latents: a uniform
    t (B,) and standard normal noise like the latents, from a generator on
    their device seeded with the step (so a resumed run draws what an
    uninterrupted one drew)."""
    dev = latents.device
    gen = torch.Generator(device=dev).manual_seed(step)
    t = torch.rand((latents.shape[0],), generator=gen, device=dev)
    noise = torch.randn(latents.shape, generator=gen, device=dev,
                        dtype=latents.dtype)
    return t, noise


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
# SDv2-style UNet (heterogeneous conv + attention blocks)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UNetConfig:
    name: str
    img_size: int = 32
    in_ch: int = 4
    base_ch: int = 128
    ch_mults: tuple[int, ...] = (1, 2, 4, 4)
    blocks_per_level: int = 2
    attn_levels: tuple[int, ...] = (1, 2, 3)
    ctx_dim: int = 512            # CLIP text embedding dim
    ctx_len: int = 77
    n_heads: int = 8
    norm_eps: float = 1e-5
    use_flash: bool = False        # flash attention, self and cross
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    def level_ch(self, lvl: int) -> int:
        return self.base_ch * self.ch_mults[lvl]

    def attn_cfg(self, c: int) -> AttnConfig:
        return AttnConfig(c, self.n_heads, self.n_heads, c // self.n_heads,
                          rope_theta=0.0, causal=False,
                          use_flash=self.use_flash)

    def param_count(self) -> int:
        """The JAX package's closed form, kept as it is: it counts neither
        the decoder's extra block per level nor its wider skip-in convs,
        so it is below what :func:`init_unet` makes (980,008,960 against
        1,839,817,728 at ``configs/sdv2_unet.CFG``)."""
        total = 0
        for lvl, m in enumerate(self.ch_mults):
            c = self.base_ch * m
            total += self.blocks_per_level * (2 * 9 * c * c + c * c)
            if lvl in self.attn_levels:
                total += self.blocks_per_level * (4 * c * c + self.ctx_dim * 2 * c
                                                  + 8 * c * c)
        return 2 * total + 10 * self.base_ch ** 2 * self.ch_mults[-1] ** 2


def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
               dtype, device) -> torch.Tensor:
    return L.normal(gen, (kh, kw, cin, cout), 1.0 / math.sqrt(kh * kw * cin),
                    dtype, device)


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: ``ceil(n / stride)``
    outputs, the odd pad element at the end (a 3x3 stride-2 conv of an
    even size pads (0, 1), not PyTorch's symmetric (1, 1))."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` and HWIO ``w`` -> NHWC, "SAME" padding as
    ``lax.conv_general_dilated``.  The permutes are views: the NCHW view of
    an NHWC tensor is channels-last, and cuDNN takes it as such."""
    kh, kw = w.shape[0], w.shape[1]
    (ht, hb), (wl, wr) = (_same_pads(x.shape[1], kh, stride),
                          _same_pads(x.shape[2], kw, stride))
    xc = x.permute(0, 3, 1, 2)
    if ht or hb or wl or wr:
        xc = F.pad(xc, (wl, wr, ht, hb))
    y = F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC ``x`` in fp32 (population variance), the affine
    in fp32 whatever the leaves' dtype, the result in ``x.dtype``."""
    xc = x.permute(0, 3, 1, 2).float()
    out = F.group_norm(xc, groups, scale.float(), bias.float(), eps)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def _init_resblock(gen: torch.Generator, cin: int, cout: int, temb_dim: int,
                   dtype, device) -> Params:
    f32 = dict(dtype=torch.float32, device=device)
    p = {
        "gn1": torch.ones((cin,), **f32), "gb1": torch.zeros((cin,), **f32),
        "conv1": _conv_init(gen, 3, 3, cin, cout, dtype, device),
        "temb": L.dense_init(gen, temb_dim, cout, dtype, device),
        "gn2": torch.ones((cout,), **f32), "gb2": torch.zeros((cout,), **f32),
        "conv2": _conv_init(gen, 3, 3, cout, cout, dtype, device),
    }
    if cin != cout:
        p["skip_conv"] = _conv_init(gen, 1, 1, cin, cout, dtype, device)
    return p


def _apply_resblock(p: Params, x: torch.Tensor, temb: torch.Tensor,
                    cfg: UNetConfig) -> torch.Tensor:
    h = F.silu(group_norm(x, p["gn1"], p["gb1"], eps=cfg.norm_eps))
    h = conv2d(h, p["conv1"])
    h = h + (F.silu(temb) @ p["temb"].to(temb.dtype))[:, None, None]
    h = F.silu(group_norm(h, p["gn2"], p["gb2"], eps=cfg.norm_eps))
    h = conv2d(h, p["conv2"])
    if "skip_conv" in p:
        x = conv2d(x, p["skip_conv"])
    return x + h


def _init_attnblock(gen: torch.Generator, c: int, cfg: UNetConfig,
                    device) -> Params:
    pd, acfg = cfg.param_dtype, cfg.attn_cfg(c)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "gn": torch.ones((c,), **f32), "gb": torch.zeros((c,), **f32),
        "attn": L.init_attention(gen, acfg, pd, device),
        "lnx": torch.ones((c,), **f32),
        "ctx_kv": L.dense_init(gen, cfg.ctx_dim, 2 * c, pd, device),
        "xattn": L.init_attention(gen, acfg, pd, device),
        "ln2": torch.ones((c,), **f32),
        "mlp": L.init_gelu_mlp(gen, c, 4 * c, pd, device),
    }


def _apply_attnblock(p: Params, x: torch.Tensor, ctx: torch.Tensor,
                     cfg: UNetConfig) -> torch.Tensor:
    """Self-attention on the group-normed pixels, cross-attention over the
    text tokens, a GELU MLP; each residual.  With ``cfg.use_flash`` both
    attentions run the flash kernel, at head dim ``C / n_heads``."""
    B, H, W, C = x.shape
    acfg = cfg.attn_cfg(C)
    t = group_norm(x, p["gn"], p["gb"], eps=cfg.norm_eps).reshape(B, H * W, C)
    a, _ = L.apply_attention(p["attn"], t, acfg)
    t = x.reshape(B, H * W, C) + a
    h = L.rms_norm(t, p["lnx"], cfg.norm_eps)
    kv = ctx @ p["ctx_kv"].to(ctx.dtype)
    hd = C // cfg.n_heads
    kx = kv[..., :C].reshape(B, -1, cfg.n_heads, hd)
    vx = kv[..., C:].reshape(B, -1, cfg.n_heads, hd)
    a, _ = L.apply_attention(p["xattn"], h, acfg, cross_kv=(kx, vx))
    t = t + a
    h = L.rms_norm(t, p["ln2"], cfg.norm_eps)
    t = t + L.apply_gelu_mlp(p["mlp"], h)
    return t.reshape(B, H, W, C)


def init_unet(gen: torch.Generator, cfg: UNetConfig, device="cuda") -> Params:
    pd = cfg.param_dtype
    temb_dim = 4 * cfg.base_ch
    p: Params = {
        "time_mlp": {
            "w1": L.dense_init(gen, cfg.base_ch, temb_dim, pd, device),
            "b1": torch.zeros((temb_dim,), dtype=pd, device=device),
            "w2": L.dense_init(gen, temb_dim, temb_dim, pd, device),
            "b2": torch.zeros((temb_dim,), dtype=pd, device=device)},
        "in_conv": _conv_init(gen, 3, 3, cfg.in_ch, cfg.base_ch, pd, device),
        "down": [], "up": [],
    }
    c = cfg.base_ch
    chans = [c]
    for lvl, m in enumerate(cfg.ch_mults):
        cout = cfg.base_ch * m
        level = []
        for _ in range(cfg.blocks_per_level):
            blk = {"res": _init_resblock(gen, c, cout, temb_dim, pd, device)}
            if lvl in cfg.attn_levels:
                blk["attn"] = _init_attnblock(gen, cout, cfg, device)
            level.append(blk)
            c = cout
            chans.append(c)
        if lvl < len(cfg.ch_mults) - 1:
            level.append({"downsample": _conv_init(gen, 3, 3, c, c, pd,
                                                   device)})
            chans.append(c)
        p["down"].append(level)
    p["mid"] = {
        "res1": _init_resblock(gen, c, c, temb_dim, pd, device),
        "attn": _init_attnblock(gen, c, cfg, device),
        "res2": _init_resblock(gen, c, c, temb_dim, pd, device),
    }
    for lvl in reversed(range(len(cfg.ch_mults))):
        cout = cfg.base_ch * cfg.ch_mults[lvl]
        level = []
        for _ in range(cfg.blocks_per_level + 1):
            cskip = chans.pop()
            blk = {"res": _init_resblock(gen, c + cskip, cout, temb_dim, pd,
                                         device)}
            if lvl in cfg.attn_levels:
                blk["attn"] = _init_attnblock(gen, cout, cfg, device)
            level.append(blk)
            c = cout
        if lvl > 0:
            level.append({"upsample": _conv_init(gen, 3, 3, c, c, pd,
                                                 device)})
        p["up"].append(level)
    p["out_gn"] = torch.ones((c,), dtype=torch.float32, device=device)
    p["out_gb"] = torch.zeros((c,), dtype=torch.float32, device=device)
    p["out_conv"] = _conv_init(gen, 3, 3, c, cfg.in_ch, pd, device)
    return p


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x resize of NHWC ``x`` (``jax.image.resize``
    "nearest": output pixel i reads input pixel i // 2)."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None].expand(B, H, 2, W, 2, C).reshape(
        B, 2 * H, 2 * W, C)


def unet_apply(params: Params, xt: torch.Tensor, t: torch.Tensor,
               batch: dict, cfg: UNetConfig) -> torch.Tensor:
    """batch: {"text_embeds": (B, ctx_len, ctx_dim)}.  Every down-path
    output is a skip; the up path's res blocks pop them LIFO and concat
    them on channels."""
    dt = cfg.dtype
    ctx = batch["text_embeds"].to(dt)
    tm = params["time_mlp"]
    temb = timestep_embedding(t, cfg.base_ch).to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    temb = F.gelu(temb @ tm["w1"].to(dt) + tm["b1"], approximate="tanh")
    temb = temb @ tm["w2"].to(dt) + tm["b2"]
    x = conv2d(xt.to(dt), params["in_conv"])
    skips = [x]
    for level in params["down"]:
        for blk in level:
            if "downsample" in blk:
                x = conv2d(x, blk["downsample"], stride=2)
            else:
                x = _apply_resblock(blk["res"], x, temb, cfg)
                if "attn" in blk:
                    x = _apply_attnblock(blk["attn"], x, ctx, cfg)
            skips.append(x)
    x = _apply_resblock(params["mid"]["res1"], x, temb, cfg)
    x = _apply_attnblock(params["mid"]["attn"], x, ctx, cfg)
    x = _apply_resblock(params["mid"]["res2"], x, temb, cfg)
    for level in params["up"]:
        for blk in level:
            if "upsample" in blk:
                x = conv2d(_upsample2x(x), blk["upsample"])
            else:
                x = torch.cat([x, skips.pop()], dim=-1)
                x = _apply_resblock(blk["res"], x, temb, cfg)
                if "attn" in blk:
                    x = _apply_attnblock(blk["attn"], x, ctx, cfg)
    x = F.silu(group_norm(x, params["out_gn"], params["out_gb"],
                          eps=cfg.norm_eps))
    return conv2d(x, params["out_conv"])


def unet_loss(params: Params, batch: dict, t: torch.Tensor,
              noise: torch.Tensor, cfg: UNetConfig) -> torch.Tensor:
    return ddpm_loss(lambda p, xt, tt, b: unet_apply(p, xt, tt, b, cfg),
                     params, batch, t, noise)


# --------------------------------------------------------------------------
# Block graphs for the compile path
# --------------------------------------------------------------------------

def uvit_block_graph(cfg: UViTConfig, batch: int,
                     hw: Hardware = H100_SXM) -> BlockGraph:
    """UViT as the analytic planner graph: ``embed``, the encoder blocks,
    the decoder blocks (each with its skip-in projection), ``out``; a skip
    edge from each encoder block to its mirror decoder block.  Costs are
    analytic (bf16 bytes, matmul FLOPs) on ``hw``, which defaults to
    ``H100_SXM`` where the JAX function defaults to its TPU preset."""
    d, n, ff = cfg.d_model, cfg.n_tokens, cfg.d_ff
    act = batch * n * d * 2                     # bf16 activation bytes
    attn_fl = 2 * batch * (4 * n * d * d + 2 * n * n * d)
    mlp_fl = 2 * batch * (2 * n * d * ff)
    blk_fl = attn_fl + mlp_fl
    per_param = (4 * d * d + 2 * d * ff) * 2
    blocks = [Block("embed", 0.0, cfg.n_classes * d * 2, act, 0,
                    2 * batch * n * (cfg.patch ** 2 * cfg.in_ch) * d)]
    for i in range(cfg.half):
        blocks.append(Block(f"enc{i}", 0.0, per_param, act, act, blk_fl))
    for i in range(cfg.half):
        blocks.append(Block(f"dec{i}", 0.0, per_param + 2 * d * d * 2, act, 0,
                            blk_fl + 2 * batch * n * 2 * d * d))
    blocks.append(Block("out", 0.0, d * cfg.patch ** 2 * cfg.in_ch * 2, act, 0,
                        2 * batch * n * d * (cfg.patch ** 2 * cfg.in_ch)))
    total = len(blocks)
    skips = tuple(SkipEdge(1 + i, total - 2 - i, act) for i in range(cfg.half))
    return BlockGraph(analytic_block_costs(blocks, hw), skips)


def hunyuan_block_graph(cfg: HunyuanDiTConfig, batch: int,
                        hw: Hardware = H100_SXM) -> BlockGraph:
    """Hunyuan-DiT as the analytic planner graph, as
    :func:`uvit_block_graph` (the blocks' adaLN and text cross-attention
    counted in their params and FLOPs); ``hw`` defaults to ``H100_SXM``."""
    d, n, ff, lt = cfg.d_model, cfg.n_tokens, cfg.d_ff, cfg.ctx_len
    act = batch * n * d * 2
    blk_fl = 2 * batch * (4 * n * d * d + 2 * n * n * d + 2 * n * d * ff
                          + 2 * n * d * d + cfg.ctx_dim * 2 * d * lt
                          + 2 * n * lt * d + 6 * n * d * d // n)
    per_param = (4 * d * d + 2 * d * ff + 2 * d * d + cfg.ctx_dim * 2 * d
                 + 6 * d * d) * 2
    blocks = [Block("embed", 0.0, d * 8, act, 0, 2 * batch * n * 16 * d)]
    for i in range(cfg.half):
        blocks.append(Block(f"enc{i}", 0.0, per_param, act, act, blk_fl))
    for i in range(cfg.half):
        blocks.append(Block(f"dec{i}", 0.0, per_param + 8 * d * d, act, 0,
                            blk_fl + 2 * batch * n * 2 * d * d))
    blocks.append(Block("out", 0.0, d * 16 * 2, act, 0, 2 * batch * n * d * 16))
    total = len(blocks)
    skips = tuple(SkipEdge(1 + i, total - 2 - i, act) for i in range(cfg.half))
    return BlockGraph(analytic_block_costs(blocks, hw), skips)


def unet_block_graph(cfg: UNetConfig, batch: int,
                     hw: Hardware = H100_SXM) -> BlockGraph:
    """Exports the UNet as a heterogeneous BlockGraph (paper Fig. 6: per-block
    cost varies ~3x across resolutions): ``in_conv``, each down-path block
    and downsample, ``mid``, each up-path block and upsample, ``out_conv``;
    skip edges from every down-path output to the up-path res block that
    pops it (nested, LIFO)."""
    blocks: list[Block] = []
    skip_meta: list[tuple[int, int]] = []   # (blk_index, bytes)
    res = cfg.img_size

    def res_cost(cin, cout, r):
        fl = 2 * batch * r * r * 9 * cin * cout + 2 * batch * r * r * 9 * cout * cout
        return fl, batch * r * r * cout * 2

    def attn_cost(c, r):
        n = r * r
        fl = 2 * batch * (8 * n * c * c + 4 * n * n * c + 8 * n * c * c
                          + cfg.ctx_len * n * c * 2)
        return fl

    c = cfg.base_ch
    fl, act = res_cost(cfg.in_ch, c, res)
    blocks.append(Block("in_conv", 0.0, 9 * cfg.in_ch * c * 2, act, act, fl))
    skip_meta.append((0, act))
    for lvl, m in enumerate(cfg.ch_mults):
        cout = cfg.base_ch * m
        for b in range(cfg.blocks_per_level):
            fl, act = res_cost(c, cout, res)
            pbytes = (9 * c * cout + 9 * cout * cout) * 2
            if lvl in cfg.attn_levels:
                fl += attn_cost(cout, res)
                pbytes += (16 * cout * cout + cfg.ctx_dim * 2 * cout) * 2
            blocks.append(Block(f"d{lvl}b{b}", 0.0, pbytes, act, act, fl))
            skip_meta.append((len(blocks) - 1, act))
            c = cout
        if lvl < len(cfg.ch_mults) - 1:
            fl = 2 * batch * (res // 2) ** 2 * 9 * c * c
            act = batch * (res // 2) ** 2 * c * 2
            blocks.append(Block(f"down{lvl}", 0.0, 9 * c * c * 2, act, act, fl))
            skip_meta.append((len(blocks) - 1, act))
            res //= 2
    fl, act = res_cost(c, c, res)
    blocks.append(Block("mid", 0.0, (18 * c * c + 16 * c * c) * 2, act, 0,
                        2 * fl + attn_cost(c, res)))
    for lvl in reversed(range(len(cfg.ch_mults))):
        cout = cfg.base_ch * cfg.ch_mults[lvl]
        for b in range(cfg.blocks_per_level + 1):
            src, sbytes = skip_meta.pop()
            cin = c + sbytes // (batch * res * res * 2)
            fl, act = res_cost(cin, cout, res)
            pbytes = (9 * cin * cout + 9 * cout * cout) * 2
            if lvl in cfg.attn_levels:
                fl += attn_cost(cout, res)
                pbytes += (16 * cout * cout + cfg.ctx_dim * 2 * cout) * 2
            blocks.append(Block(f"u{lvl}b{b}", 0.0, pbytes, act, 0, fl))
            c = cout
        if lvl > 0:
            res *= 2
            fl = 2 * batch * res * res * 9 * c * c
            act = batch * res * res * c * 2
            blocks.append(Block(f"up{lvl}", 0.0, 9 * c * c * 2, act, 0, fl))
    blocks.append(Block("out_conv", 0.0, 9 * c * cfg.in_ch * 2,
                        batch * cfg.img_size ** 2 * cfg.in_ch * 2, 0,
                        2 * batch * cfg.img_size ** 2 * 9 * c * cfg.in_ch))
    # skip edges follow the UNet's LIFO stack discipline (nested by
    # construction): producers are the down-path blocks with skip_bytes > 0,
    # consumers are the up-path res blocks, popping in reverse order
    producers = [i for i, b in enumerate(blocks) if b.skip_bytes > 0]
    consumers = [i for i, b in enumerate(blocks)
                 if b.name.startswith("u") and not b.name.startswith("up")]
    edges = []
    stack = list(producers)
    for cons in consumers:
        if stack:
            src = stack.pop()
            edges.append(SkipEdge(src, cons, blocks[src].skip_bytes))
    return BlockGraph(analytic_block_costs(blocks, hw),
                      tuple(sorted(edges, key=lambda e: e.src)))



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


# --------------------------------------------------------------------------
# SkipViT: homogeneous ViT stack with an arbitrary (possibly sparse) skip
# topology -- the asymmetric-fold workload (mid-block bottlenecks, sparse
# skips, odd block counts)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SkipViTConfig:
    """UNet-shaped ViT over ONE homogeneous block stack.

    ``n_enc`` skip-emitting blocks, ``n_mid`` bottleneck blocks (no skip
    endpoints), ``n_dec`` blocks that may consume a skip.  ``skip_pairs``
    (block-index ``(src, dst)`` tuples) defaults to full pairing
    ``(i, n-1-i)``; pass a subset for sparse-skip variants.  Every block
    carries a ``skip_in`` projection and consumes *additively*
    (``x + skip @ skip_in``), so blocks without an incoming skip see zeros
    and reduce to a plain ViT block -- one block body covers emitters,
    bottlenecks and consumers, which is what lets the fold's turnaround
    cut land anywhere the partitioner puts it.
    """

    name: str
    img_size: int = 8
    in_ch: int = 4
    patch: int = 2
    d_model: int = 32
    n_heads: int = 4
    d_ff: int = 64
    n_classes: int = 10
    n_enc: int = 3
    n_mid: int = 2
    n_dec: int = 3
    skip_pairs: tuple[tuple[int, int], ...] | None = None
    norm_eps: float = 1e-6
    use_flash: bool = False        # flash-attention kernel in every block
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def n_blocks(self) -> int:
        return self.n_enc + self.n_mid + self.n_dec

    @property
    def n_tokens(self) -> int:
        return (self.img_size // self.patch) ** 2 + 2  # + time/class tokens

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_heads,
                          self.d_model // self.n_heads, rope_theta=0.0,
                          causal=False, use_flash=self.use_flash)

    def skip_edges(self) -> tuple[tuple[int, int], ...]:
        if self.skip_pairs is not None:
            return self.skip_pairs
        k = min(self.n_enc, self.n_dec)
        return tuple((i, self.n_blocks - 1 - i) for i in range(k))


def init_skipvit(gen: torch.Generator, cfg: SkipViTConfig,
                 device="cuda") -> Params:
    d, pd = cfg.d_model, cfg.param_dtype
    pp = cfg.patch ** 2 * cfg.in_ch
    blocks = _init_vit_block(gen, cfg, cfg.d_ff, False, device,
                             (cfg.n_blocks,))
    blocks["skip_in"] = L.dense_init(gen, d, d, pd, device, (cfg.n_blocks,))
    return {
        "patch_embed": L.dense_init(gen, pp, d, pd, device),
        "pos_embed": L.normal(gen, (cfg.n_tokens, d), 0.02, pd, device),
        "time_mlp": L.init_gelu_mlp(gen, d, 4 * d, pd, device),
        "class_embed": L.dense_init(gen, cfg.n_classes, d, pd, device),
        "blocks": blocks,
        "out_norm": torch.ones((d,), dtype=pd, device=device),
        "out_proj": L.dense_init(gen, d, pp, pd, device),
    }


def skipvit_apply(params: Params, xt: torch.Tensor, t: torch.Tensor,
                  batch: dict, cfg: SkipViTConfig) -> torch.Tensor:
    """Single-device reference; the wave executor must match it for every
    legal partition, mirror-symmetric or not."""
    x = uvit_embed(params, xt, t, batch, cfg)
    consumes = {dst: src for src, dst in cfg.skip_edges()}
    stash: dict[int, torch.Tensor] = {}
    for b in range(cfg.n_blocks):
        bp = tree_index(params["blocks"], b)
        if b in consumes:
            x = x + stash[consumes[b]] @ bp["skip_in"].to(x.dtype)
        x = _apply_vit_block(bp, x, cfg)
        stash[b] = x
    return uvit_output(params, x, cfg)


def skipvit_loss(params: Params, batch: dict, t: torch.Tensor,
                 noise: torch.Tensor, cfg: SkipViTConfig) -> torch.Tensor:
    return ddpm_loss(lambda p, xt, tt, b: skipvit_apply(p, xt, tt, b, cfg),
                     params, batch, t, noise)


def skipvit_pipeline_graph(cfg: SkipViTConfig, batch: int = 1,
                           fwd_times=None,
                           hw: Hardware = H100_SXM) -> BlockGraph:
    """Runtime-aligned SkipViT graph: one block per ``params['blocks']``
    row with the config's (possibly sparse / mid-block) skip edges."""
    d, n, ff = cfg.d_model, cfg.n_tokens, cfg.d_ff
    act = batch * n * d * 2
    blk_fl = 2 * batch * (4 * n * d * d + 2 * n * n * d + 2 * n * d * ff)
    per_param = (4 * d * d + 2 * d * ff + d * d) * 2
    edges = cfg.skip_edges()
    srcs = {s for s, _ in edges}
    blocks = [Block(f"blk{i}", 0.0, per_param, act,
                    act if i in srcs else 0, blk_fl)
              for i in range(cfg.n_blocks)]
    return _runtime_graph(blocks,
                          (SkipEdge(s, t, act) for s, t in edges),
                          fwd_times, hw)
