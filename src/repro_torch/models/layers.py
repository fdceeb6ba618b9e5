"""Shared functional layers (the port of ``repro.models.layers``, in part).

Pure functions on tensors and dict-tree params with the JAX package's leaf
names and ``(in, out)`` weight layouts, so a JAX params tree converts with
no transposes (``repro_torch.convert``).  Ported so far: ``dense_init``,
``rms_norm``, rotary embeddings (``rope_freqs``, ``apply_rope``: the
half-split form, fp32 angles), the dense ``attention`` (its mask the
flash op's plain version's, ``ops._mask``, where JAX has ``_attn_mask``),
``AttnConfig`` (with Qwen3's ``qk_norm``), ``init_attention`` /
``apply_attention`` (self and cross, ``positions=``), the SwiGLU and GELU
MLPs, DeepSeek-V3's MLA (``MLAConfig``, ``init_mla``, ``apply_mla``) and
the top-k MoE (``MoEConfig``, ``init_moe``, ``apply_moe`` with its
``onehot``, ``scatter`` and ``dense`` dispatches), ``layer_norm`` and
``promoted_matmul`` (JAX's type promotion for a matmul of mixed float
dtypes, which PyTorch refuses), and the KV caches (``init_kv_cache``,
``init_mla_cache``, ``cache=`` on ``apply_attention`` and ``apply_mla``,
``q_offset`` and ``kv_valid_len`` on ``attention``).  ``apply_attention``
runs the flash-attention kernel when the config's ``use_flash`` is set
(the "drop-in replacement selected by config ``use_flash``" the JAX
module names), over a KV cache too: the kernel reads the cache in place.
MLA runs the dense ``attention``, as in JAX: its q/k head dim
(``qk_nope + qk_rope``) differs from its v head dim, and the flash kernel
takes one head dim.

A KV cache is a dict ``{"k": (B, max_len, Hkv, Dh), "v": ..., "pos": int}``
(MLA: ``{"kv", "k_rope", "pos"}``) whose tensors are written in place at
``pos`` and returned with ``pos`` advanced.  ``pos`` is a host int, where
JAX keeps a device scalar: the kernel takes it as a launch argument, and a
device ``pos`` would cost a host sync at every layer of every step.

Random init draws from an explicit ``torch.Generator`` on ``device``; the
numbers differ from ``jax.random`` for the same seed, so parity tests
carry JAX params across with ``params_from_jax``.  ``stack`` prepends
leading dims (a stack of identical blocks is drawn as one tensor).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import _mask

Params = dict


# --------------------------------------------------------------------------
# Initializers / norms
# --------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    return (torch.randn(tuple(shape), generator=gen, device=device,
                        dtype=torch.float32) * std).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, device="cuda", stack=()) -> torch.Tensor:
    return normal(gen, (*stack, in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                  dtype, device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics (biased variance), ``scale`` and ``bias`` applied
    in fp32, the result in ``x.dtype``."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dtype)


def promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.matmul``
    computes ``fp32 @ bf16`` in fp32 (``torch.matmul`` refuses mixed
    dtypes)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (Dh/2,)
    angles = positions[..., None].float() * freqs              # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA / MQA / MHA, causal + sliding window), dense reference;
# the flash kernel replaces it when AttnConfig.use_flash is set
# --------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0,
              kv_valid_len: int | None = None) -> torch.Tensor:
    """Grouped-query attention. q: (B,S,Hq,Dh), k/v: (B,T,Hkv,Dh).  A
    fully masked row takes the uniform softmax of the -1e30 fill, as in
    JAX (no serving path has one)."""
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    qg = q.reshape(B, S, Hkv, groups, Dh)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float())
    logits = logits * (1.0 / math.sqrt(Dh))
    mask = _mask(S, T, causal, window, q.device, q_offset, kv_valid_len)
    logits = torch.where(mask[None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, S, Hq, v.shape[-1]).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int | None = None       # sliding-window size (None = full)
    causal: bool = True
    qk_norm: bool = False           # Qwen3-style per-head q/k RMSNorm
    use_flash: bool = False         # flash-attention kernel, not `attention`


def init_attention(gen: torch.Generator, cfg: AttnConfig, dtype=torch.float32,
                   device="cuda", stack=()) -> Params:
    kw = dict(dtype=dtype, device=device, stack=stack)
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * cfg.head_dim, **kw),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * cfg.head_dim, **kw),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * cfg.head_dim, **kw),
        "wo": dense_init(gen, cfg.n_heads * cfg.head_dim, cfg.d_model, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*stack, cfg.head_dim), dtype=dtype,
                                 device=device)
        p["k_norm"] = torch.ones((*stack, cfg.head_dim), dtype=dtype,
                                 device=device)
    return p


def _attend(q, k, v, cfg: AttnConfig, causal: bool, q_offset: int,
            valid: int | None) -> torch.Tensor:
    """The flash kernel (``use_flash``) or the dense ``attention``."""
    if cfg.use_flash:
        return flash_attention(q.to(k.dtype), k, v, causal, cfg.window,
                               q_offset=q_offset,
                               kv_valid_len=valid).to(q.dtype)
    return attention(q, k, v, causal=causal, window=cfg.window,
                     q_offset=q_offset, kv_valid_len=valid)


def apply_attention(p: Params, x: torch.Tensor, cfg: AttnConfig, *,
                    positions: torch.Tensor | None = None,
                    cache: Params | None = None,
                    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                    tp=None, reduce: bool = True,
                    ) -> tuple[torch.Tensor, Params | None]:
    """Self- or cross-attention (``cross_kv`` supplies precomputed K/V).
    With ``cache`` (prefill or decode, self-attention), this step's K/V are
    written into the cache at ``cache["pos"]`` in place and the queries
    attend over the cache's first ``pos + S`` rows; returns ``(out,
    new_cache)``, else ``(out, None)``.  Weights of another float dtype
    than ``x`` are promoted, as JAX promotes them (a Zamba2 decode step's
    residual stream is fp32 against bf16 weights).  With ``use_flash`` the
    kernel computes in k's dtype, so over a bf16 cache an fp32 q (that
    Zamba2 decode step) is rounded to bf16: a departure from JAX, which
    computes that attention in fp32 (the kernel takes one dtype, and
    promoting the cache would copy it every step).

    ``tp`` (a ``runtime.tensor_parallel.TensorParallel``): ``wq`` is this
    rank's block of columns and ``wo`` its block of rows (see
    :func:`_apply_attention_tp`); ``reduce=False`` returns the rank's
    partial sum of the output before the all-reduce."""
    if tp is not None:
        return _apply_attention_tp(p, x, cfg, tp, positions=positions,
                                   cache=cache, reduce=reduce)
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = promoted_matmul(x, p["wq"]).reshape(B, S, H, Dh)
    if cross_kv is None:
        k = promoted_matmul(x, p["wk"]).reshape(B, S, Hkv, Dh)
        v = promoted_matmul(x, p["wv"]).reshape(B, S, Hkv, Dh)
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        if cross_kv is None:
            k = rms_norm(k, p["k_norm"])
    if cfg.rope_theta > 0 and cross_kv is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    causal = cfg.causal and cross_kv is None
    q_offset, valid, new_cache = 0, None, None
    if cache is not None and cross_kv is None:
        pos = cache["pos"]
        cache["k"][:, pos:pos + S] = k
        cache["v"][:, pos:pos + S] = v
        k, v = cache["k"], cache["v"]
        new_cache = {"k": k, "v": v, "pos": pos + S}
        q_offset, valid = pos, pos + S
    out = _attend(q, k, v, cfg, causal, q_offset, valid)
    out = promoted_matmul(out.reshape(B, S, H * Dh), p["wo"])
    return out, new_cache


def head_segments(ha: int, hb: int, groups: int) -> list[tuple[int, int]]:
    """q heads ``[ha, hb)`` cut into runs that one attention call takes
    (``Hq % Hkv == 0``, q head ``j`` of a run reading its kv head ``j //
    (Hq / Hkv)``): whole GQA groups of ``groups`` heads together, and the
    heads of a group the range holds in part (one kv head) apart.  At most
    three runs."""
    segs, h = [], ha
    while h < hb:
        if h % groups == 0 and h + groups <= hb:
            e = h + (hb - h) // groups * groups
        else:
            e = min(hb, (h // groups + 1) * groups)
        segs.append((h, e))
        h = e
    return segs


def _apply_attention_tp(p: Params, x: torch.Tensor, cfg: AttnConfig, tp, *,
                        positions, cache, reduce: bool):
    """Self-attention over tensor parallelism: this rank's columns ``[c0,
    c1)`` of ``wq`` (its block) and the same rows of ``wo``.

    The rank computes the q heads ``[ha, hb)`` that cover its columns.
    When the columns cut through a head (smollm-360m's 15 heads of 64 at
    model=2: 480 columns a rank, 7.5 heads), q is gathered whole from the
    ranks (``tp.gather(partial=True)``, whose backward reduce-scatters q's
    gradient) and the rank computes the whole heads its columns touch, at
    most ``ceil(Hq / tp) + 1``, then keeps its columns of their output.  A
    head range that is not whole GQA groups runs as at most three
    attention calls (:func:`head_segments`: the part of a group at each
    end, one kv head each, and the whole groups between), so the rank's
    attention work stays within ``ceil(Hq / tp)`` heads plus one group.

    K and V: only the kv heads ``[ka, kb)`` those q heads read, from their
    columns of the whole ``wk``/``wv`` (the TP plans' ``custom_rules``
    replicate them), read through ``tp.copy`` so that the rank's partial
    gradient is all-reduced whole.  Over a cache: a cache block of
    ``Hkv / tp`` heads (``cache_specs`` split it) holds exactly those
    heads and is written and read in place; a whole cache is written whole
    (every kv head computed) and its valid rows of heads ``[ka, kb)`` are
    read (copied when they are not all of it).

    The input goes through ``tp.copy``; the output, the rank's columns
    times its rows of ``wo``, is a partial sum that ``tp.reduce``
    all-reduces (``reduce=False``: returned as it is)."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    W = p["wq"].shape[-1]
    if p["wo"].shape[-2] != W or W * tp.size != H * Dh:
        raise ValueError(f"wq's {W} columns and wo's {p['wo'].shape[-2]} "
                         f"rows are not one of {tp.size} blocks of "
                         f"{H * Dh}")
    c0 = tp.index * W
    c1 = c0 + W
    ha, hb = c0 // Dh, -(-c1 // Dh)
    ka, kb = ha // G, (hb - 1) // G + 1
    if p["wk"].shape[-1] != Hkv * Dh:
        raise NotImplementedError(
            "wk/wv split over the TP axis: the TP plans replicate them "
            "(custom_rules)")
    x, wk, wv = tp.copy(x, p["wk"], p["wv"])
    q = promoted_matmul(x, p["wq"])
    if W % Dh:
        q = tp.gather(q, -1, partial=True)[..., ha * Dh:hb * Dh]
    q = q.reshape(B, S, hb - ha, Dh)
    # the cache's kv heads: all, or this rank's block
    cached = None if cache is None else cache["k"].shape[-2]
    if cached is not None and cached not in (Hkv, (kb - ka)):
        raise ValueError(f"a cache of {cached} kv heads: want {Hkv} (whole) "
                         f"or this rank's {kb - ka}")
    k_all = cached == Hkv
    if not k_all:
        wk, wv = wk[..., ka * Dh:kb * Dh], wv[..., ka * Dh:kb * Dh]
    nk = Hkv if k_all else kb - ka
    k = promoted_matmul(x, wk).reshape(B, S, nk, Dh)
    v = promoted_matmul(x, wv).reshape(B, S, nk, Dh)
    if cfg.qk_norm:
        q_norm, k_norm = tp.copy(p["q_norm"], p["k_norm"])
        q, k = rms_norm(q, q_norm), rms_norm(k, k_norm)
    if cfg.rope_theta > 0:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q_offset, valid, new_cache = 0, None, None
    if cache is not None:
        pos = cache["pos"]
        cache["k"][:, pos:pos + S] = k
        cache["v"][:, pos:pos + S] = v
        k, v = cache["k"], cache["v"]
        new_cache = {"k": k, "v": v, "pos": pos + S}
        q_offset, valid = pos, pos + S
        if k_all and (ka, kb) != (0, Hkv):
            # the valid rows of this rank's kv heads: a copy, read whole
            k, v = k[:, :valid, ka:kb], v[:, :valid, ka:kb]
            valid = None
    outs = []
    for h0, h1 in head_segments(ha, hb, G):
        j0, j1 = h0 // G - ka, (h1 - 1) // G + 1 - ka
        outs.append(_attend(q[:, :, h0 - ha:h1 - ha], k[:, :, j0:j1],
                            v[:, :, j0:j1], cfg, cfg.causal, q_offset,
                            valid))
    out = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    out = out.reshape(B, S, (hb - ha) * Dh)[..., c0 - ha * Dh:c1 - ha * Dh]
    out = promoted_matmul(out, p["wo"])
    return (tp.reduce(out) if reduce else out), new_cache


def init_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                  dtype=torch.float32, device="cuda", stack=()) -> Params:
    """A zero cache of ``max_len`` rows at ``pos`` 0; ``stack`` prepends
    leading dims (a stack of layers' caches, one ``pos`` for all)."""
    shape = (*stack, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "pos": 0}


# --------------------------------------------------------------------------
# MLA -- DeepSeek-V3 multi-head latent attention
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0


def init_mla(gen: torch.Generator, cfg: MLAConfig, dtype=torch.float32,
             device="cuda", stack=()) -> Params:
    H = cfg.n_heads
    kw = dict(dtype=dtype, device=device, stack=stack)
    ones = lambda n: torch.ones((*stack, n), dtype=dtype, device=device)
    return {
        "wq_a": dense_init(gen, cfg.d_model, cfg.q_lora_rank, **kw),
        "q_norm": ones(cfg.q_lora_rank),
        "wq_b": dense_init(gen, cfg.q_lora_rank,
                           H * (cfg.qk_nope_dim + cfg.qk_rope_dim), **kw),
        "wkv_a": dense_init(gen, cfg.d_model,
                            cfg.kv_lora_rank + cfg.qk_rope_dim, **kw),
        "kv_norm": ones(cfg.kv_lora_rank),
        "wkv_b": dense_init(gen, cfg.kv_lora_rank,
                            H * (cfg.qk_nope_dim + cfg.v_head_dim), **kw),
        "wo": dense_init(gen, H * cfg.v_head_dim, cfg.d_model, **kw),
    }


def apply_mla(p: Params, x: torch.Tensor, cfg: MLAConfig, *,
              positions: torch.Tensor | None = None,
              cache: Params | None = None
              ) -> tuple[torch.Tensor, Params | None]:
    """Causal MLA with a *compressed* KV cache (the latent and the shared
    rope key per token).  The latent is decompressed to per-head K and V;
    q/k heads are ``qk_nope + qk_rope`` wide and v heads ``v_head_dim``, so
    this runs the dense :func:`attention` (the flash kernel takes one head
    dim).  Returns ``(out, new_cache)`` as :func:`apply_attention`."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]

    q = rms_norm(x @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = x @ p["wkv_a"]                       # (B,S, r + dr)
    kv_latent = rms_norm(kv_a[..., :cfg.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(kv_a[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)          # (B,S,1,dr) shared by heads

    q_offset, kv_valid, new_cache = 0, None, None
    if cache is not None:
        pos = cache["pos"]
        cache["kv"][:, pos:pos + S] = kv_latent
        cache["k_rope"][:, pos:pos + S] = k_rope
        kv_latent, k_rope = cache["kv"], cache["k_rope"]
        new_cache = {"kv": kv_latent, "k_rope": k_rope, "pos": pos + S}
        q_offset, kv_valid = pos, pos + S

    # decompress the latent -> per-head K_nope and V
    T = kv_latent.shape[1]
    kv = promoted_matmul(kv_latent, p["wkv_b"]).reshape(B, T, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_rope.expand(B, T, H, dr)], -1)
    qq = torch.cat([q_nope, q_rope], -1)
    out = attention(qq, k, v, causal=True, q_offset=q_offset,
                    kv_valid_len=kv_valid)
    return out.reshape(B, S, H * dv) @ p["wo"], new_cache


def init_mla_cache(batch: int, max_len: int, cfg: MLAConfig,
                   dtype=torch.float32, device="cuda", stack=()) -> Params:
    return {
        "kv": torch.zeros((*stack, batch, max_len, cfg.kv_lora_rank),
                          dtype=dtype, device=device),
        "k_rope": torch.zeros((*stack, batch, max_len, 1, cfg.qk_rope_dim),
                              dtype=dtype, device=device),
        "pos": 0,
    }


# --------------------------------------------------------------------------
# FFN: SwiGLU, GELU MLP and MoE
# --------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32, device="cuda", stack=()) -> Params:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device, stack),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device, stack),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device, stack),
    }


def apply_swiglu(p: Params, x: torch.Tensor, tp=None,
                 reduce: bool = True) -> torch.Tensor:
    """Weights of another float dtype than ``x`` are promoted, as in JAX.
    ``tp``: ``w_gate``/``w_up`` are this rank's column blocks and
    ``w_down`` its row block; the input goes through ``tp.copy`` and the
    partial output through ``tp.reduce`` (``reduce=False``: returned as it
    is)."""
    mm = promoted_matmul
    if tp is not None:
        x = tp.copy(x)
    out = mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]), p["w_down"])
    return tp.reduce(out) if tp is not None and reduce else out


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32, device="cuda", stack=()) -> Params:
    return {
        "w_up": dense_init(gen, d_model, d_ff, dtype, device, stack),
        "b_up": torch.zeros((*stack, d_ff), dtype=dtype, device=device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device, stack),
        "b_down": torch.zeros((*stack, d_model), dtype=dtype, device=device),
    }


def apply_gelu_mlp(p: Params, x: torch.Tensor, tp=None,
                   reduce: bool = True) -> torch.Tensor:
    """``tp``: ``w_up`` is this rank's column block and ``w_down`` its row
    block.  ``b_up`` is sliced to the rank's columns where it is whole (its
    default FSDP rule splits it over no TP axis), through ``tp.copy`` with
    the input, so that its partial gradient is all-reduced whole;
    ``b_down`` is added once, after ``tp.reduce`` (``reduce=False``: the
    partial sum, before the all-reduce and without ``b_down``)."""
    b_up = p["b_up"]
    if tp is not None:
        cols = p["w_up"].shape[-1]
        if b_up.shape[-1] != cols:
            x, b_up = tp.copy(x, b_up)
            lo = tp.index * cols
            b_up = b_up[..., lo:lo + cols]
        else:
            x = tp.copy(x)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_up"] + b_up, approximate="tanh")
    if tp is None:
        return h @ p["w_down"] + p["b_down"]
    out = h @ p["w_down"]
    return tp.reduce(out) + p["b_down"] if reduce else out


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                  # expert intermediate size
    n_experts: int
    top_k: int
    n_shared: int = 0          # shared (always-on) experts
    shared_d_ff: int = 0       # their intermediate size (0 => d_ff)
    capacity_factor: float = 1.25
    router_dtype: Any = torch.float32


def init_moe(gen: torch.Generator, cfg: MoEConfig, dtype=torch.float32,
             device="cuda", stack=()) -> Params:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(gen, d, E, torch.float32, device, stack),
        "w_gate": normal(gen, (*stack, E, d, f), 1.0 / math.sqrt(d), dtype,
                         device),
        "w_up": normal(gen, (*stack, E, d, f), 1.0 / math.sqrt(d), dtype,
                       device),
        "w_down": normal(gen, (*stack, E, f, d), 1.0 / math.sqrt(f), dtype,
                         device),
    }
    if cfg.n_shared:
        sf = cfg.shared_d_ff or cfg.d_ff
        p["shared"] = init_swiglu(gen, d, cfg.n_shared * sf, dtype, device,
                                  stack)
    return p


def _expert_ffn(p: Params, xe: torch.Tensor, spec: str) -> torch.Tensor:
    """The experts' SwiGLU over per-expert rows; ``spec`` names xe's dims
    ending in (expert, row, d), as ``"becd"``."""
    lead, out = spec[:-1], spec[:-1] + "f"
    h = F.silu(torch.einsum(f"{spec},edf->{out}", xe, p["w_gate"]))
    h = h * torch.einsum(f"{spec},edf->{out}", xe, p["w_up"])
    return torch.einsum(f"{out},efd->{lead}d", h, p["w_down"])


def apply_moe(p: Params, x: torch.Tensor, cfg: MoEConfig, *,
              dispatch: str = "onehot") -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity-based dispatch.  Returns ``(output,
    aux_loss)``, the Switch load-balancing loss.  ``dispatch``:

    - ``"onehot"``: GShard-style one-hot dispatch/combine einsums, capacity
      per batch (the JAX default and historical baseline);
    - ``"scatter"``: sort-based -- each batch row's (token, slot)
      assignments stably sorted by expert, the kept ones scattered into the
      ``(E, cap, d)`` buffer (capacity per row; index ``E*cap`` is the
      dropped slot), the grouped FFN, gathered back and summed into their
      tokens with ``index_add_``;
    - ``"dense"``: every token through its selected experts' gathered
      weights (exact FLOPs, memory-heavy).  Its gates are cast to the
      activations' dtype, where JAX promotes a bf16 product to fp32; in
      fp32 the two are the same function.

    Ties between router probabilities go to ``torch.topk``'s order;
    ``jax.lax.top_k`` breaks them toward the lower index.
    """
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    logits = (xt.to(cfg.router_dtype) @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)                        # (T,E)
    top_p, top_i = torch.topk(probs, k, dim=-1)                  # (T,k)
    top_p = top_p / top_p.sum(-1, keepdim=True)                  # renormalise

    # load-balancing aux loss (Switch-style)
    me = probs.mean(0)
    ce = F.one_hot(top_i, E).sum(1).float().mean(0)
    aux = E * (me * ce).sum() / k

    if dispatch == "dense":
        wg, wu, wd = (p[n][top_i] for n in ("w_gate", "w_up", "w_down"))
        h = F.silu(torch.einsum("td,tkdf->tkf", xt, wg))
        h = h * torch.einsum("td,tkdf->tkf", xt, wu)
        y = torch.einsum("tkf,tkfd,tk->td", h, wd, top_p.to(xt.dtype))
    elif dispatch == "scatter":
        cap = max(1, int(math.ceil(S * k / E * cfg.capacity_factor)))
        n = S * k
        eid = top_i.reshape(B, n)
        gates = top_p.reshape(B, n)
        tok = torch.arange(S, device=x.device).repeat_interleave(k)
        order = torch.argsort(eid, dim=-1, stable=True)
        eid_s = eid.gather(1, order)
        tok_s, gate_s = tok[order], gates.gather(1, order)       # (B, n)
        counts = F.one_hot(eid, E).sum(1)                        # (B, E)
        starts = counts.cumsum(1) - counts
        pos = torch.arange(n, device=x.device) - starts.gather(1, eid_s)
        keep = pos < cap
        slot = eid_s * cap + torch.where(keep, pos, 0)
        # each batch row owns E*cap + 1 buffer rows: the last one takes the
        # dropped assignments and is cut away (JAX: mode="drop")
        width = E * cap + 1
        row0 = torch.arange(B, device=x.device)[:, None]
        dst = torch.where(keep, slot, E * cap) + row0 * width
        src = xt[(tok_s + row0 * S).reshape(-1)]
        buf = x.new_zeros(B * width, d).index_put((dst.reshape(-1),), src)
        xe = buf.reshape(B, width, d)[:, :E * cap].reshape(B, E, cap, d)
        ye = _expert_ffn(p, xe, "becd").reshape(B * E * cap, d)
        rows = torch.where(keep.reshape(-1, 1),
                           ye[(slot + row0 * E * cap).reshape(-1)], 0.0) \
            * gate_s.reshape(-1, 1).to(ye.dtype)
        y = ye.new_zeros(T, d).index_add_(0, (tok_s + row0 * S).reshape(-1),
                                          rows)
    elif dispatch == "onehot":
        cap = max(1, int(math.ceil(T * k / E * cfg.capacity_factor)))
        # position of each (token, slot) within its expert
        onehot = F.one_hot(top_i, E)                             # (T,k,E)
        flat = onehot.reshape(T * k, E)
        pos_in_e = flat.cumsum(0) * flat - 1                     # (T*k,E)
        pos = pos_in_e.max(-1).values.reshape(T, k)              # (T,k)
        keep = (pos < cap) & (pos >= 0)
        gate = torch.where(keep, top_p, 0.0)
        place = (onehot.to(x.dtype)[..., None]
                 * F.one_hot(pos.clamp(0, cap - 1), cap).to(x.dtype)[
                     ..., None, :])                              # (T,k,E,cap)
        d_onehot = (place * keep[..., None, None].to(x.dtype)).sum(1)
        xe = torch.einsum("tec,td->ecd", d_onehot, xt)           # (E,cap,d)
        ye = _expert_ffn(p, xe, "ecd")                           # (E,cap,d)
        combine = (place * gate[..., None, None].to(x.dtype)).sum(1)
        y = torch.einsum("tec,ecd->td", combine, ye)
    else:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}; expected "
                         "'onehot', 'scatter' or 'dense'")

    if "shared" in p:
        y = y + apply_swiglu(p["shared"], xt)
    return y.reshape(B, S, d), aux
