"""Shared functional layers (the port of ``repro.models.layers``, in part).

Pure functions on tensors and dict-tree params with the JAX package's leaf
names and ``(in, out)`` weight layouts, so a JAX params tree converts with
no transposes (``repro_torch.convert``).  Ported so far: ``dense_init``,
``rms_norm``, ``_attn_mask``, the dense ``attention``, ``AttnConfig``,
``init_attention`` / ``apply_attention`` (self and cross) and the GELU MLP.
``apply_attention`` runs the flash-attention kernel when the config's
``use_flash`` is set (the "drop-in replacement selected by config
``use_flash``" the JAX module names).  Rotary embeddings, KV caches, MLA
and MoE are not ported yet.

Random init draws from an explicit ``torch.Generator`` on ``device``; the
numbers differ from ``jax.random`` for the same seed, so parity tests
carry JAX params across with ``params_from_jax``.  ``stack`` prepends
leading dims (a stack of identical blocks is drawn as one tensor).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention

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


# --------------------------------------------------------------------------
# Attention (GQA / MQA / MHA, causal + sliding window), dense reference;
# the flash kernel replaces it when AttnConfig.use_flash is set
# --------------------------------------------------------------------------

def _attn_mask(q_len: int, kv_len: int, *, causal: bool, window: int | None,
               device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask."""
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Grouped-query attention. q: (B,S,Hq,Dh), k/v: (B,T,Hkv,Dh)."""
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    qg = q.reshape(B, S, Hkv, groups, Dh)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float())
    logits = logits * (1.0 / math.sqrt(Dh))
    mask = _attn_mask(S, T, causal=causal, window=window, device=q.device)
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
    return p


def apply_attention(p: Params, x: torch.Tensor, cfg: AttnConfig, *,
                    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                    ) -> tuple[torch.Tensor, None]:
    """Self- or cross-attention (``cross_kv`` supplies precomputed K/V).
    Returns ``(out, None)``: the second slot is the JAX function's KV-cache
    result, which the port does not have yet."""
    if cfg.rope_theta > 0 and cross_kv is None:
        raise NotImplementedError(
            "rotary embeddings are not yet ported (rope_theta > 0)")
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    if cross_kv is None:
        k = (x @ p["wk"]).reshape(B, S, Hkv, Dh)
        v = (x @ p["wv"]).reshape(B, S, Hkv, Dh)
    else:
        k, v = cross_kv
    causal = cfg.causal and cross_kv is None
    if cfg.use_flash:
        out = flash_attention(q, k, v, causal, cfg.window)
    else:
        out = attention(q, k, v, causal=causal, window=cfg.window)
    out = out.reshape(B, S, H * Dh) @ p["wo"]
    return out, None


# --------------------------------------------------------------------------
# GELU MLP
# --------------------------------------------------------------------------

def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32, device="cuda", stack=()) -> Params:
    return {
        "w_up": dense_init(gen, d_model, d_ff, dtype, device, stack),
        "b_up": torch.zeros((*stack, d_ff), dtype=dtype, device=device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device, stack),
        "b_down": torch.zeros((*stack, d_model), dtype=dtype, device=device),
    }


def apply_gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]
