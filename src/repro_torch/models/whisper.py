"""Whisper-style encoder-decoder (the port of ``repro.models.whisper``;
audio frontend stubbed).

As in the JAX module, the conv frontend is a STUB: the batch carries
precomputed frame embeddings ``(B, T_frames, d)``.  The transformer backbone
is real: a bidirectional encoder, a causal decoder with cross-attention over
the encoded frames, the readout tied to ``tok_embed``.

Encoder and decoder layers are stacked with a leading ``[n_layers, ...]``
dim, as JAX's ``vmap`` stacks them, and run in a loop over the rows (the
JAX ``lax.scan``).  Leaf names and ``(in, out)`` layouts are the JAX
package's, so ``repro_torch.convert.params_from_jax`` carries a JAX tree.
With ``use_flash`` every attention (encoder self, decoder causal self and
cross) runs the flash-attention kernel, the decoder's self-attention over
its KV cache too.  Serving: ``init_dec_caches`` stacks one cache per
decoder layer (``{"k": (L, B, max_len, H, Dh), "v": ..., "pos": int}``),
``prefill`` encodes the frames and primes the caches with the prompt,
``decode_step`` appends a token; the cross K/V are recomputed from
``enc_out`` at every step, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import AttnConfig, Params
from repro_torch.models.lm import softmax_xent
from repro_torch.tree import tree_index

MAX_POSITIONS = 4096      # the decoder's sinusoid table (JAX: _sinusoid(4096))


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str
    vocab: int
    d_model: int
    n_enc_layers: int
    n_dec_layers: int
    n_heads: int
    d_ff: int
    norm_eps: float = 1e-5
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    use_flash: bool = False       # flash-attention kernel, not `attention`

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def attn_cfg(self, causal: bool) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_heads,
                          self.head_dim, rope_theta=0.0, causal=causal,
                          use_flash=self.use_flash)

    def param_count(self) -> int:
        d = self.d_model
        per_enc = 4 * d * d + 2 * d * self.d_ff
        per_dec = 8 * d * d + 2 * d * self.d_ff
        return (self.vocab * d + self.n_enc_layers * per_enc
                + self.n_dec_layers * per_dec)


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _norm(pd, device, stack, d, fill):
    return torch.full((*stack, d), fill, dtype=pd, device=device)


def _init_enc_layer(gen: torch.Generator, cfg: WhisperConfig, device="cuda",
                    stack=()) -> Params:
    d, pd = cfg.d_model, cfg.param_dtype
    return {
        "ln1": _norm(pd, device, stack, d, 1.0),
        "b1": _norm(pd, device, stack, d, 0.0),
        "attn": L.init_attention(gen, cfg.attn_cfg(False), pd, device, stack),
        "ln2": _norm(pd, device, stack, d, 1.0),
        "b2": _norm(pd, device, stack, d, 0.0),
        "mlp": L.init_gelu_mlp(gen, d, cfg.d_ff, pd, device, stack),
    }


def _init_dec_layer(gen: torch.Generator, cfg: WhisperConfig, device="cuda",
                    stack=()) -> Params:
    d, pd = cfg.d_model, cfg.param_dtype
    return {
        "ln1": _norm(pd, device, stack, d, 1.0),
        "b1": _norm(pd, device, stack, d, 0.0),
        "attn": L.init_attention(gen, cfg.attn_cfg(True), pd, device, stack),
        "lnx": _norm(pd, device, stack, d, 1.0),
        "bx": _norm(pd, device, stack, d, 0.0),
        "xattn": L.init_attention(gen, cfg.attn_cfg(False), pd, device,
                                  stack),
        "ln2": _norm(pd, device, stack, d, 1.0),
        "b2": _norm(pd, device, stack, d, 0.0),
        "mlp": L.init_gelu_mlp(gen, d, cfg.d_ff, pd, device, stack),
    }


def init_whisper(gen: torch.Generator, cfg: WhisperConfig,
                 device="cuda") -> Params:
    """The params, drawn from ``gen`` on ``device``, each layer stack one
    tensor per leaf."""
    d, pd = cfg.d_model, cfg.param_dtype
    return {
        "enc_layers": _init_enc_layer(gen, cfg, device, (cfg.n_enc_layers,)),
        "enc_norm": _norm(pd, device, (), d, 1.0),
        "enc_norm_b": _norm(pd, device, (), d, 0.0),
        "tok_embed": L.dense_init(gen, cfg.vocab, d, pd, device),
        "dec_layers": _init_dec_layer(gen, cfg, device, (cfg.n_dec_layers,)),
        "dec_norm": _norm(pd, device, (), d, 1.0),
        "dec_norm_b": _norm(pd, device, (), d, 0.0),
    }


def encode(params: Params, frames: torch.Tensor,
           cfg: WhisperConfig) -> torch.Tensor:
    """frames: (B, T, d) stubbed frame embeddings -> (B, T, d)."""
    x = (frames.to(cfg.dtype)
         + _sinusoid(frames.shape[1], cfg.d_model,
                     frames.device).to(cfg.dtype)[None])
    stack = params["enc_layers"]
    for i in range(stack["ln1"].shape[0]):
        lp = tree_index(stack, i)
        h = L.layer_norm(x, lp["ln1"], lp["b1"], cfg.norm_eps)
        a, _ = L.apply_attention(lp["attn"], h, cfg.attn_cfg(False))
        x = x + a
        h = L.layer_norm(x, lp["ln2"], lp["b2"], cfg.norm_eps)
        x = x + L.apply_gelu_mlp(lp["mlp"], h)
    return L.layer_norm(x, params["enc_norm"], params["enc_norm_b"],
                        cfg.norm_eps)


def decode(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
           cfg: WhisperConfig, *, caches: Params | None = None,
           positions: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, Params | None]:
    """The causal decoder over ``tokens`` (B, S), cross-attending to
    ``enc_out`` (B, T, d).  Returns ``(hidden, new_caches)``: with
    ``caches`` (stacked over the decoder layers, written in place) the
    self-attention reads and extends them, else ``None``."""
    x = params["tok_embed"][tokens.long()].to(cfg.dtype)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    x = x + _sinusoid(MAX_POSITIONS, cfg.d_model, x.device).to(
        cfg.dtype)[positions[0]][None]
    B, T = enc_out.shape[0], enc_out.shape[1]
    stack = params["dec_layers"]
    pos = caches["pos"] if caches is not None else None
    for i in range(stack["ln1"].shape[0]):
        lp = tree_index(stack, i)
        h = L.layer_norm(x, lp["ln1"], lp["b1"], cfg.norm_eps)
        cache = None
        if caches is not None:
            cache = {"k": caches["k"][i], "v": caches["v"][i], "pos": pos}
        a, new = L.apply_attention(lp["attn"], h, cfg.attn_cfg(True),
                                   positions=positions, cache=cache)
        x = x + a
        h = L.layer_norm(x, lp["lnx"], lp["bx"], cfg.norm_eps)
        kx = (enc_out @ lp["xattn"]["wk"]).reshape(B, T, cfg.n_heads,
                                                   cfg.head_dim)
        vx = (enc_out @ lp["xattn"]["wv"]).reshape(B, T, cfg.n_heads,
                                                   cfg.head_dim)
        a, _ = L.apply_attention(lp["xattn"], h, cfg.attn_cfg(False),
                                 cross_kv=(kx, vx))
        x = x + a
        h = L.layer_norm(x, lp["ln2"], lp["b2"], cfg.norm_eps)
        x = x + L.apply_gelu_mlp(lp["mlp"], h)
    x = L.layer_norm(x, params["dec_norm"], params["dec_norm_b"],
                     cfg.norm_eps)
    if caches is None:
        return x, None
    return x, {**caches, "pos": new["pos"]}


def whisper_loss(params: Params, batch: dict,
                 cfg: WhisperConfig) -> torch.Tensor:
    """batch: {"frames": (B,T,d), "tokens": (B,S)}: the next-token loss of
    ``tokens[:, 1:]`` through the tied readout."""
    enc = encode(params, batch["frames"], cfg)
    h, _ = decode(params, batch["tokens"][:, :-1], enc, cfg)
    logits = h @ params["tok_embed"].T.to(h.dtype)
    return softmax_xent(logits, batch["tokens"][:, 1:])


def init_dec_caches(cfg: WhisperConfig, batch: int, max_len: int,
                    device="cuda") -> Params:
    return L.init_kv_cache(batch, max_len, cfg.attn_cfg(True), cfg.dtype,
                           device, (cfg.n_dec_layers,))


def prefill(params: Params, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: WhisperConfig, max_len: int
            ) -> tuple[torch.Tensor, torch.Tensor, Params]:
    """Encode audio + prime decoder cache. Returns (logits, enc_out, caches)."""
    enc = encode(params, frames, cfg)
    caches = init_dec_caches(cfg, tokens.shape[0], max_len, tokens.device)
    h, caches = decode(params, tokens, enc, cfg, caches=caches)
    logits = h[:, -1:] @ params["tok_embed"].T.to(h.dtype)
    return logits, enc, caches


def decode_step(params: Params, token: torch.Tensor, enc_out: torch.Tensor,
                caches: Params, cfg: WhisperConfig
                ) -> tuple[torch.Tensor, Params]:
    positions = torch.full((1, 1), caches["pos"], device=token.device)
    h, caches = decode(params, token, enc_out, cfg, caches=caches,
                       positions=positions)
    return h @ params["tok_embed"].T.to(h.dtype), caches
