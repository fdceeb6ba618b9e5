"""The decoder-LM family (the port of ``repro.models.lm``).

One configurable decoder-only implementation covers smollm-360m,
h2o-danube-1.8b (sliding window), internlm2-20b, granite-34b (MQA, GELU
MLP), internvl2-2b (vision prefix), qwen3-moe-30b-a3b (MoE + qk-norm) and
deepseek-v3-671b (MLA + shared/routed MoE + dense prelude + MTP).

Layers are stacked with a leading ``[n_layers, ...]`` dim, as in JAX, so
the pipeline cuts ``params["layers"]`` into stage rows; deepseek's dense
prelude lives apart in ``dense_layers``.  Leaf names and ``(in, out)``
layouts are the JAX package's, so a JAX params tree converts with
``repro_torch.convert.params_from_jax``.

``_scan_layers`` is a loop over a stack's rows; ``remat`` recomputes each
layer in the backward (``torch.utils.checkpoint``), as ``jax.checkpoint``
does per scanned layer.  Serving: ``init_caches`` stacks one KV cache per
layer as JAX does, ``{"layers": {"k": (L, B, max_len, Hkv, Dh), "v": ...,
"pos": int}}`` (deepseek: MLA's ``kv``/``k_rope`` and a ``"dense"``
stack), ``prefill`` primes it with a prompt and ``decode_step`` appends a
token; a layer's cache is its row of the stack, written in place.  Not
ported: the JAX config's ``remat_policy`` and ``seq_shard_activations``
(a GSPMD sharding hint, with no meaning in one process), which are no
fields here: no config sets them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.graph import Block, BlockGraph
from repro_torch.core.hw import Hardware, H100_SXM
from repro_torch.core.profiler import analytic_block_costs
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnConfig, MLAConfig, MoEConfig, Params
from repro_torch.tree import tree_index


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    attn: AttnConfig | None = None
    mla: MLAConfig | None = None
    d_ff: int = 0                      # SwiGLU FFN size (dense layers)
    moe: MoEConfig | None = None       # MoE FFN (replaces dense except prelude)
    n_dense_layers: int = 0            # deepseek: first k layers dense
    tied_embeddings: bool = False
    mtp: bool = False                  # multi-token prediction head
    norm_eps: float = 1e-6
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    vision_prefix: int = 0             # of stubbed patch-embedding tokens
    moe_aux_weight: float = 0.01
    mtp_weight: float = 0.3
    moe_dispatch: str = "onehot"
    mlp_gelu: bool = False             # 2-matrix GELU MLP (gpt_bigcode/granite)
    remat: bool = False                # checkpoint each layer in the loop

    @property
    def head_dim(self) -> int:
        return self.attn.head_dim if self.attn else self.mla.v_head_dim

    def param_count(self) -> int:
        """Approximate total parameters (for roofline MODEL_FLOPS)."""
        d = self.d_model
        emb = self.vocab * d * (1 if self.tied_embeddings else 2)
        if self.mla:
            m = self.mla
            attn = (d * m.q_lora_rank + m.q_lora_rank * m.n_heads *
                    (m.qk_nope_dim + m.qk_rope_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * m.n_heads * (m.qk_nope_dim + m.v_head_dim)
                    + m.n_heads * m.v_head_dim * d)
        else:
            a = self.attn
            attn = d * a.head_dim * (a.n_heads * 2 + a.n_kv_heads * 2)
        dense_ffn = (2 if self.mlp_gelu else 3) * d * self.d_ff
        n_moe = self.n_layers - self.n_dense_layers if self.moe else 0
        n_dense = self.n_layers - n_moe
        total = emb + self.n_layers * attn + n_dense * dense_ffn
        if self.moe:
            c = self.moe
            per_expert = 3 * d * c.d_ff
            shared = 3 * d * (c.shared_d_ff or c.d_ff) * c.n_shared
            total += n_moe * (c.n_experts * per_expert + shared + d * c.n_experts)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k + shared experts)."""
        if not self.moe:
            return self.param_count()
        d, c = self.d_model, self.moe
        n_moe = self.n_layers - self.n_dense_layers
        inactive = n_moe * (c.n_experts - c.top_k) * 3 * d * c.d_ff
        return self.param_count() - inactive


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: LMConfig, dense_ffn: bool,
                device="cuda", stack=()) -> Params:
    d, pd = cfg.d_model, cfg.param_dtype
    kw = dict(dtype=pd, device=device, stack=stack)
    p: Params = {"ln1": torch.ones((*stack, d), dtype=pd, device=device),
                 "ln2": torch.ones((*stack, d), dtype=pd, device=device)}
    if cfg.mla is not None:
        p["attn"] = L.init_mla(gen, cfg.mla, **kw)
    else:
        p["attn"] = L.init_attention(gen, cfg.attn, **kw)
    if dense_ffn or cfg.moe is None:
        init = L.init_gelu_mlp if cfg.mlp_gelu else L.init_swiglu
        p["ffn"] = init(gen, d, cfg.d_ff, pd, device, stack)
    else:
        p["ffn"] = L.init_moe(gen, cfg.moe, **kw)
    return p


def init_lm(gen: torch.Generator, cfg: LMConfig, device="cuda") -> Params:
    """The params, drawn from ``gen`` on ``device``: each stack of identical
    layers as one tensor per leaf."""
    d, pd = cfg.d_model, cfg.param_dtype
    params: Params = {
        "embed": L.dense_init(gen, cfg.vocab, d, pd, device),
        "final_norm": torch.ones((d,), dtype=pd, device=device),
    }
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe else cfg.n_layers
    n_dense = cfg.n_layers - n_moe
    if n_dense:
        params["dense_layers"] = _init_layer(gen, cfg, True, device,
                                             (n_dense,))
    params["layers"] = _init_layer(gen, cfg, cfg.moe is None, device,
                                   (n_moe,))
    if not cfg.tied_embeddings:
        params["head"] = L.dense_init(gen, d, cfg.vocab, pd, device)
    if cfg.mtp:
        params["mtp"] = {
            "proj": L.dense_init(gen, 2 * d, d, pd, device),
            "norm_h": torch.ones((d,), dtype=pd, device=device),
            "norm_e": torch.ones((d,), dtype=pd, device=device),
            "block": _init_layer(gen, cfg, True, device),
        }
    return params


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def apply_layer(p: Params, x: torch.Tensor, cfg: LMConfig, *,
                dense_ffn: bool, positions: torch.Tensor | None = None,
                cache: Params | None = None
                ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """One decoder layer.  Returns ``(x, new_cache, moe_aux_loss)``."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, new_cache = L.apply_mla(p["attn"], h, cfg.mla,
                                   positions=positions, cache=cache)
    else:
        a, new_cache = L.apply_attention(p["attn"], h, cfg.attn,
                                         positions=positions, cache=cache)
    x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if dense_ffn or cfg.moe is None:
        mlp = L.apply_gelu_mlp if cfg.mlp_gelu else L.apply_swiglu
        f, aux = mlp(p["ffn"], h), torch.zeros((), device=x.device)
    else:
        f, aux = L.apply_moe(p["ffn"], h, cfg.moe, dispatch=cfg.moe_dispatch)
    return x + f, new_cache, aux


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: LMConfig,
                 prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The embedding gather (its gradient a scatter-add into ``embed``),
    with the vision prefix's rows in front."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.dtype), x], dim=1)
    return x


def unembed(params: Params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tied_embeddings else params["head"]
    return x @ w.to(x.dtype)


def _scan_layers(stack: Params, x: torch.Tensor, cfg: LMConfig, *,
                 dense_ffn: bool, positions: torch.Tensor,
                 caches: Params | None = None
                 ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """The stack's rows in order (``lax.scan`` in JAX); with ``remat`` and
    no caches each layer is recomputed in the backward.  ``caches``: the
    stack's caches (one ``pos``), row ``i`` layer ``i``'s, written in
    place.  Returns ``(x, new_caches, aux)``."""
    def body(lp, x):
        x, _, a = apply_layer(lp, x, cfg, dense_ffn=dense_ffn,
                              positions=positions)
        return x, a

    n = stack["ln1"].shape[0]
    aux = torch.zeros((), device=x.device)
    for i in range(n):
        lp = tree_index(stack, i)
        if caches is not None:
            cache = {k: v if k == "pos" else v[i] for k, v in caches.items()}
            x, new, a = apply_layer(lp, x, cfg, dense_ffn=dense_ffn,
                                    positions=positions, cache=cache)
        elif cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(body, lp, x, use_reentrant=False)
        else:
            x, a = body(lp, x)
        aux = aux + a
    if caches is None:
        return x, None, aux
    return x, {**caches, "pos": new["pos"]}, aux


def forward(params: Params, tokens: torch.Tensor, cfg: LMConfig, *,
            prefix_embeds: torch.Tensor | None = None,
            caches: Params | None = None,
            positions: torch.Tensor | None = None,
            ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Full forward -> ``(hidden (B,S,d), new_caches, moe_aux)``.

    ``caches``: ``{"dense": stacked, "layers": stacked}`` or None."""
    x = embed_tokens(params, tokens, cfg, prefix_embeds)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)
    new_caches: Params = {}
    if "dense_layers" in params:
        x, nc, a = _scan_layers(params["dense_layers"], x, cfg,
                                dense_ffn=True, positions=positions,
                                caches=caches["dense"] if caches else None)
        aux = aux + a
        new_caches["dense"] = nc
    x, nc, a = _scan_layers(params["layers"], x, cfg, dense_ffn=False,
                            positions=positions,
                            caches=caches["layers"] if caches else None)
    new_caches["layers"] = nc
    return x, (new_caches if caches is not None else None), aux + a


# --------------------------------------------------------------------------
# losses / serving steps
# --------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy, the log-sum-exp in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0] - logz
    nll = -ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def lm_loss(params: Params, batch: dict, cfg: LMConfig) -> torch.Tensor:
    """Causal LM loss. batch: {"tokens": (B,S) int, "prefix_embeds"?}."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    h, _, aux = forward(params, tokens, cfg, prefix_embeds=prefix)
    P = cfg.vision_prefix if prefix is not None else 0
    h_text = h[:, P:]
    logits = unembed(params, h_text[:, :-1], cfg)
    loss = softmax_xent(logits, tokens[:, 1:])
    if cfg.mtp:
        loss = loss + cfg.mtp_weight * _mtp_loss(params, h_text, tokens, cfg)
    return loss + cfg.moe_aux_weight * aux


def _mtp_loss(params: Params, h: torch.Tensor, tokens: torch.Tensor,
              cfg: LMConfig) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction: predict token t+2 from the main
    stream's hidden at t combined with the embedding of token t+1."""
    mp = params["mtp"]
    h_in = L.rms_norm(h[:, :-2], mp["norm_h"], cfg.norm_eps)
    e_in = L.rms_norm(params["embed"][tokens[:, 1:-1].long()].to(h.dtype),
                      mp["norm_e"], cfg.norm_eps)
    merged = torch.cat([h_in, e_in], dim=-1) @ mp["proj"].to(h.dtype)
    pos = torch.arange(merged.shape[1], device=h.device)[None, :]
    out, _, _ = apply_layer(mp["block"], merged, cfg, dense_ffn=True,
                            positions=pos)
    logits = unembed(params, out, cfg)
    return softmax_xent(logits, tokens[:, 2:])


def init_caches(cfg: LMConfig, batch: int, max_len: int, dtype=None,
                device="cuda") -> Params:
    """Zero KV caches of ``max_len`` rows, stacked over each layer group
    (``"layers"``, and deepseek's ``"dense"`` prelude), in ``cfg.dtype``
    unless ``dtype`` is given."""
    dtype = dtype or cfg.dtype
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe else cfg.n_layers
    n_dense = cfg.n_layers - n_moe

    def stack(n: int) -> Params:
        if cfg.mla is not None:
            return L.init_mla_cache(batch, max_len, cfg.mla, dtype, device,
                                    (n,))
        return L.init_kv_cache(batch, max_len, cfg.attn, dtype, device, (n,))

    caches: Params = {"layers": stack(n_moe)}
    if n_dense:
        caches["dense"] = stack(n_dense)
    return caches


def prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig,
            max_len: int, *, prefix_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, Params]:
    """Prime a KV cache with a prompt; returns (last-token logits, caches)."""
    caches = init_caches(cfg, tokens.shape[0], max_len, device=tokens.device)
    h, caches, _ = forward(params, tokens, cfg, prefix_embeds=prefix_embeds,
                           caches=caches)
    return unembed(params, h[:, -1:], cfg), caches


def decode_step(params: Params, token: torch.Tensor, caches: Params,
                cfg: LMConfig) -> tuple[torch.Tensor, Params]:
    """One greedy decode step. token: (B,1) int."""
    pos = caches["layers"]["pos"]
    positions = torch.full((1, 1), pos, device=token.device)
    h, caches, _ = forward(params, token, cfg, caches=caches,
                           positions=positions)
    return unembed(params, h, cfg), caches


# --------------------------------------------------------------------------
# PULSE planner export (runtime-aligned: one block per decoder layer)
# --------------------------------------------------------------------------

def lm_pipeline_graph(cfg: LMConfig, batch: int = 1, seq: int = 512,
                      fwd_times=None, hw: Hardware = H100_SXM) -> BlockGraph:
    """Block graph for the auto-pipeline compile path.

    One block per decoder layer; embeddings / head / norms are edge params
    (replicated) and excluded, so the graph lines up 1:1 with the stacked
    block parameters the executor splits.  ``fwd_times`` overrides the
    analytic roofline estimate with profiled per-layer times.  ``hw``
    defaults to ``H100_SXM``, where the JAX function defaults to its TPU
    preset.
    """
    d, ff = cfg.d_model, cfg.d_ff
    act = batch * seq * d * 2
    flops = 2 * batch * seq * (4 * d * d + 2 * d * ff)
    per_param = (4 * d * d + 2 * d * ff) * 2
    blocks = [Block(f"layer{i}", 0.0, per_param, act, 0, flops)
              for i in range(cfg.n_layers)]
    blocks = list(analytic_block_costs(blocks, hw))
    if fwd_times is not None:
        if len(fwd_times) != cfg.n_layers:
            raise ValueError("fwd_times must have one entry per layer")
        blocks = [dataclasses.replace(b, fwd_time=float(t))
                  for b, t in zip(blocks, fwd_times)]
    return BlockGraph(tuple(blocks))
