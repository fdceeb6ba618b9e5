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

Tensor parallelism over ranks (``tp``, a
``runtime.tensor_parallel.TensorParallel``, which ``train.steps``' sharded
builders pass where the plan's TP axis is larger than 1): each leaf's own
shape says whether it is the rank's TP block or whole, and the functions
below take the matching path (dense layers only: MLA, MoE and MTP raise).
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
from repro_torch.runtime.tensor_parallel import VocabLogits
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

def _tp_parts(p: Params, cfg: LMConfig, tp) -> tuple:
    """``(tp_attn, tp_ffn)``: ``tp`` for a layer's attention and FFN where
    their leaves are TP blocks (``wq``'s columns, the FFN's inner dim
    fewer than whole), else None (whole on every rank, computed alike)."""
    if tp is None:
        return None, None
    if cfg.mla is not None or cfg.moe is not None or cfg.mtp:
        raise NotImplementedError(
            "tensor parallelism of MLA, MoE and MTP layers is not ported "
            "(expert parallelism comes first)")
    a = cfg.attn
    attn = tp if p["attn"]["wq"].shape[-1] != a.n_heads * a.head_dim \
        else None
    inner = p["ffn"]["w_up"].shape[-1]
    return attn, (tp if inner != cfg.d_ff else None)


def apply_layer(p: Params, x: torch.Tensor, cfg: LMConfig, *,
                dense_ffn: bool, positions: torch.Tensor | None = None,
                cache: Params | None = None, tp=None
                ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """One decoder layer.  Returns ``(x, new_cache, moe_aux_loss)``.
    ``tp``: the attention and the FFN over tensor parallelism where their
    leaves are TP blocks (:func:`_tp_parts`)."""
    tp_attn, tp_ffn = _tp_parts(p, cfg, tp)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, new_cache = L.apply_mla(p["attn"], h, cfg.mla,
                                   positions=positions, cache=cache)
    else:
        a, new_cache = L.apply_attention(p["attn"], h, cfg.attn,
                                         positions=positions, cache=cache,
                                         tp=tp_attn)
    x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if dense_ffn or cfg.moe is None:
        mlp = L.apply_gelu_mlp if cfg.mlp_gelu else L.apply_swiglu
        f, aux = mlp(p["ffn"], h, tp_ffn), torch.zeros((), device=x.device)
    else:
        f, aux = L.apply_moe(p["ffn"], h, cfg.moe, dispatch=cfg.moe_dispatch)
    return x + f, new_cache, aux


def _apply_layer_remat_tp(p: Params, x: torch.Tensor, cfg: LMConfig, *,
                          positions: torch.Tensor, tp) -> torch.Tensor:
    """:func:`apply_layer` (no cache) recomputed in the backward region by
    region: the attention's and the FFN's rank-local parts are each
    checkpointed up to their partial sums, and the all-reduces after them
    stay outside, so the backward re-issues no forward collective (every
    rank issues the same ones in the same order: the copies' all-reduces
    of the backward).  Saves two activations a layer, the layer's input
    and the attention's residual sum."""
    tp_attn, tp_ffn = _tp_parts(p, cfg, tp)

    def attn(lp, x):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        return L.apply_attention(lp["attn"], h, cfg.attn,
                                 positions=positions, tp=tp_attn,
                                 reduce=False)[0]

    def ffn(lp, x):
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        mlp = L.apply_gelu_mlp if cfg.mlp_gelu else L.apply_swiglu
        return mlp(lp["ffn"], h, tp_ffn, reduce=False)

    a = checkpoint(attn, p, x, use_reentrant=False)
    x = x + (tp_attn.reduce(a) if tp_attn is not None else a)
    f = checkpoint(ffn, p, x, use_reentrant=False)
    if tp_ffn is not None:
        f = tp_ffn.reduce(f)
        if cfg.mlp_gelu:
            f = f + p["ffn"]["b_down"]
    return x + f


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: LMConfig,
                 prefix_embeds: torch.Tensor | None = None,
                 tp=None) -> torch.Tensor:
    """The embedding gather (its gradient a scatter-add into ``embed``),
    with the vision prefix's rows in front.  ``tp`` with ``embed`` the
    rank's block of d: the ``(B, S, d / tp)`` lookup gathered whole
    (``tp.gather``), then the prefix."""
    emb = params["embed"]
    x = emb[tokens.long()].to(cfg.dtype)
    if tp is not None and emb.shape[-1] != cfg.d_model:
        x = tp.gather(x, -1)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.dtype), x], dim=1)
    return x


def unembed(params: Params, x: torch.Tensor, cfg: LMConfig, tp=None):
    """The final norm and the logits.  With ``tp``, a
    ``runtime.tensor_parallel.VocabLogits``:

    - an untied ``head`` split on its vocab: vocab-parallel logits of the
      rank's block (the input through ``tp.copy``);
    - a ``head`` whole over the TP axis (internvl2-2b's odd vocab of
      92,553, which ``fit_spec`` leaves whole): whole logits, alike on
      every rank;
    - tied, ``embed`` the rank's ``(V, d / tp)`` block: of the two ways,
      an all-gather of the matrix's d blocks (each rank sends ``V d /
      tp`` elements a peer) followed by vocab-parallel logits (``tp.gather
      (partial=True)``: the backward reduce-scatters the matrix's
      gradient), or an all-reduce of every rank's partial ``(rows, V)``
      logits of its d block (``rows x V`` elements a peer), the cheaper:
      the gather when ``rows x tp > d`` (smollm-360m's prefill at S=32768:
      94 MB against 3.2 GB a row in bf16), the all-reduce for a few rows
      (a decode step: 2 rows, 196 KB against 94 MB).  Every rank of the
      axis holds the same rows, so all take the same way."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    V = cfg.vocab
    if tp is None:
        w = params["embed"].T if cfg.tied_embeddings else params["head"]
        return x @ w.to(x.dtype)
    if not cfg.tied_embeddings:
        head = params["head"]
        if head.shape[-1] == V:
            return VocabLogits(x @ head.to(x.dtype), 0, V)
        v0, _ = tp.block(V)
        return VocabLogits(tp.copy(x) @ head.to(x.dtype), v0, V)
    emb = params["embed"]
    if emb.shape[-1] == cfg.d_model:
        return VocabLogits(x @ emb.T.to(x.dtype), 0, V)
    rows = x.numel() // x.shape[-1]
    if rows * tp.size <= cfg.d_model:
        part = tp.split(x, -1) @ emb.T.to(x.dtype)
        return VocabLogits(tp.reduce(part), 0, V)
    if V % tp.size:
        return VocabLogits(x @ tp.gather(emb, -1).T.to(x.dtype), 0, V)
    v0, v1 = tp.block(V)
    w = tp.gather(emb, -1, partial=True)[v0:v1]
    return VocabLogits(tp.copy(x) @ w.T.to(x.dtype), v0, V)


def _scan_layers(stack: Params, x: torch.Tensor, cfg: LMConfig, *,
                 dense_ffn: bool, positions: torch.Tensor,
                 caches: Params | None = None, tp=None
                 ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """The stack's rows in order (``lax.scan`` in JAX); with ``remat`` and
    no caches each layer is recomputed in the backward (over tensor
    parallelism region by region: :func:`_apply_layer_remat_tp`).
    ``caches``: the stack's caches (one ``pos``), row ``i`` layer ``i``'s,
    written in place.  Returns ``(x, new_caches, aux)``."""
    def body(lp, x):
        x, _, a = apply_layer(lp, x, cfg, dense_ffn=dense_ffn,
                              positions=positions, tp=tp)
        return x, a

    n = stack["ln1"].shape[0]
    aux = torch.zeros((), device=x.device)
    for i in range(n):
        lp = tree_index(stack, i)
        if caches is not None:
            cache = {k: v if k == "pos" else v[i] for k, v in caches.items()}
            x, new, a = apply_layer(lp, x, cfg, dense_ffn=dense_ffn,
                                    positions=positions, cache=cache, tp=tp)
        elif cfg.remat and torch.is_grad_enabled() and tp is not None:
            x, a = _apply_layer_remat_tp(lp, x, cfg, positions=positions,
                                         tp=tp), 0.0
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
            positions: torch.Tensor | None = None, tp=None,
            ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Full forward -> ``(hidden (B,S,d), new_caches, moe_aux)``.

    ``caches``: ``{"dense": stacked, "layers": stacked}`` or None; ``tp``:
    tensor parallelism (the module docstring)."""
    x = embed_tokens(params, tokens, cfg, prefix_embeds, tp=tp)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)
    new_caches: Params = {}
    if "dense_layers" in params:
        x, nc, a = _scan_layers(params["dense_layers"], x, cfg,
                                dense_ffn=True, positions=positions,
                                caches=caches["dense"] if caches else None,
                                tp=tp)
        aux = aux + a
        new_caches["dense"] = nc
    x, nc, a = _scan_layers(params["layers"], x, cfg, dense_ffn=False,
                            positions=positions,
                            caches=caches["layers"] if caches else None,
                            tp=tp)
    new_caches["layers"] = nc
    return x, (new_caches if caches is not None else None), aux + a


# --------------------------------------------------------------------------
# losses / serving steps
# --------------------------------------------------------------------------

def softmax_xent(logits, labels: torch.Tensor,
                 mask: torch.Tensor | None = None, tp=None) -> torch.Tensor:
    """Mean token cross-entropy, the log-sum-exp in fp32.  With ``tp``,
    ``logits`` are ``VocabLogits`` (:func:`unembed`'s): the vocab-parallel
    cross-entropy (``TensorParallel.xent``)."""
    if tp is not None:
        nll = tp.xent(logits, labels)
    else:
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels.long()[..., None])[..., 0] - logz
        nll = -ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def lm_loss(params: Params, batch: dict, cfg: LMConfig,
            tp=None) -> torch.Tensor:
    """Causal LM loss. batch: {"tokens": (B,S) int, "prefix_embeds"?};
    ``tp``: tensor parallelism (the module docstring)."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    h, _, aux = forward(params, tokens, cfg, prefix_embeds=prefix, tp=tp)
    P = cfg.vision_prefix if prefix is not None else 0
    h_text = h[:, P:]
    logits = unembed(params, h_text[:, :-1], cfg, tp=tp)
    loss = softmax_xent(logits, tokens[:, 1:], tp=tp)
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
            max_len: int, *, prefix_embeds: torch.Tensor | None = None,
            caches: Params | None = None, tp=None
            ) -> tuple[torch.Tensor, Params]:
    """Prime a KV cache with a prompt; returns (last-token logits, caches).
    ``caches``: zero caches to prime (else ``init_caches``' of ``max_len``
    rows); with ``tp`` they are the rank's blocks under the serve step's
    cache specs, and the logits ``VocabLogits``."""
    if caches is None:
        caches = init_caches(cfg, tokens.shape[0], max_len,
                             device=tokens.device)
    h, caches, _ = forward(params, tokens, cfg, prefix_embeds=prefix_embeds,
                           caches=caches, tp=tp)
    return unembed(params, h[:, -1:], cfg, tp=tp), caches


def decode_step(params: Params, token: torch.Tensor, caches: Params,
                cfg: LMConfig, tp=None) -> tuple[torch.Tensor, Params]:
    """One greedy decode step. token: (B,1) int.  With ``tp`` the logits
    are ``VocabLogits`` (:func:`unembed`)."""
    pos = caches["layers"]["pos"]
    positions = torch.full((1, 1), pos, device=token.device)
    h, caches, _ = forward(params, token, cfg, caches=caches,
                           positions=positions, tp=tp)
    return unembed(params, h, cfg, tp=tp), caches


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
