"""xLSTM: mLSTM (matrix-memory) and sLSTM (scalar-memory) blocks (the port
of ``repro.models.xlstm``).

mLSTM has two equivalent forms, as in JAX: the stabilized parallel form (a
gated-linear-attention quadratic form) trains, the O(1)-state recurrent
form (``mlstm_recurrent``) decodes.  sLSTM runs a loop over time with its
recurrent h feedback, autograd through the loop.  Decoding
(``init_states``, ``decode_step``, ``forward(states=)``) steps one token at
a time through each block's state: the mLSTM cell ``{"C", "n", "m"}`` or
the sLSTM cell ``{"h", "c", "n", "m"}``, and the causal conv's last
``conv_width - 1`` inputs.  The recurrent state is the model's "KV cache"
analogue: it does not grow with the sequence.

Block layout, as in the JAX module: pre-norm, up-projection, causal conv(4)
+ SiLU on the q/k path, the cell, a per-channel norm, the output gate,
down-projection, residual.  Layer ``i`` is an sLSTM block iff ``i %
slstm_every == slstm_every - 1``; ``init_xlstm`` makes a heterogeneous list
of blocks, as JAX does (not stacked).

dtypes follow JAX's promotion: ``mlstm_parallel`` and ``slstm_scan`` return
fp32, so after the first block a bf16 config's residual stream is fp32 and
its matmuls against bf16 weights run in fp32 (``promoted_matmul``, where
PyTorch would refuse the mixed dtypes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import Params, promoted_matmul as mm
from repro_torch.models.lm import softmax_xent


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    slstm_every: int = 6          # layer i is sLSTM iff i % slstm_every == slstm_every-1
    conv_width: int = 4
    proj_factor: float = 2.0      # mLSTM up-projection factor
    norm_eps: float = 1e-6
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    tied_embeddings: bool = True

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    def is_slstm(self, layer: int) -> bool:
        return (self.slstm_every > 0
                and layer % self.slstm_every == self.slstm_every - 1)

    def param_count(self) -> int:
        """Rough analytic parameter count (mLSTM-block dominated), the JAX
        config's: it counts neither the sLSTM blocks' own shapes, nor the
        convs and norms."""
        d, di = self.d_model, self.d_inner
        per_block = 2 * d * di + di * d + 3 * di * di + 2 * di * self.n_heads
        return self.vocab * d + self.n_layers * per_block


# --------------------------------------------------------------------------
# mLSTM cell
# --------------------------------------------------------------------------

def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
    """Stabilized parallel form.

    q,k,v: (B,S,H,Dh); i_pre,f_pre: (B,S,H) pre-activations.
    Returns h: (B,S,H,Dh) in fp32.  ``log D[t,s]`` for s > t is masked to
    -inf before the row max and the exp, as in JAX.
    """
    B, S, H, Dh = q.shape
    q = q.float() / math.sqrt(Dh)
    k, v = k.float(), v.float()
    log_f = F.logsigmoid(f_pre.float())                           # (B,S,H)
    Fc = torch.cumsum(log_f, dim=1)                               # (B,S,H)
    # log D[t,s] = F[t] - F[s] + i[s], masked to s <= t
    logD = (Fc[:, :, None, :] - Fc[:, None, :, :]
            + i_pre.float()[:, None, :, :])                       # (B,t,s,H)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logD = torch.where(mask[None, :, :, None], logD, -math.inf)
    m = logD.amax(dim=2)                                          # (B,t,H)
    D = torch.exp(logD - m[:, :, None, :])                        # (B,t,s,H)
    scores = torch.einsum("bthd,bshd->btsh", q, k) * D
    n = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-m))     # (B,t,H)
    return torch.einsum("btsh,bshd->bthd", scores, v) / n[..., None]


def mlstm_recurrent(state: Params, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, i_pre: torch.Tensor, f_pre: torch.Tensor
                    ) -> tuple[torch.Tensor, Params]:
    """One step. q,k,v: (B,H,Dh); i_pre,f_pre: (B,H).
    state: {"C": (B,H,Dh,Dh), "n": (B,H,Dh), "m": (B,H)}, fp32.  Returns
    ``(h (B,H,Dh) fp32, new state)``."""
    Dh = q.shape[-1]
    q = q.float() / math.sqrt(Dh)
    k, v = k.float(), v.float()
    log_f = F.logsigmoid(f_pre.float())
    i_ = i_pre.float()
    m_new = torch.maximum(log_f + state["m"], i_)
    a = torch.exp(log_f + state["m"] - m_new)[..., None]          # (B,H,1)
    b = torch.exp(i_ - m_new)[..., None]
    C = state["C"] * a[..., None] + b[..., None] * (v[..., :, None]
                                                    * k[..., None, :])
    n = state["n"] * a + b * k
    num = torch.einsum("bhvd,bhd->bhv", C, q)                     # (B,H,Dh)
    den = torch.maximum((n * q).sum(-1).abs(), torch.exp(-m_new))
    return num / den[..., None], {"C": C, "n": n, "m": m_new}


def init_mlstm_state(batch: int, H: int, Dh: int, device="cuda") -> Params:
    return {
        "C": torch.zeros((batch, H, Dh, Dh), device=device),
        "n": torch.zeros((batch, H, Dh), device=device),
        "m": torch.full((batch, H), -1e30, device=device),
    }


# --------------------------------------------------------------------------
# sLSTM cell (per-head vector memories, recurrent h feedback)
# --------------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


def slstm_scan(p: Params, x: torch.Tensor,
               state: Params) -> tuple[torch.Tensor, Params]:
    """x: (B,S,Di).  A loop over time; the gates take x_t and h_{t-1}.
    state: {"h","c","n","m"} each (B,Di), fp32.  Returns ``(h (B,S,Di) in
    x.dtype, final state)``.

    The gates' input halves ``x_t @ w*`` are one matmul over every step
    before the loop (the same rows the JAX step computes one at a time),
    and the four recurrent matmuls ``h @ r*`` one matmul against their
    concatenation; x and the state are fp32, so bf16 weights are promoted,
    as JAX promotes them."""
    B, S, Di = x.shape
    x32 = x.float()
    w = torch.cat([p[f"w{g}"] for g in GATES], dim=1)
    r = torch.cat([p[f"r{g}"] for g in GATES], dim=1).float()
    xw = mm(x32, w)                                               # (B,S,4Di)
    st = state
    floor = x32.new_tensor(1e-6)        # torch.maximum splits ties as JAX's
    hs = []
    for t in range(S):
        pre = xw[:, t] + st["h"] @ r
        zi, ii, ff, oo = pre.split(Di, dim=-1)
        z = torch.tanh(zi)
        log_f = F.logsigmoid(ff)
        m_new = torch.maximum(log_f + st["m"], ii)
        i_s = torch.exp(ii - m_new)
        f_s = torch.exp(log_f + st["m"] - m_new)
        c = f_s * st["c"] + i_s * z
        n = torch.maximum(f_s * st["n"] + i_s, floor)
        h = torch.sigmoid(oo) * (c / n)
        st = {"h": h, "c": c, "n": n, "m": m_new}
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), st


def init_slstm_state(batch: int, d_inner: int, device="cuda") -> Params:
    z = torch.zeros((batch, d_inner), dtype=torch.float32, device=device)
    return {"h": z, "c": z, "n": z + 1e-6,
            "m": torch.full((batch, d_inner), -1e30, device=device)}


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _init_conv(gen: torch.Generator, width: int, channels: int, dtype,
               device="cuda") -> torch.Tensor:
    return L.normal(gen, (width, channels), 1.0 / math.sqrt(width), dtype,
                    device)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Depthwise causal conv. x: (B,S,C), w: (W,C).  With ``state``
    (B,W-1,C), the last W-1 inputs before x, the streaming (decode)
    convolution: returns ``(out, new_state)`` in x's dtype, else ``(out,
    None)``."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        pad = F.pad(x, (0, 0, W - 1, 0))
        new_state = None
    else:
        pad = torch.cat([state.to(x.dtype), x], dim=1)
        new_state = pad[:, -(W - 1):]
    out = sum(pad[:, i:i + S] * w[i] for i in range(W))
    return out, new_state


def init_mlstm_block(gen: torch.Generator, cfg: XLSTMConfig,
                     device="cuda") -> Params:
    d, di, pd = cfg.d_model, cfg.d_inner, cfg.param_dtype
    H = cfg.n_heads
    return {
        "ln": torch.ones((d,), dtype=pd, device=device),
        "w_up": L.dense_init(gen, d, 2 * di, pd, device),
        "conv": _init_conv(gen, cfg.conv_width, di, pd, device),
        "wq": L.dense_init(gen, di, di, pd, device),
        "wk": L.dense_init(gen, di, di, pd, device),
        "wv": L.dense_init(gen, di, di, pd, device),
        "w_if": L.dense_init(gen, di, 2 * H, pd, device),
        "gn": torch.ones((di,), dtype=pd, device=device),
        "w_down": L.dense_init(gen, di, d, pd, device),
    }


def apply_mlstm_block(p: Params, x: torch.Tensor, cfg: XLSTMConfig, *,
                      state: Params | None = None
                      ) -> tuple[torch.Tensor, Params | None]:
    """With ``state`` ({"cell", "conv"}), one decode step (S = 1) through
    the recurrent form; returns ``(x, new_state)``, else ``(x, None)``."""
    B, S, d = x.shape
    H, Dh, di = cfg.n_heads, cfg.head_dim, cfg.d_inner
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    up = mm(h, p["w_up"])
    a, z = up[..., :di], up[..., di:]
    c, new_conv = causal_conv(a, p["conv"],
                              state["conv"] if state is not None else None)
    c = F.silu(c)
    q = mm(c, p["wq"]).reshape(B, S, H, Dh)
    k = mm(c, p["wk"]).reshape(B, S, H, Dh)
    v = mm(a, p["wv"]).reshape(B, S, H, Dh)
    gates = mm(c, p["w_if"])
    i_pre, f_pre = gates[..., :H], gates[..., H:]
    new_state = None
    if state is None:
        out = mlstm_parallel(q, k, v, i_pre, f_pre)
    else:
        out, cell = mlstm_recurrent(state["cell"], q[:, 0], k[:, 0],
                                    v[:, 0], i_pre[:, 0], f_pre[:, 0])
        out = out[:, None]
        new_state = {"cell": cell, "conv": new_conv}
    out = out.reshape(B, S, di)
    out = L.rms_norm(out, p["gn"], cfg.norm_eps)       # per-channel group norm
    out = out * F.silu(z)
    return x + mm(out, p["w_down"]), new_state


def init_slstm_block(gen: torch.Generator, cfg: XLSTMConfig,
                     device="cuda") -> Params:
    d, di, pd = cfg.d_model, cfg.d_inner, cfg.param_dtype
    p = {"ln": torch.ones((d,), dtype=pd, device=device),
         "w_up": L.dense_init(gen, d, di, pd, device),
         "conv": _init_conv(gen, cfg.conv_width, di, pd, device),
         "gn": torch.ones((di,), dtype=pd, device=device),
         "w_down": L.dense_init(gen, di, d, pd, device)}
    for g in GATES:
        p[f"w{g}"] = L.dense_init(gen, di, di, pd, device)
    for g in GATES:
        p[f"r{g}"] = L.normal(gen, (di, di), 0.1 / math.sqrt(di), pd, device)
    return p


def apply_slstm_block(p: Params, x: torch.Tensor, cfg: XLSTMConfig, *,
                      state: Params | None = None
                      ) -> tuple[torch.Tensor, Params | None]:
    """With ``state`` ({"cell", "conv"}), the scan continues from it and
    returns ``(x, new_state)``; else from a fresh cell, ``(x, None)``."""
    B = x.shape[0]
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    u = mm(h, p["w_up"])
    c, new_conv = causal_conv(u, p["conv"],
                              state["conv"] if state is not None else None)
    c = F.silu(c)
    cell = state["cell"] if state is not None \
        else init_slstm_state(B, cfg.d_inner, x.device)
    out, new_cell = slstm_scan(p, c, cell)
    out = L.rms_norm(out, p["gn"], cfg.norm_eps)
    new_state = ({"cell": new_cell, "conv": new_conv}
                 if state is not None else None)
    return x + mm(out, p["w_down"]), new_state


# --------------------------------------------------------------------------
# Full model
# --------------------------------------------------------------------------

def init_xlstm(gen: torch.Generator, cfg: XLSTMConfig,
               device="cuda") -> Params:
    blocks = [init_slstm_block(gen, cfg, device) if cfg.is_slstm(i)
              else init_mlstm_block(gen, cfg, device)
              for i in range(cfg.n_layers)]
    p: Params = {
        "embed": L.dense_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype,
                              device),
        "blocks": blocks,   # heterogeneous list (not stacked)
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.param_dtype,
                                 device=device),
    }
    if not cfg.tied_embeddings:
        p["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab,
                                 cfg.param_dtype, device)
    return p


def forward(params: Params, tokens: torch.Tensor, cfg: XLSTMConfig, *,
            states: list | None = None) -> tuple[torch.Tensor, list | None]:
    """-> ``(hidden (B,S,d), new_states)``: with ``states`` (one per block,
    ``init_states``) one decode step, else ``None``."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    new_states = [] if states is not None else None
    for i, bp in enumerate(params["blocks"]):
        apply = apply_slstm_block if cfg.is_slstm(i) else apply_mlstm_block
        x, ns = apply(bp, x, cfg,
                      state=states[i] if states is not None else None)
        if new_states is not None:
            new_states.append(ns)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), new_states


def unembed(params: Params, x: torch.Tensor,
            cfg: XLSTMConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tied_embeddings else params["head"]
    return x @ w.to(x.dtype)


def xlstm_loss(params: Params, batch: dict, cfg: XLSTMConfig) -> torch.Tensor:
    h, _ = forward(params, batch["tokens"], cfg)
    logits = unembed(params, h[:, :-1], cfg)
    return softmax_xent(logits, batch["tokens"][:, 1:])


def init_states(cfg: XLSTMConfig, batch: int, device="cuda") -> list:
    """Each block's decode state: its cell's and its conv's (``cfg.dtype``)."""
    states = []
    for i in range(cfg.n_layers):
        conv = torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner),
                           dtype=cfg.dtype, device=device)
        cell = (init_slstm_state(batch, cfg.d_inner, device)
                if cfg.is_slstm(i) else
                init_mlstm_state(batch, cfg.n_heads, cfg.head_dim, device))
        states.append({"cell": cell, "conv": conv})
    return states


def decode_step(params: Params, token: torch.Tensor, states: list,
                cfg: XLSTMConfig) -> tuple[torch.Tensor, list]:
    h, states = forward(params, token, cfg, states=states)
    return unembed(params, h, cfg), states
