"""Mamba2 (SSD) blocks and the Zamba2 hybrid architecture (the port of
``repro.models.mamba``).

Mamba2 state-space recurrence per head (state size N, head dim P):

    h_t = exp(a * dt_t) * h_{t-1} + dt_t * B_t (outer) x_t      (N x P)
    y_t = C_t . h_t + D * x_t

Training uses the *chunked* formulation over chunks of length Q with an
intra-chunk quadratic form.  The carry across chunks,

    h_c = exp(cum_c[-1]) * h_{c-1} + S_c,

is a gated linear scan over (batch, chunks, H*N*P): :func:`_ssd_chunked`
computes every chunk's decay and state contribution at once and runs the
carry through ``kernels.linear_scan.gated_linear_scan`` (the hand-written
scan kernel on a CUDA tensor, its plain version on a CPU tensor), then the
chunks' outputs batched over chunks.  :func:`_ssd_chunked_plain` is the
JAX function's form, a loop over chunks carrying h, kept as its plain
version.  Both mask the intra-chunk decay ``exp(cum[t] - cum[s])`` for
s > t before the exp, where JAX masks after it: the same values, and no
``0 * inf`` in the gradient where the masked exponent overflows (at
Zamba2's widths, a = -80 and dt near 1 reach fp32's limit in two steps).

Decoding uses the O(1) recurrent step (:func:`ssd_recurrent`), as in
JAX, one token at a time: a block's state is its SSM state ``(b, H, N,
P)`` and its causal conv's last ``conv_width - 1`` inputs.

Zamba2 = a stack of Mamba2 blocks with a *shared* full-attention
transformer block applied every ``shared_every`` layers, alternating
between ``n_shared_blocks`` parameter sets (their gradients the sum over
their sites).  ``mamba_blocks`` and ``shared_blocks`` are lists, as in
JAX.  Each site keeps its own KV cache (``init_states``), read in place by
the flash kernel when the shared attention's ``use_flash`` is set.

dtypes follow JAX's promotion: a decode step's SSM output is fp32, so
after the first block a bf16 config's residual stream is fp32 at decode
and its matmuls against bf16 weights run in fp32 (``promoted_matmul``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan import gated_linear_scan
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnConfig, Params
from repro_torch.models.layers import promoted_matmul as mm
from repro_torch.models.lm import softmax_xent
from repro_torch.models.xlstm import _init_conv, causal_conv


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64           # N
    head_dim: int = 64          # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_mamba2_block(gen: torch.Generator, cfg: Mamba2Config,
                      dtype=torch.float32, device="cuda") -> Params:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    # fused in-projection: [z (di), x (di), B (N), C (N), dt (H)]
    d_in_proj = 2 * di + 2 * N + H
    w_in = L.dense_init(gen, d, d_in_proj, dtype, device)
    conv = _init_conv(gen, cfg.conv_width, di + 2 * N, dtype, device)
    u = torch.rand((H,), generator=gen, device=device)
    dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                   + math.log(cfg.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))     # inverse softplus
    return {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "w_in": w_in,
        "conv": conv,
        "dt_bias": dt_bias.to(dtype),
        "a_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)).to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=device),
        "gn": torch.ones((di,), dtype=dtype, device=device),
        "w_out": L.dense_init(gen, di, d, dtype, device),
    }


def _chunks(x, dt, a, B, C, chunk: int):
    """The inputs cut into chunks, in fp32: x (b,nc,Q,H,P), dt (b,nc,Q,H),
    B and C (b,nc,Q,N), and the within-chunk cumulative log-decay (b,nc,Q,H)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    dtc = dt.reshape(b, nc, chunk, H).float()
    cums = torch.cumsum(dtc * a.float(), dim=2)
    return (x.reshape(b, nc, chunk, H, P).float(), dtc,
            B.reshape(b, nc, chunk, N).float(),
            C.reshape(b, nc, chunk, N).float(), cums)


def _intra_decay(cums: torch.Tensor) -> torch.Tensor:
    """exp(cum[t] - cum[s]) for s <= t, 0 above: (..., t, s, H) of cums
    (..., Q, H), masked before the exp."""
    Q = cums.shape[-2]
    diff = cums[..., :, None, :] - cums[..., None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=cums.device).tril()
    return torch.exp(torch.where(mask[:, :, None], diff, -math.inf))


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan from a zero state, the carry across chunks through
    the gated linear scan (the JAX function's ``h0``, which no training
    caller passes, is not ported).

    x: (b,S,H,P), dt: (b,S,H), a: (H,) (negative), B,C: (b,S,N).  Returns
    (y (b,S,H,P) in x.dtype, final_state (b,H,N,P) fp32).
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    xc, dtc, Bc, Cc, cums = _chunks(x, dt, a, B, C, chunk)
    nc = xc.shape[1]
    # each chunk's decay A_c = exp(cum_c[-1]) and state contribution
    # S_c = sum_s exp(cum_c[-1] - cum_c[s]) dt_s B_s (outer) x_s
    dec_last = torch.exp(cums[:, :, -1:, :] - cums)                # (b,nc,Q,H)
    s_c = torch.einsum("bcsh,bcsn,bcshp->bchnp", dec_last * dtc, Bc, xc)
    a_c = torch.exp(cums[:, :, -1, :])                             # (b,nc,H)
    # h_c = A_c h_{c-1} + S_c over (R=b, T=nc, C=H*N*P); the op takes a
    # and x of one shape
    a_full = a_c[..., None].expand(b, nc, H, N * P).reshape(b, nc, H * N * P)
    hs = gated_linear_scan(a_full, s_c.reshape(b, nc, H * N * P))
    hs = hs.reshape(b, nc, H, N, P)
    h_prev = torch.cat([hs.new_zeros((b, 1, H, N, P)), hs[:, :-1]],
                       dim=1)                                     # carry-in
    # intra-chunk quadratic: y[t] = sum_{s<=t} C_t.B_s dt_s
    #                               exp(cum[t]-cum[s]) x_s
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    w = cb[..., None] * _intra_decay(cums) * dtc[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", w, xc)
    # the carry-in: y += C_t exp(cum[t]) h_{c-1}
    y = y + torch.einsum("bctn,bcth,bchnp->bcthp", Cc, torch.exp(cums),
                         h_prev)
    return y.reshape(b, S, H, P).to(x.dtype), hs[:, -1]


def _ssd_chunked_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, chunk: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`_ssd_chunked`: the JAX function's loop
    over chunks carrying h (its ``lax.scan``), the same arguments and
    results."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    xc, dtc, Bc, Cc, cums = _chunks(x, dt, a, B, C, chunk)
    h = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(xc.shape[1]):
        xq, dtq, Bq, Cq, cumq = (t[:, c] for t in (xc, dtc, Bc, Cc, cums))
        cb = torch.einsum("btn,bsn->bts", Cq, Bq)                 # (b,t,s)
        w = cb[..., None] * _intra_decay(cumq) * dtq[:, None, :, :]
        y = torch.einsum("btsh,bshp->bthp", w, xq)
        y = y + torch.einsum("btn,bth,bhnp->bthp", Cq, torch.exp(cumq), h)
        dec_last = torch.exp(cumq[:, -1:, :] - cumq)              # (b,Q,H)
        h = (torch.exp(cumq[:, -1, :])[:, :, None, None] * h
             + torch.einsum("bsh,bsn,bshp->bhnp", dec_last * dtq, Bq, xq))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, S, H, P)
    return y.to(x.dtype), h


def ssd_recurrent(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                  a: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  state: (b,H,N,P) fp32; x: (b,H,P); dt: (b,H); B,C:
    (b,N).  Returns (y (b,H,P), new state), both fp32."""
    da = torch.exp(dt * a)                                      # (b,H)
    state = (state * da[..., None, None]
             + torch.einsum("bh,bn,bhp->bhnp", dt, B.float(), x.float()))
    y = torch.einsum("bn,bhnp->bhp", C.float(), state)
    return y, state


def apply_mamba2_block(p: Params, x: torch.Tensor, cfg: Mamba2Config, *,
                       state: Params | None = None,
                       ssd=_ssd_chunked) -> tuple[torch.Tensor, Params | None]:
    """One Mamba2 block with its residual.  Without ``state``, over the
    whole sequence through ``ssd``, the chunked scan (:func:`_ssd_chunked`;
    :func:`_ssd_chunked_plain` to hold it to the JAX form), returning
    ``(x, None)``; with ``state`` ({"ssm", "conv"}), one decode step
    (S = 1) through :func:`ssd_recurrent`, returning ``(x, new_state)``."""
    b, S, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    h = L.rms_norm(x, p["ln"])
    zxbcdt = mm(h, p["w_in"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * N]
    dt_pre = zxbcdt[..., -H:]
    xbc, new_conv = causal_conv(xbc, p["conv"],
                                state["conv"] if state is not None else None)
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(b, S, H, P)
    B = xbc[..., di:di + N]
    C = xbc[..., di + N:]
    # fp32 + bf16 promotes to fp32, as in JAX
    dt = F.softplus(dt_pre.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    new_state = None
    if state is None:
        y, _ = ssd(xs, dt, a, B, C, min(cfg.chunk, S))
    else:
        y, ssm = ssd_recurrent(state["ssm"], xs[:, 0], dt[:, 0], a, B[:, 0],
                               C[:, 0])
        y = y[:, None]
        new_state = {"ssm": ssm, "conv": new_conv}
    y = y + xs * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, S, di)
    y = L.rms_norm(y, p["gn"]) * F.silu(z)
    return x + mm(y, p["w_out"]), new_state


def init_mamba2_state(batch: int, cfg: Mamba2Config, dtype=torch.float32,
                      device="cuda") -> Params:
    return {
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                           device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.d_state), dtype=dtype,
                            device=device),
    }


# --------------------------------------------------------------------------
# Zamba2 hybrid
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Zamba2Config:
    name: str
    vocab: int
    d_model: int
    n_layers: int                 # number of Mamba2 blocks
    mamba: Mamba2Config = None    # type: ignore
    shared_attn: AttnConfig = None  # type: ignore
    shared_d_ff: int = 10240
    shared_every: int = 6         # apply shared block after every k mamba blocks
    n_shared_blocks: int = 2      # alternate between this many shared blocks
    norm_eps: float = 1e-6
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    tied_embeddings: bool = True

    def shared_sites(self) -> list[int]:
        """Mamba-layer indices after which a shared block runs."""
        return [i for i in range(self.n_layers)
                if i % self.shared_every == self.shared_every - 1]

    def param_count(self) -> int:
        d, di = self.d_model, self.mamba.d_inner
        N, H = self.mamba.d_state, self.mamba.n_heads
        per_mamba = d * (2 * di + 2 * N + H) + di * d + 2 * d + di
        a = self.shared_attn
        per_shared = (d * a.head_dim * (a.n_heads * 2 + a.n_kv_heads * 2)
                      + 3 * d * self.shared_d_ff)
        return (self.vocab * d + self.n_layers * per_mamba
                + self.n_shared_blocks * per_shared)


def init_zamba2(gen: torch.Generator, cfg: Zamba2Config,
                device="cuda") -> Params:
    pd = cfg.param_dtype
    blocks = [init_mamba2_block(gen, cfg.mamba, pd, device)
              for _ in range(cfg.n_layers)]
    shared = [{
        "ln1": torch.ones((cfg.d_model,), dtype=pd, device=device),
        "attn": L.init_attention(gen, cfg.shared_attn, pd, device),
        "ln2": torch.ones((cfg.d_model,), dtype=pd, device=device),
        "ffn": L.init_swiglu(gen, cfg.d_model, cfg.shared_d_ff, pd, device),
    } for _ in range(cfg.n_shared_blocks)]
    return {
        "embed": L.dense_init(gen, cfg.vocab, cfg.d_model, pd, device),
        "mamba_blocks": blocks,
        "shared_blocks": shared,
        "final_norm": torch.ones((cfg.d_model,), dtype=pd, device=device),
    }


def _apply_shared(p: Params, x: torch.Tensor, cfg: Zamba2Config, *,
                  cache: Params | None = None,
                  positions: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, Params | None]:
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = L.apply_attention(p["attn"], h, cfg.shared_attn,
                                     cache=cache, positions=positions)
    x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.apply_swiglu(p["ffn"], h), new_cache


def forward(params: Params, tokens: torch.Tensor, cfg: Zamba2Config, *,
            states: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """-> ``(hidden (B,S,d), new_states)``.  Shared block ``site %
    n_shared_blocks`` runs after each Mamba2 block of ``shared_sites()``,
    the sites counted over the whole stack.  With ``states``
    (``init_states``) one decode step: each Mamba2 block steps its state,
    each site attends over its own KV cache; else ``None``."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    sites = cfg.shared_sites()
    new_states = positions = None
    if states is not None:
        new_states = {"mamba": [], "shared": []}
        pos = states["shared"][0]["pos"] if states["shared"] else 0
        positions = torch.full((1, 1), pos, device=x.device)
    site_counter = 0
    for i, bp in enumerate(params["mamba_blocks"]):
        x, ns = apply_mamba2_block(
            bp, x, cfg.mamba,
            state=states["mamba"][i] if states is not None else None)
        if new_states is not None:
            new_states["mamba"].append(ns)
        if i in sites:
            sp = params["shared_blocks"][site_counter % cfg.n_shared_blocks]
            cache = states["shared"][site_counter] if states is not None \
                else None
            x, nc = _apply_shared(sp, x, cfg, cache=cache,
                                  positions=positions)
            if new_states is not None:
                new_states["shared"].append(nc)
            site_counter += 1
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), new_states


def zamba2_loss(params: Params, batch: dict, cfg: Zamba2Config) -> torch.Tensor:
    h, _ = forward(params, batch["tokens"], cfg)
    logits = h @ params["embed"].T.to(h.dtype)
    return softmax_xent(logits[:, :-1], batch["tokens"][:, 1:])


def init_states(cfg: Zamba2Config, batch: int, max_len: int,
                device="cuda") -> dict:
    """Each Mamba2 block's decode state and each shared site's KV cache of
    ``max_len`` rows, in ``cfg.dtype`` (the SSM states in fp32)."""
    return {
        "mamba": [init_mamba2_state(batch, cfg.mamba, cfg.dtype, device)
                  for _ in range(cfg.n_layers)],
        "shared": [L.init_kv_cache(batch, max_len, cfg.shared_attn,
                                   cfg.dtype, device)
                   for _ in cfg.shared_sites()],
    }


def decode_step(params: Params, token: torch.Tensor, states: dict,
                cfg: Zamba2Config) -> tuple[torch.Tensor, dict]:
    h, states = forward(params, token, cfg, states=states)
    return h @ params["embed"].T.to(h.dtype), states
