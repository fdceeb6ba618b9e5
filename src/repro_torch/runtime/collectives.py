"""Explicit collective building blocks (the port of
``repro.runtime.collectives``).

``sharded_decode_attention``: flash-decode over a sequence-sharded KV cache
(batch 1, the cache split over the ranks of a process group).  Each rank
computes a partial attention with a local log-sum-exp; the partials merge
with the numerically stable LSE combine:

    m      = max over ranks (m_local)
    out    = sum over ranks (out_local * exp(m_local - m))
           / sum over ranks (l_local * exp(m_local - m))

as a MAX all-reduce of ``m`` and two SUM all-reduces (JAX: ``pmax`` and
``psum`` inside ``shard_map``).  At long contexts the merge moves
O(B * H * Dh) bytes instead of the O(B * H * S / ranks) logits that
partitioning the softmax would gather.
"""
from __future__ import annotations

import math

import torch


def local_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, kv_offset: int,
                             kv_valid_len: int
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Partial attention over a local KV shard.

    q: (B, 1, H, Dh); k, v: (B, S_shard, H, Dh).  Returns, in fp32,
    ``(out_unnormalised (B,1,H,Dh), m (B,1,H), l (B,1,H))`` where
    ``out = sum_j exp(s_j - m) v_j`` and ``l = sum_j exp(s_j - m)``.
    ``kv_offset``: absolute position of this shard's row 0;
    ``kv_valid_len``: global number of valid tokens (masked past it).  A
    shard with no valid key gives ``m = -inf`` and zeros.
    """
    Dh = q.shape[-1]
    S = k.shape[1]
    s = torch.einsum("bqhd,bshd->bqhs", q.float(), k.float()) / math.sqrt(Dh)
    pos = kv_offset + torch.arange(S, device=q.device)
    mask = (pos < kv_valid_len)[None, None, None, :]
    s = torch.where(mask, s, -math.inf)
    m = s.amax(dim=-1)                                        # (B,1,H)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bqhs,bshd->bqhd", p, v.float())
    return out, m, l


def merge_lse(parts: list) -> torch.Tensor:
    """Merge ``[(out_i, m_i, l_i)]`` partials -> normalised attention output
    (fp32)."""
    m_glob = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    num = den = 0.0
    for out, m, l in parts:
        scale = torch.exp(m - m_glob)
        num = num + out * scale[..., None]
        den = den + l * scale
    return num / torch.clamp(den[..., None], min=1e-30)


def sharded_decode_attention(q: torch.Tensor, k_shard: torch.Tensor,
                             v_shard: torch.Tensor, *, kv_valid_len: int,
                             group=None) -> torch.Tensor:
    """Decode attention with the KV cache's sequence dim sharded over the
    ranks of ``group`` (``torch.distributed``; the default group when
    None), rank ``r`` holding rows ``[r * S_shard, (r + 1) * S_shard)``.
    q replicated (B,1,H,Dh); k/v the local shards.  Returns the attention
    output in q's dtype on every rank."""
    import torch.distributed as dist

    idx = dist.get_rank(group)
    S_shard = k_shard.shape[1]
    out, m, l = local_attention_with_lse(
        q, k_shard, v_shard, kv_offset=idx * S_shard,
        kv_valid_len=kv_valid_len)
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    scale = torch.exp(m - m_glob)
    num = out * scale[..., None]
    den = l * scale
    dist.all_reduce(num, group=group)
    dist.all_reduce(den, group=group)
    return (num / torch.clamp(den[..., None], min=1e-30)).to(q.dtype)
