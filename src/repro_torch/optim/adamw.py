"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (the port of ``repro.optim.adamw``): fp32-state AdamW, and AdamW
with int8 moments (block-wise absmax quantization, about 2 bytes a param
for both moments where fp32 takes 8).

The state mirrors the param tree leaf by leaf (``m`` and ``v`` in fp32,
``step`` an int32 scalar), as in the JAX package, so a JAX optimizer state
converts with ``params_from_jax``.  Under ZeRO-1 a rank hands it views of
its shard of its stage rows (``CompiledPipeline.optimizer_view``), so the
moments cover the shard alone, and the update writes the views in place.

Unlike the JAX functions, :func:`adamw_update` and
:func:`int8_adamw_update` work IN PLACE: they overwrite the param tensors
and the moments they are given and return the same objects.  At UViT-H scale that saves a second copy of the
params (5.5 GB in bf16) and of the fp32 moments (21.8 GB).  Callers that
need the old values must copy them first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0


def cosine_schedule(step: int, *, base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> float:
    if step < warmup:
        return base_lr * (step + 1) / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base_lr * (min_ratio + (1 - min_ratio) * 0.5
                      * (1 + math.cos(math.pi * prog)))


def global_norm(grads: Pytree) -> torch.Tensor:
    """fp32 L2 norm over every leaf of a gradient tree."""
    leaves = tree_leaves(grads)
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
          for g in leaves]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads: Pytree, max_norm: float
                        ) -> tuple[Pytree, torch.Tensor]:
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def adamw_init(params: Pytree) -> Pytree:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def adamw_update(params: Pytree, grads: Pytree, state: Pytree,
                 cfg: AdamWConfig, lr: float | None = None,
                 norm: torch.Tensor | None = None
                 ) -> tuple[Pytree, Pytree]:
    """One AdamW step, in place (see the module docstring): returns
    ``(params, state)``, the same tensors updated.  ``norm`` is the
    gradient's global norm when ``grads`` holds only part of it (a rank's
    leaves; the norm then comes summed over the group), else it is
    computed here."""
    state["step"] += 1
    step = int(state["step"])
    lr = cfg.lr if lr is None else lr
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    scale = None
    if cfg.clip_norm:
        gn = global_norm(grads) if norm is None else norm
        scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        if scale is not None:
            g = (g * scale).to(g.dtype)
        g32 = g.float()
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        p32 = p.float()             # p itself when p is fp32
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        upd.add_(p32, alpha=cfg.weight_decay)
        p.copy_(p32.sub_(upd, alpha=lr))
    return params, state


# --------------------------------------------------------------------------
# int8-state AdamW (block-wise absmax quantization of m and v)
# --------------------------------------------------------------------------

_BLOCK = 256
# pad the block count to a multiple of 32 so the quantized state tensors
# stay evenly shardable over up to 32-way ZeRO axes (pod x data), as in JAX
_BLOCK_ALIGN = 32


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` -> ``(q, scale)``: int8 codes ``(nblocks, 256)`` and fp32
    scales ``(nblocks, 1)``, ``nblocks`` padded to a multiple of 32; a
    block's scale is its max|x| / 127 + 1e-12, its codes
    ``round(x / scale)`` half to even, as ``jnp.round``."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % (_BLOCK * _BLOCK_ALIGN)
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    scale = _div(blocks.abs().amax(dim=1, keepdim=True), 127.0) + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def int8_adamw_init(params: Pytree) -> Pytree:
    def zq(p):
        q, s = _quantize(torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device))
        return {"q": q, "s": s}
    dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(zq, params),
        "v": tree_map(zq, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def int8_adamw_update(params: Pytree, grads: Pytree, state: Pytree,
                      cfg: AdamWConfig, lr: float | None = None
                      ) -> tuple[Pytree, Pytree]:
    """One AdamW step on int8 moments, in place: each leaf's moments are
    dequantized, updated in fp32 and quantized again into ``state``'s
    ``{"q", "s"}`` entries; the params are overwritten.  Returns
    ``(params, state)``, the same objects."""
    state["step"] += 1
    step = int(state["step"])
    lr = cfg.lr if lr is None else lr
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    scale = None
    if cfg.clip_norm:
        scale = torch.clamp(cfg.clip_norm / (global_norm(grads) + 1e-9),
                            max=1.0)
    for p, g, mq, vq in zip(tree_leaves(params), tree_leaves(grads),
                            _codes(state["m"]), _codes(state["v"])):
        if scale is not None:
            g = (g * scale).to(g.dtype)
        g32 = g.float()
        m = _dequantize(mq["q"], mq["s"], p.shape)
        v = _dequantize(vq["q"], vq["s"], p.shape)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        del g32
        u = _div(m, b1c) / (torch.sqrt(_div(torch.clamp(v, min=0.0), b2c))
                            + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (u + cfg.weight_decay * p32))
        del u, p32
        mq["q"], mq["s"] = _quantize(m)
        vq["q"], vq["s"] = _quantize(v)
    return params, state


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` correctly rounded on every device: CUDA divides by a
    host scalar as a product with its reciprocal, by a tensor exactly, so
    the card's codes and params are the CPU's."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _codes(tree: Pytree) -> list:
    """The ``{"q", "s"}`` entries of an int8 moment tree, in the order of
    the param leaves they stand for."""
    if isinstance(tree, dict) and set(tree) == {"q", "s"}:
        return [tree]
    if isinstance(tree, dict):
        return [c for k in tree for c in _codes(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [c for t in tree for c in _codes(t)]
    return []
