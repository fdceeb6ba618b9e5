"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (the port of ``repro.optim.adamw``, fp32-state AdamW only).

The state mirrors the param tree leaf by leaf (``m`` and ``v`` in fp32,
``step`` an int32 scalar), as in the JAX package, so a JAX optimizer state
converts with ``params_from_jax``.  Under ZeRO-1 a rank hands it views of
its shard of its stage rows (``CompiledPipeline.optimizer_view``), so the
moments cover the shard alone, and the update writes the views in place.

Unlike the JAX functions, :func:`adamw_update` works IN PLACE: it
overwrites the param tensors and the ``m`` / ``v`` tensors it is given and
returns the same objects.  At UViT-H scale that saves a second copy of the
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
