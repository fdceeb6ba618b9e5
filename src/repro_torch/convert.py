"""Carry JAX parameter (and AdamW state) trees, and decode caches and
states, into the port.

The port keeps the JAX package's leaf names and ``(in, out)`` layouts, so a
tree of numpy arrays (``jax.device_get`` of a params pytree) converts leaf
by leaf with no transposes.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16, as JAX gives it
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def params_from_jax(tree, device="cuda"):
    """Nested dicts / lists / tuples of numpy arrays -> the same structure of
    tensors on ``device`` (the card unless the caller asks for the CPU),
    dtypes kept (bf16 included)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _to_tensor(tree, device)


def state_from_jax(tree, device="cuda"):
    """A JAX KV cache or decode-state tree (numpy leaves) -> the port's:
    every ``"pos"`` (a scalar, or one per layer of a stacked cache, all
    equal) becomes a host int, every other leaf a tensor on ``device``.
    Lets a test continue decoding from a cache the JAX package primed."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "pos":
                p = np.unique(np.asarray(v))
                if p.size != 1:
                    raise ValueError(f"stacked caches at positions {p}; the "
                                     "port keeps one pos a stack")
                out[k] = int(p[0])
            else:
                out[k] = state_from_jax(v, device)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_jax(v, device) for v in tree)
    return _to_tensor(tree, device)
