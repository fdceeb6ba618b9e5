"""Pipeline configuration, wire formats, remat and the masked block loops
(the port of the parts of ``repro.runtime.pipeline`` the table executor
uses; the closed-form executors are not ported yet).

A stage's blocks arrive as a list of per-row param trees (views of the
``[D, V, pad, ...]`` stage stacks, see ``runtime.schedule_exec``).  The
JAX scans run every padded row and mask rows ``>= count`` out with
``where``; here the device, slot and count are host integers, so the loops
simply stop at ``count``: padded rows never run and get zero gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


# Wire formats the table executor may put on the ring.  bf16 halves the
# bytes of every boundary hop (forward and, through the cast's backward,
# the cotangents); float32 is the exact-wire escape hatch the strict
# differential tests pin.
WIRE_DTYPES = ("bfloat16", "float32")


def _wrap_remat(fn: Callable, cfg: "PipelineConfig") -> Callable:
    """Recompute ``fn`` in the backward pass instead of keeping its
    activations (``jax.checkpoint`` in the JAX package)."""
    if not cfg.remat:
        return fn

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


def scan_blocks_emit(block_fn: Callable, rows: list, x, count: int, *args):
    """``block_fn(bp, x, *args) -> (x, skip)`` over rows ``[0, count)``;
    returns ``(x, skips)`` with one skip per row of ``rows`` (``None`` on
    padded rows, which consumers never read)."""
    skips: list = [None] * len(rows)
    for i in range(count):
        x, skips[i] = block_fn(rows[i], x, *args)
    return x, skips


def scan_blocks_consume(block_fn: Callable, rows: list, skips: list, x,
                        count: int, skip_rows, *args):
    """``block_fn(bp, x, skip, *args)`` over rows ``[0, count)``; row i
    consumes ``skips[skip_rows[i]]`` (``-1`` = no skip: zeros are passed).

    ``skip_rows`` is the producer/consumer pairing the layout derived from
    the partition's skip edges (``StageLayout.skip_rows``), indexing the
    flat ``[V * enc_pad]`` stash view of the device's encoder slots.
    """
    for i in range(count):
        r = skip_rows[i]
        if r >= 0:
            skip = skips[r]
            if skip is None:
                raise ValueError(f"decoder row {i} reads stash row {r}, "
                                 "which no encoder row wrote")
        else:
            skip = torch.zeros_like(x)
        x = block_fn(rows[i], x, skip, *args)
    return x


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_devices: int            # D pipeline devices
    num_microbatches: int       # M
    remat: bool = True          # recompute each stage call in backward
    wire_dtype: str = "bfloat16"      # boundary-hop dtype (WIRE_DTYPES)
