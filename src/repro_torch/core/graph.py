"""Block-graph IR for PULSE.

A copy of ``repro.core.graph``: the port imports nothing of the JAX package, so it
keeps its own copy of this framework-neutral module.

A model is an ordered sequence of *blocks* (the paper's fine-grained
operations, §IV-B) plus a set of *skip edges* ``(src, dst)`` with
``dst > src`` denoting a long-range activation dependency (UNet/UViT skip
connections, whisper cross-attention, tied embeddings, ...).

The IR is deliberately tiny: the partitioner (`core.partition`), the
schedule synthesizer (`core.schedule`), the hybrid tuner (`core.tuner`) and
the comm-volume model (`core.comm_model`) all consume this structure, while
`models/*.py` export their architectures into it via ``to_block_graph()``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Block:
    """One atomic unit of the partitionable sequence."""

    name: str
    fwd_time: float          # profiled or analytic forward time (seconds)
    param_bytes: int = 0     # parameter footprint (M_theta contribution)
    act_bytes: int = 0       # boundary activation size it emits (M_o / M_a)
    skip_bytes: int = 0      # size of the skip tensor it emits (0 if none)
    flops: float = 0.0       # analytic forward FLOPs (roofline bookkeeping)


@dataclasses.dataclass(frozen=True)
class SkipEdge:
    src: int                 # producing block index
    dst: int                 # consuming block index (dst > src)
    bytes: int = 0           # activation volume carried by the edge

    def __post_init__(self):
        if self.dst <= self.src:
            raise ValueError(f"skip edge must go forward: {self.src}->{self.dst}")


@dataclasses.dataclass(frozen=True)
class BlockGraph:
    blocks: tuple[Block, ...]
    skips: tuple[SkipEdge, ...] = ()

    def __post_init__(self):
        n = len(self.blocks)
        for e in self.skips:
            if not (0 <= e.src < n and 0 <= e.dst < n):
                raise ValueError(f"skip edge {e} out of range for {n} blocks")

    @property
    def n(self) -> int:
        return len(self.blocks)

    @property
    def fwd_times(self) -> tuple[float, ...]:
        return tuple(b.fwd_time for b in self.blocks)

    def is_nested(self) -> bool:
        """True iff skip edges are symmetric-nested (UNet-style).

        Sorted by src ascending, dsts must be strictly descending and all
        edges non-crossing: src_0 < src_1 < ... and dst_0 > dst_1 > ...
        with src_k < dst_k for all k.  This is the structure PULSE's
        bidirectional DP exploits (paper §IV-B); arbitrary DAG skips fall
        back to the reference partitioner.
        """
        es = sorted(self.skips, key=lambda e: e.src)
        for a, b in zip(es, es[1:]):
            if not (a.src < b.src and a.dst > b.dst and b.src < b.dst):
                return False
        return True

    def sorted_skips(self) -> tuple[SkipEdge, ...]:
        return tuple(sorted(self.skips, key=lambda e: e.src))

    def total_fwd_time(self) -> float:
        return sum(b.fwd_time for b in self.blocks)

    def total_param_bytes(self) -> int:
        return sum(b.param_bytes for b in self.blocks)


def make_unet_like(
    n_pairs: int,
    mid_blocks: int = 1,
    enc_time: float = 1.0,
    dec_time: float = 1.0,
    act_bytes: int = 1 << 20,
    skip_bytes: int = 1 << 20,
    param_bytes: int = 1 << 20,
) -> BlockGraph:
    """Synthetic symmetric encoder-decoder graph (test/benchmark helper).

    ``n_pairs`` encoder blocks, ``mid_blocks`` bottleneck blocks, ``n_pairs``
    decoder blocks; skip edge from encoder block i to its mirror decoder.
    """
    blocks = []
    for i in range(n_pairs):
        blocks.append(Block(f"enc{i}", enc_time, param_bytes, act_bytes, skip_bytes))
    for i in range(mid_blocks):
        blocks.append(Block(f"mid{i}", enc_time, param_bytes, act_bytes, 0))
    for i in range(n_pairs):
        blocks.append(Block(f"dec{i}", dec_time, param_bytes, act_bytes, 0))
    total = 2 * n_pairs + mid_blocks
    skips = tuple(
        SkipEdge(i, total - 1 - i, skip_bytes) for i in range(n_pairs)
    )
    return BlockGraph(tuple(blocks), skips)
