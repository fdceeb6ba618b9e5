"""Per-block cost profiling (paper §IV-A "profile layer runtimes").

The port's copy of ``repro.core.profiler::analytic_block_costs``: a FLOPs /
peak + bytes / memory-bandwidth roofline estimate, deterministic and
independent of the framework.  ``measure_block_times`` (wall-clock timing
of the block functions) is not ported yet.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.graph import Block
from repro_torch.core.hw import Hardware, H100_SXM


def analytic_time(flops: float, bytes_moved: float,
                  hw: Hardware = H100_SXM) -> float:
    """max(compute, memory) roofline time for one block."""
    return max(flops / hw.peak_flops, bytes_moved / hw.hbm_bw)


def analytic_block_costs(
    blocks: Sequence[Block], hw: Hardware = H100_SXM
) -> tuple[Block, ...]:
    """Return blocks with ``fwd_time`` replaced by the roofline estimate."""
    out = []
    for b in blocks:
        bytes_moved = 2 * b.param_bytes + 2 * b.act_bytes  # read params+act, write act
        t = analytic_time(b.flops, bytes_moved, hw)
        out.append(Block(b.name, t, b.param_bytes, b.act_bytes, b.skip_bytes, b.flops))
    return tuple(out)

