"""Per-block cost profiling (paper §IV-A "profile layer runtimes").

The port's copy of ``repro.core.profiler``.  Two paths:

- ``analytic_block_costs``: FLOPs / peak + bytes / memory-bandwidth
  roofline estimate -- deterministic and independent of the framework,
  used for dry-runs and for the tuner on a machine without the card.
- ``measure_block_times``: timing of the block callables themselves, with
  CUDA events for tensors on the card and the host clock for tensors on
  the CPU.  The callables run as given (no compilation step stands in for
  ``jax.jit``).
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

from repro_torch.core.graph import Block, BlockGraph
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


def _device_of(args) -> "object | None":
    """The device of the first tensor in ``args`` (nested tuples, lists and
    dicts are searched), or None when ``args`` holds no tensor."""
    import torch

    stack = [args]
    while stack:
        a = stack.pop()
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, dict):
            stack.extend(reversed(list(a.values())))
        elif isinstance(a, (tuple, list)):
            stack.extend(reversed(a))
    return None


def measure_block_times(
    fns: Sequence[Callable],
    args: Sequence[tuple],
    *,
    warmup: int = 1,
    iters: int = 3,
) -> list[float]:
    """Seconds per call for each block callable ``fn(*a)``.

    Every callable runs its ``warmup`` calls before any is timed, and the
    cards the arguments lie on are synchronized after them: the first
    block's timed calls find the card as warm as the last one's.  (Timed
    right after its own warm-up, the first block of a run on a cold card
    read up to twice what a warm card gives.)  Then, where ``a`` holds CUDA
    tensors, a pair of CUDA events brackets the ``iters`` calls and the end
    event is synchronized; where it holds CPU tensors (or none), the host
    clock brackets them.  The device is read from the arguments, so a call
    on the card is never timed by the host clock.
    """
    import torch                     # lazy: core/ imports without torch

    devs = [_device_of(a) for a in args]
    for fn, a in zip(fns, args):
        for _ in range(warmup):
            fn(*a)
    for dev in {d for d in devs if d is not None and d.type == "cuda"}:
        torch.cuda.synchronize(dev)
    times = []
    for fn, a, dev in zip(fns, args, devs):
        if dev is not None and dev.type == "cuda":
            with torch.cuda.device(dev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(*a)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*a)
            times.append((time.perf_counter() - t0) / iters)
    return times


def reprofile_graph(graph: BlockGraph, hw: Hardware = H100_SXM) -> BlockGraph:
    """Analytically re-profile every block of a graph for hardware ``hw``."""
    return BlockGraph(analytic_block_costs(graph.blocks, hw), graph.skips)
