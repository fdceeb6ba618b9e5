"""Skip-aware model partitioning (paper §IV, Algorithm 1).

A copy of ``repro.core.partition``: the port imports nothing of the JAX package, so it
keeps its own copy of this framework-neutral module.  The one difference:
the default hardware is the port's ``H100_SXM``.

Five partitioners:

- ``blockwise_partition``      — the paper's baseline: equal-count contiguous
                                 stages, no cost awareness.
- ``linear_partition``         — classic cost-balanced linear partition
                                 (the S = D skip-free default).
- ``partition_symmetric_fold`` — mirror-symmetric fold for skip-free graphs
                                 forced into a wave (min-max over mirror-pair
                                 costs); the skip-free dispatch target of
                                 ``partition_bidirectional``.
- ``partition_bidirectional``  — Algorithm 1: bidirectional DP over
                                 prefix/suffix states.  The per-state
                                 feasibility predicate handles *any* skip
                                 structure (nested, sparse, partially
                                 skipped, crossing), so it returns its
                                 asymmetric optimum directly instead of
                                 detouring through the exponential
                                 reference.
- ``partition_reference``      — exact brute-force reference with the
                                 paper's full constraint predicate
                                 c(i',i,j,j'); any skip structure;
                                 exponential — used for validation only.

All partitioners return a :class:`Partition` whose ``cuts`` are ``p+1``
monotone boundaries over block indices; stage ``s`` covers
``[cuts[s], cuts[s+1])`` and executes s-th in pipeline order.  Stage
placement is carried *explicitly* in ``Partition.devices`` (one device id
per stage); the partitioners here emit the folded mirror placement
``min(s, p-1-s)`` for waves and the identity for linear pipelines, but the
rest of the stack (layout, schedule, executors) reads ``devices``, not the
closed form — folded cuts need not be mirror-symmetric.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np

from repro_torch.core.graph import Block, BlockGraph
from repro_torch.core.hw import Hardware, H100_SXM

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Partition:
    cuts: tuple[int, ...]            # p+1 boundaries, cuts[0]=0, cuts[p]=n
    folded: bool                     # True => wave (two stages per device)
    objective: float                 # max over stages of Eq. (1) cost
    stage_costs: tuple[float, ...]   # per-stage Eq. (1) cost
    devices: tuple[int, ...] = ()    # per-stage device id; () derives the
    #   canonical placement (mirror fold min(s, p-1-s), identity linear)

    def __post_init__(self):
        p = len(self.cuts) - 1
        if not self.devices:
            object.__setattr__(self, "devices", tuple(
                min(s, p - 1 - s) if self.folded else s for s in range(p)))
        elif len(self.devices) != p:
            raise ValueError(
                f"devices maps {len(self.devices)} stages but cuts describe "
                f"{p}")

    @property
    def num_stages(self) -> int:
        return len(self.cuts) - 1

    @property
    def num_devices(self) -> int:
        return max(self.devices) + 1

    def stage_range(self, s: int) -> tuple[int, int]:
        return self.cuts[s], self.cuts[s + 1]

    def device_of_stage(self, s: int) -> int:
        return self.devices[s]

    def stages_of_device(self, d: int) -> tuple[int, ...]:
        return tuple(s for s, dev in enumerate(self.devices) if dev == d)

    def stage_of_block(self, b: int) -> int:
        for s in range(self.num_stages):
            if self.cuts[s] <= b < self.cuts[s + 1]:
                return s
        raise ValueError(f"block {b} outside partition")

    def stage_sizes(self) -> tuple[int, ...]:
        return tuple(self.cuts[s + 1] - self.cuts[s]
                     for s in range(self.num_stages))

    def collocated_pairs(self) -> tuple[tuple[int, int], ...]:
        """Stage pairs pinned to one device (schedule Eq. (9)), read off the
        explicit device mapping.  A device may hold any number of stage
        slots (2V for a V-fold interleaved wave); every same-device pair is
        reported so the schedule validator/ILP see the full collocation
        set."""
        by_dev: dict[int, list[int]] = {}
        for s, d in enumerate(self.devices):
            by_dev.setdefault(d, []).append(s)
        return tuple((a, b)
                     for _, ss in sorted(by_dev.items())
                     for i, a in enumerate(ss) for b in ss[i + 1:])

    @property
    def interleave(self) -> int:
        """Stage slot pairs per device: V = S / 2D folded (S / D linear).
        V == 1 is the classic mirror fold / plain linear pipeline."""
        S, D = self.num_stages, self.num_devices
        return S // (2 * D) if self.folded else S // D

    def mirror_symmetric(self) -> bool:
        """True iff stage s and stage S-1-s have equal block counts — the
        shape fully-paired skip graphs force.  Informational only: the
        layout/lowering stack no longer requires it (asymmetric folds from
        partially-skipped graphs lower through the same executors)."""
        if not self.folded:
            return False
        S, n = self.num_stages, self.cuts[-1]
        return all(self.cuts[s] + self.cuts[S - s] == n
                   for s in range(S + 1))

    def validate_collocation(self, graph: BlockGraph) -> bool:
        """All skip endpoints on the same device?"""
        return all(
            self.device_of_stage(self.stage_of_block(e.src))
            == self.device_of_stage(self.stage_of_block(e.dst))
            for e in graph.skips
        )


def _stage_cost(
    graph: BlockGraph, lo: int, hi: int, hw: Hardware, lam: float
) -> float:
    """Eq. (1)/(2)/(3): forward time of [lo,hi) + weighted p2p of its output."""
    t = sum(graph.blocks[l].fwd_time for l in range(lo, hi))
    out = graph.blocks[hi - 1].act_bytes if hi > lo else 0
    return t + lam * (hw.t_lat + out / hw.inter_bw)


def _mk_partition(
    graph: BlockGraph, cuts: Sequence[int], folded: bool, hw: Hardware, lam: float
) -> Partition:
    cuts = tuple(cuts)
    costs = tuple(
        _stage_cost(graph, cuts[s], cuts[s + 1], hw, lam)
        for s in range(len(cuts) - 1)
    )
    return Partition(cuts, folded, max(costs), costs)


# --------------------------------------------------------------------------
# Baseline: block-wise equal-count partition (paper's comparison baseline)
# --------------------------------------------------------------------------

def blockwise_partition(
    graph: BlockGraph, p: int, *, folded: bool = False,
    hw: Hardware = H100_SXM, lam: float = 0.0,
) -> Partition:
    n = graph.n
    if p > n:
        raise ValueError(f"cannot split {n} blocks into {p} stages")
    cuts = [round(s * n / p) for s in range(p + 1)]
    # de-duplicate to keep stages non-empty
    for s in range(1, p + 1):
        cuts[s] = max(cuts[s], cuts[s - 1] + 1)
    cuts[p] = n
    for s in range(p - 1, 0, -1):
        cuts[s] = min(cuts[s], cuts[s + 1] - 1)
    return _mk_partition(graph, cuts, folded, hw, lam)


# --------------------------------------------------------------------------
# Classic linear partition (no skip constraints)
# --------------------------------------------------------------------------

def linear_partition(
    graph: BlockGraph, p: int, *,
    hw: Hardware = H100_SXM, lam: float = 1.0, folded: bool = False,
) -> Partition:
    """Min-max cost contiguous partition via DP, O(p n^2)."""
    n = graph.n
    if p > n:
        raise ValueError(f"cannot split {n} blocks into {p} stages")
    cost = np.full((n + 1, n + 1), INF)
    for lo in range(n):
        for hi in range(lo + 1, n + 1):
            cost[lo, hi] = _stage_cost(graph, lo, hi, hw, lam)
    dp = np.full((p + 1, n + 1), INF)
    parent = np.zeros((p + 1, n + 1), dtype=int)
    dp[0, 0] = 0.0
    for k in range(1, p + 1):
        for i in range(k, n - (p - k) + 1):
            # last stage covers [i', i)
            cand = np.maximum(dp[k - 1, :i], cost[:i, i])
            j = int(np.argmin(cand))
            dp[k, i] = cand[j]
            parent[k, i] = j
    cuts = [n]
    k, i = p, n
    while k > 0:
        i = int(parent[k, i])
        cuts.append(i)
        k -= 1
    cuts.reverse()
    return _mk_partition(graph, cuts, folded, hw, lam)


# --------------------------------------------------------------------------
# Mirror-symmetric fold for skip-free graphs (force_wave)
# --------------------------------------------------------------------------

def partition_symmetric_fold(
    graph: BlockGraph, p: int, *,
    hw: Hardware = H100_SXM, lam: float = 1.0,
) -> Partition:
    """Folded partition with mirror-symmetric cuts for skip-free graphs.

    The folded executor collocates stage s with stage p-1-s and requires
    equal block counts per pair, so a plain min-max linear partition is not
    a valid fold shape under heterogeneous costs.  Since each device runs
    both stages of its pair, balancing device load reduces to a min-max
    linear partition over mirror-pair costs t[i] + t[n-1-i]; the resulting
    half-cuts are mirrored onto the full graph.

    The lam comm term on the pair graph is an approximation: it charges the
    summed enc+dec act bytes of the stage's last pair under one latency,
    whereas the true up-stream transfer leaves from the stage's first
    pair's mirror and each boundary is two physical hops.  Exact for
    uniform act_bytes; a heuristic otherwise (compute balance dominates).

    Odd block counts leave one unpaired middle block; it always executes on
    the innermost device (the mirrored cuts pin it there), so its cost is
    charged to the innermost pair and the resulting fold is *asymmetric by
    one block* (the middle block rides the first suffix stage) — a legal
    shape for the generalized layout.
    """
    n = graph.n
    if p % 2 != 0:
        raise ValueError("symmetric fold needs an even stage count")
    if p > n:
        raise ValueError(f"cannot split {n} blocks into {p} stages")
    D, h = p // 2, n // 2
    mid_t = graph.blocks[h].fwd_time if n % 2 else 0.0
    pairs = tuple(
        Block(f"pair{i}",
              (graph.blocks[i].fwd_time + graph.blocks[n - 1 - i].fwd_time
               + (mid_t if i == h - 1 else 0.0)),
              act_bytes=(graph.blocks[i].act_bytes
                         + graph.blocks[n - 1 - i].act_bytes))
        for i in range(h))
    half = linear_partition(BlockGraph(pairs), D, hw=hw, lam=lam)
    cuts = list(half.cuts) + [n - c for c in reversed(half.cuts[:-1])]
    return _mk_partition(graph, cuts, True, hw, lam)


# --------------------------------------------------------------------------
# Algorithm 1: bidirectional skip-aware DP (any skip structure)
# --------------------------------------------------------------------------

def _feasible_j_interval(graph: BlockGraph, i: int) -> tuple[int, int]:
    """Feasible suffix starts j for prefix end i — any skip structure.

    State (i, j): prefix covers [0, i), suffix covers [j, n).  The state is
    consistent iff every skip pairs prefix with suffix at this boundary:
    ``(src < i) <=> (dst >= j)``.  That pins j into the inclusive interval
    ``(max dst over skips with src >= i, min dst over skips with src < i]``
    — for nested skips this collapses to the paper's (d_m, d_{m-1}]
    interval, but no nestedness is required: sparse, partially-skipped and
    crossing topologies all reduce to the same interval form.  A chain of
    states each consistent at its boundary realizes exactly the paper's
    c(i',i,j,j') stage-symmetry predicate (skip src in stage q <=> dst in
    stage p-1-q), which is what :func:`partition_reference` enumerates.
    Returns an inclusive interval (j_lo, j_hi); empty if j_lo > j_hi.
    """
    n = graph.n
    lo, hi = i, n
    for e in graph.skips:
        if e.src < i:
            hi = min(hi, e.dst)
        else:
            lo = max(lo, e.dst + 1)
    return max(lo, i), hi


def partition_bidirectional(
    graph: BlockGraph, p: int, *,
    hw: Hardware = H100_SXM, lam: float = 1.0,
) -> Partition:
    """Skip-aware bidirectional DP (Algorithm 1) for skip graphs.

    Builds p stages (p even) pairwise from both sequence ends; stage q is
    collocated with stage p-1-q on device q.  DP state dp[(i, j)] after k
    stage-pairs = minimal max-cost covering prefix [0,i) and suffix [j,n).
    The per-state feasibility interval handles *any* skip structure —
    nested, sparse, mid-block bottlenecks, crossing — so partially-skipped
    graphs get their (generally mirror-asymmetric) DP optimum directly; the
    exponential :func:`partition_reference` is a test oracle, not a
    fallback.  For nested skips the interval collapses to the paper's
    state space, giving the O(p n^3) bound (and far less when most blocks
    carry skips).
    """
    n = graph.n
    if p % 2 != 0:
        raise ValueError("bidirectional partition needs an even stage count")
    if p > n:
        raise ValueError(f"cannot split {n} blocks into {p} stages")
    if not graph.skips:
        return partition_symmetric_fold(graph, p, hw=hw, lam=lam)

    # Pre-compute prefix sums of fwd time; stage costs on demand.
    pref = np.concatenate([[0.0], np.cumsum([b.fwd_time for b in graph.blocks])])

    def L(lo: int, hi: int) -> float:  # prefix stage [lo, hi)
        return (pref[hi] - pref[lo]) + lam * (
            hw.t_lat + graph.blocks[hi - 1].act_bytes / hw.inter_bw
        )

    def R(lo: int, hi: int) -> float:  # suffix stage [lo, hi)
        return (pref[hi] - pref[lo]) + lam * (
            hw.t_lat + graph.blocks[lo - 1].act_bytes / hw.inter_bw
        )

    # Enumerate feasible states per prefix end i (nested-skip interval).
    feas: dict[int, tuple[int, int]] = {}
    for i in range(1, n):
        lo, hi = _feasible_j_interval(graph, i)
        if lo <= hi:
            feas[i] = (lo, hi)

    return _partition_bidirectional_backtrack(graph, p, hw, lam, L, R, feas)


def _partition_bidirectional_backtrack(graph, p, hw, lam, L, R, feas) -> Partition:
    """Full DP keeping one table per generation for exact backtracking."""
    n = graph.n
    tables: list[dict[tuple[int, int], tuple[float, tuple[int, int] | None]]] = []
    t0: dict[tuple[int, int], tuple[float, tuple[int, int] | None]] = {}
    for i, (jlo, jhi) in feas.items():
        # j == i is a valid (middle-empty) state; it can only close the DP.
        for j in range(max(jlo, i), min(jhi, n - 1) + 1):
            t0[(i, j)] = (max(L(0, i), R(j, n)), None)
    tables.append(t0)
    gens = (p - 2) // 2
    for _ in range(gens):
        prev = tables[-1]
        ndp: dict[tuple[int, int], tuple[float, tuple[int, int] | None]] = {}
        for (i2, j2), (c_prev, _) in prev.items():
            for i in range(i2 + 1, n):
                if i not in feas:
                    continue
                jlo, jhi = feas[i]
                lcost = L(i2, i)
                lb = max(c_prev, lcost)
                for j in range(max(jlo, i), min(jhi, j2 - 1) + 1):
                    cand = max(lb, R(j, j2))
                    key = (i, j)
                    if key not in ndp or cand < ndp[key][0]:
                        ndp[key] = (cand, (i2, j2))
        tables.append(ndp)

    final = tables[-1]
    best, best_state = INF, None
    for (i, j), (c, _) in final.items():
        if j == i and c < best:
            best, best_state = c, (i, j)
    if best_state is None:
        raise ValueError(
            f"no feasible {p}-stage bidirectional partition "
            f"(graph n={n}, skips={len(graph.skips)})"
        )

    # collect boundaries generation by generation
    pre_cuts, suf_cuts = [], []
    state = best_state
    for g in range(len(tables) - 1, -1, -1):
        i, j = state
        pre_cuts.append(i)
        suf_cuts.append(j)
        parent = tables[g][state][1]
        if parent is None:
            break
        state = parent
    pre_cuts.reverse()           # increasing prefix ends
    suf_cuts.sort()              # increasing suffix starts
    cuts = [0] + pre_cuts + suf_cuts[1:] + [n]
    # pre_cuts[-1] == suf_cuts[0] (middle closed); stage boundaries are
    # 0, pre..., (=mid), suf..., n
    return _mk_partition(graph, cuts, True, hw, lam)


# --------------------------------------------------------------------------
# Exact reference (paper's c(i',i,j,j') predicate, any skip structure)
# --------------------------------------------------------------------------

def partition_reference(
    graph: BlockGraph, p: int, *,
    hw: Hardware = H100_SXM, lam: float = 1.0,
) -> Partition:
    """Brute-force over all cut placements; checks the paper's symmetric
    stage constraint exactly: skip (c1, c2) with c1 in stage q requires c2
    in stage p-1-q (0-indexed; Eq. (4)'s c(i',i,j,j') predicate).  Device
    collocation follows from the fold.  Exponential — tests only."""
    n = graph.n
    if p % 2 != 0:
        raise ValueError("reference partitioner assumes even stage count")

    def stage_symmetric(part: Partition) -> bool:
        return all(
            part.stage_of_block(e.dst) == p - 1 - part.stage_of_block(e.src)
            for e in graph.skips)

    best_cuts, best_cost = None, INF
    for inner in itertools.combinations(range(1, n), p - 1):
        cuts = (0,) + inner + (n,)
        part = _mk_partition(graph, cuts, True, hw, lam)
        if not stage_symmetric(part):
            continue
        if part.objective < best_cost:
            best_cost, best_cuts = part.objective, cuts
    if best_cuts is None:
        raise ValueError("no feasible partition (reference)")
    return _mk_partition(graph, best_cuts, True, hw, lam)


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def interleaved_wave_devices(S: int, D: int) -> tuple[int, ...]:
    """Cyclic stage->device mapping for a V-fold interleaved wave (S = 2VD).

    Encoder-half stage s runs on device ``s % D``; decoder-half stage s on
    ``(S-1-s) % D``, so skip-paired stages (q, S-1-q) stay collocated for
    every interleave degree.  For V == 1 this is exactly the classic mirror
    fold ``min(s, S-1-s)``.  The cyclic pattern is not a free choice: the
    ring executors deliver enc->enc messages to device (d+1) % D and
    dec->dec to (d-1) % D, which pins the placement up to rotation.
    """
    return tuple((s % D) if s < S // 2 else (S - 1 - s) % D
                 for s in range(S))


def partition(
    graph: BlockGraph, num_devices: int, *,
    hw: Hardware = H100_SXM, lam: float = 1.0, force_wave: bool | None = None,
    interleave: int = 1,
) -> Partition:
    """PULSE partitioning entry point.

    With skip edges (C != empty), uses S = 2VD folded stages and the
    bidirectional DP (paper default, §V-B).  Without skips, uses S = VD
    linear partitioning + 1F1B unless ``force_wave`` requests folding.
    ``interleave`` (V) is the number of stage slots per device and kind:
    V == 1 keeps the classic fold / linear shapes; V > 1 emits the
    interleaved (virtual-stage) placement ``interleaved_wave_devices``
    whose finer stages shrink fill/drain bubbles roughly from
    ``(D-1)/(M+D-1)`` toward ``(D-1)/(V*M+D-1)`` at the price of V weight
    shards and more ppermute hops per microbatch.
    """
    if interleave < 1:
        raise ValueError(f"interleave degree must be >= 1, got {interleave}")
    V, D = interleave, num_devices
    wave = force_wave if force_wave is not None else bool(graph.skips)
    if wave:
        S = 2 * V * D
        part = partition_bidirectional(graph, S, hw=hw, lam=lam)
        if V > 1:
            part = dataclasses.replace(
                part, devices=interleaved_wave_devices(S, D))
        return part
    if V > 1:
        S = V * D
        part = linear_partition(graph, S, hw=hw, lam=lam, folded=False)
        return dataclasses.replace(
            part, devices=tuple(s % D for s in range(S)))
    return linear_partition(graph, num_devices, hw=hw, lam=lam, folded=False)
