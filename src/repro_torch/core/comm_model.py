"""Analytic communication-volume models (paper §II-C, §V-B, Table III).

A copy of ``repro.core.comm_model``: the port imports nothing of the JAX
package, so it keeps its own copy of this framework-neutral module.

All volumes are *bytes per microbatch* unless stated otherwise.  These
formulas are validated against byte counts parsed from compiled HLO by
``benchmarks/comm_volume.py`` (collective-permute operand sums).

Graph ``act_bytes`` are denominated at 2 bytes/element (bf16 activations —
see the graph builders in ``models.diffusion``).  :func:`wire_factor`
rescales them to the executor's wire format, and
:func:`lowered_comm_volume` prices what the table executors *actually*
lower — live hops only (the schedule's channel-activity masks) at the wire
dtype — against the dense pre-liveness cost (every step, both rings,
fp32).  This is the point where the planner's model and the executor's
measured HLO bytes are held to agree.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.graph import BlockGraph
from repro_torch.core.partition import Partition

# Bytes per element of the wire formats the lowered executors support
# (runtime.pipeline.WIRE_DTYPES).  Graph act_bytes assume 2 (bf16).
WIRE_BYTES = {"bfloat16": 2, "float32": 4}
ACT_DENOM_BYTES = 2


def wire_factor(wire_dtype: str = "bfloat16") -> float:
    """Scale from the graph's act_bytes denomination to wire bytes."""
    return WIRE_BYTES[wire_dtype] / ACT_DENOM_BYTES


def naive_pp_volume(K: int, D: int, a: int) -> float:
    """Paper §II-C: sequential block-wise partition of a UNet with K blocks
    (K/2 skip pairs) over D devices; every skip hops stage-by-stage.
    Total per-microbatch forward volume: ((K+4)*D/4 - 1) * a."""
    return ((K + 4) * D / 4 - 1) * a


def pulse_volume(D: int, a: int) -> float:
    """Paper §V-B: skip-collocated wave needs only boundary transfers:
    2*(D-1)*a per microbatch (down-stream + up-stream)."""
    return 2 * (D - 1) * a


def zero_volume_per_iter(param_bytes: int, G: int, stage: int = 2) -> float:
    """ZeRO-stage-2/3 per-iteration collective volume per device (ring):
    reduce-scatter(grads) + all-gather(params) ~= 2 * (G-1)/G * P bytes,
    ZeRO-3 re-gathers params in both passes (x2)."""
    base = 2.0 * (G - 1) / G * param_bytes
    return base * (2.0 if stage >= 3 else 1.0)


@dataclasses.dataclass(frozen=True)
class PartitionCommVolume:
    boundary_bytes: float     # short-range stage-to-stage (fwd, per microbatch)
    skip_bytes: float         # long-range skip traffic (fwd, per microbatch)

    @property
    def fwd_total(self) -> float:
        return self.boundary_bytes + self.skip_bytes

    @property
    def train_total(self) -> float:
        # backward transfers mirror the forward ones (activation gradients)
        return 2.0 * self.fwd_total


def partition_comm_volume(graph: BlockGraph, part: Partition) -> PartitionCommVolume:
    """Exact per-microbatch P2P volume for an arbitrary partition.

    Boundary: each stage sends its output tensor to the next stage if it is
    on a different device.  Skip: each skip edge whose endpoints live on
    different devices is relayed hop-by-hop through every intermediate
    stage boundary (the paper's 1F1B/Hanayo baseline semantics: stacked,
    transferred, popped).
    """
    boundary = 0.0
    for s in range(part.num_stages - 1):
        if part.device_of_stage(s) != part.device_of_stage(s + 1):
            lo, hi = part.stage_range(s)
            boundary += graph.blocks[hi - 1].act_bytes
    skip = 0.0
    for e in graph.skips:
        s_src = part.stage_of_block(e.src)
        s_dst = part.stage_of_block(e.dst)
        if part.device_of_stage(s_src) == part.device_of_stage(s_dst):
            continue  # collocated: local buffer, no transfer
        hops = 0
        for s in range(s_src, s_dst):
            if part.device_of_stage(s) != part.device_of_stage(s + 1):
                hops += 1
        skip += hops * e.bytes
    return PartitionCommVolume(boundary, skip)


def per_sample_volume(
    graph: BlockGraph, part: Partition, microbatch_size: int
) -> float:
    """Bytes/sample of P2P traffic for one training iteration (fwd+bwd)."""
    v = partition_comm_volume(graph, part)
    return v.train_total / max(microbatch_size, 1)


@dataclasses.dataclass(frozen=True)
class LoweredCommVolume:
    """What the table executors put on the ring for one iteration's
    forward pass, as lowered from the schedule's channel-activity masks.

    ``live_hops`` counts (device, step, ring) hops that carry a message;
    ``dense_hops`` is what the pre-liveness lowering paid (every step,
    both rings); ``payload_bytes`` is the boundary activation size at the
    graph's 2-byte/element denomination.
    """

    live_hops: int
    dense_hops: int
    payload_bytes: float
    wire_dtype: str = "bfloat16"

    @property
    def hop_bytes(self) -> float:
        return self.payload_bytes * wire_factor(self.wire_dtype)

    @property
    def fwd_total(self) -> float:
        return self.live_hops * self.hop_bytes

    @property
    def train_total(self) -> float:
        # backward hops mirror the forward ones through the cast/ppermute
        # transposes, at the same wire dtype
        return 2.0 * self.fwd_total

    @property
    def dense_fp32_total(self) -> float:
        """The pre-liveness executor's cost: every-step/both-rings fp32."""
        return self.dense_hops * self.payload_bytes * wire_factor("float32")


def lowered_comm_volume(tables, payload_bytes: float,
                        wire_dtype: str = "bfloat16") -> LoweredCommVolume:
    """Price a lowered schedule's actual ring traffic.

    ``tables`` is duck-typed on the
    :class:`~repro_torch.runtime.schedule_exec.StepTables` activity analysis
    (``live_hops`` / ``dense_hops``) so the planning layer never imports
    the runtime; ``payload_bytes`` is the boundary activation size
    (``StageProfile.out_bytes_per_sample`` x microbatch size).
    """
    down, up = tables.live_hops
    return LoweredCommVolume(live_hops=down + up,
                             dense_hops=tables.dense_hops,
                             payload_bytes=payload_bytes,
                             wire_dtype=wire_dtype)


@dataclasses.dataclass(frozen=True)
class OverlapAccounting:
    """Exposed-vs-hidden split of a schedule's live ring hops.

    An **exposed** hop's consumer runs on the very next forward step, so
    even the overlapped executors (``PipelineConfig.overlap``) pay its
    full wire time on the critical path; a **hidden** hop has at least
    one intervening step of compute to ride under, costing only the wire
    time the covering compute does not absorb.  This is the accounting
    the tuner's overlap-aware Eq. 15 term prices and the point where the
    planner (``core.schedule.comm_stats``) and the executor lowering
    (``StepTables.exposed_hops``) are held to agree — the overlap
    counterpart of :func:`lowered_comm_volume`'s byte agreement.
    """

    exposed_hops: int
    hidden_hops: int

    @property
    def total_hops(self) -> int:
        return self.exposed_hops + self.hidden_hops

    def comm_time(self, t_p2p: float, t_f: float,
                  overlap: bool = True) -> float:
        """Total wire seconds on the critical path.

        ``t_p2p`` is one hop's wire time, ``t_f`` the typical compute a
        hidden hop rides under.  ``overlap=False`` prices the synchronous
        lowering: every live hop serializes at full ``t_p2p``.
        """
        if not overlap:
            return self.total_hops * t_p2p
        return (self.exposed_hops * t_p2p
                + self.hidden_hops * max(0.0, t_p2p - t_f))


def overlap_accounting(tables) -> OverlapAccounting:
    """Extract the exposed/hidden split from a lowered or analyzed
    schedule.  ``tables`` is duck-typed on ``exposed_hops`` /
    ``hidden_hops`` — both
    :class:`~repro_torch.runtime.schedule_exec.StepTables` and the
    planner-side :class:`~repro_torch.core.schedule.ScheduleCommStats`
    qualify, so either layer's analysis can be priced (and the property
    tests hold the two to agree)."""
    return OverlapAccounting(exposed_hops=int(tables.exposed_hops),
                             hidden_hops=int(tables.hidden_hops))
