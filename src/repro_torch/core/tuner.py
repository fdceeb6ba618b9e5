"""Hybrid parallelism tuner (paper §VI, Eqs. 14-17).

Given per-stage profiled costs, enumerate every factorization ``N = P * G``
and every power-of-two microbatch size ``b``; reject configurations whose
peak memory (Eq. 14) exceeds the device budget; score the rest with the
iteration-time model (Eq. 15 + 16) and return the argmin of per-sample time
(Eq. 17).

A copy of ``repro.core.tuner``: the port imports nothing of the JAX
package, so it keeps its own copy of this framework-neutral module.  The
one difference: the default hardware is the port's ``H100_SXM``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.core.comm_model import (WIRE_BYTES, wire_factor,
                                         zero_volume_per_iter)
from repro_torch.core.graph import BlockGraph
from repro_torch.core.hw import Hardware, H100_SXM
from repro_torch.core import partition as part_mod
from repro_torch.core.schedule import (schedule_for_partition, simulate,
                                       template_1f1b, template_wave)


@dataclasses.dataclass(frozen=True)
class StageProfile:
    """Per-stage profiled quantities; indices follow pipeline stage order.

    ``act_bytes_per_sample`` includes each stage's skip-stash bytes (the
    historical aggregate every dense consumer prices);
    ``skip_bytes_per_sample`` additionally breaks the skip share out per
    stage so :func:`peak_memory` can price the stash at the proven
    ``W_skip`` rotating window instead of dense over all ``P`` in-flight
    microbatches.  Legacy profiles may leave it empty (skip treated as
    inseparable from the activations — the dense pricing)."""

    fwd_time_per_sample: tuple[float, ...]   # T_f^s(b) = b * this
    param_bytes: tuple[int, ...]             # M_theta^s
    act_bytes_per_sample: tuple[int, ...]    # M_a^s (incl. skip share)
    out_bytes_per_sample: tuple[int, ...]    # M_o^s
    skip_bytes_per_sample: tuple[int, ...] = ()   # skip share of M_a^s

    @property
    def num_stages(self) -> int:
        return len(self.fwd_time_per_sample)


def profile_partition(graph: BlockGraph, part: part_mod.Partition) -> StageProfile:
    f, p, a, o, k = [], [], [], [], []
    for s in range(part.num_stages):
        lo, hi = part.stage_range(s)
        blocks = graph.blocks[lo:hi]
        f.append(sum(b.fwd_time for b in blocks))
        p.append(sum(b.param_bytes for b in blocks))
        a.append(sum(b.act_bytes + b.skip_bytes for b in blocks))
        o.append(blocks[-1].act_bytes)
        k.append(sum(b.skip_bytes for b in blocks))
    return StageProfile(tuple(f), tuple(p), tuple(a), tuple(o), tuple(k))


@dataclasses.dataclass(frozen=True)
class TunerChoice:
    P: int                 # pipeline-parallel degree (devices per pipeline)
    G: int                 # data-parallel replicas
    b: int                 # microbatch size
    t_sample: float        # modelled seconds per training sample (Eq. 17)
    t_sched: float         # modelled iteration time (Eq. 15)
    peak_mem: float        # modelled peak bytes (Eq. 14)
    wave: bool             # folded wave (S=2VP) vs plain 1F1B (S=VP)
    M: int = 1             # microbatches per iteration the score assumed —
    #   auto_pipeline executes this M so the iteration it runs is the one
    #   the tuner ranked (previously the executor silently ran M = 2D).
    V: int = 1             # interleave degree: stage slot pairs per device
    #   (V > 1 = interleaved/virtual-stage schedule; finer stages shrink
    #   the fill/drain ramp ~1/V at the cost of V padded weight shards and
    #   more p2p hops per microbatch)
    partition: "part_mod.Partition | None" = None
    # ^ the partition this choice was scored on — the compile path
    #   (runtime.compile.auto_pipeline) lowers it directly.
    zero_stage: int = 0    # ZeRO sharding over the dp axis: 0 = replicated,
    #   1 = optimizer state sharded, 2 = params-at-rest + grads +
    #   optimizer state sharded (all-gather-on-use in the scan body)

    @property
    def dp(self) -> int:
        """Data-parallel degree (alias: the mesh's 'data' axis size)."""
        return self.G


def zero_param_state_breakdown(
    m_theta: float, *, dp: int = 1, zero_stage: int = 0,
    param_state_factor: float = 7.0, m_gather: float | None = None,
) -> dict[str, float]:
    """Per-device param/grad/optimizer resident bytes under ZeRO sharding.

    Decomposes the legacy lump ``param_state_factor * m_theta`` into
    params (1x), grads (1x) and optimizer state (``param_state_factor -
    2`` x, the AdamW m/v/master share).  ZeRO-1 shards the optimizer
    term over the ``dp`` replicas; ZeRO-2 also shards params-at-rest and
    the (reduce-scattered) grads, charging one transient all-gathered
    working copy ``m_gather`` for the stage slot currently in use
    (default: all of ``m_theta`` — conservative for multi-slot layouts
    whose callers don't pass the per-slot size).  The components are the
    executor's actual sharded leaf bytes (``runtime.sharding.
    zero_stack_specs`` scatters every eligible leaf by exactly ``dp``),
    which the property tests pin.
    """
    opt = max(param_state_factor - 2.0, 0.0)
    if dp <= 1 or zero_stage <= 0:
        return {"params": m_theta, "grads": m_theta,
                "opt": opt * m_theta, "gathered": 0.0}
    if zero_stage == 1:
        return {"params": m_theta, "grads": m_theta,
                "opt": opt * m_theta / dp, "gathered": 0.0}
    if m_gather is None:
        m_gather = m_theta
    return {"params": m_theta / dp, "grads": m_theta / dp,
            "opt": opt * m_theta / dp, "gathered": float(m_gather)}


def zero_param_state_bytes(
    m_theta: float, *, dp: int = 1, zero_stage: int = 0,
    param_state_factor: float = 7.0, m_gather: float | None = None,
) -> float:
    """Scalar form of :func:`zero_param_state_breakdown`; bit-identical
    to the legacy ``param_state_factor * m_theta`` when unsharded."""
    if dp <= 1 or zero_stage <= 0:
        return param_state_factor * m_theta
    return sum(zero_param_state_breakdown(
        m_theta, dp=dp, zero_stage=zero_stage,
        param_state_factor=param_state_factor, m_gather=m_gather).values())


def peak_memory(
    prof: StageProfile, P: int, b: int, *, wave: bool, V: int = 1,
    param_state_factor: float = 7.0,
    windows: "tuple[int, int] | tuple[int, int, int] | None" = None,
    wire_bytes: int = 2,
    dp: int = 1, zero_stage: int = 0,
) -> float:
    """Eq. (14).  The busiest devices are the innermost collocated pair
    (stages P-1 and P, 0-indexed) which retain activations for all
    in-flight microbatches (P of them in the wave steady state).

    ``V > 1`` prices the interleaved layout instead: each device carries
    ``2V`` (``V`` linear) stage slots whose parameter/activation stacks
    are padded to the *largest* slot — the memory side of the
    bubble-vs-V trade-off the tuner searches over.

    ``windows = (W_rx, W_turn)`` replaces the dense in-flight boundary
    term (``P`` / ``P + 2V - 2`` activations) with the liveness windows
    the schedule lowering proved: ``W_rx`` receive-buffer entries at
    ``wire_bytes``/element (the wire format of the hops) plus two ring
    registers, and ``W_turn`` turnaround entries at fp32.  The 3-tuple
    form ``(W_rx, W_turn, W_skip)`` additionally prices the skip stash
    at its proven rotating window — ``W_skip`` fp32 entries of the
    largest per-stage skip payload — instead of dense over all ``P``
    in-flight microbatches (the executor allocates exactly ``W_skip``
    rotating entries, so the dense charge over-billed skip-heavy
    candidates).  ``tune`` passes the lowered 3-tuple, so smaller proven
    footprints admit larger microbatches on memory-bound candidates.
    Without windows the dense pre-liveness sizing is priced (back-compat
    / no schedule yet); the legacy 2-tuple keeps skip dense.

    ``dp``/``zero_stage`` charge the ZeRO-sharded param/optimizer bytes
    instead of the replicated ``param_state_factor * m_theta`` lump (see
    :func:`zero_param_state_breakdown`): optimizer state ``/dp`` at
    ZeRO-1+, params-at-rest and grads ``/dp`` plus one transient
    gathered stage copy at ZeRO-2.  ``dp <= 1`` or ``zero_stage == 0``
    is bit-identical to the historical form.
    """
    from repro_torch.core.comm_model import ACT_DENOM_BYTES

    def param_state(m_theta: float, m_gather: float) -> float:
        return zero_param_state_bytes(
            m_theta, dp=dp, zero_stage=zero_stage,
            param_state_factor=param_state_factor, m_gather=m_gather)

    def boundary_term(m_out: float, dense_count: float) -> float:
        if windows is None:
            return dense_count * m_out * b
        w_rx, w_turn = windows[0], windows[1]
        return m_out * b * ((w_rx + 2) * wire_bytes / ACT_DENOM_BYTES
                            + w_turn * 4 / ACT_DENOM_BYTES)

    w_skip = None
    if windows is not None and len(windows) == 3 and prof.skip_bytes_per_sample:
        w_skip = windows[2]
    skips = prof.skip_bytes_per_sample or (0,) * prof.num_stages
    # The skip stash lives at fp32 regardless of the wire format (it never
    # rides the ring; act bytes are denominated at ACT_DENOM_BYTES/elem).
    skip_entry_factor = b * 4 / ACT_DENOM_BYTES

    if V > 1:
        slots = 2 * V if wave else V
        m_theta = slots * max(prof.param_bytes)
        if w_skip is None:
            m_act = slots * max(prof.act_bytes_per_sample)
            skip_term = 0.0
        else:
            m_act = slots * max(a - k for a, k in
                                zip(prof.act_bytes_per_sample, skips))
            skip_term = w_skip * max(skips) * skip_entry_factor
        m_out = max(prof.out_bytes_per_sample)
        return (param_state(m_theta, max(prof.param_bytes))
                + P * m_act * b
                + skip_term
                + boundary_term(m_out, P + slots - 2))
    if wave:
        i, j = P - 1, P  # innermost pair on the same device
        m_theta = prof.param_bytes[i] + prof.param_bytes[j]
        if w_skip is None:
            m_act = prof.act_bytes_per_sample[i] + prof.act_bytes_per_sample[j]
            skip_term = 0.0
        else:
            m_act = (prof.act_bytes_per_sample[i] - skips[i]
                     + prof.act_bytes_per_sample[j] - skips[j])
            skip_term = w_skip * max(skips[i], skips[j]) * skip_entry_factor
        m_out = prof.out_bytes_per_sample[i - 1] if i >= 1 else prof.out_bytes_per_sample[0]
    else:
        # 1F1B: stage 0 retains P microbatches (skip-free graphs, but the
        # windowed form stays uniform if a profile carries skip bytes)
        m_theta = prof.param_bytes[0]
        if w_skip is None:
            m_act = prof.act_bytes_per_sample[0]
            skip_term = 0.0
        else:
            m_act = prof.act_bytes_per_sample[0] - skips[0]
            skip_term = w_skip * skips[0] * skip_entry_factor
        m_out = prof.out_bytes_per_sample[0]
    return (
        param_state(m_theta, m_theta)
        + P * m_act * b
        + skip_term
        + boundary_term(m_out, P)
    )


def t_allreduce(param_bytes: float, G: int, hw: Hardware) -> float:
    """Eq. (16): ring all-reduce of the largest stage's gradients.

    Routed through the same ``2(G-1)/G`` volume arithmetic as the ZeRO
    term so stage-0/1 and stage-2 candidates with identical modelled
    volume tie *exactly* (bit-for-bit) and the tuner's zero_stage
    tie-break stays deterministic."""
    if G <= 1:
        return 0.0
    return hw.t_lat + zero_volume_per_iter(param_bytes, G, 2) / hw.intra_bw


def t_grad_sync(param_bytes: float, G: int, hw: Hardware,
                zero_stage: int = 0) -> float:
    """Eq. (16) generalized to the ZeRO stages.

    ZeRO-0/1 all-reduce the gradients (ZeRO-1's optimizer shard update is
    local, so its wire cost is the same ring all-reduce).  ZeRO-2 pays
    the all-gather-on-use + gradient reduce-scatter volume instead
    (:func:`repro_torch.core.comm_model.zero_volume_per_iter` — the same
    ``2(G-1)/G`` ring bytes an all-reduce moves, which is ZeRO's claim:
    sharding the state costs no extra steady-state volume).
    """
    if G <= 1:
        return 0.0
    if zero_stage >= 2:
        return hw.t_lat + (zero_volume_per_iter(param_bytes, G, zero_stage)
                           / hw.intra_bw)
    return t_allreduce(param_bytes, G, hw)


def t_sched_paper(
    prof: StageProfile, P: int, b: int, G: int, hw: Hardware,
    *, M: int | None = None, V: int = 1, wire_dtype: str = "bfloat16",
    overlap: bool = True, zero_stage: int = 0,
) -> float:
    """Eq. (15): (10P-4) T_f(b) + (10P-12)(t_lat + b M_o / B) + T_AR.

    The paper's closed form corresponds to M = P microbatches per
    iteration on the S = 2P wave: 6 T_f steady state per microbatch per
    device plus a ~4P ramp, i.e. (6M + 4P - 4) T_f at M = P.  Passing a
    different ``M`` prices that iteration shape with the same wave model
    (so custom ``microbatches_per_iter`` overrides in :func:`tune` are
    scored for the M they actually execute); ``tune`` records the scored M
    on ``TunerChoice.M`` and the executor runs the same iteration shape.

    ``V`` generalizes the form to the interleaved S = 2VP wave: the
    steady state becomes 6V unit tasks per microbatch per device and every
    unit task (compute *and* p2p event) counts one of the finer V-fold
    stages, so with ``prof`` profiled on the V-fold partition (t_f roughly
    1/V of the 2P fold's), the compute steady state is unchanged, the
    fill/drain ramp ``4P * t_f`` shrinks ~1/V, and the p2p event count
    grows ~V — exactly the bubble-vs-communication trade the interleave
    axis searches.  V = 1 is Eq. (15) verbatim.

    ``wire_dtype`` prices the boundary hops at the executor's wire format
    (``m_o`` is denominated at 2 bytes/element, so bf16 — the default —
    is a factor of 1 and fp32-wire doubles the hop bytes).  Until the
    liveness lowering landed, the table executors paid fp32 on every hop
    while this model priced bf16 — the executors now pay what Eq. (15)
    prices.

    ``overlap`` prices the double-buffered executors
    (``PipelineConfig.overlap``, the default): the ~``4P-12`` fill/drain
    ramp hops stay *exposed* (their consumer runs on the very next step,
    nothing to hide under) and cost full ``p2p``, while the ``6VM``
    steady-state hops ride under the next step's compute and only cost
    what that compute does not absorb, ``max(0, p2p - t_f)`` — the same
    split :class:`repro_torch.core.comm_model.OverlapAccounting` prices
    from a lowered schedule.  ``overlap=False`` is the synchronous lowering:
    every hop serializes at full ``p2p`` (the historical form).
    """
    if M is None:
        M = P
    t_f = max(prof.fwd_time_per_sample) * b
    m_o = max(prof.out_bytes_per_sample) * b * wire_factor(wire_dtype)
    m_theta = max(prof.param_bytes)
    p2p = hw.t_lat + m_o / hw.inter_bw
    n_hops = max(6 * V * M + 4 * P - 12, 0)
    if overlap:
        n_ramp = min(max(4 * P - 12, 0), n_hops)
        t_comm = n_ramp * p2p + (n_hops - n_ramp) * max(0.0, p2p - t_f)
    else:
        t_comm = n_hops * p2p
    return (
        (6 * V * M + 4 * P - 4) * t_f
        + t_comm
        + t_grad_sync(m_theta, G, hw, zero_stage)
    )


def t_sched_simulated(
    prof: StageProfile, P: int, b: int, G: int, hw: Hardware,
    *, microbatches: int, wave: bool,
    part: "part_mod.Partition | None" = None,
    sched=None, wire_dtype: str = "bfloat16", overlap: bool = True,
    zero_stage: int = 0,
) -> float:
    """Higher-fidelity alternative: event-driven simulation of the actual
    schedule with per-stage durations (beyond-paper option).  With a
    ``part``, the schedule is synthesized for that partition's own
    stage->device mapping (required to price interleaved V > 1 plans);
    otherwise the classic V = 1 templates are simulated.  The schedule
    depends only on (part, microbatches) — callers sweeping b (the
    tuner's inner loop) should synthesize once and pass ``sched``.
    ``overlap`` selects whether cross-device sends occupy the sender
    (synchronous lowering) or ride under its next task (the
    double-buffered executors) — see
    :func:`repro_torch.core.schedule.simulate`."""
    if sched is None:
        if part is not None:
            sched = schedule_for_partition(part, microbatches)
        else:
            sched = (template_wave(P, microbatches) if wave
                     else template_1f1b(P, microbatches))
    times = [t * b for t in prof.fwd_time_per_sample]
    m_o = max(prof.out_bytes_per_sample) * b * wire_factor(wire_dtype)
    mk, _ = simulate(sched, times, bwd_ratio=2.0,
                     p2p_time=hw.t_lat + m_o / hw.inter_bw,
                     overlap=overlap)
    return mk + t_grad_sync(max(prof.param_bytes), G, hw, zero_stage)


def tune(
    graph: BlockGraph,
    N: int,
    *,
    hw: Hardware = H100_SXM,
    max_microbatch: int = 512,
    lam: float = 1.0,
    use_simulation: bool = False,
    microbatches_per_iter: Callable[[int], int] | None = None,
    drops: list[str] | None = None,
    interleave_options: Sequence[int] | None = None,
    wire_dtype: str = "bfloat16",
    overlap: bool = True,
    zero_stages: Sequence[int] = (0, 1, 2),
) -> list[TunerChoice]:
    """Enumerate (P, G, b) — and the interleave degree V for wave plans —
    and return all feasible choices, best first.

    ``N`` is the total device count.  ``microbatches_per_iter(P)`` defaults
    to M = P — the iteration shape Eq. (15)'s (10P-4) closed form prices
    (6*T_f steady-state per microbatch per device + ~4P ramp), which makes
    Eq. (17)'s denominator b*M*G the per-iteration sample count.  The M
    each choice was scored with is recorded on ``TunerChoice.M``;
    ``auto_pipeline`` executes that M.

    ``interleave_options`` lists the V values to search (default: (1, 2)
    for wave graphs, (1,) for skip-free ones).  Each V gets its own V-fold
    partition, profile, memory check (``peak_memory`` prices the V padded
    weight shards) and iteration-time score (the V-generalized Eq. (15),
    or the event-driven simulation of the interleaved schedule under
    ``use_simulation``) — V is a search axis exactly like (P, G, b), and
    the winning choice's V rides to the executor through its partition.

    ``drops`` (optional out-param) collects one human-readable reason per
    (pipeline degree, interleave degree) that yielded NO choice — recorded
    here, at the point each filter fires, so error reports read facts
    rather than re-simulating the filter (``auto_pipeline`` surfaces them
    when nothing survives).

    Every P > 1 candidate's schedule is synthesized and lowered to step
    tables here, so (a) ``peak_memory`` is checked against the
    schedule-proven liveness windows (rotating rx/turn buffers, not the
    dense ``O(P)`` in-flight sizing — memory-bound candidates admit
    larger microbatches) at ``wire_dtype`` hop bytes, and (b) plans whose
    schedule the executors cannot realize are dropped with a reason
    instead of failing later in ``auto_pipeline``.

    ``overlap`` must match the executor mode the winning choice will run
    (``PipelineConfig.overlap``): both scorers price hidden steady-state
    hops at ``max(0, p2p - t_f)`` when True and full ``p2p`` when False,
    so the tuner ranks candidates by the comm cost the lowering actually
    pays.

    ``zero_stages`` lists the ZeRO stages to search for every dp > 1
    candidate (dp is ``G``, the data axis of the hybrid mesh): 0
    replicates param/optimizer state, 1 shards the optimizer state over
    dp, 2 also shards params-at-rest + grads with an all-gather-on-use
    in the executor scan body.  ``peak_memory`` charges the sharded
    bytes and the scorers price the ZeRO collective volume
    (:func:`t_grad_sync`), so memory-bound big configs become feasible
    at higher stages — ties on modelled time break toward the *lowest*
    stage (least sharding machinery).  ``G == 1`` candidates only ever
    score stage 0 (there is nothing to shard over).
    """
    if microbatches_per_iter is None:
        microbatches_per_iter = lambda P: max(P, 1)
    wave = bool(graph.skips)
    if interleave_options is None:
        interleave_options = (1, 2) if wave else (1,)
    choices: list[TunerChoice] = []
    for P in sorted({d for d in range(1, N + 1) if N % d == 0}):
        G = N // P
        for V in (interleave_options if P > 1 else (1,)):
            vtag = f"P={P}" if V == 1 else f"P={P} V={V}"
            S = (2 * V * P if wave else V * P) if P > 1 else 1
            if S > graph.n or S < 1:
                if drops is not None:
                    drops.append(f"{vtag}: needs S={S} stages but the "
                                 f"graph has only {graph.n} blocks")
                continue
            try:
                if P == 1:
                    part = part_mod.Partition((0, graph.n), False, 0.0,
                                              (0.0,))
                else:
                    part = part_mod.partition(graph, P, hw=hw, lam=lam,
                                              force_wave=wave, interleave=V)
            except ValueError as e:
                if drops is not None:
                    drops.append(f"{vtag}: partitioner infeasible: {e}")
                continue
            prof = profile_partition(graph, part)
            M = microbatches_per_iter(P)
            # the synthesized schedule depends on (part, M) only — hoist
            # it out of the b sweep (the interleaved portfolio race is
            # the expensive part of simulation scoring), and lower it to
            # step tables for the liveness windows peak_memory prices
            sched = None
            windows = None
            if P > 1:
                # Deliberate layering exception: the windows charged here
                # must be EXACTLY the buffers the executor will allocate,
                # so the tuner reuses the executors' own (memoized)
                # lowering instead of re-deriving the liveness analysis
                # in core and risking divergence.  The import stays lazy
                # so planning modules don't pull torch in at import time.
                from repro_torch.runtime.schedule_exec import StepTables
                try:
                    sched = schedule_for_partition(part, M)
                    tabs = StepTables.from_schedule(
                        sched, folded=bool(getattr(part, "folded", False)),
                        devices=part.devices)
                except (ValueError, RuntimeError) as e:
                    if drops is not None:
                        drops.append(f"{vtag}: schedule synthesis/lowering "
                                     f"infeasible: {e}")
                    continue
                windows = (tabs.W_down + tabs.W_up, tabs.W_turn,
                           tabs.W_skip)
            for z in (tuple(zero_stages) if G > 1 else (0,)):
                ztag = vtag if z == 0 else f"{vtag} zero{z}"
                b = 1
                while b <= max_microbatch:
                    mem = peak_memory(prof, max(P, 1), b,
                                      wave=wave and P > 1, V=V,
                                      windows=windows,
                                      wire_bytes=WIRE_BYTES[wire_dtype],
                                      dp=G, zero_stage=z)
                    if mem >= hw.mem_limit:
                        if b == 1 and drops is not None:
                            if z == 0:
                                drops.append(
                                    f"{ztag}: smallest microbatch already "
                                    f"exceeds the memory budget (peak "
                                    f"{mem / 1e9:.2f} GB >= "
                                    f"{hw.mem_limit / 1e9:.2f} GB)")
                            else:
                                drops.append(
                                    f"{ztag}: smallest microbatch exceeds "
                                    f"the memory budget even with ZeRO-{z} "
                                    f"param/optimizer state sharded over "
                                    f"dp={G} (peak {mem / 1e9:.2f} GB >= "
                                    f"{hw.mem_limit / 1e9:.2f} GB)")
                        break
                    if use_simulation and P > 1:
                        t_iter = t_sched_simulated(prof, P, b, G, hw,
                                                   microbatches=M, wave=wave,
                                                   part=part, sched=sched,
                                                   wire_dtype=wire_dtype,
                                                   overlap=overlap,
                                                   zero_stage=z)
                    elif P > 1:
                        t_iter = t_sched_paper(prof, P, b, G, hw, M=M, V=V,
                                               wire_dtype=wire_dtype,
                                               overlap=overlap,
                                               zero_stage=z)
                    else:
                        # pure DP: compute + gradient synchronization
                        t_f = sum(prof.fwd_time_per_sample) * b
                        t_iter = 3.0 * t_f * M + t_grad_sync(
                            sum(prof.param_bytes), G, hw, z
                        )
                    samples = b * M * G
                    choices.append(TunerChoice(
                        P=P, G=G, b=b,
                        t_sample=t_iter / samples,
                        t_sched=t_iter,
                        peak_mem=mem,
                        wave=wave and P > 1,
                        M=M,
                        V=V if P > 1 else 1,
                        partition=part,
                        zero_stage=z,
                    ))
                    b *= 2
    # ties on modelled time break toward the least sharding machinery
    choices.sort(key=lambda c: (c.t_sample, c.zero_stage))
    return choices


def shrink_plan(surviving_devices: int, *, dp: int, pp: int,
                zero_stage: int = 0,
                graph: BlockGraph | None = None,
                hw: Hardware = H100_SXM) -> tuple[int, int, int]:
    """Re-plan ``(dp, pp, zero_stage)`` for a shrunken device pool — the
    supervisor's re-tune entry point after a host loss.

    With ``graph`` the full tuner re-runs on the surviving count
    (``tune(graph, surviving_devices, ...)``) and the best feasible
    choice wins — the paper's Eq. 14-17 machinery pricing the smaller
    cluster.  Without it (the supervisor is a framework-free process manager
    that does not hold the model graph) a deterministic structural
    policy applies:

    - keep the pipeline depth while it still fits (per-device weight
      shard size is set by ``pp``, so preserving it preserves memory
      feasibility) and shed data-parallel replicas first;
    - once even ``dp = 1`` cannot fund the old depth, halve ``pp`` until
      ``dp * pp <= surviving_devices`` (power-of-two descent mirrors the
      tuner's factorization lattice);
    - cap ``zero_stage`` by the new dp (sharding over one replica is a
      no-op: stage drops to 0 when ``dp`` reaches 1).

    Raises ``ValueError`` when no device survives.
    """
    if surviving_devices < 1:
        raise ValueError(
            f"cannot re-plan for {surviving_devices} surviving devices — "
            "the cluster is gone")
    if graph is not None:
        choices = tune(graph, surviving_devices, hw=hw,
                       zero_stages=tuple(sorted({0, zero_stage})))
        if choices:
            best = choices[0]
            return best.G, best.P, best.zero_stage
    new_pp = max(min(pp, surviving_devices), 1)
    while surviving_devices // new_pp < 1:
        new_pp = max(new_pp // 2, 1)
    new_dp = max(min(dp, surviving_devices // new_pp), 1)
    new_zero = zero_stage if new_dp > 1 else 0
    return new_dp, new_pp, new_zero
