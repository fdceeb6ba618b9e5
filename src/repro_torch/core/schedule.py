"""Pipeline schedule synthesis under collocation constraints (paper §V).

A copy of ``repro.core.schedule``: the port imports nothing of the JAX package, so it
keeps its own copy of this framework-neutral module.

Tasks are *virtual stages*: for a partition with S pipeline stages, each
microbatch m executes the chain

    F_0 -> F_1 -> ... -> F_{S-1} -> B_{S-1} -> ... -> B_0

(2S unit tasks).  F_s and B_s run on the stage's device; skip collocation
pins stage s and its mirror onto one device (folded mapping).

Components:

- ``ilp_schedule``     — the paper's ILP (Eqs. 6-13) via scipy/HiGHS; exact
                         bubble-minimal schedules for small instances.
                         Supports free device mapping or a fixed mapping.
- ``greedy_schedule``  — scalable template generator (backward-first list
                         scheduling).  Recovers classic 1F1B when S == D and
                         the Hanayo-style wave when S == 2D folded; this is
                         the "replicate the small-instance pattern" mechanism
                         of §V-B.
- ``validate_schedule`` — checks all six constraint families.
- ``simulate``          — event-driven makespan with real per-stage durations
                          and p2p latency; bubble-ratio reporting.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np


# --------------------------------------------------------------------------
# Virtual-stage helpers
# --------------------------------------------------------------------------

def num_virtual(S: int) -> int:
    return 2 * S

def stage_of_virtual(v: int, S: int) -> int:
    return v if v < S else 2 * S - 1 - v

def is_backward(v: int, S: int) -> bool:
    return v >= S


@dataclasses.dataclass(frozen=True)
class Placement:
    virtual: int      # virtual stage index (0..2S-1)
    microbatch: int
    device: int
    step: int         # scheduling step (unit slot)


@dataclasses.dataclass(frozen=True)
class DevicePrograms:
    """Dense per-device step programs lowered from a :class:`Schedule`.

    Three ``[D, makespan]`` arrays: ``virtual[d, t]`` / ``microbatch[d, t]``
    give the task device ``d`` runs at step ``t`` (``-1`` when idle) and
    ``valid[d, t]`` marks occupied slots.  This is ``Schedule.grid()`` in
    array form — the lowering-facing representation the table-driven
    executors (``runtime.schedule_exec``) consume, and the thing to print
    next to :meth:`Schedule.to_ascii` when debugging a plan.
    """

    virtual: np.ndarray
    microbatch: np.ndarray
    valid: np.ndarray

    @property
    def num_devices(self) -> int:
        return self.virtual.shape[0]

    @property
    def num_steps(self) -> int:
        return self.virtual.shape[1]


@dataclasses.dataclass(frozen=True)
class Schedule:
    S: int            # pipeline stages
    M: int            # microbatches
    D: int            # devices
    placements: tuple[Placement, ...]

    @property
    def makespan(self) -> int:
        if not self.placements:
            raise ValueError(
                f"schedule (S={self.S}, M={self.M}, D={self.D}) has no "
                "placements — makespan is undefined on an empty schedule "
                "(validate_schedule reports this as a family (6) violation)")
        return 1 + max(p.step for p in self.placements)

    def grid(self) -> list[list[Placement | None]]:
        g: list[list[Placement | None]] = [
            [None] * self.makespan for _ in range(self.D)
        ]
        for p in self.placements:
            g[p.device][p.step] = p
        return g

    def device_programs(self) -> DevicePrograms:
        """Extract the per-device step programs as dense arrays.

        The arrays agree with :meth:`grid` slot-for-slot (property-tested);
        executors lower *these*, so what runs is exactly what was
        synthesized and validated.  Raises ``ValueError`` (not an opaque
        ``IndexError``) on out-of-range placements — ``validate_schedule``
        reports the same malformations as constraint family (7).

        Memoized per schedule (schedules are frozen/hashable): the tuner's
        candidate loop and repeated ``auto_pipeline`` calls reuse the
        O(S*M*steps) lowering instead of recomputing it.  Treat the
        returned arrays as read-only.
        """
        return _device_programs_cached(self)

    def _device_programs_uncached(self) -> DevicePrograms:
        T = self.makespan
        for p in self.placements:
            err = placement_bounds_error(p, self.S, self.M, self.D)
            if err is not None:
                raise ValueError(
                    f"placement v={p.virtual} m={p.microbatch}: {err}; "
                    "run validate_schedule for the full report")
        virt = np.full((self.D, T), -1, dtype=np.int32)
        mb = np.full((self.D, T), -1, dtype=np.int32)
        valid = np.zeros((self.D, T), dtype=bool)
        for p in self.placements:
            virt[p.device, p.step] = p.virtual
            mb[p.device, p.step] = p.microbatch
            valid[p.device, p.step] = True
        return DevicePrograms(virt, mb, valid)

    def bubble_ratio(self) -> float:
        if not self.placements:
            raise ValueError(
                f"schedule (S={self.S}, M={self.M}, D={self.D}) has no "
                "placements — bubble_ratio is undefined on an empty "
                "schedule (validate_schedule reports this as a family (6) "
                "violation)")
        busy = len(self.placements)
        return 1.0 - busy / (self.D * self.makespan)

    def device_of_stage_map(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for p in self.placements:
            s = stage_of_virtual(p.virtual, self.S)
            out.setdefault(s, p.device)
        return out

    def to_ascii(self) -> str:
        """Fig. 8/9-style diagram: rows = devices, columns = steps."""
        g = self.grid()
        width = max(3, len(str(self.M - 1)) + 2)
        lines = []
        for d, row in enumerate(g):
            cells = []
            for p in row:
                if p is None:
                    cells.append("." * width)
                else:
                    kind = "B" if is_backward(p.virtual, self.S) else "F"
                    s = stage_of_virtual(p.virtual, self.S)
                    cells.append(f"{kind}{s}{p.microbatch}".ljust(width))
            lines.append(f"d{d}| " + " ".join(cells))
        return "\n".join(lines)


@functools.lru_cache(maxsize=256)
def _device_programs_cached(sched: Schedule) -> DevicePrograms:
    return sched._device_programs_uncached()


# --------------------------------------------------------------------------
# Validation (paper constraints (6)-(11))
# --------------------------------------------------------------------------

def placement_bounds_error(p: Placement, S: int, M: int, D: int
                           ) -> str | None:
    """Bounds check shared by validate_schedule / device_programs /
    StepTables lowering — one source of truth for what 'in bounds' means.

    Microbatch/virtual bounds matter as much as device/step: the executors
    index [M]-sized buffers with clamped dynamic indices, so an
    out-of-range microbatch would silently corrupt microbatch M-1's slots
    instead of failing.
    """
    if not 0 <= p.virtual < num_virtual(S):
        return f"virtual stage {p.virtual} out of range [0, {num_virtual(S)})"
    if not 0 <= p.microbatch < M:
        return f"microbatch {p.microbatch} out of range [0, {M})"
    if not 0 <= p.device < D:
        return f"device {p.device} out of range [0, {D})"
    if p.step < 0:
        return f"negative step {p.step}"
    return None

def slot_maps(S: int, D: int, folded: bool,
              device_of_stage: Callable[[int], int]
              ) -> tuple[int, dict[int, int], dict[int, int]]:
    """(V, enc_slot_of_stage, dec_slot_of_stage) for a stage->device map.

    A device's stages of one kind (encoder-half s < S/2, decoder-half
    otherwise; everything is 'encoder' for linear pipelines), sorted by
    stage id, occupy slots 0..V-1.  Every device must hold the same slot
    count per kind — the SPMD executors run one program with [V, pad, ...]
    parameter stacks, so a ragged slot layout is unliftable and raises
    here with per-device context.
    """
    half = S // 2 if folded else S
    enc_by_dev: dict[int, list[int]] = {}
    dec_by_dev: dict[int, list[int]] = {}
    for s in range(S):
        (enc_by_dev if s < half else dec_by_dev).setdefault(
            device_of_stage(s), []).append(s)
    counts = {d: (len(enc_by_dev.get(d, ())), len(dec_by_dev.get(d, ())))
              for d in range(D)}
    kinds = set(counts.values())
    ok = len(kinds) == 1
    if ok:
        e, c = next(iter(kinds))
        ok = e > 0 and ((e == c) if folded else (c == 0))
    if not ok:
        detail = ", ".join(
            f"device {d}: {e} prefix-half + {c} suffix-half slots"
            if folded else f"device {d}: {e} stage slots"
            for d, (e, c) in sorted(counts.items()))
        raise ValueError(
            f"stage->device mapping is not an even interleave over D={D} "
            f"devices ({detail}); the table executors need V equal slots "
            "per device and kind")
    V = next(iter(kinds))[0]
    enc_slot = {s: k for ss in enc_by_dev.values()
                for k, s in enumerate(sorted(ss))}
    dec_slot = {s: k for ss in dec_by_dev.values()
                for k, s in enumerate(sorted(ss))}
    return V, enc_slot, dec_slot


def _slot_context(S: int, device_of_stage: Callable[[int], int] | None,
                  folded: bool = False) -> Callable[[int], str]:
    """Virtual task -> ``[stage s = device d enc slot k/V, wave w]`` label.

    Interleaved schedules place several stage slots per device; constraint
    errors name the slot and the wave (the w-th forward visit of that
    device) so an infeasible interleaved plan reads as *which slot of
    which device* went wrong, not just a bare stage index.  With
    ``folded`` the slot index counts within the stage's kind (encoder
    half s < S/2 vs decoder half) — the same numbering ``StageLayout``,
    ``StepTables`` and the executors use — while the wave counts across
    both kinds.  Degenerates to the empty label for one-slot devices and
    when no mapping is supplied.
    """
    if device_of_stage is None:
        return lambda v: ""
    by_dev: dict[int, list[int]] = {}
    for s in range(S):
        by_dev.setdefault(device_of_stage(s), []).append(s)
    info: dict[int, str] = {}
    for d, ss in by_dev.items():
        ss = sorted(ss)
        if len(ss) <= 1:
            continue
        for w, s in enumerate(ss):
            if folded:
                same = [t for t in ss if (t < S // 2) == (s < S // 2)]
                kind = "enc " if s < S // 2 else "dec "
                k, n = same.index(s), len(same)
            else:
                kind, k, n = "", w, len(ss)
            info[s] = (f" [stage {s} = device {d} {kind}slot {k}/{n}, "
                       f"wave {w}]")

    def ctx(v: int) -> str:
        return info.get(stage_of_virtual(v, S), "")

    return ctx


def validate_schedule(
    sched: Schedule,
    device_of_stage: Callable[[int], int] | None = None,
    collocated: Sequence[tuple[int, int]] = (),
    folded: bool = False,
) -> list[str]:
    """Return a list of violated-constraint descriptions (empty == valid).

    ``folded`` only affects error *labels*: multi-slot devices get their
    per-kind (enc/dec) slot numbering in slot-context messages."""
    errors: list[str] = []
    S, M, D = sched.S, sched.M, sched.D
    if not sched.placements:
        # One aggregate violation instead of 2*S*M missing-task lines: a
        # placement-free schedule is a malformed *schedule*, not 2SM
        # individually missing tasks, and makespan/bubble_ratio raise on
        # it with the same diagnosis.
        return [f"(6) schedule (S={S}, M={M}, D={D}) has no placements "
                f"(expected {num_virtual(S) * M} tasks)"]
    ctx = _slot_context(S, device_of_stage, folded)
    # Placement bounds first (family (7)): an out-of-range virtual stage,
    # microbatch, device, or negative step would otherwise pass validation
    # and crash later in grid()/device_programs()/lowering with an opaque
    # IndexError — or worse, silently corrupt a clamped buffer slot.
    for p in sched.placements:
        err = placement_bounds_error(p, S, M, D)
        if err is not None:
            where = ctx(p.virtual) if 0 <= p.virtual < num_virtual(S) else ""
            errors.append(f"(7) v={p.virtual} m={p.microbatch}: {err}{where}")
    seen: dict[tuple[int, int], Placement] = {}
    for p in sched.placements:
        key = (p.virtual, p.microbatch)
        if key in seen:
            errors.append(f"(6) duplicate assignment {key}")
        seen[key] = p
    for v in range(num_virtual(S)):
        for m in range(M):
            if (v, m) not in seen:
                errors.append(f"(6) missing task v={v} m={m}")
    if errors:
        return errors

    # (7) device exclusivity (bounds were checked up front)
    busy: dict[tuple[int, int], Placement] = {}
    for p in sched.placements:
        key = (p.device, p.step)
        if key in busy:
            q = busy[key]
            errors.append(
                f"(7) device {p.device} double-booked at t={p.step}: "
                f"v={q.virtual}{ctx(q.virtual)} and v={p.virtual}"
                f"{ctx(p.virtual)}")
        busy[key] = p

    # (8) fixed device mapping per stage (and F/B of a stage share a device)
    dev_of: dict[int, int] = {}
    for p in sched.placements:
        s = stage_of_virtual(p.virtual, S)
        if s in dev_of and dev_of[s] != p.device:
            errors.append(f"(8) stage {s} on devices {dev_of[s]} and {p.device}")
        dev_of.setdefault(s, p.device)
    if device_of_stage is not None:
        for s, d in dev_of.items():
            if device_of_stage(s) != d:
                errors.append(f"(8) stage {s} expected dev {device_of_stage(s)} got {d}")

    # (9) collocation
    for s1, s2 in collocated:
        if dev_of.get(s1) != dev_of.get(s2):
            errors.append(f"(9) stages {s1},{s2} not collocated")

    # (10) sequential execution within a microbatch
    for m in range(M):
        for v in range(1, num_virtual(S)):
            if seen[(v, m)].step < seen[(v - 1, m)].step + 1:
                errors.append(f"(10) v={v}{ctx(v)} m={m} starts before "
                              "v-1 finishes")

    # (11) monotonic microbatch ordering per stage
    for v in range(num_virtual(S)):
        for m in range(1, M):
            if seen[(v, m)].step <= seen[(v, m - 1)].step:
                errors.append(f"(11) v={v}{ctx(v)}: m={m} not after m={m-1}")
    return errors


# --------------------------------------------------------------------------
# Planner-side communication statistics (liveness windows + overlap slack)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleCommStats:
    """Ring-message accounting of a schedule's forward placements.

    The planning-layer mirror of the executor lowering's channel analysis
    (``runtime.schedule_exec.StepTables``): per-ring liveness windows (max
    simultaneously-live receive-buffer entries) and the exposed-vs-hidden
    hop split the overlapped executors realize.  A hop is **exposed** when
    its consumer runs on the very next forward step — the arrival's
    dependency forces the collective onto the critical path — and
    **hidden** otherwise (the receive slot is dead until the consumer
    runs, so the overlapped executor prefetches it under intervening
    compute).  Pure host-side analysis (no jax import); the property
    tests hold it to agree with the lowered ``StepTables`` field for
    field, the same way ``lowered_comm_volume`` is held to the measured
    HLO bytes.
    """

    W_down: int
    W_up: int
    W_turn: int
    W_skip: int
    exposed_down: int
    exposed_up: int
    hidden_down: int
    hidden_up: int

    @property
    def exposed_hops(self) -> int:
        return self.exposed_down + self.exposed_up

    @property
    def hidden_hops(self) -> int:
        return self.hidden_down + self.hidden_up

    @property
    def live_hops(self) -> tuple[int, int]:
        return (self.exposed_down + self.hidden_down,
                self.exposed_up + self.hidden_up)

    @property
    def window_total(self) -> int:
        return self.W_down + self.W_up + self.W_turn + self.W_skip


def comm_stats(sched: Schedule, device_of_stage: Callable[[int], int],
               folded: bool) -> ScheduleCommStats:
    """Compute :class:`ScheduleCommStats` for a valid schedule.

    Uses the same message model as the executor lowering: an enc->enc
    boundary rides the down ring, dec->dec the up ring; a message is live
    in its receiver's buffer from the step after its producer until its
    consumer runs; the turnaround and the (conservative, all-slots) skip
    stash are device-local lifetimes.  Windows are max-overlap counts per
    device, so they equal the first-fit coloring's slot counts.
    """
    S, M = sched.S, sched.M
    half = S // 2 if folded else S
    fwd = [p for p in sched.placements if p.virtual < S]
    steps = sorted({p.step for p in fwd})
    k_of_step = {t: k for k, t in enumerate(steps)}
    k_of = {(p.virtual, p.microbatch): k_of_step[p.step] for p in fwd}

    def peak(ivs_by_dev: dict[int, list[tuple[int, int]]]) -> int:
        best = 0
        for ivs in ivs_by_dev.values():
            events: dict[int, int] = {}
            for a, b in ivs:
                events[a] = events.get(a, 0) + 1
                events[b + 1] = events.get(b + 1, 0) - 1
            live = 0
            for k in sorted(events):
                live += events[k]
                best = max(best, live)
        return best

    rings: dict[str, dict[int, list[tuple[int, int]]]] = {
        "down": {}, "up": {}}
    exposed = {"down": 0, "up": 0}
    hidden = {"down": 0, "up": 0}
    for p in fwd:
        v, m = p.virtual, p.microbatch
        if v >= S - 1 or (folded and v == half - 1):
            continue                       # loss stage / local turnaround
        ring = "down" if v < half else "up"
        k_prod, k_cons = k_of[(v, m)], k_of[(v + 1, m)]
        rings[ring].setdefault(device_of_stage(v + 1), []).append(
            (k_prod + 1, k_cons))
        if k_cons == k_prod + 1:
            exposed[ring] += 1
        else:
            hidden[ring] += 1

    turn: dict[int, list[tuple[int, int]]] = {}
    skip: dict[int, list[tuple[int, int]]] = {}
    if folded:
        for m in range(M):
            kw, kr = k_of.get((half - 1, m)), k_of.get((half, m))
            if kw is not None and kr is not None:
                turn.setdefault(device_of_stage(half - 1), []).append(
                    (kw, kr))
        last_dec: dict[tuple[int, int], int] = {}
        for p in fwd:
            if p.virtual >= half:
                key = (p.device, p.microbatch)
                k = k_of[(p.virtual, p.microbatch)]
                if last_dec.get(key, -1) < k:
                    last_dec[key] = k
        for p in fwd:
            if p.virtual < half:
                end = last_dec.get((p.device, p.microbatch))
                if end is not None:
                    skip.setdefault(p.device, []).append(
                        (k_of[(p.virtual, p.microbatch)], end))

    return ScheduleCommStats(
        W_down=peak(rings["down"]), W_up=peak(rings["up"]),
        W_turn=peak(turn), W_skip=peak(skip),
        exposed_down=exposed["down"], exposed_up=exposed["up"],
        hidden_down=hidden["down"], hidden_up=hidden["up"])


# --------------------------------------------------------------------------
# Greedy template generator (scalable; 1F1B / wave patterns)
# --------------------------------------------------------------------------

def greedy_schedule(
    S: int,
    M: int,
    device_of_stage: Callable[[int], int],
    D: int,
    *,
    backward_first: bool = True,
    max_steps: int | None = None,
) -> Schedule:
    """Backward-first list scheduling.

    Reproduces 1F1B when S == D with the identity mapping, and the wave
    schedule when S == 2D with the folded mapping (paper Figs. 8/9).
    """
    V = num_virtual(S)
    done_at = -np.ones((V, M), dtype=int)      # finish step of each task
    placed: list[Placement] = []
    remaining = V * M
    t = 0
    horizon = max_steps or (V * M + 4 * (S + M))
    while remaining and t < horizon:
        for d in range(D):
            best = None
            for v in range(V):
                if device_of_stage(stage_of_virtual(v, S)) != d:
                    continue
                for m in range(M):
                    if done_at[v, m] >= 0:
                        continue
                    if v > 0 and not (0 <= done_at[v - 1, m] <= t - 1):
                        break  # chain: earlier microbatches of this v first
                    if m > 0 and done_at[v, m - 1] < 0:
                        continue
                    if m > 0 and done_at[v, m - 1] > t - 1:
                        continue
                    # candidate; rank: backward first, then microbatch, then depth
                    key = (
                        0 if (backward_first and is_backward(v, S)) else 1,
                        m,
                        -v,
                    )
                    if best is None or key < best[0]:
                        best = (key, v, m)
                    break  # only the first pending microbatch of v is eligible
            if best is not None:
                _, v, m = best
                placed.append(Placement(v, m, d, t))
                done_at[v, m] = t
                remaining -= 1
        t += 1
    if remaining:
        raise RuntimeError("greedy scheduler did not finish within horizon")
    return Schedule(S, M, D, tuple(placed))


# Tie-break orientations greedy_schedule_timed accepts; the interleaved
# portfolio in schedule_for_partition races all of them.
TIMED_PRIORITIES = ("backward", "forward", "critical_path", "window")

# Portfolio candidates whose simulated makespan lands within this relative
# band of the best compete on liveness windows / exposed hops instead of
# raw makespan: below 1% the event-driven model's fidelity cannot rank
# candidates (it ignores launch overheads and overlap jitter), while the
# windows are exact executor buffer memory.  The band is the hard bound on
# how much modelled makespan a buffer win may spend.
MAKESPAN_BAND = 0.01


def greedy_schedule_timed(
    S: int,
    M: int,
    device_of_stage: Callable[[int], int],
    D: int,
    times: Sequence[float],
    *,
    bwd_ratio: float = 2.0,
    p2p_time: float = 0.0,
    priority: str = "backward",
) -> Schedule:
    """Duration-aware list scheduling: event-driven over real per-stage
    durations, then layered back onto unit steps.

    The unit-slot greedy models every task as one slot, which misorders
    interleaved (V > 1) plans whose fine stages have heterogeneous
    durations — the drain fills with avoidable stalls.  Here each device
    picks, at its next free instant, the eligible task with the earliest
    real start time; ties break by ``priority``:

    - ``"backward"`` — backward tasks first (the unit greedy's 1F1B rule);
    - ``"forward"`` — forward tasks first (keeps downstream devices fed
      through the interleave's extra fill phases);
    - ``"critical_path"`` — longest remaining chain duration first
      (HEFT-style upward rank; packs the drain the way the ILP does);
    - ``"window"`` — oldest-resident input first: among equally-early
      candidates, run the task whose predecessor finished *earliest*, so
      arrivals drain FIFO.  A consumed arrival frees its receive slot, so
      this orientation directly targets small liveness windows (W_down /
      W_up) and leaves later-arriving messages the most overlap slack;
      embeds (no arrival) yield to any task with a resident input.

    None of the orientations dominates on interleaved mappings, so
    :func:`schedule_for_partition` races all of them.  The resulting
    per-device *order* is layered onto unit steps (longest-path over the
    chain / monotone / exclusivity constraints), producing a valid
    :class:`Schedule` whose order ``simulate`` — and the table-driven
    executors — replay exactly.
    """
    if priority not in TIMED_PRIORITIES:
        raise ValueError(
            f"unknown priority {priority!r}; expected one of "
            f"{TIMED_PRIORITIES}")
    V = num_virtual(S)
    dur_of = [times[stage_of_virtual(v, S)] * (
        bwd_ratio if is_backward(v, S) else 1.0) for v in range(V)]
    rem = [0.0] * (V + 1)           # remaining chain duration from v
    for v in range(V - 1, -1, -1):
        rem[v] = rem[v + 1] + dur_of[v]

    start: dict[tuple[int, int], float] = {}
    finish: dict[tuple[int, int], float] = {}

    def tie_key(v: int, m: int):
        if priority == "critical_path":
            return (-rem[v], m)
        if priority == "window":
            # FIFO over resident inputs: the earliest-finished predecessor
            # has occupied its receive slot longest — consuming it first
            # keeps the rx liveness windows small.  Tasks with no arrival
            # (embeds) defer to any task holding a slot.
            arr = finish[(v - 1, m)] if v > 0 else float("inf")
            return (arr, m, -v)
        bwd_first = priority == "backward"
        return (0 if (bwd_first == is_backward(v, S)) else 1, m, -v)
    dev_free = [0.0] * D
    next_m = [0] * V        # lowest pending microbatch per v (monotone)
    dev_of_v = [device_of_stage(stage_of_virtual(v, S)) for v in range(V)]
    n_left = V * M
    while n_left:
        best = None
        for d in range(D):
            for v in range(V):
                m = next_m[v]
                if m >= M or dev_of_v[v] != d:
                    continue
                if v > 0 and (v - 1, m) not in finish:
                    continue
                ready = 0.0
                if v > 0:
                    ready = finish[(v - 1, m)]
                    if dev_of_v[v - 1] != d:
                        ready += p2p_time
                if m > 0:
                    ready = max(ready, start[(v, m - 1)])
                est = max(ready, dev_free[d])
                key = (est,) + tie_key(v, m)
                if best is None or key < best[0]:
                    best = (key, d, v, m)
        if best is None:
            raise RuntimeError("timed greedy deadlocked")
        (est, *_), d, v, m = best
        dur = dur_of[v]
        start[(v, m)] = est
        finish[(v, m)] = est + dur
        dev_free[d] = est + dur
        next_m[v] += 1
        n_left -= 1
    # layer onto unit steps in global start order (device order preserved;
    # same-device starts are strictly ordered by the event loop)
    order = sorted(start, key=lambda vm: (start[vm], vm[1], vm[0]))
    step: dict[tuple[int, int], int] = {}
    dev_last = [-1] * D
    for (v, m) in order:
        t = dev_last[dev_of_v[v]] + 1
        if v > 0:
            t = max(t, step[(v - 1, m)] + 1)
        if m > 0:
            t = max(t, step[(v, m - 1)] + 1)
        step[(v, m)] = t
        dev_last[dev_of_v[v]] = t
    return Schedule(S, M, D, tuple(
        Placement(v, m, dev_of_v[v], step[(v, m)]) for (v, m) in order))


def template_1f1b(D: int, M: int) -> Schedule:
    """Classic 1F1B: S == D stages, identity mapping (paper Fig. 8)."""
    return greedy_schedule(D, M, lambda s: s, D)


def template_wave(D: int, M: int) -> Schedule:
    """PULSE wave: S == 2D folded stages (paper Fig. 9)."""
    S = 2 * D
    return greedy_schedule(S, M, lambda s: min(s, S - 1 - s), D)


def template_interleaved(D: int, M: int, V: int) -> Schedule:
    """Interleaved wave: S == 2VD folded stages, cyclic slot placement
    (uniform durations; partition-driven synthesis races duration-aware
    candidates — see :func:`schedule_for_partition`)."""
    from repro_torch.core.partition import interleaved_wave_devices
    devices = interleaved_wave_devices(2 * V * D, D)
    return greedy_schedule(2 * V * D, M, lambda s: devices[s], D)


def schedule_for_partition(part, M: int, *, use_ilp: bool = False,
                           time_limit: float = 120.0) -> Schedule:
    """Synthesize + validate a schedule for a partitioner output.

    ``part`` is any object with the :class:`~repro_torch.core.partition.Partition`
    interface (num_stages / num_devices / device_of_stage /
    collocated_pairs).  Greedy template synthesis by default (recovers 1F1B
    and the wave pattern, §V-B); ``use_ilp`` solves Eqs. (6)-(13) exactly.

    Interleaved partitions (more than one stage slot pair per device) race
    a small candidate portfolio — the unit-slot greedy plus the
    duration-aware :func:`greedy_schedule_timed` in every priority
    orientation (including the window-minimizing ``"window"``
    tie-break) — because no single list-scheduling priority dominates
    once a device multiplexes V slots.  Candidates are scored in two
    passes: simulated makespan first; candidates within
    :data:`MAKESPAN_BAND` of the best then compete on total liveness
    windows (W_down + W_up + W_turn + W_skip — the buffers the executors
    allocate), then exposed hops (messages whose consumer runs on the
    very next step, which the overlapped executors cannot hide under
    compute), with makespan as the final tie-break.  The windows and
    overlap slack are optimization terms of the synthesis, not post-hoc
    measurements; the band bounds how much modelled makespan a buffer
    win may spend — below it the cost model's fidelity cannot separate
    candidates, while the windows are exact executor memory.  V = 1
    plans keep the exact paper templates.

    Raises ``ValueError`` listing every violated constraint if the
    synthesized schedule is invalid — planning bugs surface here, before an
    executor is built.
    """
    S, D = part.num_stages, part.num_devices
    if use_ilp:
        sched = ilp_schedule(S, M, D, device_of_stage=part.device_of_stage,
                             collocated=part.collocated_pairs(),
                             time_limit=time_limit)
    else:
        folded = bool(getattr(part, "folded", False))
        interleaved = S > (2 * D if folded else D)
        if interleaved:
            times = getattr(part, "stage_costs", None) or (1.0,) * S
            cands = [greedy_schedule(S, M, part.device_of_stage, D)] + [
                greedy_schedule_timed(S, M, part.device_of_stage, D, times,
                                      priority=prio)
                for prio in TIMED_PRIORITIES
            ]
            scored = [(simulate(s, times)[0], s) for s in cands]
            best_mk = min(mk for mk, _ in scored)
            near = [(mk, s) for mk, s in scored
                    if mk <= best_mk * (1.0 + MAKESPAN_BAND)]

            def residency(entry: tuple[float, Schedule]):
                mk, s = entry
                st = comm_stats(s, part.device_of_stage, folded)
                return (st.window_total, st.exposed_hops, mk)

            sched = min(near, key=residency)[1]
        else:
            sched = greedy_schedule(S, M, part.device_of_stage, D)
    errors = validate_schedule(sched, part.device_of_stage,
                               collocated=part.collocated_pairs(),
                               folded=getattr(part, "folded", False))
    if errors:
        raise ValueError(
            f"synthesized schedule violates constraints: {errors[:5]}"
            + (f" (+{len(errors) - 5} more)" if len(errors) > 5 else ""))
    return sched


# --------------------------------------------------------------------------
# ILP synthesizer (paper Eqs. (6)-(13)) via scipy HiGHS
# --------------------------------------------------------------------------

def ilp_schedule(
    S: int,
    M: int,
    D: int,
    *,
    device_of_stage: Callable[[int], int] | None = None,
    collocated: Sequence[tuple[int, int]] = (),
    horizon: int | None = None,
    time_limit: float = 120.0,
) -> Schedule:
    """Solve the scheduling ILP exactly.

    ``device_of_stage`` fixes the stage->device mapping (partitioner output);
    if None, device assignment variables y[s,d] are free (Eqs. 8/9/13) with
    stage 0 anchored to device 0.
    """
    from scipy import sparse
    from scipy.optimize import LinearConstraint, milp, Bounds

    V = num_virtual(S)
    # A feasible horizon: greedy gives an upper bound.
    if horizon is None:
        if device_of_stage is not None:
            horizon = greedy_schedule(S, M, device_of_stage, D).makespan
        else:
            horizon = V * M
    T = horizon

    def xid(v: int, m: int, d: int, t: int) -> int:
        return ((v * M + m) * D + d) * T + t

    nx = V * M * D * T
    free_map = device_of_stage is None
    ny = S * D if free_map else 0

    def yid(s: int, d: int) -> int:
        return nx + s * D + d

    tmax_id = nx + ny
    nvar = nx + ny + 1

    rows, cols, vals, lbs, ubs = [], [], [], [], []
    r = 0

    def add_row(entries: list[tuple[int, float]], lo: float, hi: float):
        nonlocal r
        for c, a in entries:
            rows.append(r); cols.append(c); vals.append(a)
        lbs.append(lo); ubs.append(hi)
        r += 1

    # (6) unique assignment
    for v in range(V):
        for m in range(M):
            add_row([(xid(v, m, d, t), 1.0) for d in range(D) for t in range(T)],
                    1.0, 1.0)

    # (7) device exclusivity
    for d in range(D):
        for t in range(T):
            add_row([(xid(v, m, d, t), 1.0) for v in range(V) for m in range(M)],
                    -np.inf, 1.0)

    # (8) device mapping
    if free_map:
        # sum_d y[s,d] == 1 ; link: sum_t x[v,m,d,t] == y[stage(v),d]
        for s in range(S):
            add_row([(yid(s, d), 1.0) for d in range(D)], 1.0, 1.0)
        for v in range(V):
            s = stage_of_virtual(v, S)
            for m in range(M):
                for d in range(D):
                    ent = [(xid(v, m, d, t), 1.0) for t in range(T)]
                    ent.append((yid(s, d), -1.0))
                    add_row(ent, 0.0, 0.0)
        # (9) collocation + anchor
        for s1, s2 in collocated:
            for d in range(D):
                add_row([(yid(s1, d), 1.0), (yid(s2, d), -1.0)], 0.0, 0.0)
        add_row([(yid(0, 0), 1.0)], 1.0, 1.0)
    else:
        # pin x to the fixed mapping: x[v,m,d,t] == 0 for d != dev(stage)
        for v in range(V):
            dv = device_of_stage(stage_of_virtual(v, S))
            for m in range(M):
                for d in range(D):
                    if d != dv:
                        add_row([(xid(v, m, d, t), 1.0) for t in range(T)],
                                0.0, 0.0)

    # times: time(v,m) = sum t * x
    def time_entries(v: int, m: int, sign: float) -> list[tuple[int, float]]:
        return [
            (xid(v, m, d, t), sign * t) for d in range(D) for t in range(T)
        ]

    # (10) sequential execution
    for m in range(M):
        for v in range(1, V):
            add_row(time_entries(v, m, 1.0) + time_entries(v - 1, m, -1.0),
                    1.0, np.inf)
    # (11) monotonic microbatches
    for v in range(V):
        for m in range(1, M):
            add_row(time_entries(v, m, 1.0) + time_entries(v, m - 1, -1.0),
                    1.0, np.inf)
    # (12) T_max >= time(V-1, m)  (chain+monotone make this the global max)
    for m in range(M):
        add_row([(tmax_id, 1.0)] + time_entries(V - 1, m, -1.0), 0.0, np.inf)

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(r, nvar))
    constraints = LinearConstraint(A, np.array(lbs), np.array(ubs))

    # objective: min T_max + eps * sum(t * x)  (canonical early schedules)
    #            + eps_w * sum_cross-edges (t(v+1,m) - t(v,m))
    # The second tiebreak is a *residency* penalty on cross-device chain
    # edges: each message occupies its receiver's rotating buffer slot
    # from production until consumption, so total residency upper-bounds
    # the liveness windows the executors allocate — the ILP prefers, among
    # makespan-optimal schedules, ones with shorter in-flight lifetimes
    # (smaller rx windows, more overlap slack).  Both weights are scaled
    # so their combined contribution stays below one unit step: eps's
    # term is <= 1/(T+1) and eps_w's <= 1/(2(T+1)), so T_max remains
    # strictly dominant and ilp.makespan <= greedy.makespan is preserved.
    # Residency needs a fixed stage->device mapping; with free device
    # variables the cross-edge set is unknown, so the penalty is skipped.
    c = np.zeros(nvar)
    c[tmax_id] = 1.0
    eps = 1.0 / (V * M * T * (T + 1))
    for v in range(V):
        for m in range(M):
            for d in range(D):
                for t in range(T):
                    c[xid(v, m, d, t)] = eps * t
    if not free_map:
        eps_w = eps / 2.0
        for v in range(V - 1):
            dv = device_of_stage(stage_of_virtual(v, S))
            dn = device_of_stage(stage_of_virtual(v + 1, S))
            if dv == dn:
                continue
            for m in range(M):
                for d in range(D):
                    for t in range(T):
                        c[xid(v + 1, m, d, t)] += eps_w * t
                        c[xid(v, m, d, t)] -= eps_w * t

    integrality = np.ones(nvar)
    res = milp(
        c=c,
        constraints=constraints,
        integrality=integrality,
        bounds=Bounds(0, np.concatenate([np.ones(nx + ny), [T]])),
        options={"time_limit": time_limit, "presolve": True},
    )
    if res.status != 0 or res.x is None:
        raise RuntimeError(f"ILP failed: status={res.status} msg={res.message}")
    x = np.round(res.x[:nx]).astype(int).reshape(V, M, D, T)
    placements = []
    for v in range(V):
        for m in range(M):
            d, t = np.argwhere(x[v, m] == 1)[0]
            placements.append(Placement(v, m, int(d), int(t)))
    return Schedule(S, M, D, tuple(placements))


# --------------------------------------------------------------------------
# Simulation with real durations (wall-clock model)
# --------------------------------------------------------------------------

def simulate(
    sched: Schedule,
    fwd_time_of_stage: Sequence[float],
    *,
    bwd_ratio: float = 2.0,
    p2p_time: float = 0.0,
    overlap: bool = True,
) -> tuple[float, float]:
    """Event-driven makespan with real durations.

    Respects the schedule's per-device task *ordering* (not its unit slots);
    a task starts when (a) its predecessor in the chain has finished
    (+``p2p_time`` if it crossed devices) and (b) its device is free.
    Returns ``(makespan_seconds, bubble_ratio)``.

    ``overlap`` (default) models asynchronous sends — the table executors'
    overlapped lowering: a producer hands its boundary activation to the
    ring and immediately starts its next task, so only the *receiver*
    waits out ``p2p_time``.  ``overlap=False`` models the synchronous
    lowering, where the producing device also blocks for ``p2p_time`` after every
    cross-device send before its next compute.
    """
    S = sched.S
    by_dev: dict[int, list[Placement]] = {}
    for p in sorted(sched.placements, key=lambda p: p.step):
        by_dev.setdefault(p.device, []).append(p)
    finish: dict[tuple[int, int], float] = {}
    dev_free = {d: 0.0 for d in range(sched.D)}
    dev_of: dict[int, int] = {
        stage_of_virtual(p.virtual, S): p.device for p in sched.placements
    }
    pending = {d: list(ps) for d, ps in by_dev.items()}
    busy_time = 0.0
    progressed = True
    n_done = 0
    total = len(sched.placements)
    while n_done < total and progressed:
        progressed = False
        for d, queue in pending.items():
            while queue:
                p = queue[0]
                key = (p.virtual, p.microbatch)
                if p.virtual > 0:
                    dep = (p.virtual - 1, p.microbatch)
                    if dep not in finish:
                        break
                    ready = finish[dep]
                    s_prev = stage_of_virtual(p.virtual - 1, S)
                    s_cur = stage_of_virtual(p.virtual, S)
                    if dev_of[s_prev] != dev_of[s_cur]:
                        ready += p2p_time
                else:
                    ready = 0.0
                s = stage_of_virtual(p.virtual, S)
                dur = fwd_time_of_stage[s] * (
                    bwd_ratio if is_backward(p.virtual, S) else 1.0
                )
                start = max(ready, dev_free[d])
                finish[key] = start + dur
                dev_free[d] = start + dur
                if not overlap and p.virtual < sched.S * 2 - 1:
                    s_next = stage_of_virtual(p.virtual + 1, S)
                    if s_next in dev_of and dev_of[s_next] != d:
                        # synchronous lowering: the sender's ppermute sits
                        # on its own timeline before the next compute
                        dev_free[d] += p2p_time
                busy_time += dur
                queue.pop(0)
                n_done += 1
                progressed = True
    if n_done < total:
        raise RuntimeError("simulation deadlocked (invalid schedule ordering)")
    makespan = max(finish.values())
    bubble = 1.0 - busy_time / (sched.D * makespan)
    return makespan, bubble
