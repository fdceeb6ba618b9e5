"""Table-driven wave and linear executors lowered from a validated
Schedule (the port of ``repro.runtime.schedule_exec``).

:class:`StepTables` (with :class:`PlanError`, ``_color_intervals`` and the
memoized ``_tables_cached``) is a copy of the JAX module's numpy lowering:
per device, a dense forward step program extracted from the schedule's
placements (which stage slot runs on which microbatch at each step, where
each arrival is stored, when the turnaround buffer is written and read,
where the skip stash goes, when the loss is emitted), the channel activity
of both rings and the proven liveness windows ``W_down`` / ``W_up`` /
``W_turn`` / ``W_skip``.  It is copied because the JAX module imports jax
at its top.

:func:`make_wave_pipeline_from_schedule` (folded plans) and
:func:`make_linear_pipeline_from_schedule` (skip-free linear plans) walk
those tables step by step, one (device, step) at a time through a body
both lowerings share:

- one process (the default): all D pipeline devices live in one process
  on one card -- the counterpart of the JAX package running D
  host-simulated devices on one CPU -- so each device's rotating receive,
  turnaround and skip-stash buffers are Python lists of tensors sized by
  the proven windows, and a ring hop is a move between the devices' lists
  (:func:`~repro_torch.runtime.pipeline.hop`, which also counts the bytes
  each hop moves).  Quiescent hops carry zero payloads.  The backward
  pass is PyTorch autograd over the whole walk, with each stage call
  recomputed under ``torch.utils.checkpoint`` when ``remat`` is on.
- one rank (``ring=``, a :class:`~repro_torch.runtime.ring.Ring`): the
  process runs device ``ring.index`` alone, over its own rows.  Its
  arrivals come over the ring -- only where the tables flag a send, which
  :func:`check_ring_agreement` proves both ends read alike -- into the
  same rotating slots, and the backward is the rank walk of
  ``runtime.ring``: the same tables walked back, each arrival's cotangent
  sent back to its sender.

Boundary activations are cast to ``PipelineConfig.wire_dtype`` on send
(the cast's backward rounds the cotangents the same way).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.schedule import (Schedule, placement_bounds_error,
                                       slot_maps)
from repro_torch.runtime.pipeline import (WIRE_DTYPES, PipelineConfig,
                                          _wrap_remat, check_data_group,
                                          check_one_replica, finish_rank,
                                          hop, rank_rows, rank_slots,
                                          unbind_rows)
from repro_torch.runtime.ring import DOWN, UP, StepPlan, rank_walk
from repro_torch.runtime.sharding import batch_shard
from repro_torch.tree import tree_index, tree_leaves

Pytree = Any

IDLE, RUN_ENC, RUN_DEC = 0, 1, 2


class PlanError(ValueError):
    """A plan the lowering cannot realize, with structured context.

    Every rejection carries the name of the violated check plus the
    (device, step, slot) coordinates where the lowering noticed it, so
    callers — and the mutation-soundness suite — can dispatch on
    ``err.check`` instead of grepping message strings.  Subclasses
    ``ValueError``: every pre-existing ``except ValueError`` /
    ``pytest.raises(ValueError, match=...)`` site keeps working, and the
    original message text is preserved verbatim inside the formatted
    string.
    """

    POINTER = ("the table executor cannot realize this plan; validate the "
               "schedule with core.schedule.validate_schedule")

    def __init__(self, message: str, *, check: str,
                 device: int | None = None, step: int | None = None,
                 slot: int | None = None):
        self.check = check
        self.device = device
        self.step = step
        self.slot = slot
        where = ", ".join(
            f"{k}={v}" for k, v in (("device", device), ("step", step),
                                    ("slot", slot)) if v is not None)
        super().__init__(
            f"[{check}{'; ' + where if where else ''}] {message} "
            f"({self.POINTER})")


def _color_intervals(ivs) -> tuple[dict[tuple[int, int], int], int]:
    """First-fit interval coloring by start step.

    ``ivs`` is a list of closed ``(start, end)`` step intervals on ONE
    device's channel; a slot is reusable only *strictly after* its last
    read (stores happen before reads within a step, so an entry arriving
    at the step its slot was last read would clobber it).  First-fit on
    start-sorted intervals is optimal for interval graphs, so the slot
    count equals the max number of simultaneously-live entries — the
    liveness window W the property tests cross-check against an
    event-driven replay.
    """
    ends: list[int] = []                 # slot -> last occupied step
    out: dict[tuple[int, int], int] = {}
    for s, e in sorted(ivs):
        for i, last in enumerate(ends):
            if last < s:
                ends[i] = e
                out[(s, e)] = i
                break
        else:
            out[(s, e)] = len(ends)
            ends.append(e)
    return out, len(ends)


# ===========================================================================
# Step-table extraction (host-side, numpy)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class StepTables:
    """Per-device forward step programs + message routing for one Schedule.

    All arrays are ``[D, num_steps]`` over the *compressed forward step
    axis*: the schedule's global steps that contain at least one forward
    placement, in order (``forward_steps`` maps compressed index -> global
    step).  Compression preserves the relative order of every placement, so
    the synchronous scan (one ppermute hop per step) realizes the same
    partial order the schedule was validated against.

    - ``sel``: ``IDLE`` / ``RUN_ENC`` / ``RUN_DEC`` (linear pipelines only
      use ``IDLE`` / ``RUN_ENC``).
    - ``slot``: which of the device's V same-kind stage slots the task
      runs (0 for classic V=1 plans; interleaved plans index the [V, pad]
      parameter stacks and per-slot count/pairing tables with it).
    - ``mb``: microbatch of the slot (0 when idle — never read).
    - ``down_mb`` / ``down_valid``: arrival on the down-ring channel at the
      *start* of the step (what the upstream device sent last step), with
      the microbatch for introspection; ``up_mb`` / ``up_valid`` the same
      for the up ring.  ``down_slot`` / ``up_slot`` give the rotating
      receive-buffer slot the arrival is stored into, and ``rx_slot`` the
      slot the step's *running* task reads its input from (undefined — 0 —
      on embed / turnaround-read / idle steps, where the buffers are not
      consulted).
    - ``down_send`` / ``up_send``: this device's hop on the ring actually
      carries a message this step (the channel activity analysis); on
      quiescent steps the executors send zeros and the transposed scan
      carries zero cotangents.
    - ``loss``: slot computes the final-stage output and emits the loss.
    - ``embed`` / ``turn_rd`` / ``turn_wr``: the slot runs stage 0 (embeds
      its input), the first decoder-half stage (reads the local turn
      buffer) or the last encoder-half stage (writes it).  With V > 1 a
      device runs several enc/dec slots, so these are per-(device, step)
      facts, not per-device ones — ``embed_device`` / ``turn_device`` stay
      as informational summaries.  ``turn_wr_slot`` / ``turn_rd_slot``
      give the rotating turn-buffer slot written / read.
    - ``skip_wr`` / ``skip_wr_slot``: the encoder slot's skip stash is
      live (some decoder row consumes it — dead stores are elided) and
      where it goes; ``skip_rd_slot[d, t, v]`` is the stash slot holding
      encoder-slot ``v``'s entry for the decoder task's microbatch
      (gathered into the ``[V * enc_pad]`` flat view
      ``StageLayout.skip_rows`` addresses).
    - ``W_down`` / ``W_up`` / ``W_turn`` / ``W_skip``: the proven liveness
      windows — max simultaneously-live entries per channel across
      devices; the executors allocate exactly these many buffer slots.
    """

    D: int
    M: int
    V: int
    rings: int                     # 2 folded (down + up), 1 linear
    forward_steps: tuple[int, ...]
    sel: np.ndarray
    slot: np.ndarray
    mb: np.ndarray
    down_mb: np.ndarray
    down_valid: np.ndarray
    up_mb: np.ndarray
    up_valid: np.ndarray
    loss: np.ndarray
    embed: np.ndarray
    turn_rd: np.ndarray
    turn_wr: np.ndarray
    # ---- channel activity + liveness lowering --------------------------
    down_send: np.ndarray
    up_send: np.ndarray
    down_slot: np.ndarray
    up_slot: np.ndarray
    rx_slot: np.ndarray
    turn_wr_slot: np.ndarray
    turn_rd_slot: np.ndarray
    skip_wr: np.ndarray
    skip_wr_slot: np.ndarray
    skip_rd_slot: np.ndarray
    W_down: int
    W_up: int
    W_turn: int
    W_skip: int
    # hops whose consumer runs on the very next forward step: the arrival's
    # dependency serializes the collective against compute even in the
    # overlapped lowering (the rest are hidden under intervening steps)
    exposed_down: int
    exposed_up: int
    embed_device: int = 0
    turn_device: int = -1

    @property
    def num_steps(self) -> int:
        return self.sel.shape[1]

    @property
    def live_hops(self) -> tuple[int, int]:
        """(down, up) hops that actually carry a message (fwd pass)."""
        return int(self.down_send.sum()), int(self.up_send.sum())

    @property
    def dense_hops(self) -> int:
        """Hops the pre-liveness lowering paid: every ring, every step."""
        return self.rings * self.D * self.num_steps

    @property
    def exposed_hops(self) -> int:
        """Live hops whose consumer runs one step after the producer —
        the overlapped executor cannot hide these under compute."""
        return self.exposed_down + self.exposed_up

    @property
    def hidden_hops(self) -> int:
        """Live hops with at least one intervening step before their
        consumer: the overlapped lowering prefetches them under compute."""
        down, up = self.live_hops
        return down + up - self.exposed_hops

    @classmethod
    def from_schedule(cls, sched: Schedule, *, folded: bool,
                      device_of_stage=None,
                      devices: tuple[int, ...] | None = None,
                      skip_consumers=None) -> "StepTables":
        """Lower a schedule's forward placements to step tables.

        ``device_of_stage`` is the partition's *explicit* stage->device
        mapping; when omitted the canonical placements (mirror fold /
        identity, or their V-fold interleaved generalization) are assumed.
        Pass the mapping as a ``devices`` *tuple* instead to memoize the
        lowering per (schedule, folded, devices, skip_consumers) — the
        tuner's candidate loop and repeated ``auto_pipeline`` calls then
        reuse the O(S*M*steps) extraction.

        ``skip_consumers[d][dec_slot]`` optionally lists the encoder slots
        whose stash entries device ``d``'s decoder slot actually consumes
        (``StageLayout`` derives this from the graph's skip edges — see
        ``runtime.compile``).  Without it the analysis is conservative:
        every decoder slot may read every encoder slot, so stash entries
        stay live until the device's last decoder task of the microbatch.
        With it, unconsumed entries become dead stores (never written) and
        the skip window shrinks on sparse graphs.  Must be nested tuples
        when combined with ``devices`` (the memoization key).

        Raises ``ValueError`` on any shape the synchronous scan cannot
        realize (malformed placements, a stage mapped off the ring
        neighbourhood its messages need, double-booked channels, a
        consumer scheduled before its input can arrive) — the
        planner/executor mismatches the closed forms used to hide surface
        here.
        """
        if devices is not None:
            if device_of_stage is not None:
                raise ValueError("pass device_of_stage or devices, not both")
            return _tables_cached(sched, folded, tuple(devices),
                                  skip_consumers)
        return cls._build(sched, folded, device_of_stage, skip_consumers)

    @classmethod
    def _build(cls, sched: Schedule, folded: bool,
               device_of_stage, skip_consumers=None) -> "StepTables":
        S, M, D = sched.S, sched.M, sched.D
        if (S % (2 * D) if folded else S % D) != 0:
            raise PlanError(
                f"schedule has S={S} stages but a "
                f"{'folded' if folded else 'linear'} executor over D={D} "
                f"devices lowers S = {'2*V*D' if folded else 'V*D'} "
                "(an integer number of stage slots per device)",
                check="program-shape")
        half = S // 2 if folded else S
        if device_of_stage is None:
            if folded:
                device_of_stage = (
                    lambda s: (s % D) if s < half else (S - 1 - s) % D)
            else:
                device_of_stage = lambda s: s % D
        V, enc_slot, dec_slot = slot_maps(S, D, folded, device_of_stage)
        if skip_consumers is not None:
            if len(skip_consumers) != D or any(
                    len(dev) != V for dev in skip_consumers):
                raise PlanError(
                    f"skip_consumers must list every (device, dec slot): "
                    f"expected [{D}][{V}], got "
                    f"{[len(dev) for dev in skip_consumers]}",
                    check="program-shape")
        fwd = sorted((p for p in sched.placements if p.virtual < S),
                     key=lambda p: (p.step, p.device))
        steps = sorted({p.step for p in fwd})
        k_of_step = {t: k for k, t in enumerate(steps)}
        T = len(steps)

        sel = np.zeros((D, T), dtype=np.int32)
        slot = np.zeros((D, T), dtype=np.int32)
        mb = np.zeros((D, T), dtype=np.int32)
        down_mb = np.zeros((D, T), dtype=np.int32)
        down_valid = np.zeros((D, T), dtype=bool)
        up_mb = np.zeros((D, T), dtype=np.int32)
        up_valid = np.zeros((D, T), dtype=bool)
        loss = np.zeros((D, T), dtype=bool)
        embed = np.zeros((D, T), dtype=bool)
        turn_rd = np.zeros((D, T), dtype=bool)
        turn_wr = np.zeros((D, T), dtype=bool)

        def mark_rx(tab, ok, dev, k, m, chan):
            if k >= T:
                raise PlanError(
                    f"message for m={m} sent on the last forward step has "
                    "no consumer step — run validate_schedule",
                    check="no-lost-message", device=dev)
            if ok[dev, k]:
                raise PlanError(
                    f"two messages on the {chan} channel of device {dev} "
                    f"at forward step {k} — run validate_schedule",
                    check="send-recv-pairing", device=dev, step=k)
            tab[dev, k] = m
            ok[dev, k] = True

        # message / buffer-lifetime event logs for the liveness analysis
        msgs_down: list[tuple[int, int, int, int, int]] = []
        msgs_up: list[tuple[int, int, int, int, int]] = []
        turn_writes: dict[tuple[int, int], int] = {}   # (dev, m) -> step
        turn_reads: dict[tuple[int, int], int] = {}
        enc_runs: list[tuple[int, int, int, int]] = []  # (dev, k, m, vslot)
        dec_runs: list[tuple[int, int, int, int]] = []

        k_of_task: dict[tuple[int, int], int] = {}
        for p in fwd:
            v, m, dev = p.virtual, p.microbatch, p.device
            err = placement_bounds_error(p, S, M, D)
            if err is not None:
                raise PlanError(
                    f"placement v={v} m={m}: {err}; run validate_schedule",
                    check="placement-bounds")
            # The stage layout pins each stage to the partition's device
            # mapping; routing below assumes it.  A schedule with a
            # permuted device mapping (e.g. an ILP free-mapping solve) is
            # *valid* but not realizable on this layout — reject it here
            # rather than run the wrong stage's parameters silently.
            canon = device_of_stage(v)
            if dev != canon:
                raise PlanError(
                    f"placement v={v} m={m} on device {dev}, but this "
                    f"executor's stage layout pins stage {v} to device "
                    f"{canon} (slot "
                    f"{enc_slot.get(v, dec_slot.get(v))}); re-synthesize "
                    "the schedule with the partition's device_of_stage",
                    check="stage-routing", device=dev)
            k = k_of_step[p.step]
            if sel[dev, k] != IDLE:
                raise PlanError(
                    f"device {dev} double-booked at step {p.step} — run "
                    "validate_schedule",
                    check="program-shape", device=dev, step=k)
            k_of_task[(v, m)] = k
            mb[dev, k] = m
            is_enc = v < half
            sel[dev, k] = RUN_ENC if is_enc else RUN_DEC
            slot[dev, k] = enc_slot[v] if is_enc else dec_slot[v]
            (enc_runs if is_enc else dec_runs).append(
                (dev, k, m, int(slot[dev, k])))
            if v == 0:
                embed[dev, k] = True
            if folded and v == half:
                turn_rd[dev, k] = True
                turn_reads[(dev, m)] = k
            if folded and v == half - 1:
                # turnaround — consumed locally from the turn buffer by
                # stage S/2, which must share the device; no send.
                turn_wr[dev, k] = True
                turn_writes[(dev, m)] = k
                if device_of_stage(half) != dev:
                    raise PlanError(
                        f"turnaround stages {half - 1},{half} on devices "
                        f"{dev},{device_of_stage(half)}: the fold "
                        "collocates them (constraint (9))",
                        check="stage-routing", device=dev)
            elif v < S - 1:
                # enc -> enc rides the down ring, dec -> dec the up ring
                # (both wrap: interleaved slot boundaries cross D-1 -> 0);
                # the consumer must be the matching ring neighbour.
                nd = device_of_stage(v + 1)
                want = (dev + 1) % D if is_enc else (dev - 1) % D
                if nd != want:
                    raise PlanError(
                        f"stage {v} on device {dev} (slot "
                        f"{slot[dev, k]}) feeds stage {v + 1} on device "
                        f"{nd}, but the ring executors only deliver to "
                        f"device {want}",
                        check="stage-routing", device=dev, step=k,
                        slot=int(slot[dev, k]))
                if is_enc:
                    mark_rx(down_mb, down_valid, nd, k + 1, m, "down")
                    msgs_down.append((dev, nd, k, v, m))
                else:
                    mark_rx(up_mb, up_valid, nd, k + 1, m, "up")
                    msgs_up.append((dev, nd, k, v, m))
            if v == S - 1:
                loss[dev, k] = True

        # Dataflow feasibility: each forward task's input must have been
        # produced at an earlier compressed step (so it arrived — one
        # ppermute hop — at or before the consumer's step).
        for p in fwd:
            if p.virtual == 0:
                continue
            dep = (p.virtual - 1, p.microbatch)
            if dep not in k_of_task:
                raise PlanError(
                    f"task v={p.virtual} m={p.microbatch} has no scheduled "
                    "predecessor — run validate_schedule",
                    check="matched-store-read", device=p.device)
            if k_of_task[(p.virtual, p.microbatch)] < k_of_task[dep] + 1:
                raise PlanError(
                    f"task v={p.virtual} m={p.microbatch} runs before its "
                    "input can arrive (constraint (10)) — run "
                    "validate_schedule",
                    check="matched-store-read", device=p.device,
                    step=k_of_task[(p.virtual, p.microbatch)])

        # ---- channel activity + liveness windows -----------------------
        down_send = np.zeros((D, T), dtype=bool)
        up_send = np.zeros((D, T), dtype=bool)
        down_slot = np.zeros((D, T), dtype=np.int32)
        up_slot = np.zeros((D, T), dtype=np.int32)
        rx_slot = np.zeros((D, T), dtype=np.int32)
        windows = {}
        exposed = {}
        for name, msgs, send_tab, slot_tab in (
                ("down", msgs_down, down_send, down_slot),
                ("up", msgs_up, up_send, up_slot)):
            by_dev: dict[int, list[tuple[int, int]]] = {}
            n_exposed = 0
            for src, dst, k_prod, v, m in msgs:
                send_tab[src, k_prod] = True
                # in flight in the receiver's buffer from arrival (start
                # of k_prod + 1) until its consumer runs
                k_cons = k_of_task[(v + 1, m)]
                by_dev.setdefault(dst, []).append((k_prod + 1, k_cons))
                if k_cons == k_prod + 1:
                    n_exposed += 1
            exposed[name] = n_exposed
            W = 0
            for dst, ivs in by_dev.items():
                assign, w = _color_intervals(ivs)
                W = max(W, w)
                for (k_arr, k_cons), sl in assign.items():
                    slot_tab[dst, k_arr] = sl
                    rx_slot[dst, k_cons] = sl
            windows[name] = W

        turn_wr_slot = np.zeros((D, T), dtype=np.int32)
        turn_rd_slot = np.zeros((D, T), dtype=np.int32)
        by_dev = {}
        for (dev, m), kw in turn_writes.items():
            kr = turn_reads.get((dev, m))
            if kr is None:
                turn_wr[dev, kw] = False    # dead store: no reader
                continue
            by_dev.setdefault(dev, []).append((kw, kr))
        W_turn = 0
        for dev, ivs in by_dev.items():
            assign, w = _color_intervals(ivs)
            W_turn = max(W_turn, w)
            for (kw, kr), sl in assign.items():
                turn_wr_slot[dev, kw] = sl
                turn_rd_slot[dev, kr] = sl

        # Skip stash: entry (device, microbatch, enc slot) is written when
        # the encoder slot runs and stays live until the last decoder task
        # whose slot consumes it.  Without skip_consumers every decoder
        # slot is assumed to read every encoder slot (conservative).
        skip_wr = np.zeros((D, T), dtype=bool)
        skip_wr_slot = np.zeros((D, T), dtype=np.int32)
        skip_rd_slot = np.zeros((D, T, V), dtype=np.int32)
        last_read: dict[tuple[int, int, int], int] = {}
        for dev, k2, m, dv in dec_runs:
            evs = (range(V) if skip_consumers is None
                   else skip_consumers[dev][dv])
            for ev in evs:
                if not 0 <= ev < V:
                    raise PlanError(
                        f"skip_consumers names enc slot {ev} on device "
                        f"{dev}, but the layout has V={V} slots",
                        check="program-shape", device=dev, slot=ev)
                key = (dev, m, ev)
                if last_read.get(key, -1) < k2:
                    last_read[key] = k2
        per_dev: dict[int, list[tuple[int, int]]] = {}
        entry_of: dict[tuple[int, int, int], tuple[int, int]] = {}
        for dev, k, m, vslot in enc_runs:
            if not folded:
                continue
            end = last_read.get((dev, m, vslot))
            if end is None:
                continue                    # dead store: never consumed
            skip_wr[dev, k] = True
            per_dev.setdefault(dev, []).append((k, end))
            entry_of[(dev, m, vslot)] = (k, end)
        W_skip = 0
        entry_slot: dict[tuple[int, int, int], int] = {}
        for dev, ivs in per_dev.items():
            assign, w = _color_intervals(ivs)
            W_skip = max(W_skip, w)
            for key, iv in entry_of.items():
                if key[0] == dev:
                    entry_slot[key] = assign[iv]
        for dev, k2, m, dv in dec_runs:
            for ev in range(V):
                skip_rd_slot[dev, k2, ev] = entry_slot.get((dev, m, ev), 0)
        for dev, k, m, vslot in enc_runs:
            if skip_wr[dev, k]:
                skip_wr_slot[dev, k] = entry_slot[(dev, m, vslot)]

        return cls(D=D, M=M, V=V, rings=2 if folded else 1,
                   forward_steps=tuple(steps), sel=sel,
                   slot=slot, mb=mb,
                   down_mb=down_mb, down_valid=down_valid, up_mb=up_mb,
                   up_valid=up_valid, loss=loss, embed=embed,
                   turn_rd=turn_rd, turn_wr=turn_wr,
                   down_send=down_send, up_send=up_send,
                   down_slot=down_slot, up_slot=up_slot, rx_slot=rx_slot,
                   turn_wr_slot=turn_wr_slot, turn_rd_slot=turn_rd_slot,
                   skip_wr=skip_wr, skip_wr_slot=skip_wr_slot,
                   skip_rd_slot=skip_rd_slot,
                   W_down=windows["down"], W_up=windows["up"],
                   W_turn=W_turn, W_skip=W_skip,
                   exposed_down=exposed["down"], exposed_up=exposed["up"],
                   embed_device=device_of_stage(0),
                   turn_device=device_of_stage(half - 1) if folded else -1)


@functools.lru_cache(maxsize=256)
def _tables_cached(sched: Schedule, folded: bool,
                   devices: tuple[int, ...],
                   skip_consumers) -> StepTables:
    return StepTables._build(sched, folded, lambda s: devices[s],
                             skip_consumers)


def check_ring_agreement(tables: StepTables) -> None:
    """Prove that both ends of every ring hop read the tables alike: an
    arrival stored at step t (``down_valid`` / ``up_valid``) has its
    sender's flag (``down_send`` of device d-1, ``up_send`` of device d+1,
    both rings closed) at step t-1, every flagged send is stored, and the
    last step sends nothing.  A rank executor posts a receive only where
    the tables store an arrival and a send only where they flag one, so a
    mismatch here would hang the ring; raises :class:`PlanError`."""
    D, T = tables.D, tables.num_steps
    for name, valid, send, shift in (
            ("down", tables.down_valid, tables.down_send, 1),
            ("up", tables.up_valid, tables.up_send, -1)):
        sent = np.zeros_like(valid)
        sent[:, 1:] = np.roll(send, shift, axis=0)[:, :-1]
        bad = np.argwhere(sent != valid)
        if bad.size:
            d, t = (int(x) for x in bad[0])
            raise PlanError(
                f"{name} ring: device {d} {'stores' if valid[d, t] else 'drops'}"
                f" an arrival at step {t} but device {(d - shift) % D} "
                f"{'does not send' if valid[d, t] else 'sends'} at step "
                f"{t - 1}", check="send-recv-pairing", device=d, step=t)
        if T and send[:, T - 1].any():
            d = int(np.argmax(send[:, T - 1]))
            raise PlanError(f"{name} ring: device {d} sends on the last "
                            "step, which nobody receives",
                            check="no-lost-message", device=d, step=T - 1)



# ===========================================================================
# Folded wave executor from tables
# ===========================================================================

def _wire_dtype(cfg: PipelineConfig) -> torch.dtype:
    if cfg.wire_dtype not in WIRE_DTYPES:
        raise PlanError(
            f"unknown wire_dtype {cfg.wire_dtype!r}; expected one of "
            f"{WIRE_DTYPES} (float32 is the exact-differential escape "
            "hatch)",
            check="wire-dtype-flow")
    return getattr(torch, cfg.wire_dtype)


def _wave_body(tab: dict, x_dtype, enc_pad: int, embed_fn,
               enc_stage: Callable, dec_stage: Callable,
               loss_fn: Callable) -> Callable:
    """Device d's step t of the folded walk, given what the tables say it
    reads: ``body(d, t, enc_rows, dec_rows, edge_p, mbs, aux, x_rx,
    x_turn, stash) -> (x_out, skips, loss)``.  ``enc_rows`` / ``dec_rows``
    are the device's ``[V][pad]`` row trees (indexed once, by the slot the
    step runs), ``enc_pad`` the encoder slots' row count, ``x_rx`` the
    arrival the step reads (wire dtype) or None, ``x_turn`` the turn entry
    or None, ``stash`` the device's stash entries per encoder slot
    (``[V]`` lists of ``enc_pad`` skips, or None).  ``skips`` is None for a decoder slot
    and ``loss`` None where the step emits none."""

    def body(d, t, enc_rows, dec_rows, edge_p, mbs, aux, x_rx, x_turn,
             stash):
        vslot, m = tab["slot"][d][t], tab["mb"][d][t]
        mb_m, aux_m = tree_index(mbs, m), tree_index(aux, m)
        if tab["sel"][d][t] == RUN_ENC:
            x_in = (embed_fn(edge_p, mb_m, aux_m) if tab["embed"][d][t]
                    else x_rx.to(x_dtype))
            x_out, skips = enc_stage(enc_rows[vslot], x_in, aux_m, d, vslot)
        else:
            x_in = x_turn if tab["turn_rd"][d][t] else x_rx.to(x_dtype)
            # the stash slots holding this microbatch's V encoder-slot
            # entries, as the flat [V * enc_pad] view consumers address
            # via StageLayout.skip_rows
            skips_m = []
            for entry in stash:
                skips_m += entry if entry is not None else [None] * enc_pad
            x_out = dec_stage(dec_rows[vslot], x_in, skips_m, aux_m, d,
                              vslot)
            skips = None
        loss = (loss_fn(edge_p, x_out, mb_m, aux_m) if tab["loss"][d][t]
                else None)
        return x_out, skips, loss

    return body


def _stash_slots(tab: dict, V: int, skip_consumers, d: int, t: int
                 ) -> list[tuple[int, int]]:
    """(encoder slot, stash slot) of each entry decoder step (d, t) reads:
    every encoder slot's, or only those its decoder slot consumes."""
    evs = (range(V) if skip_consumers is None
           else skip_consumers[d][tab["slot"][d][t]])
    return [(ev, tab["skip_rd_slot"][d][t][ev]) for ev in evs]


def make_wave_pipeline_from_schedule(
    cfg: PipelineConfig,
    sched: Schedule,
    *,
    embed_fn: Callable,       # (edge_p, mb, aux) -> tokens
    enc_stage_fn: Callable,   # (rows, x, aux, device, slot) -> (x_out, skips)
    dec_stage_fn: Callable,   # (rows, x, skips, aux, device, slot) -> x_out
    loss_fn: Callable,        # (edge_p, x_final, mb, aux) -> scalar
    device_of_stage=None,     # partition's explicit stage->device mapping
    devices=None,             # ...same, as a tuple (memoized lowering)
    skip_consumers=None,      # layout-derived (device, dec slot) -> enc slots
    ring=None,                # runtime.ring.Ring: this rank's executor
    data=None,                # runtime.ring.DataGroup: its data replicas
    zero_dims=None,           # (enc_dims, dec_dims): ZeRO slot-view dims
    #   per stack leaf (runtime.sharding.zero_stack_dims), zero_stage >= 1
) -> Callable:
    """Lower a folded S=2VD schedule to ``fn(enc_stack, dec_stack, edge_p,
    mbs, aux) -> loss`` with ``[D, V, pad, ...]`` stage stacks and
    ``[M, ...]`` microbatch trees.

    Each step of the walk consults the tables, device by device: arrivals
    are stored into the rotating receive buffers at their slots, the
    selected stage slot runs on its microbatch with its own rows
    (``stack[d, slot]``), encoder slots stash their skips under the
    precomputed stash slot -- and the turnaround slot its output under its
    turn slot -- so each decoder slot reads exactly the skips its
    collocated encoder slot produced.  The stage functions get the device
    and slot so they can look up per-slot block counts and skip pairings.
    Correct for any valid schedule, including ``M < D`` and interleaved
    V > 1 plans (the rings wrap).  The loss is the mean over microbatches
    of ``loss_fn`` where ``tables.loss`` says.

    With ``ring`` the executor is rank ``ring.index``'s: the stacks are
    that device's ``[V, pad, ...]`` rows, the loss comes back summed over
    the group, and the call fills every leaf's ``.grad`` itself (the rank
    walk of ``runtime.ring``; no ``loss.backward()``).  With
    ``cfg.dp_size > 1`` the rank is data index ``data.index`` of its
    pipeline index: it runs its shard of every microbatch's batch
    (``runtime.sharding.batch_shard``), the loss is summed over the ring
    and the data group and divided by ``dp``, the edge gradients are
    summed over the ring and averaged over data, and the stage rows'
    are averaged over data as ``cfg.zero_stage`` says
    (``pipeline.reduce_stage_grads``); at ZeRO-2 the stacks are the
    rank's shards and each step all-gathers the slot it runs
    (``pipeline.rank_slots``).
    """
    D, M = cfg.num_devices, cfg.num_microbatches
    if sched.M != M or sched.D != D:
        raise PlanError(
            f"schedule (M={sched.M}, D={sched.D}) does not match the "
            f"pipeline config (M={M}, D={D})",
            check="program-shape")
    tables = StepTables.from_schedule(sched, folded=True,
                                      device_of_stage=device_of_stage,
                                      devices=devices,
                                      skip_consumers=skip_consumers)
    T, V = tables.num_steps, tables.V
    wire = _wire_dtype(cfg)
    W_down = max(tables.W_down, 1)
    W_up = max(tables.W_up, 1)
    W_turn = max(tables.W_turn, 1)
    W_skip = max(tables.W_skip, 1)
    tab = {f.name: getattr(tables, f.name) for f in dataclasses.fields(tables)
           if isinstance(getattr(tables, f.name), np.ndarray)}
    tab = {k: v.tolist() for k, v in tab.items()}   # host ints, fast lookups
    if ring is not None:
        check_ring_agreement(tables)
        return _wave_rank(cfg, tables, tab, ring, data, zero_dims, wire,
                          skip_consumers, embed_fn, enc_stage_fn,
                          dec_stage_fn, loss_fn)
    check_one_replica(cfg)
    down_used = bool(tables.down_send.any())
    up_used = bool(tables.up_send.any())
    enc_stage = _wrap_remat(enc_stage_fn, cfg)
    dec_stage = _wrap_remat(dec_stage_fn, cfg)

    def fn(enc_stack, dec_stack, edge_p, mbs, aux):
        enc_rows = unbind_rows(enc_stack)      # [D][V][enc_pad] row trees
        dec_rows = unbind_rows(dec_stack)      # [D][V][dec_pad]
        with torch.no_grad():
            proto = embed_fn(edge_p, tree_index(mbs, 0), tree_index(aux, 0))
        enc_pad = tree_leaves(enc_stack)[0].shape[2]
        body = _wave_body(tab, proto.dtype, enc_pad, embed_fn, enc_stage,
                          dec_stage, loss_fn)
        zero_w = torch.zeros(proto.shape, dtype=wire, device=proto.device)
        del proto

        enc_rx = [[None] * W_down for _ in range(D)]   # arrivals (wire)
        dec_rx = [[None] * W_up for _ in range(D)]
        turn = [[None] * W_turn for _ in range(D)]
        cache = [[None] * W_skip for _ in range(D)]    # skip stash entries
        losses = []

        def step(d, t, down_in, up_in):
            if tab["down_valid"][d][t]:
                enc_rx[d][tab["down_slot"][d][t]] = down_in
            if tab["up_valid"][d][t]:
                dec_rx[d][tab["up_slot"][d][t]] = up_in
            sel = tab["sel"][d][t]
            if sel == IDLE:
                return zero_w, zero_w
            rx = enc_rx if sel == RUN_ENC else dec_rx
            stash = None
            if sel == RUN_DEC:
                stash = [None] * V
                for ev, sl in _stash_slots(tab, V, skip_consumers, d, t):
                    stash[ev] = cache[d][sl]
            x_out, skips, loss = body(
                d, t, enc_rows[d], dec_rows[d], edge_p, mbs, aux,
                rx[d][tab["rx_slot"][d][t]],
                turn[d][tab["turn_rd_slot"][d][t]], stash)
            if tab["skip_wr"][d][t]:
                cache[d][tab["skip_wr_slot"][d][t]] = skips
            # gated stores: only the turnaround slot's output is read back
            if tab["turn_wr"][d][t]:
                turn[d][tab["turn_wr_slot"][d][t]] = x_out
            if loss is not None:
                losses.append(loss)
            # cast-on-send; quiescent hops carry zeros
            payload = x_out.to(wire)
            return (payload if tab["down_send"][d][t] else zero_w,
                    payload if tab["up_send"][d][t] else zero_w)

        pend_down, pend_up = [zero_w] * D, [zero_w] * D
        live_down = live_up = [False] * D
        for t in range(T):
            # double-buffered: step t-1's payloads hop at the top of t
            down_in, up_in = hop(pend_down, pend_up, down_used=down_used,
                                 up_used=up_used, down_live=live_down,
                                 up_live=live_up)
            outs = [step(d, t, down_in[d], up_in[d]) for d in range(D)]
            pend_down = [o[0] for o in outs]
            pend_up = [o[1] for o in outs]
            live_down = [tab["down_send"][d][t] for d in range(D)]
            live_up = [tab["up_send"][d][t] for d in range(D)]
        if len(losses) != M:
            raise PlanError(f"the walk emitted {len(losses)} losses for "
                            f"M={M} microbatches", check="program-shape")
        return torch.stack(losses).sum() / M

    return fn


def _sends(tab: dict, d: int, t: int) -> list[int]:
    return ([DOWN] if tab["down_send"][d][t] else []) + (
        [UP] if "up_send" in tab and tab["up_send"][d][t] else [])


def _arrivals(tab: dict, d: int, t: int, T: int) -> list[tuple[int, int]]:
    if t >= T:
        return []
    out = []
    if tab["down_valid"][d][t]:
        out.append((DOWN, tab["down_slot"][d][t]))
    if "up_valid" in tab and tab["up_valid"][d][t]:
        out.append((UP, tab["up_slot"][d][t]))
    return out


def _rx_input(rx: dict, chan: int, slot: int) -> tuple:
    """The arrival in ``slot`` of ``chan``, waited for, as a step input."""
    pend, t_arr = rx[(chan, slot)]
    return pend.wait()[0], ("rx", chan, t_arr, 0)


def _data_rank(cfg, data, zero_dims) -> tuple:
    """``(dp, data index, stage rows)`` of a rank: ``rows(stack, i)`` gives
    stack ``i``'s ``[V][pad]`` rows and their ``finish`` (gathered slot by
    slot from the rank's shards at ZeRO-2)."""
    check_data_group(cfg, data)
    if data is None:
        return 1, 0, lambda stack, i: rank_rows(stack, 2)
    if cfg.zero_stage >= 2:
        return data.size, data.index, lambda stack, i: rank_slots(
            stack, zero_dims[i], data)
    return data.size, data.index, lambda stack, i: rank_rows(stack, 2)


def _wave_rank(cfg, tables, tab, ring, data, zero_dims, wire, skip_consumers,
               embed_fn, enc_stage_fn, dec_stage_fn, loss_fn) -> Callable:
    """Rank ``ring.index`` of the folded walk (see
    :func:`make_wave_pipeline_from_schedule`).  The stage functions run
    without ``_wrap_remat``: the rank walk recomputes whole steps."""
    D, M, T, V = tables.D, tables.M, tables.num_steps, tables.V
    d = ring.index
    if ring.size != D:
        raise PlanError(f"a {ring.size}-rank ring for D={D} devices",
                        check="program-shape")
    W_turn = max(tables.W_turn, 1)
    W_skip = max(tables.W_skip, 1)
    dp, di, rows_of = _data_rank(cfg, data, zero_dims)

    def fn(enc_stack, dec_stack, edge_p, mbs, aux):
        mbs, aux = batch_shard(mbs, dp, di), batch_shard(aux, dp, di)
        enc_rows, enc_done = rows_of(enc_stack, 0)     # [V][enc_pad]
        dec_rows, dec_done = rows_of(dec_stack, 1)
        enc_pad = tree_leaves(enc_stack)[0].shape[1]
        with torch.no_grad():
            proto = embed_fn(edge_p, tree_index(mbs, 0), tree_index(aux, 0))
        body = _wave_body(tab, proto.dtype, enc_pad, embed_fn, enc_stage_fn,
                          dec_stage_fn, loss_fn)
        spec = [(tuple(proto.shape), wire)]
        del proto
        turn: list = [None] * W_turn     # (x_out, producing step)
        cache: list = [None] * W_skip    # (skips, producing step)
        rx: dict = {}

        def plan(t):
            sel = tab["sel"][d][t]
            if sel == IDLE:
                return None
            ins = {}
            if sel == RUN_ENC and not tab["embed"][d][t]:
                ins["rx"] = _rx_input(rx, DOWN, tab["rx_slot"][d][t])
            if sel == RUN_DEC:
                if tab["turn_rd"][d][t]:
                    x, t_prod = turn[tab["turn_rd_slot"][d][t]]
                    ins["turn"] = (x, ("out", t_prod, "turn"))
                else:
                    ins["rx"] = _rx_input(rx, UP, tab["rx_slot"][d][t])
                for ev, sl in _stash_slots(tab, V, skip_consumers, d, t):
                    if cache[sl] is None:
                        continue
                    skips, t_prod = cache[sl]
                    for i, x in enumerate(skips):
                        if x is not None:
                            ins[f"skip/{ev}/{i}"] = (x, ("out", t_prod,
                                                         f"skip/{i}"))

            def step(x):
                stash = ([[x.get(f"skip/{ev}/{i}") for i in range(enc_pad)]
                          for ev in range(V)] if sel == RUN_DEC else None)
                x_out, skips, loss = body(d, t, enc_rows, dec_rows, edge_p,
                                          mbs, aux, x.get("rx"),
                                          x.get("turn"), stash)
                out = {}
                if _sends(tab, d, t):
                    out["send/0"] = x_out.to(wire)     # cast-on-send
                if tab["turn_wr"][d][t]:
                    out["turn"] = x_out
                if tab["skip_wr"][d][t]:
                    out.update((f"skip/{i}", y) for i, y in enumerate(skips)
                               if y is not None)
                if loss is not None:
                    out["loss"] = loss
                return out

            def after(out):
                if tab["turn_wr"][d][t]:
                    turn[tab["turn_wr_slot"][d][t]] = (out["turn"], t)
                if tab["skip_wr"][d][t]:
                    cache[tab["skip_wr_slot"][d][t]] = (
                        [out.get(f"skip/{i}") for i in range(enc_pad)], t)

            return StepPlan(ins, step, after)

        local = rank_walk(
            ring, T=T, M=M, remat=cfg.remat, overlap=cfg.overlap,
            specs={DOWN: spec, UP: spec},
            arrivals=lambda t: _arrivals(tab, d, t, T),
            sends=lambda t: _sends(tab, d, t), plan=plan, rx=rx, dp=dp)
        return finish_rank(cfg, ring, data, zero_dims, local,
                           (enc_done, dec_done), (enc_stack, dec_stack),
                           edge_p)

    return fn


# ===========================================================================
# Linear executor from tables
# ===========================================================================

def _linear_body(tab: dict, x_dtype, embed_fn: Callable, stage: Callable,
                 loss_fn: Callable) -> Callable:
    """Device d's step t of the linear walk: ``body(d, t, rows, edge_p,
    mbs, x_rx) -> (x_out, loss)`` (``x_rx`` the arrival, wire dtype, or
    None where the step embeds; ``loss`` None where it emits none)."""

    def body(d, t, rows, edge_p, mbs, x_rx):
        vslot, mb_m = tab["slot"][d][t], tree_index(mbs, tab["mb"][d][t])
        x_in = (embed_fn(edge_p, mb_m) if tab["embed"][d][t]
                else x_rx.to(x_dtype))
        x_out = stage(rows[vslot], x_in, d, vslot)
        loss = loss_fn(edge_p, x_out, mb_m) if tab["loss"][d][t] else None
        return x_out, loss

    return body


def make_linear_pipeline_from_schedule(
    cfg: PipelineConfig,
    sched: Schedule,
    *,
    embed_fn: Callable,       # (edge_p, mb) -> x
    stage_fn: Callable,       # (rows, x, device, slot) -> x
    loss_fn: Callable,        # (edge_p, x_final, mb) -> scalar
    device_of_stage=None,     # partition's explicit stage->device mapping
    devices=None,             # ...same, as a tuple (memoized lowering)
    ring=None,                # runtime.ring.Ring: this rank's executor
    data=None,                # runtime.ring.DataGroup: its data replicas
    zero_dims=None,           # ZeRO slot-view dims per stack leaf
) -> Callable:
    """Lower a linear S=VD schedule to ``fn(stack, edge_p, mbs) -> loss``
    (the call of :func:`~repro_torch.runtime.pipeline.make_linear_pipeline`;
    the stack carries a slot axis, ``[D, V, pad, ...]``, and ``stage_fn``
    receives the device and slot).  The down ring wraps so interleaved
    (V > 1) plans cross the D-1 -> 0 slot boundary; arrivals land in a
    rotating ``W_down`` receive buffer in ``cfg.wire_dtype``, stored only
    where the tables mark them, and quiescent hops carry zeros.  With
    ``ring``: rank ``ring.index``'s executor over its ``[V, pad, ...]``
    rows, with ``data`` and ``zero_dims`` (a 1-tuple) as in
    :func:`make_wave_pipeline_from_schedule`."""
    D, M = cfg.num_devices, cfg.num_microbatches
    if sched.M != M or sched.D != D:
        raise PlanError(
            f"schedule (M={sched.M}, D={sched.D}) does not match the "
            f"pipeline config (M={M}, D={D})",
            check="program-shape")
    tables = StepTables.from_schedule(sched, folded=False,
                                      device_of_stage=device_of_stage,
                                      devices=devices)
    T = tables.num_steps
    wire = _wire_dtype(cfg)
    down_used = bool(tables.down_send.any())
    W_down = max(tables.W_down, 1)
    tab = {k: getattr(tables, k).tolist() for k in (
        "sel", "slot", "mb", "down_valid", "down_slot", "rx_slot",
        "down_send", "loss", "embed")}
    if ring is not None:
        check_ring_agreement(tables)
        return _linear_rank(cfg, tables, tab, ring, data, zero_dims, wire,
                            embed_fn, stage_fn, loss_fn)
    check_one_replica(cfg)
    stage = _wrap_remat(stage_fn, cfg)

    def fn(stack, edge_p, mbs):
        rows = unbind_rows(stack)              # [D][V][pad] row trees
        with torch.no_grad():
            proto = embed_fn(edge_p, tree_index(mbs, 0))
        body = _linear_body(tab, proto.dtype, embed_fn, stage, loss_fn)
        zero_w = torch.zeros(proto.shape, dtype=wire, device=proto.device)
        del proto
        rx = [[None] * W_down for _ in range(D)]   # arrivals (wire)
        losses = []

        def step(d, t, h_in):
            if tab["down_valid"][d][t]:
                rx[d][tab["down_slot"][d][t]] = h_in
            if tab["sel"][d][t] == IDLE:
                return zero_w
            x_out, loss = body(d, t, rows[d], edge_p, mbs,
                               rx[d][tab["rx_slot"][d][t]])
            if loss is not None:
                losses.append(loss)
            # cast-on-send; quiescent hops carry zeros
            return x_out.to(wire) if tab["down_send"][d][t] else zero_w

        pend, live = [zero_w] * D, [False] * D
        for t in range(T):
            # double-buffered: step t-1's payloads hop at the top of t
            h_in, _ = hop(pend, None, down_used=down_used, up_used=False,
                          down_live=live)
            pend = [step(d, t, h_in[d]) for d in range(D)]
            live = [tab["down_send"][d][t] for d in range(D)]
        if len(losses) != M:
            raise PlanError(f"the walk emitted {len(losses)} losses for "
                            f"M={M} microbatches", check="program-shape")
        return torch.stack(losses).sum() / M

    return fn


def _linear_rank(cfg, tables, tab, ring, data, zero_dims, wire, embed_fn,
                 stage_fn, loss_fn) -> Callable:
    """Rank ``ring.index`` of the linear walk (see
    :func:`make_linear_pipeline_from_schedule`)."""
    D, M, T = tables.D, tables.M, tables.num_steps
    d = ring.index
    if ring.size != D:
        raise PlanError(f"a {ring.size}-rank ring for D={D} devices",
                        check="program-shape")
    dp, di, rows_of = _data_rank(cfg, data, zero_dims)

    def fn(stack, edge_p, mbs):
        mbs = batch_shard(mbs, dp, di)
        rows, done = rows_of(stack, 0)         # [V][pad] row trees
        with torch.no_grad():
            proto = embed_fn(edge_p, tree_index(mbs, 0))
        body = _linear_body(tab, proto.dtype, embed_fn, stage_fn, loss_fn)
        spec = [(tuple(proto.shape), wire)]
        del proto
        rx: dict = {}

        def plan(t):
            if tab["sel"][d][t] == IDLE:
                return None
            ins = ({} if tab["embed"][d][t]
                   else {"rx": _rx_input(rx, DOWN, tab["rx_slot"][d][t])})

            def step(x):
                x_out, loss = body(d, t, rows, edge_p, mbs, x.get("rx"))
                out = {}
                if tab["down_send"][d][t]:
                    out["send/0"] = x_out.to(wire)     # cast-on-send
                if loss is not None:
                    out["loss"] = loss
                return out

            return StepPlan(ins, step)

        local = rank_walk(
            ring, T=T, M=M, remat=cfg.remat, overlap=cfg.overlap,
            specs={DOWN: spec}, arrivals=lambda t: _arrivals(tab, d, t, T),
            sends=lambda t: _sends(tab, d, t), plan=plan, rx=rx, dp=dp)
        return finish_rank(cfg, ring, data, zero_dims, local, (done,),
                           (stack,), edge_p)

    return fn
