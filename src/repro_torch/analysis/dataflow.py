"""Abstract interpretation of lowered step tables (race/deadlock proofs).

A copy of ``repro.analysis.dataflow``: the port imports nothing of the JAX
package, so it keeps its own copy of this framework-neutral module.

The table executors (``runtime.schedule_exec``) are scan bodies driven
entirely by host-precomputed per-device arrays: which task runs each step,
which rotating-buffer slot each arrival is stored into, which slot each
task reads, which hops carry a message.  That makes them *statically
verifiable*: this module replays the device programs symbolically — no
framework, no execution — moving abstract tokens through the ring registers
and the rotating ``W_down``/``W_up``/``W_turn``/``W_skip`` buffers in exactly
the executor's phase order (arrivals stored at the top of the body, the
running task's reads next, turn/skip/wire writes last), and checks:

- **no-live-overwrite** — no store lands in a slot whose current entry
  still has an unconsumed reader: arrivals into the rx buffers, turnaround
  writes, and skip-stash writes all prove their target slot dead first.
  This is the race certificate: it holds under the overlapped
  (``PipelineConfig.overlap``) lowering too, where step t's send is
  *issued* one scan iteration later but its arrival still lands at the
  top of step t+1's body, before that step's reads.
- **matched-store-read** — every buffer read is preceded by exactly one
  matching store: the slot is live, and the stored token's microbatch
  (and, for skip reads, encoder slot) equals what the consumer expects.
  Uninitialized-slot reads and stale-entry reads fail here.
- **send-recv-pairing** — ring hops pair across devices every step: a
  stored arrival on device d at step k requires the matching ring
  neighbour to have sent at step k-1, every sent message is stored by its
  receiver one hop later, and nothing is still in flight when the scan
  ends.  Together with device programs being loop-free per step this
  proves the hop ordering deadlock-free: messages only flow forward in
  step order, so a cyclic wait cannot form.
- **wire-dtype-flow** — values that cross a ring are wire-dtype tokens
  (cast-on-send) and every consumer of a ring slot upcasts on read, while
  device-local turnaround / skip-stash traffic stays in the compute dtype;
  a wire-dtype token reaching a compute-dtype read site (or vice versa)
  fails here.
- **buffer-bounds** — every store/read slot index lies inside the
  declared window, and the replayed peak occupancy per channel never
  exceeds it (the windows really are upper bounds on simultaneously-live
  entries — the memory-safety half of the proof).
- **no-lost-message** — every stored entry is eventually read (an unread
  arrival or stash entry means the liveness analysis kept a dead store —
  or a corrupted table dropped a consumer).
- **overlap-accounting** — the interpreter's own exposed/hidden hop
  counts (a hop is exposed when its consumer reads on the arrival step)
  equal the counts the lowering declared, holding the executor tables to
  the same split the planner's ``core.schedule.comm_stats`` mirrors.
- **program-shape** — structural sanity: table shapes agree, selector /
  microbatch / slot values are in range, each microbatch emits its loss
  exactly once, sends and buffer writes are attached to running tasks.

``interpret_tables`` runs the replay in BOTH hop lowerings (synchronous
send-at-bottom and overlapped send-at-top-of-next-body) and requires the
resulting store/read event streams to be identical — the overlapped
double-buffering may restructure *when* collectives are issued, never what
arrives where.

Everything here is deliberately independent of the lowering's own
interval-coloring machinery (the windows are *recomputed* by brute-force
occupancy counting, the pairing by actually carrying tokens around the
ring) so a bug in ``StepTables.from_schedule`` cannot certify itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Selector codes — must mirror runtime.schedule_exec (tested for equality
# in tests/test_torch_tuner.py; redefined here so this module stays
# importable without torch).
IDLE, RUN_ENC, RUN_DEC = 0, 1, 2

#: Every check the interpreter runs, in report order.  A clean certificate
#: lists all of them with zero violations.
CHECKS = (
    "program-shape",
    "buffer-bounds",
    "send-recv-pairing",
    "no-live-overwrite",
    "matched-store-read",
    "wire-dtype-flow",
    "no-lost-message",
    "overlap-accounting",
    "overlap-equivalence",
)

# Abstract value dtypes riding the dataflow: ring payloads are cast to the
# wire dtype on send; turnaround and skip-stash entries stay in the
# compute dtype.  The interpreter tracks which kind each token is.
WIRE, COMPUTE = "wire", "compute"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One failed static check, with enough context to locate it."""

    check: str                    # one of CHECKS
    detail: str
    device: int | None = None
    step: int | None = None      # compressed forward step index
    slot: int | None = None      # buffer slot / ring channel context

    def __str__(self) -> str:
        where = ", ".join(
            f"{k}={v}" for k, v in (("device", self.device),
                                    ("step", self.step),
                                    ("slot", self.slot)) if v is not None)
        return f"[{self.check}] {self.detail}" + (f" ({where})" if where
                                                  else "")


@dataclasses.dataclass(frozen=True)
class _Token:
    """Abstract value: who produced it, when, for which microbatch."""

    src_device: int
    src_step: int
    microbatch: int
    kind: str                    # WIRE | COMPUTE
    enc_slot: int = -1           # skip-stash entries only


class _Slot:
    """One rotating-buffer slot: empty, or holding a token with a
    remaining-reader count (rx/turn entries have exactly one reader; a
    skip entry may be read several times and dies at its last read)."""

    __slots__ = ("token", "reads", "stored_at")

    def __init__(self):
        self.token: _Token | None = None
        self.reads = 0
        self.stored_at = -1


@dataclasses.dataclass(frozen=True)
class DataflowReport:
    """Everything ``interpret_tables`` proved (or failed to prove)."""

    violations: tuple[Violation, ...]
    # replayed peak occupancy per channel (max simultaneously-live entries
    # across devices) — the independent proof behind the declared windows
    peak_down: int
    peak_up: int
    peak_turn: int
    peak_skip: int
    # independently recounted hop classification
    exposed_down: int
    exposed_up: int
    live_down: int
    live_up: int

    @property
    def ok(self) -> bool:
        return not self.violations

    def by_check(self) -> dict[str, list[Violation]]:
        out: dict[str, list[Violation]] = {name: [] for name in CHECKS}
        for v in self.violations:
            out.setdefault(v.check, []).append(v)
        return out

    def failed_checks(self) -> tuple[str, ...]:
        return tuple(name for name, vs in self.by_check().items() if vs)


def _shape_check(tabs, errs: list[Violation]) -> bool:
    """Structural sanity; returns False when the replay cannot proceed."""
    D = int(tabs.D)
    arrays_2d = ("sel", "slot", "mb", "down_mb", "down_valid", "up_mb",
                 "up_valid", "loss", "embed", "turn_rd", "turn_wr",
                 "down_send", "up_send", "down_slot", "up_slot", "rx_slot",
                 "turn_wr_slot", "turn_rd_slot", "skip_wr", "skip_wr_slot")
    shapes = {name: np.asarray(getattr(tabs, name)).shape
              for name in arrays_2d}
    T = shapes["sel"][1] if len(shapes["sel"]) == 2 else -1
    for name, shape in shapes.items():
        if shape != (D, T):
            errs.append(Violation(
                "program-shape",
                f"table {name!r} has shape {shape}, expected ({D}, {T})"))
    skip_rd = np.asarray(tabs.skip_rd_slot)
    if skip_rd.shape != (D, T, int(tabs.V)):
        errs.append(Violation(
            "program-shape",
            f"skip_rd_slot has shape {skip_rd.shape}, expected "
            f"({D}, {T}, {tabs.V})"))
    if errs:
        return False
    sel = np.asarray(tabs.sel)
    bad = ~np.isin(sel, (IDLE, RUN_ENC, RUN_DEC))
    for d, k in zip(*np.nonzero(bad)):
        errs.append(Violation("program-shape",
                              f"selector {sel[d, k]} is not IDLE/ENC/DEC",
                              device=int(d), step=int(k)))
    mb = np.asarray(tabs.mb)
    run = sel != IDLE
    bad_mb = run & ((mb < 0) | (mb >= int(tabs.M)))
    for d, k in zip(*np.nonzero(bad_mb)):
        errs.append(Violation(
            "program-shape",
            f"microbatch {mb[d, k]} out of range [0, {tabs.M})",
            device=int(d), step=int(k)))
    vslot = np.asarray(tabs.slot)
    bad_v = run & ((vslot < 0) | (vslot >= int(tabs.V)))
    for d, k in zip(*np.nonzero(bad_v)):
        errs.append(Violation(
            "program-shape",
            f"stage slot {vslot[d, k]} out of range [0, {tabs.V})",
            device=int(d), step=int(k)))
    if int(tabs.rings) not in (1, 2):
        errs.append(Violation("program-shape",
                              f"rings={tabs.rings}, expected 1 or 2"))
    # a send / buffer write must be attached to a running task (the
    # executors would put an all-zeros "message" on the wire otherwise)
    for name, tab in (("down_send", tabs.down_send),
                      ("up_send", tabs.up_send),
                      ("turn_wr", tabs.turn_wr),
                      ("skip_wr", tabs.skip_wr)):
        orphan = np.asarray(tab) & ~run
        for d, k in zip(*np.nonzero(orphan)):
            errs.append(Violation(
                "program-shape", f"{name} set on an idle step",
                device=int(d), step=int(k)))
    # each microbatch's loss is emitted exactly once, by a running task
    loss = np.asarray(tabs.loss)
    loss_mbs = [int(m) for m in mb[loss & run]] + \
        [-1 for _ in range(int((loss & ~run).sum()))]
    for d, k in zip(*np.nonzero(loss & ~run)):
        errs.append(Violation("program-shape", "loss emitted on idle step",
                              device=int(d), step=int(k)))
    counts = np.bincount([m for m in loss_mbs if m >= 0],
                         minlength=int(tabs.M))
    for m, c in enumerate(counts):
        if c != 1:
            errs.append(Violation(
                "program-shape",
                f"microbatch {m} emits its loss {c} times (expected 1)"))
    return not errs


def _interpret_once(tabs, *, overlap: bool, skip_consumers,
                    errs: list[Violation]):
    """One full symbolic replay.  Returns (events, peaks, hop counts).

    ``events`` is the ordered log of (phase, device, step, channel, slot,
    token) tuples — the observable dataflow — used to prove the overlapped
    and synchronous lowerings equivalent.
    """
    D, T, V = int(tabs.D), int(tabs.num_steps), int(tabs.V)
    folded = int(tabs.rings) == 2
    W = {"down": int(tabs.W_down), "up": int(tabs.W_up),
         "turn": int(tabs.W_turn), "skip": int(tabs.W_skip)}
    sel = np.asarray(tabs.sel)
    slot = np.asarray(tabs.slot)
    mb = np.asarray(tabs.mb)
    down_valid = np.asarray(tabs.down_valid)
    up_valid = np.asarray(tabs.up_valid)
    down_mb = np.asarray(tabs.down_mb)
    up_mb = np.asarray(tabs.up_mb)
    down_send = np.asarray(tabs.down_send)
    up_send = np.asarray(tabs.up_send)
    down_slot = np.asarray(tabs.down_slot)
    up_slot = np.asarray(tabs.up_slot)
    rx_slot = np.asarray(tabs.rx_slot)
    embed = np.asarray(tabs.embed)
    turn_rd = np.asarray(tabs.turn_rd)
    turn_wr = np.asarray(tabs.turn_wr)
    turn_wr_slot = np.asarray(tabs.turn_wr_slot)
    turn_rd_slot = np.asarray(tabs.turn_rd_slot)
    skip_wr = np.asarray(tabs.skip_wr)
    skip_wr_slot = np.asarray(tabs.skip_wr_slot)
    skip_rd_slot = np.asarray(tabs.skip_rd_slot)

    bufs = {chan: [[_Slot() for _ in range(W[chan])] for _ in range(D)]
            for chan in ("down", "up", "turn", "skip")}
    peaks = {chan: 0 for chan in bufs}
    exposed = {"down": 0, "up": 0}
    live = {"down": 0, "up": 0}
    # one in-flight register per ring per device; overlapped lowering also
    # needs the not-yet-issued pending payload (the double buffer)
    in_flight: dict[str, list[_Token | None]] = {
        "down": [None] * D, "up": [None] * D}
    pending: dict[str, list[_Token | None]] = {
        "down": [None] * D, "up": [None] * D}
    events: list[tuple] = []

    def slot_ok(chan: str, d: int, k: int, w: int) -> bool:
        if not 0 <= w < W[chan]:
            errs.append(Violation(
                "buffer-bounds",
                f"{chan} slot {w} outside the declared window "
                f"W_{chan}={W[chan]}", device=d, step=k, slot=int(w)))
            return False
        return True

    def store(chan: str, d: int, k: int, w: int, tok: _Token):
        if not slot_ok(chan, d, k, w):
            return
        s = bufs[chan][d][w]
        if s.token is not None and s.reads == 0:
            errs.append(Violation(
                "no-live-overwrite",
                f"store into {chan} slot {w} clobbers the live entry for "
                f"microbatch {s.token.microbatch} (stored at step "
                f"{s.stored_at}, not yet read)", device=d, step=k,
                slot=int(w)))
        s.token, s.reads, s.stored_at = tok, 0, k
        events.append(("store", chan, d, k, int(w), tok))

    def read(chan: str, d: int, k: int, w: int, want_mb: int,
             want_kind: str, want_enc_slot: int | None = None
             ) -> _Token | None:
        if not slot_ok(chan, d, k, w):
            return None
        s = bufs[chan][d][w]
        if s.token is None:
            errs.append(Violation(
                "matched-store-read",
                f"read of {chan} slot {w} with no preceding store "
                "(uninitialized-slot read)", device=d, step=k,
                slot=int(w)))
            return None
        tok = s.token
        if tok.microbatch != want_mb or (
                want_enc_slot is not None
                and tok.enc_slot != want_enc_slot):
            errs.append(Violation(
                "matched-store-read",
                f"read of {chan} slot {w} expected microbatch {want_mb}"
                + (f" enc slot {want_enc_slot}"
                   if want_enc_slot is not None else "")
                + f" but the slot holds microbatch {tok.microbatch}"
                + (f" enc slot {tok.enc_slot}"
                   if want_enc_slot is not None else "")
                + f" (stored at step {s.stored_at})",
                device=d, step=k, slot=int(w)))
        if tok.kind != want_kind:
            errs.append(Violation(
                "wire-dtype-flow",
                f"{chan} slot {w} holds a {tok.kind}-dtype value but the "
                f"consumer reads it as {want_kind} (cast-on-send must "
                "meet upcast-on-read)", device=d, step=k, slot=int(w)))
        s.reads += 1
        events.append(("read", chan, d, k, int(w), tok))
        return tok

    def occupancy(chan: str) -> int:
        return max(sum(1 for s in dev if s.token is not None
                       and s.reads == 0) for dev in bufs[chan]) \
            if bufs[chan] and W[chan] else 0

    for k in range(T):
        # ---- hop + arrival phase (top of the scan body) ----------------
        # overlapped: step k-1's payload was parked in `pending` and its
        # ppermute is issued now; synchronous: it already moved to
        # `in_flight` at the bottom of step k-1.  Either way the token is
        # stored before this step's reads — same arrival step, which is
        # exactly the equivalence the overlap lowering claims.
        if overlap:
            for ring in ("down", "up"):
                in_flight[ring] = pending[ring]
                pending[ring] = [None] * D
        for ring, valid, mb_tab, slot_tab, shift in (
                ("down", down_valid, down_mb, down_slot, +1),
                ("up", up_valid, up_mb, up_slot, -1)):
            arrived = [None] * D
            for src in range(D):
                if in_flight[ring][src] is not None:
                    arrived[(src + shift) % D] = in_flight[ring][src]
            in_flight[ring] = [None] * D
            for d in range(D):
                tok = arrived[d]
                if valid[d, k]:
                    if tok is None:
                        errs.append(Violation(
                            "send-recv-pairing",
                            f"{ring}-ring arrival stored at step {k} but "
                            "the ring neighbour sent nothing at step "
                            f"{k - 1}", device=d, step=k))
                        continue
                    if tok.microbatch != mb_tab[d, k]:
                        errs.append(Violation(
                            "send-recv-pairing",
                            f"{ring}-ring arrival carries microbatch "
                            f"{tok.microbatch} but the table expects "
                            f"{mb_tab[d, k]}", device=d, step=k))
                    live[ring] += 1
                    store(ring, d, k, int(slot_tab[d, k]), tok)
                elif tok is not None:
                    errs.append(Violation(
                        "send-recv-pairing",
                        f"{ring}-ring message sent by device "
                        f"{tok.src_device} at step {tok.src_step} is "
                        "dropped (receiver stores nothing this step)",
                        device=d, step=k))
        for chan in peaks:
            peaks[chan] = max(peaks[chan], occupancy(chan))

        # ---- compute phase: the selected task's reads ------------------
        for d in range(D):
            s, m = int(sel[d, k]), int(mb[d, k])
            if s == RUN_ENC and not embed[d, k]:
                tok = read("down", d, k, int(rx_slot[d, k]), m, WIRE)
                if tok is not None and tok.src_step + 1 == k:
                    exposed["down"] += 1
            elif s == RUN_DEC:
                if turn_rd[d, k]:
                    read("turn", d, k, int(turn_rd_slot[d, k]), m, COMPUTE)
                else:
                    tok = read("up", d, k, int(rx_slot[d, k]), m, WIRE)
                    if tok is not None and tok.src_step + 1 == k:
                        exposed["up"] += 1
                consumers = (range(V) if skip_consumers is None
                             else skip_consumers[d][int(slot[d, k])])
                for ev in consumers:
                    read("skip", d, k, int(skip_rd_slot[d, k, ev]), m,
                         COMPUTE, want_enc_slot=int(ev))

        # ---- write phase: turn / skip stores + this step's sends -------
        for d in range(D):
            s, m = int(sel[d, k]), int(mb[d, k])
            out = _Token(d, k, m, COMPUTE) if s != IDLE else None
            if turn_wr[d, k] and out is not None:
                store("turn", d, k, int(turn_wr_slot[d, k]), out)
            if skip_wr[d, k] and out is not None:
                store("skip", d, k, int(skip_wr_slot[d, k]),
                      dataclasses.replace(out, enc_slot=int(slot[d, k])))
            for ring, send in (("down", down_send), ("up", up_send)):
                if send[d, k] and out is not None:
                    wire_tok = dataclasses.replace(out, kind=WIRE)
                    (pending if overlap else in_flight)[ring][d] = wire_tok
        for chan in ("turn", "skip"):
            peaks[chan] = max(peaks[chan], occupancy(chan))

    # ---- end of scan: nothing may still be in flight or unread ---------
    for ring in ("down", "up"):
        for regs in (in_flight[ring], pending[ring]):
            for d in range(D):
                tok = regs[d]
                if tok is not None:
                    errs.append(Violation(
                        "send-recv-pairing",
                        f"{ring}-ring message sent at step {tok.src_step} "
                        "is still in flight when the scan ends (no "
                        "consumer step)", device=d, step=tok.src_step))
    for chan, dev_bufs in bufs.items():
        for d, dev in enumerate(dev_bufs):
            for w, s in enumerate(dev):
                if s.token is not None and s.reads == 0:
                    errs.append(Violation(
                        "no-lost-message",
                        f"{chan} slot {w} entry for microbatch "
                        f"{s.token.microbatch} (stored at step "
                        f"{s.stored_at}) is never read", device=d,
                        slot=w, step=s.stored_at))
    if not folded and (turn_wr.any() or skip_wr.any() or up_send.any()):
        errs.append(Violation(
            "program-shape",
            "linear (single-ring) tables carry turnaround/skip/up-ring "
            "activity"))
    return events, peaks, exposed, live


def interpret_tables(tabs, *, overlap: bool = True,
                     skip_consumers=None) -> DataflowReport:
    """Statically verify a lowered :class:`StepTables` device program.

    ``tabs`` is duck-typed (any object with the StepTables fields), so
    corrupted/mutated tables — ``dataclasses.replace`` products in the
    mutation-soundness suite — flow through the same proof.

    ``skip_consumers`` must be the SAME per-(device, dec-slot) consumer
    lists the lowering was given (``StageLayout.skip_consumers()``), or
    None for the conservative every-slot analysis; the interpreter reads
    exactly the stash entries the executors' pairing tables consume.

    ``overlap`` selects which hop lowering is primary (it decides nothing
    about arrival steps — that is the point); the interpreter ALWAYS
    replays both lowerings and appends an ``overlap-equivalence``
    violation if their observable store/read event streams differ.
    """
    errs: list[Violation] = []
    if not _shape_check(tabs, errs):
        return DataflowReport(tuple(errs), 0, 0, 0, 0, 0, 0, 0, 0)
    events, peaks, exposed, live = _interpret_once(
        tabs, overlap=overlap, skip_consumers=skip_consumers, errs=errs)
    other_errs: list[Violation] = []
    other_events, *_ = _interpret_once(
        tabs, overlap=not overlap, skip_consumers=skip_consumers,
        errs=other_errs)
    if events != other_events:
        diff = next((i for i, (a, b) in enumerate(
            zip(events, other_events)) if a != b),
            min(len(events), len(other_events)))
        errs.append(Violation(
            "overlap-equivalence",
            "synchronous and double-buffered hop lowerings diverge at "
            f"dataflow event {diff} of {len(events)}"))

    # declared windows really bound the replayed occupancy
    for chan, declared in (("down", tabs.W_down), ("up", tabs.W_up),
                           ("turn", tabs.W_turn), ("skip", tabs.W_skip)):
        if peaks[chan] > int(declared):
            errs.append(Violation(
                "buffer-bounds",
                f"replayed peak {chan} occupancy {peaks[chan]} exceeds "
                f"the declared window W_{chan}={declared}"))
    # the lowering's exposed/hidden split matches the replay's own count
    for ring, declared in (("down", tabs.exposed_down),
                           ("up", tabs.exposed_up)):
        if exposed[ring] != int(declared):
            errs.append(Violation(
                "overlap-accounting",
                f"replay counts {exposed[ring]} exposed {ring}-ring hops "
                f"but the lowering declared {declared}"))
    declared_live = tuple(int(x) for x in tabs.live_hops)
    if (live["down"], live["up"]) != declared_live:
        errs.append(Violation(
            "overlap-accounting",
            f"replay carried {(live['down'], live['up'])} (down, up) "
            f"messages but the send masks declare {declared_live}"))
    return DataflowReport(
        tuple(errs), peak_down=peaks["down"], peak_up=peaks["up"],
        peak_turn=peaks["turn"], peak_skip=peaks["skip"],
        exposed_down=exposed["down"], exposed_up=exposed["up"],
        live_down=live["down"], live_up=live["up"])
