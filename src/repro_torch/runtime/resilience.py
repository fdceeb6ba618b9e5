"""Elastic fault tolerance for the compiled pipeline (the port of sections
1-3 of ``repro.runtime.resilience`` and the worker half of section 4).

1. **Plan state-specs + fingerprints.**  :func:`compiled_state_spec`
   serializes everything that determines how a
   :class:`~repro_torch.runtime.compile.CompiledPipeline`'s training state
   is laid out at rest -- partition cuts, stage->device map, the
   :class:`~repro_torch.runtime.compile.StageLayout` slot/count/pad tables
   -- and :func:`plan_fingerprint` hashes the layout-relevant subset.  Both
   equal the JAX package's for the same graph and plan, so a checkpoint
   of either package takes the fast path in the other when the plans
   agree.  ``M``/``wire_dtype``/``dp``/``zero_stage`` are recorded but not
   hashed.

2. **Elastic restore.**  :func:`state_to_logical` de-stacks saved
   ``[D, V, pad, ...]`` stage stacks through the *saved* layout spec back
   to the model's block stacks (AdamW's ``m``/``v`` mirror params
   leaf-wise); the tests and drills read logical params through it.  A
   restore never materializes that view: :func:`restore_rank_state`
   reads each device's rows of the new plan straight from the saved
   members -- the rows themselves when the fingerprints match, else the
   saved blocks they hold (:func:`rank_rows_sources`), each run of them
   one byte range.  :func:`restore_training_state` is the one-process
   restore: the same reader over every device's rows.

   Over ranks (one process per (data, pipeline) grid point) the state at
   rest is the same: every leaf whole, as one process of the plan holds
   it; dp and the ZeRO stage are placement only.  :func:`gather_rank_state`
   is a save's gather (each rank's piece goes to the leaf's writer, who
   places it by ``CompiledPipeline.rank_piece``; :class:`RankSaves` hands
   it to a ``CheckpointManager``), and :func:`restore_rank_state` a
   rank's restore: the ranks split the hashing and agree on every
   verdict, and each reads only its rows, never the whole state.

3. **Fault injection + a NaN guard.**  :class:`FaultPlan` parses the
   flag/env fault script (``kill@K``, ``stop@K``, ``nan@K``,
   ``corrupt@K[:shard]``, ``truncate@K[:shard]``, ``iofail@K:N``, and the
   multi-host verbs ``hostdown@K:h``, ``hang@K[:h]``, ``slow@K:factor[:h]``)
   that the trainer consults each step, and :class:`GradGuard` is
   the skip-and-log guard for non-finite grads with a bounded
   consecutive-skip budget and an escalation.

4. **Supervisor detection primitives**: :func:`write_heartbeat` /
   :func:`read_heartbeats` over atomic per-host files (the worker half),
   and the supervisor's :class:`Watchdog` (progress-based ``suspect`` /
   ``hung`` verdicts, lenient until a host moves past its first ``train``
   beat) and :class:`StragglerDetector` (per-step ``step_s`` samples
   against the peers' median).  Both are the JAX classes line for line:
   the same inputs give the same verdicts, ages and ratios.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import sys
import time
from typing import Any

import numpy as np
import torch

from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                               tree_map_paths)

Pytree = Any

STATE_SPEC_SCHEMA = "repro.state-spec/v1"

#: spec keys that determine the at-rest array layout (and hence whether a
#: saved checkpoint can be loaded directly or must be de-/re-stacked).
_FINGERPRINT_FIELDS = ("P", "V", "folded", "cuts", "devices",
                       "num_param_stacks", "enc_slots", "dec_slots",
                       "enc_counts", "dec_counts", "enc_pad", "dec_pad")


def plan_fingerprint(spec: dict) -> str:
    """Stable 16-hex-digit digest of a state spec's layout fields.

    Computed over the canonical JSON of :data:`_FINGERPRINT_FIELDS` only,
    so it is identical whether the spec came fresh off a plan (tuples)
    or round-tripped through a manifest (lists).
    """
    doc = {k: spec[k] for k in _FINGERPRINT_FIELDS}
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def compiled_state_spec(plan) -> dict:
    """JSON-serializable layout spec for a CompiledPipeline's state."""
    part, lay, pcfg = plan.partition, plan.layout, plan.pcfg
    spec = {
        "schema": STATE_SPEC_SCHEMA,
        "P": int(part.num_devices),
        "S": int(part.num_stages),
        "V": int(lay.V),
        "folded": bool(part.folded),
        "cuts": [int(c) for c in part.cuts],
        "devices": [int(d) for d in part.devices],
        "dp": int(pcfg.dp_size),
        "zero_stage": int(pcfg.zero_stage),
        "M": int(pcfg.num_microbatches),
        "wire_dtype": str(pcfg.wire_dtype),
        "num_param_stacks": int(plan.model_fns.num_param_stacks),
        "enc_slots": [[int(s) for s in ss] for ss in lay.enc_slots],
        "dec_slots": [[int(s) for s in ss] for ss in lay.dec_slots],
        "enc_counts": [[int(c) for c in cc] for cc in lay.enc_counts],
        "dec_counts": [[int(c) for c in cc] for cc in lay.dec_counts],
        "enc_pad": int(lay.enc_pad),
        "dec_pad": int(lay.dec_pad),
    }
    spec["fingerprint"] = plan_fingerprint(spec)
    return spec


# ===========================================================================
# Elastic de-stack / re-stack
# ===========================================================================

def _spec_enc_ranges(spec: dict) -> list:
    cuts = spec["cuts"]
    return [[(cuts[s], cuts[s + 1]) for s in ss]
            for ss in spec["enc_slots"]]


def _spec_dec_ranges(spec: dict) -> list:
    cuts = spec["cuts"]
    mid = cuts[(len(cuts) - 1) // 2]
    return [[(cuts[s] - mid, cuts[s + 1] - mid) for s in ss]
            for ss in spec["dec_slots"]]


def _destack(stacked: Pytree, ranges: list) -> Pytree:
    """``StageLayout._unstack`` driven by a serialized spec: ``[D, V, pad,
    ...]`` stage stacks -> flat block stack in graph order."""
    order = sorted(((d, v) for d in range(len(ranges))
                    for v in range(len(ranges[d]))),
                   key=lambda dv: ranges[dv[0]][dv[1]][0])

    def f(x):
        return torch.cat([x[d, v, : ranges[d][v][1] - ranges[d][v][0]]
                          for d, v in order], 0)

    return tree_map(f, stacked)


def destack_stage_stacks(stage_stacks: tuple, spec: dict) -> tuple:
    """Saved per-(device, slot) stage stacks -> the model's logical block
    stacks, through the *saved* plan's layout spec."""
    if not spec["folded"]:
        return (_destack(stage_stacks[0], _spec_enc_ranges(spec)),)
    enc_b = _destack(stage_stacks[0], _spec_enc_ranges(spec))
    dec_b = _destack(stage_stacks[1], _spec_dec_ranges(spec))
    if spec["num_param_stacks"] == 1:
        return (tree_map(lambda a, b: torch.cat([a, b], 0), enc_b, dec_b),)
    return (enc_b, dec_b)


def _logical_pt(pt, spec: dict) -> dict:
    stacks, edge = pt
    return {"stacks": destack_stage_stacks(tuple(stacks), spec),
            "edge": edge}


def state_to_logical(state: dict, spec: dict) -> dict:
    """Training state saved under ``spec`` -> plan-independent logical view.

    ``state`` is the tree ``launch/train.py`` checkpoints: ``{"params":
    (stage_stacks, edge), "opt": {"m": ..., "v": ..., "step": ...}}``
    where AdamW's ``m``/``v`` mirror ``params`` leaf-wise.
    """
    out = {"params": _logical_pt(state["params"], spec)}
    if state.get("opt") is not None:
        o = state["opt"]
        out["opt"] = {"m": _logical_pt(o["m"], spec),
                      "v": _logical_pt(o["v"], spec), "step": o["step"]}
    return out


@dataclasses.dataclass(frozen=True)
class RestoreInfo:
    """What :func:`restore_training_state` did."""
    step: int                       # checkpoint step restored
    elastic: bool                   # True when saved plan != current plan
    saved_fingerprint: str | None
    fingerprint: str


def restore_training_state(directory: str, plan, like_state: dict, *,
                           step: int | None = None
                           ) -> tuple[dict, RestoreInfo]:
    """Restore the newest verified step (or step ``step``) for one-process
    ``plan`` into ``like_state``'s tensors, in place, elastically when the
    manifest's saved state spec has another fingerprint; returns
    ``(like_state, info)``.  A step that fails to verify is walked past
    (:func:`restore_rank_state` with a world of one: its reader over every
    device's rows)."""
    info, _ = restore_rank_state(directory, plan, like_state, step=step)
    return like_state, info


# ===========================================================================
# Checkpoints over ranks: the gather of a save, each rank's share of a restore
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class RankLeaf:
    """One leaf of a rank's training state ``{"params", "opt"}``, in the
    checkpoint's leaf order: its ``shape`` and ``dtype`` at rest (a stage
    leaf whole, ``[D, V, pad, ...]``), the part of the state it belongs to
    (``group``: ``params``, ``m``, ``v`` or ``step``), and for a stage leaf
    its stage stack and path in it (``stack`` None: an edge leaf or AdamW's
    step, whole on every rank)."""
    shape: tuple
    dtype: torch.dtype
    group: str
    stack: int | None = None
    path: str = ""

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * torch.empty(
            (), dtype=self.dtype).element_size()

    @property
    def moments(self) -> bool:
        return self.group in ("m", "v")


def _tag(pt, group: str, plan):
    stacks, edge = pt
    P, dp = plan.partition.num_devices, plan.pcfg.dp_size

    def stage(k):
        def leaf(path, x):
            if plan.rank is None:       # one process holds the leaf whole
                return RankLeaf(tuple(x.shape), x.dtype, group, k, path)
            rows = list(x.shape)
            dim = plan.piece_dim(k, path, moments=group != "params")
            if dim >= 0:
                rows[dim] *= dp
            return RankLeaf((P, *rows), x.dtype, group, k, path)
        return leaf

    return (tuple(tree_map_paths(stage(k), st)
                  for k, st in enumerate(stacks)),
            tree_map_paths(lambda _, x: RankLeaf(tuple(x.shape), x.dtype,
                                                 group), edge))


def rank_leaves(plan, state: dict) -> list[RankLeaf]:
    """A :class:`RankLeaf` for each leaf of ``plan``'s training state
    ``{"params": (stage stacks, edge), "opt": {"m", "v", "step"}}``
    (:func:`~repro_torch.tree.tree_flatten` order, the checkpoint's
    numbering): for a rank's plan its whole shape read from the rank's
    piece through the plan's
    :meth:`~repro_torch.runtime.compile.CompiledPipeline.piece_dim`; one
    process holds every leaf whole."""
    o = state["opt"]
    roles = {"params": _tag(state["params"], "params", plan),
             "opt": {"m": _tag(o["m"], "m", plan),
                     "v": _tag(o["v"], "v", plan),
                     "step": RankLeaf(tuple(o["step"].shape),
                                      o["step"].dtype, "step")}}
    return tree_flatten(roles)[0]


def gather_rank_state(state: dict, plan, world, rank_of) -> tuple:
    """A save's gather over ranks: ``(leaves, meta, stats)`` for a
    ``CheckpointManager`` (:meth:`RankSaves.collect`).  Every rank calls
    it at the same point with its own state and plan
    (``CompiledPipeline.for_rank``);
    ``world`` is the ranks' :class:`~repro_torch.runtime.ring.GroupView`
    and ``rank_of(pipe, data)`` a grid point's index in it.

    The leaves go to writers by :func:`~repro_torch.checkpoint.store.
    assign_writers` (bytes balanced).  A leaf at a time, in order: the
    writer of a stage leaf allocates it whole on the host, and each rank
    holding a piece of it sends that piece (chunked, :meth:`GroupView.
    send_chunked`) for the writer to place where ``for_rank(pipe,
    data).rank_piece`` says -- every replica's shard where the plan rests
    the leaf sharded, else the rows of the writer's own data replica.  An
    edge leaf, and AdamW's step, are whole on every rank: the writer
    copies its own.  ``leaves`` holds this rank's whole leaves on the host
    (the snapshot), ``meta`` every leaf's manifest record, ``stats`` the
    gather's seconds and bytes received and sent."""
    from repro_torch.checkpoint.store import assign_writers, dtype_name
    t0 = time.perf_counter()
    flat = tree_flatten(state)[0]
    places = rank_leaves(plan, state)
    writers = assign_writers([p.nbytes for p in places], world.size)
    P, dp = plan.partition.num_devices, plan.pcfg.dp_size
    me, here = world.index, (plan.rank, plan.data_index)
    # each grid point's plan, once (a plan's ZeRO dims are drawn once)
    plans = {(d, j): plan.for_rank(d, j) for d in range(P) for j in range(dp)}
    point = {rank_of(d, j): (d, j) for d, j in plans}
    leaves, got, sent = {}, 0, 0
    with torch.no_grad():
        for i, (x, p) in enumerate(zip(flat, places)):
            w = writers[i]
            if p.stack is None:
                if me == w:
                    leaves[i] = x.detach().to("cpu", copy=True)
                continue
            sharded = plan.piece_dim(p.stack, p.path, moments=p.moments) >= 0
            holders = [(d, j) for j in (range(dp) if sharded
                                        else (point[w][1],))
                       for d in range(P)]
            if me != w:
                if here in holders:
                    sent += world.send_chunked(x, w)
                continue
            whole = torch.empty(p.shape, dtype=p.dtype)
            for d, j in holders:
                view = plans[d, j].rank_piece(
                    whole[d], p.stack, p.path, moments=p.moments)
                if (d, j) == here:
                    view.copy_(x)
                elif view.is_contiguous():
                    got += world.recv_chunked(view, rank_of(d, j))
                else:
                    buf = torch.empty(view.shape, dtype=p.dtype)
                    got += world.recv_chunked(buf, rank_of(d, j))
                    view.copy_(buf)
            leaves[i] = whole
    meta = [{"shape": list(p.shape), "dtype": dtype_name(p.dtype)}
            for p in places]
    return leaves, meta, {"gather_s": time.perf_counter() - t0,
                          "gather_bytes_in": got, "gather_bytes_out": sent,
                          "leaves_written": len(leaves),
                          "bytes_written": sum(p.nbytes for i, p in
                                               enumerate(places)
                                               if i in leaves)}


@dataclasses.dataclass(frozen=True)
class RankSaves:
    """What a ``CheckpointManager`` over ranks asks of the world: this
    rank's ``plan`` (``CompiledPipeline.for_rank``), the whole world as a
    :class:`~repro_torch.runtime.ring.GroupView` (``world``), a grid
    point's index in it (``rank_of(pipe, data)``), and ``agree(obj)``, an
    all-gather of a small object over it."""
    plan: Any
    world: Any
    rank_of: Any
    agree: Any

    def collect(self, tree: dict) -> tuple:
        """The save's gather (:func:`gather_rank_state`): every rank calls
        it at the same point."""
        return gather_rank_state(tree, self.plan, self.world, self.rank_of)

    def all(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank (a collective)."""
        return all(self.agree(flag))


def _stage_ranges(spec: dict) -> list:
    """Per stage stack of a plan's state, ``ranges[d][v]``: the rows of its
    own block numbering that slot ``v`` of device ``d`` holds."""
    if not spec["folded"]:
        return [_spec_enc_ranges(spec)]
    return [_spec_enc_ranges(spec), _spec_dec_ranges(spec)]


def _logical_block(spec: dict, stage: int, row: int) -> tuple[int, int]:
    """``(param stack, block)`` of the model that row ``row`` of stage stack
    ``stage``'s numbering is (:func:`destack_stage_stacks`: one param stack
    is the encoder rows, then the decoder rows from the turnaround cut)."""
    if spec["folded"] and stage == 1 and spec["num_param_stacks"] == 1:
        return 0, spec["cuts"][(len(spec["cuts"]) - 1) // 2] + row
    return stage, row


def block_homes(spec: dict) -> dict:
    """``(param stack, block) -> (stage stack, device, slot, row)``: where
    each of the model's blocks rests in a state laid out by ``spec``."""
    out = {}
    for s, ranges in enumerate(_stage_ranges(spec)):
        for d, slots in enumerate(ranges):
            for v, (lo, hi) in enumerate(slots):
                for r in range(hi - lo):
                    out[_logical_block(spec, s, lo + r)] = (s, d, v, r)
    return out


def rank_rows_sources(saved: dict, new: dict, stage: int, device: int
                      ) -> list[list]:
    """For device ``device``'s rows of stage stack ``stage`` under the new
    spec, ``src[v][r] = (stage stack, device, slot, row)`` of the saved
    state each real row comes from (the padding rows past a slot's count
    are not listed)."""
    homes = block_homes(saved)
    return [[homes[_logical_block(new, stage, lo + r)]
             for r in range(hi - lo)]
            for lo, hi in _stage_ranges(new)[stage][device]]


def restore_rank_state(directory: str, plan, state: dict, *, index: int = 0,
                       size: int = 1, agree=None, step: int | None = None
                       ) -> tuple[RestoreInfo, dict]:
    """Restore ``plan``'s share of the newest verified checkpoint (or of
    step ``step``) into its live ``state`` tensors, in place (the port of
    :func:`restore_training_state` over ranks).  ``index`` and ``size``
    are the rank's place in the world, ``agree(obj)`` an all-gather of a
    small object over it (every rank gets every rank's ``obj``, in
    order); by default a world of one (a one-process plan).

    The ranks take rank 0's list of step directories.  For each candidate,
    newest first, each rank hashes the shards ``k`` with ``k % size ==
    index`` (every shard is hashed once, not once a rank; presence and
    coverage are checked by all) and the ranks agree on the verdicts: a
    step that fails anywhere fails everywhere, and every rank walks back
    past it.  A rank then reads only what it holds: at the saved plan's
    fingerprint its rows ``x[d]`` of each stage leaf (one contiguous byte
    range of the member), cut to its data replica's shard
    (``rank_piece``); at another (elastic) the blocks its new rows hold,
    each run of them one byte range, through the saved spec's ranges, the
    padding rows zero; and every edge leaf whole.  One process reads every
    device's rows.  Returns the :class:`RestoreInfo` and ``stats``: the
    seconds verifying and reading, the bytes this rank hashed and the
    array bytes it read.  Raises
    :class:`~repro_torch.checkpoint.store.CheckpointError` with ``reason``
    ``"empty"`` (no step) or ``"unverified"`` (none verifies) or the error
    of a verified step that does not load."""
    from repro_torch.checkpoint.store import (CheckpointError,
                                              _all_step_dirs, _step_dir,
                                              verify_step)
    if agree is None:
        def agree(obj):
            return [obj]
    candidates = agree([step] if step is not None else
                       sorted(_all_step_dirs(directory), reverse=True))[0]
    if not candidates:
        raise CheckpointError(f"no checkpoints under {directory}",
                              reason="empty")
    flat = tree_flatten(state)[0]
    places = rank_leaves(plan, state)
    cur = compiled_state_spec(plan)
    stats = dict(verify_s=0.0, read_s=0.0, hashed_bytes=0, bytes_read=0)
    skipped: list[int] = []
    last: CheckpointError | None = None
    load_err: CheckpointError | None = None

    def agreed(err: CheckpointError | None, step: int):
        bad = [m for m in agree(None if err is None else str(err)) if m]
        return err or (CheckpointError(f"another rank: {bad[0]}", step=step,
                                       reason="peer") if bad else None)

    for s in candidates:
        t0 = time.perf_counter()
        err, man = None, None
        try:
            man = verify_step(directory, s,
                              mine=lambda k: k % size == index)
            stats["hashed_bytes"] += sum(
                os.path.getsize(os.path.join(_step_dir(directory, s), sh))
                for k, sh in enumerate(man["shards"]) if k % size == index)
        except CheckpointError as e:
            err = e
        err = agreed(err, s)
        stats["verify_s"] += time.perf_counter() - t0
        if err is None:
            t0 = time.perf_counter()
            try:
                info = _load_rank_share(directory, s, man, plan, cur, flat,
                                        places, stats)
            except CheckpointError as e:
                err = e
            err = agreed(err, s)
            stats["read_s"] += time.perf_counter() - t0
            if err is None:
                if skipped and index == 0:
                    print(f"[checkpoint] step(s) {skipped} failed "
                          f"verification (last: {last}); fell back to "
                          f"step {s}")
                return info, stats
            load_err = err
        skipped.append(s)
        last = err
    if load_err is not None:
        raise load_err
    raise CheckpointError(f"no step under {directory} verifies (last: "
                          f"{last})", reason="unverified")


def _load_rank_share(directory: str, step: int, man: dict, plan, cur: dict,
                     flat: list, places: list, stats: dict) -> RestoreInfo:
    """:func:`restore_rank_state`'s read of one verified step."""
    from repro_torch.checkpoint.store import (CheckpointError, _leaf_tensor,
                                              _NpzReader, _step_dir)
    saved = man.get("plan")
    if saved is None:
        raise CheckpointError(
            "checkpoint carries no plan state-spec; cannot verify it "
            "matches the compiled pipeline (save through "
            "CheckpointManager(..., plan=compiled.state_spec()))",
            step=step, reason="no-plan-spec")
    if man["num_leaves"] != len(flat):
        raise CheckpointError(
            f"checkpoint has {man['num_leaves']} leaves, the state "
            f"{len(flat)} -- architecture mismatch", step=step,
            reason="structure")
    elastic = saved["fingerprint"] != cur["fingerprint"]
    devices = (range(plan.partition.num_devices) if plan.rank is None
               else (plan.rank,))
    index = {(p.group, p.stack, p.path): i for i, p in enumerate(places)}
    files = [_NpzReader(os.path.join(_step_dir(directory, step), sh))
             for sh in man["shards"]]
    try:
        where = {int(k[1:]): z for z in files for k in z.keys()}
        for i, (dst, p) in enumerate(zip(flat, places)):
            shape = tuple(man["leaves"][i]["shape"])
            # elastic: the stage leaves' blocks must match, not their stacks
            cut = 3 if elastic and p.stack is not None else 0
            if shape[cut:] != p.shape[cut:]:
                raise CheckpointError(
                    f"leaf {i} is {list(shape)} at rest, the plan's "
                    f"{list(p.shape)}", step=step, reason="shape")
            if i not in where:
                raise CheckpointError(f"leaf {i} missing from shards",
                                      step=step, reason="missing-leaf")
            key = f"a{i}"
            if p.stack is None:
                a = where[i][key]
            elif not elastic:
                a = where[i].read_rows(key, 1, devices[0], devices[-1] + 1)
            else:
                a = np.stack([_read_new_rows(where, index, man, saved, cur,
                                             p, d) for d in devices])
            t = _leaf_tensor(a, man["leaves"][i]["dtype"], "cpu")
            if plan.rank is not None and p.stack is not None:
                t = plan.rank_piece(t[0], p.stack, p.path, moments=p.moments)
            if t.shape != dst.shape or t.dtype != dst.dtype:
                raise CheckpointError(
                    f"leaf {i} restores as {t.dtype}{list(t.shape)}, the "
                    f"state holds {dst.dtype}{list(dst.shape)}", step=step,
                    reason="shape")
            with torch.no_grad():
                dst.copy_(t)
            del a, t
        stats["bytes_read"] += sum(z.bytes_read for z in files)
    finally:
        for z in files:
            z.close()
    if elastic and plan.rank in (None, 0) and plan.data_index == 0:
        print(f"[resilience] plan changed since step {step} "
              f"({saved['fingerprint']} -> {cur['fingerprint']}): "
              + ("each rank reads its rows' blocks" if plan.rank is not None
                 else "reading each device's rows' blocks")
              + f" of the P={saved['P']} V={saved['V']} dp={saved['dp']} "
              f"zero={saved['zero_stage']} state for P={cur['P']} "
              f"V={cur['V']} dp={cur['dp']} zero={cur['zero_stage']}")
    return RestoreInfo(step, elastic, saved["fingerprint"],
                       cur["fingerprint"])


def _read_new_rows(where: dict, index: dict, man: dict, saved: dict,
                   new: dict, p: RankLeaf, d: int) -> np.ndarray:
    """Device ``d``'s rows ``[V, pad, ...]`` of stage leaf ``p`` under the
    new spec, from the saved members: each run of rows that is one run of
    one saved member's ``[D * V * pad]`` rows is one read; padding rows
    are zero."""
    own = index[(p.group, p.stack, p.path)]
    out = np.zeros(p.shape[1:], dtype=where[own].member(f"a{own}")[1])
    for v, srcs in enumerate(rank_rows_sources(saved, new, p.stack, d)):
        r = 0
        while r < len(srcs):
            s, ds, vs, rs = srcs[r]
            n = 1
            while r + n < len(srcs) and srcs[r + n] == (s, ds, vs, rs + n):
                n += 1
            i = index[(p.group, s, p.path)]
            shape = man["leaves"][i]["shape"]
            lo = (ds * shape[1] + vs) * shape[2] + rs
            out[v, r:r + n] = where[i].read_rows(f"a{i}", 3, lo, lo + n)
            r += n
    return out


# ===========================================================================
# Fault injection
# ===========================================================================

#: seconds a ``hang@K`` fault sleeps -- long enough that any reasonable
#: watchdog declares the host hung first (SIGTERM interrupts the sleep).
HANG_SECONDS = 3600.0

#: process exit codes a supervisor branches on.
EXIT_KILLED = 42      # kill@K / hostdown@K:h -- a node died
EXIT_ESCALATE = 43    # GradGuard skip budget exhausted, rollback requested

_FAULT_KINDS = ("kill", "stop", "nan", "corrupt", "truncate", "iofail",
                "hostdown", "hang", "slow")
_FAULT_RE = re.compile(r"([a-z]+)@(-?\d+)(?::([\w.\-:]+))?")


class FaultPlanError(ValueError):
    """Structured fault-spec failure naming the offending token.

    Raised by :meth:`FaultPlan.parse` / :meth:`FaultPlan.for_host` so a
    malformed ``--faults`` spec fails at startup with the bad token in
    hand, instead of deep inside the training loop.  ``token``/``reason``
    survive as fields; subclasses ``ValueError``.
    """

    def __init__(self, message: str, *, token: str | None = None,
                 reason: str | None = None):
        self.token = token
        self.reason = reason
        ctx = ", ".join(f"{k}={v!r}" for k, v in
                        (("token", token), ("reason", reason))
                        if v is not None)
        super().__init__(f"[faultplan{'; ' + ctx if ctx else ''}] {message}")


@dataclasses.dataclass(frozen=True)
class FaultAction:
    kind: str            # kill | stop | nan | corrupt | truncate | iofail
    #                      | hostdown | hang | slow
    step: int
    arg: str | None = None   # corrupt/truncate: shard name
    count: int = 1           # iofail: number of injected IO failures
    host: int | None = None  # hostdown/hang/slow: target host rank
    factor: float = 1.0      # slow: per-step slowdown factor
    token: str = ""          # the spec token this action parsed from


class FaultPlan:
    """Env/flag-driven fault script for the trainer.

    Comma-separated tokens, each ``kind@step`` with an optional arg:

    - ``kill@K``      -- hard-kill the process (``os._exit``) after step K,
      flushing any in-flight checkpoint first (a node dies between steps);
    - ``stop@K``      -- abrupt in-process stop after step K, *without* a
      final save (same recovery surface as kill, usable by in-process
      drills);
    - ``nan@K``       -- poison step K's batch with NaNs, so the step's
      grads go non-finite and the :class:`GradGuard` path runs;
    - ``corrupt@K[:shard]``  -- after step K, flip one byte in the named
      (default: first) shard of the newest complete checkpoint;
    - ``truncate@K[:shard]`` -- same, but truncate the shard to half;
    - ``iofail@K:N``  -- the next N checkpoint-save attempts at/after
      step K raise a transient ``OSError`` (exercises the manager's
      retry/backoff path);
    - ``hostdown@K:h`` -- host ``h`` hard-exits after step K (the
      multi-host ``kill``);
    - ``hang@K[:h]``   -- host ``h`` (default 0) stalls before step K for
      :data:`HANG_SECONDS`;
    - ``slow@K:factor[:h]`` -- from step K on, host ``h`` (default 0)
      runs each step ``factor``x slower (a straggler).

    Malformed specs raise :class:`FaultPlanError` naming the offending
    token: unknown kinds, negative steps, duplicate ``kind@step`` pairs,
    and (once the host count is known -- :meth:`for_host`) host indices
    outside ``[0, num_hosts)``.

    Source: the ``--faults`` flag, else the ``REPRO_FAULTS`` env var.
    """

    def __init__(self, actions=(), exit_code: int = EXIT_KILLED):
        self.actions: tuple[FaultAction, ...] = tuple(actions)
        self.exit_code = exit_code
        self._io_left = {i: a.count for i, a in enumerate(self.actions)
                         if a.kind == "iofail"}

    @classmethod
    def parse(cls, spec: str | None = None, *,
              env: str = "REPRO_FAULTS") -> "FaultPlan":
        if spec is None:
            spec = os.environ.get(env, "")
        actions: list[FaultAction] = []
        seen: set[tuple[str, int]] = set()
        for tok in filter(None, (t.strip() for t in spec.split(","))):
            m = _FAULT_RE.fullmatch(tok)
            if not m:
                raise FaultPlanError(
                    f"unparseable fault token {tok!r}; expected "
                    f"kind@step[:arg] with kind in {'|'.join(_FAULT_KINDS)}",
                    token=tok, reason="syntax")
            kind, step, arg = m.group(1), int(m.group(2)), m.group(3)
            if kind not in _FAULT_KINDS:
                raise FaultPlanError(
                    f"unparseable fault token {tok!r}: unknown kind "
                    f"{kind!r} (known: {'|'.join(_FAULT_KINDS)})",
                    token=tok, reason="unknown-kind")
            if step < 0:
                raise FaultPlanError(
                    f"negative step in token {tok!r}: faults fire at "
                    "step indices >= 0", token=tok, reason="negative-step")
            if (kind, step) in seen:
                raise FaultPlanError(
                    f"duplicate {kind}@{step} (token {tok!r}): each verb "
                    "may fire at most once per step",
                    token=tok, reason="duplicate")
            seen.add((kind, step))
            actions.append(cls._parse_action(kind, step, arg, tok))
        return cls(actions)

    @staticmethod
    def _parse_action(kind: str, step: int, arg: str | None,
                      tok: str) -> FaultAction:
        def bad(msg, reason="bad-arg"):
            return FaultPlanError(f"{msg} (token {tok!r})", token=tok,
                                  reason=reason)

        count, host, factor = 1, None, 1.0
        if kind in ("kill", "stop", "nan"):
            if arg is not None:
                raise bad(f"{kind}@K takes no argument")
        elif kind == "iofail":
            try:
                count = int(arg) if arg else 1
            except ValueError:
                raise bad("iofail@K:N needs an integer failure count, "
                          f"got {arg!r}") from None
            if count < 1:
                raise bad(f"iofail@K:N needs N >= 1, got {count}")
            arg = None
        elif kind == "hostdown":
            if arg is None:
                raise bad("hostdown@K:h needs a host index",
                          reason="missing-host")
            try:
                host = int(arg)
            except ValueError:
                raise bad("hostdown@K:h needs an integer host index, "
                          f"got {arg!r}") from None
            arg = None
        elif kind == "hang":
            try:
                host = int(arg) if arg is not None else 0
            except ValueError:
                raise bad("hang@K[:h] needs an integer host index, "
                          f"got {arg!r}") from None
            arg = None
        elif kind == "slow":
            if arg is None:
                raise bad("slow@K:factor[:h] needs a slowdown factor",
                          reason="missing-factor")
            head, _, tail = arg.partition(":")
            try:
                factor = float(head)
                host = int(tail) if tail else 0
            except ValueError:
                raise bad("slow@K:factor[:h] needs a float factor and an "
                          f"optional integer host, got {arg!r}") from None
            if factor < 1.0:
                raise bad(f"slow factor must be >= 1.0, got {factor}")
            arg = None
        return FaultAction(kind, step, arg, count, host, factor, tok)

    def for_host(self, host_id: int, num_hosts: int) -> "FaultPlan":
        """The sub-plan host ``host_id`` of ``num_hosts`` executes: every
        host-scoped token is validated against the real host count
        (:class:`FaultPlanError` on out-of-range indices), and host-less
        actions plus those targeting ``host_id`` are kept."""
        for a in self.actions:
            if a.host is not None and not (0 <= a.host < num_hosts):
                raise FaultPlanError(
                    f"host index {a.host} out of range for num_hosts="
                    f"{num_hosts} (token {a.token!r})", token=a.token,
                    reason="unknown-host")
        keep = tuple(a for a in self.actions
                     if a.host is None or a.host == host_id)
        return FaultPlan(keep, self.exit_code)

    def with_kill(self, step: int) -> "FaultPlan":
        """Legacy ``--simulate-failure K`` alias."""
        return FaultPlan(self.actions + (FaultAction("kill", step),),
                         self.exit_code)

    # ---- hooks the trainer calls -------------------------------------
    def wants_nan(self, step: int) -> bool:
        return any(a.kind == "nan" and a.step == step for a in self.actions)

    def hang_before(self, step: int, *, sleep=time.sleep,
                    seconds: float = HANG_SECONDS) -> bool:
        """``hang@K`` hook, called at the TOP of step K (before compute):
        sleeps ``seconds`` so the process stays alive while its heartbeat
        step stops advancing.  Returns whether it fired."""
        if not any(a.kind == "hang" and a.step == step
                   for a in self.actions):
            return False
        print(f"[resilience] fault plan: hanging before step {step} "
              f"(sleep {seconds:.0f}s -- simulated stuck collective)")
        sys.stdout.flush()
        sleep(seconds)
        return True

    def slow_factor(self, step: int) -> float:
        """Largest active ``slow@K:factor`` slowdown at ``step`` (1.0 =
        none)."""
        return max((a.factor for a in self.actions
                    if a.kind == "slow" and step >= a.step), default=1.0)

    def poison_batch(self, batch: Pytree, step: int) -> Pytree:
        """NaN every floating tensor of ``batch`` when a ``nan@step``
        fires."""
        if not self.wants_nan(step):
            return batch
        print(f"[resilience] fault plan: poisoning step {step}'s batch "
              "with NaNs")
        return tree_map(
            lambda x: torch.full_like(x, float("nan"))
            if x.is_floating_point() else x, batch)

    def io_fault(self, step: int) -> None:
        """Checkpoint-save hook (``CheckpointManager(io_fault=...)``):
        raises a transient OSError while an ``iofail`` budget remains."""
        for i, a in enumerate(self.actions):
            if a.kind == "iofail" and step >= a.step \
                    and self._io_left.get(i, 0) > 0:
                self._io_left[i] -= 1
                raise OSError(
                    f"[faultplan] injected transient IO failure at step "
                    f"{step} ({self._io_left[i]} more to come)")

    def post_step(self, step: int, *, ckpt_dir: str | None = None,
                  flush=None) -> str | None:
        """Fire end-of-step actions; returns ``"stop"`` on a stop fault."""
        stop = False
        for a in self.actions:
            if a.step != step:
                continue
            if a.kind in ("corrupt", "truncate"):
                if flush is not None:
                    flush()
                if ckpt_dir:
                    what = corrupt_checkpoint(
                        ckpt_dir, shard=a.arg,
                        truncate=(a.kind == "truncate"))
                    print(f"[resilience] fault plan: {a.kind}d {what}")
            elif a.kind in ("kill", "hostdown"):
                if flush is not None:
                    flush()
                who = (f"host {a.host} down" if a.kind == "hostdown"
                       else "hard node failure")
                print(f"[resilience] fault plan: {who} after "
                      f"step {step} (os._exit({self.exit_code}))")
                sys.stdout.flush()
                os._exit(self.exit_code)
            elif a.kind == "stop":
                # like kill, a stop "dies" only between checkpoint writes:
                # flush the in-flight save so the recovery point is
                # deterministic
                if flush is not None:
                    flush()
                stop = True
        return "stop" if stop else None


def corrupt_checkpoint(directory: str, *, step: int | None = None,
                       shard: str | None = None,
                       truncate: bool = False) -> str:
    """Flip one byte in (or truncate) a shard of the newest complete
    checkpoint -- the mutation the SHA-256 verification must catch."""
    from repro_torch.checkpoint.store import complete_steps, read_manifest

    if step is None:
        steps = complete_steps(directory)
        if not steps:
            raise FileNotFoundError(
                f"no complete checkpoint under {directory} to corrupt")
        step = steps[-1]
    man = read_manifest(directory, step)
    names = man["shards"]
    name = shard if shard is not None else names[0]
    if not name.endswith(".npz"):
        name += ".npz"
    if name not in names:
        raise ValueError(f"shard {name!r} not in step {step}'s manifest "
                         f"({names})")
    path = os.path.join(directory, f"step_{step:09d}", name)
    size = os.path.getsize(path)
    if truncate:
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        return f"{path} (truncated {size} -> {size // 2} bytes)"
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    return f"{path} (flipped byte {size // 2})"


# ===========================================================================
# Non-finite gradient guard
# ===========================================================================

def all_finite(*trees) -> torch.Tensor:
    """0-d bool tensor: every floating leaf of every tree is finite (one
    reduction on the leaves' device; ``bool()`` of it is the one sync)."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(list(trees))
             if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


class GradGuardEscalation(RuntimeError):
    """Raised when :class:`GradGuard`'s consecutive-skip budget is
    exhausted.  A ``RuntimeError``, so a caller that does not opt into
    escalation aborts; the trainer's ``--escalation rollback`` catches it
    and exits :data:`EXIT_ESCALATE` for a supervisor to roll back to the
    last verified checkpoint."""

    def __init__(self, message: str, *, step: int, consecutive: int,
                 budget: int):
        self.step = step
        self.consecutive = consecutive
        self.budget = budget
        super().__init__(message)


class GradGuard:
    """Skip-and-log guard for non-finite updates.

    The step skips the optimizer update when loss/grads contain
    non-finite values (:func:`all_finite`); the host-side guard counts
    *consecutive* skipped steps and raises :class:`GradGuardEscalation`
    once they exceed ``budget`` -- a single poisoned batch is survivable,
    a divergence or persistently bad data pipeline is not.
    """

    def __init__(self, budget: int = 3):
        self.budget = budget
        self.consecutive = 0
        self.skipped_total = 0

    def observe(self, finite: bool, step: int) -> bool:
        """Record one step's finite flag; returns whether it applied."""
        if finite:
            self.consecutive = 0
            return True
        self.consecutive += 1
        self.skipped_total += 1
        print(f"[resilience] non-finite loss/grads at step {step}: update "
              f"skipped ({self.consecutive}/{self.budget} consecutive)")
        if self.consecutive > self.budget:
            raise GradGuardEscalation(
                f"{self.consecutive} consecutive non-finite steps exceed "
                f"the skip budget ({self.budget}): aborting -- bad data "
                "stream or diverged optimizer state",
                step=step, consecutive=self.consecutive,
                budget=self.budget)
        return False


# ===========================================================================
# Supervisor detection primitives: heartbeats, watchdog, stragglers
# ===========================================================================

@dataclasses.dataclass
class Heartbeat:
    """One worker's liveness/progress record, written atomically per step.

    ``step`` is the last COMPLETED step (-1 before the first), ``phase``
    one of ``init``, ``train``, ``ckpt``, ``done``.  ``gen`` is the
    supervisor generation that launched the worker, so a monitor never
    confuses a stale file from a torn-down generation with a live worker.
    """
    host_id: int
    step: int
    phase: str = "init"             # init | train | ckpt | done
    t: float = 0.0                  # wall-clock at write (time.time())
    loss: float | None = None
    grad_norm: float | None = None
    step_s: float | None = None     # worker-measured duration of `step`
    pid: int | None = None
    gen: int = 0


def _heartbeat_path(directory: str, host_id: int) -> str:
    return os.path.join(directory, f"hb_h{host_id:05d}.json")


def write_heartbeat(directory: str, hb: Heartbeat) -> None:
    """Atomic (tmp + ``os.replace``) write -- monitors never read a torn
    record.  Fills ``t``/``pid`` when unset."""
    os.makedirs(directory, exist_ok=True)
    if not hb.t:
        hb.t = time.time()
    if hb.pid is None:
        hb.pid = os.getpid()
    path = _heartbeat_path(directory, hb.host_id)
    tmp = os.path.join(directory, f".hb_h{hb.host_id:05d}.tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(dataclasses.asdict(hb), f)
    os.replace(tmp, path)


def read_heartbeats(directory: str, *, gen: int | None = None
                    ) -> dict[int, Heartbeat]:
    """All readable heartbeats under ``directory`` keyed by host id.

    Unreadable/torn files are skipped (the next poll sees the replaced
    record); ``gen`` filters out stale records from earlier supervisor
    generations."""
    out: dict[int, Heartbeat] = {}
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        m = re.fullmatch(r"hb_h(\d+)\.json", name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                doc = json.load(f)
            hb = Heartbeat(**doc)
        except (OSError, json.JSONDecodeError, TypeError):
            continue
        if gen is not None and hb.gen != gen:
            continue
        out[hb.host_id] = hb
    return out


class Watchdog:
    """Progress watchdog over per-host heartbeats.

    A host is judged on the age of its last *progress* (a heartbeat whose
    ``(phase, step)`` advanced), not of its last write -- a hung collective
    leaves the process alive (and able to write) but its step frozen:

    - age > deadline                 -> ``suspect`` (a missed heartbeat);
    - age > deadline * miss_budget   -> ``hung`` (persistent stall).

    The deadline is ``startup_timeout`` until the host advances *past*
    its first ``train`` heartbeat and the tight ``stall_timeout``
    afterwards: a worker's cold start (CUDA context, kernel loads, the
    first step's allocations) runs arbitrarily long before step 0, and the
    step in flight right after the first beat still carries residual
    warmup, so both are judged leniently.  Hosts expected but never seen
    at all are judged from the watchdog's construction time against
    ``startup_timeout``.  Poll-rate independent: thresholds are wall-clock
    ages, not poll counts.
    """

    def __init__(self, hosts, *, stall_timeout: float = 10.0,
                 startup_timeout: float = 300.0, miss_budget: int = 3,
                 now: float | None = None):
        self.hosts = tuple(hosts)
        self.stall_timeout = float(stall_timeout)
        self.startup_timeout = float(startup_timeout)
        self.miss_budget = int(miss_budget)
        t0 = time.time() if now is None else now
        self._last: dict[int, tuple[str, int, float]] = {
            h: ("unseen", -2, t0) for h in self.hosts}
        self._first_train: dict[int, int] = {}

    def observe(self, heartbeats: dict[int, Heartbeat],
                now: float | None = None) -> None:
        now = time.time() if now is None else now
        for h, hb in heartbeats.items():
            if h not in self._last:
                continue
            if hb.phase == "train":
                self._first_train.setdefault(h, hb.step)
            phase, step, _ = self._last[h]
            if (hb.phase, hb.step) != (phase, step):
                self._last[h] = (hb.phase, hb.step, now)

    def _deadline(self, host: int) -> float:
        phase, step, _ = self._last[host]
        if phase in ("ckpt", "done"):
            return self.stall_timeout
        if phase == "train" and step != self._first_train.get(host):
            return self.stall_timeout
        # init / unseen, or sitting on the first train step (the next
        # step still pays warmup): lenient
        return self.startup_timeout

    def age(self, host: int, now: float | None = None) -> float:
        now = time.time() if now is None else now
        return now - self._last[host][2]

    def progress(self, host: int) -> tuple[str, int]:
        """Last observed (phase, step) progress point for ``host`` -- what
        a supervisor uses to tell a ROOT hung host (least progress: it
        wedged its peers) from victims blocked on it further along."""
        phase, step, _ = self._last[host]
        return phase, step

    def check(self, now: float | None = None) -> dict[int, str]:
        """Per-host verdict: ``ok`` | ``suspect`` | ``hung`` (``done``
        once a clean final heartbeat landed)."""
        now = time.time() if now is None else now
        out: dict[int, str] = {}
        for h in self.hosts:
            phase, _, _ = self._last[h]
            if phase == "done":
                out[h] = "done"
                continue
            age, deadline = self.age(h, now), self._deadline(h)
            if age > deadline * self.miss_budget:
                out[h] = "hung"
            elif age > deadline:
                out[h] = "suspect"
            else:
                out[h] = "ok"
        return out


class StragglerDetector:
    """Flag hosts persistently slower than the cluster median step time.

    Duration samples prefer the worker-measured ``Heartbeat.step_s`` (a
    monitor starved of poll slots observes beats in multi-step jumps --
    time-derived averages would wash a slowdown out against warmup),
    falling back to successive ``(step, t)`` pair deltas for writers that
    don't report it.  Each host keeps a rolling window and its median
    (p50) duration is compared against the median of the *other* hosts'
    medians: ratio >= ``factor`` sustained over ``patience`` completed
    steps flags the host (streaks are counted in steps advanced, not in
    observations, for the same sparse-poll reason).  Needs >= 2 hosts (a
    cluster of one has no peers to straggle behind).
    """

    def __init__(self, *, factor: float = 2.0, patience: int = 3,
                 window: int = 16):
        self.factor = float(factor)
        self.patience = int(patience)
        self.window = int(window)
        self._prev: dict[int, tuple[int, float]] = {}   # host -> (step, t)
        self._durs: dict[int, list[float]] = {}
        self._streak: dict[int, int] = {}

    def observe(self, heartbeats: dict[int, Heartbeat]) -> None:
        for h, hb in heartbeats.items():
            if hb.phase != "train" or hb.step < 0:
                continue
            prev = self._prev.get(h)
            self._prev[h] = (hb.step, hb.t)
            if prev is None or hb.step <= prev[0]:
                continue
            advanced = hb.step - prev[0]
            dur = (hb.step_s if hb.step_s is not None
                   else (hb.t - prev[1]) / advanced)
            durs = self._durs.setdefault(h, [])
            durs.append(dur)
            del durs[:-self.window]
            ratio = self._ratio(h)
            self._streak[h] = (self._streak.get(h, 0) + advanced
                               if ratio >= self.factor else 0)

    def _ratio(self, host: int) -> float:
        mine = self._durs.get(host)
        peers = [float(np.median(d)) for h, d in self._durs.items()
                 if h != host and d]
        if not mine or not peers:
            return 0.0
        p50 = float(np.median(peers))
        return float(np.median(mine)) / p50 if p50 > 0 else 0.0

    def stragglers(self) -> dict[int, float]:
        """Hosts flagged ``patience`` consecutive steps -> slowdown ratio."""
        return {h: self._ratio(h) for h, n in self._streak.items()
                if n >= self.patience}
