"""PULSE auto-pipeline compile path: graph -> partition -> schedule -> executor
(the port of ``repro.runtime.compile``).

:func:`auto_pipeline` takes a :class:`~repro_torch.core.graph.BlockGraph`,
a block-level model description (:class:`PipelineModelFns`) and a device
budget, then

1. **plans**: runs the hybrid tuner (§VI, ``core.tuner.tune``) -- or a
   pinned partitioner call -- to pick (P, G, b, V, M) and the skip-aware
   partition (§IV, Algorithm 1), which cuts the graph into stages with
   skip pairs collocated on one device;
2. **schedules**: synthesizes the pipeline schedule from the partition's
   stage->device mapping (§V, greedy or the exact ILP) and validates every
   constraint family before anything executes;
3. **lowers**: lays the model's block stacks out as padded per-device
   ``[D, V, pad, ...]`` stage stacks with true per-slot block counts and a
   skip-stash pairing derived from the graph's skip edges
   (:class:`StageLayout`), and builds the table-driven wave executor
   (``runtime.schedule_exec``) over the validated schedule.

:meth:`CompiledPipeline.state_spec` and :meth:`~CompiledPipeline.fingerprint`
record how the plan lays training state out at rest, equal to the JAX
package's for the same graph and plan: checkpoints carry the spec, and a
restore onto another plan de-stacks through it (``runtime.resilience``).
:meth:`CompiledPipeline.certify` proves the lowered step tables race- and
deadlock-free without running them (``repro_torch.analysis``).

Not ported yet (they raise ``NotImplementedError``): data parallelism and
ZeRO (``dp_size > 1``, ``zero_stage > 0``, and a tuner choice with G > 1 or
a ZeRO stage, which is refused rather than replaced by a lower-ranked one;
a state spec records ``dp = 1`` and ``zero_stage = 0``), the closed-form
executors and the linear (skip-free) executor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.graph import BlockGraph
from repro_torch.core.hw import Hardware, H100_SXM
from repro_torch.core.partition import Partition, partition as partition_graph
from repro_torch.core.schedule import Schedule, schedule_for_partition
from repro_torch.core.tuner import TunerChoice, tune
from repro_torch.runtime.pipeline import (PipelineConfig, scan_blocks_consume,
                                          scan_blocks_emit)
from repro_torch.runtime.schedule_exec import (StepTables,
                                               make_wave_pipeline_from_schedule)
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to repro_torch")


# ===========================================================================
# Model description consumed by the compiler
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class PipelineModelFns:
    """Block-level callables + parameter layout for one model family.

    The graph handed to :func:`auto_pipeline` must have exactly one block
    per row of the model's stacked block parameters (edge params -- embed,
    head, norms -- live outside the graph).

    ``split_blocks(params) -> (stacks, edge)`` where ``stacks`` is a
    1-tuple ``(blocks,)`` for a homogeneous stack (SkipViT: rows 0..n-1 in
    graph order) or a 2-tuple ``(enc_blocks, dec_blocks)`` when encoder
    and decoder blocks have different parameter structures (UViT's decoder
    blocks carry ``skip_proj``); ``merge_blocks`` is the exact inverse.
    ``num_param_stacks`` is ``len(split_blocks(params)[0])``, which a
    state spec records.  (The JAX package's default is 1; the port's is
    2, the two-stack models it ported first.)
    """

    init_fn: Callable        # (generator, device) -> params
    embed_fn: Callable       # (edge_p, mb, aux) -> x
    loss_fn: Callable        # (edge_p, x, mb, aux) -> scalar
    split_blocks: Callable   # params -> (stacks, edge)
    merge_blocks: Callable   # (stacks, edge) -> params
    enc_block_fn: Callable   # (block_p, x, aux) -> (x, skip)
    dec_block_fn: Callable   # (block_p, x, skip, aux) -> x
    num_param_stacks: int = 2               # len(split_blocks(params)[0])


# ===========================================================================
# Stage layout: partition cuts -> padded per-device stacks
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class StageLayout:
    """Mapping between a model's flat block stack and per-device stage-slot
    stacks for a (possibly uneven, mirror-asymmetric, interleaved) folded
    partition.

    Device ``d`` runs ``V`` encoder-half (prefix) stage slots and ``V``
    decoder-half (suffix) slots; ``enc_slots[d][v]`` / ``dec_slots[d][v]``
    name the pipeline stages in slot order and ``enc_counts[d][v]`` /
    ``dec_counts[d][v]`` their true block counts.  All slots pad to
    ``enc_pad`` / ``dec_pad`` rows.

    ``skip_rows[d][v][i]`` is the *flat* stash row device d's decoder slot
    v consumes at its row ``i``: ``src_slot * enc_pad + src_row`` into the
    device's ``[V * enc_pad]`` skip stash -- derived from the partition's
    skip edges; ``-1`` marks rows without a skip (they receive zeros).
    """

    partition: Partition
    enc_slots: tuple[tuple[int, ...], ...]
    dec_slots: tuple[tuple[int, ...], ...]
    enc_counts: tuple[tuple[int, ...], ...]
    dec_counts: tuple[tuple[int, ...], ...]
    enc_pad: int
    dec_pad: int
    skip_rows: tuple[tuple[tuple[int, ...], ...], ...] = ()

    @property
    def V(self) -> int:
        """Interleave degree: stage slots per device and kind."""
        return len(self.enc_slots[0])

    @property
    def counts(self) -> tuple[int, ...]:
        """Per-device encoder-half block totals."""
        return tuple(sum(c) for c in self.enc_counts)

    @classmethod
    def from_partition(cls, part: Partition,
                       graph: BlockGraph) -> "StageLayout":
        """Lay out a folded ``part``; ``graph`` supplies the skip edges that
        define the stash pairing."""
        if not part.folded:
            raise _not_ported("the linear (skip-free) pipeline layout")
        D = part.num_devices
        sizes = part.stage_sizes()
        S = part.num_stages
        half = S // 2
        enc: list[list[int]] = [[] for _ in range(D)]
        dec: list[list[int]] = [[] for _ in range(D)]
        for s in range(S):
            (enc if s < half else dec)[part.device_of_stage(s)].append(s)
        V = len(enc[0])
        if any(len(ss) != V for ss in enc) or any(len(ss) != V
                                                  for ss in dec) or V == 0:
            raise ValueError(
                "folded partition is not an even interleave: devices hold "
                f"{[(len(e), len(c)) for e, c in zip(enc, dec)]} "
                "(prefix, suffix)-half stage slots; the wave layout needs "
                "V of each per device")
        enc_slots = tuple(map(tuple, enc))
        dec_slots = tuple(map(tuple, dec))
        enc_counts = tuple(tuple(sizes[s] for s in ss) for ss in enc_slots)
        dec_counts = tuple(tuple(sizes[s] for s in ss) for ss in dec_slots)
        enc_pad = max(c for cs in enc_counts for c in cs)
        dec_pad = max(c for cs in dec_counts for c in cs)
        skip_rows = cls._pair_skips(part, graph, enc_slots, dec_slots,
                                    enc_pad, dec_pad)
        return cls(part, enc_slots, dec_slots, enc_counts, dec_counts,
                   enc_pad, dec_pad, skip_rows)

    @staticmethod
    def _pair_skips(part: Partition, graph: BlockGraph,
                    enc_slots: tuple[tuple[int, ...], ...],
                    dec_slots: tuple[tuple[int, ...], ...],
                    enc_pad: int, dec_pad: int
                    ) -> tuple[tuple[tuple[int, ...], ...], ...]:
        """Per (device, dec slot): decoder row -> flat encoder stash row
        (``src_slot * enc_pad + src_row``), from the graph's skip edges."""
        D, cuts = part.num_devices, part.cuts
        V = len(enc_slots[0])
        rows = [[[-1] * dec_pad for _ in range(V)] for _ in range(D)]
        for e in graph.skips:
            s_src = part.stage_of_block(e.src)
            s_dst = part.stage_of_block(e.dst)
            d = part.device_of_stage(s_src)
            if part.device_of_stage(s_dst) != d:
                raise ValueError(
                    f"skip {e.src}->{e.dst} spans devices "
                    f"{d} and {part.device_of_stage(s_dst)}: the partition "
                    "violates collocation (validate_collocation)")
            if s_src not in enc_slots[d] or s_dst not in dec_slots[d]:
                raise ValueError(
                    f"skip {e.src}->{e.dst} is not encoder-half -> "
                    f"decoder-half on device {d} (stages {s_src}->{s_dst}): "
                    "the stash executors cache skips across the fold only")
            src_slot = enc_slots[d].index(s_src)
            dst_slot = dec_slots[d].index(s_dst)
            dec_row = e.dst - cuts[s_dst]
            enc_row = e.src - cuts[s_src]
            if rows[d][dst_slot][dec_row] != -1:
                raise ValueError(
                    f"block {e.dst} consumes two skips; one stash slot per "
                    "decoder row")
            rows[d][dst_slot][dec_row] = src_slot * enc_pad + enc_row
        return tuple(tuple(map(tuple, dev_rows)) for dev_rows in rows)

    def skip_consumers(self) -> tuple[tuple[tuple[int, ...], ...], ...]:
        """Per (device, dec slot): the encoder slots whose stash entries
        the decoder slot actually consumes (from ``skip_rows``)."""
        return tuple(
            tuple(tuple(sorted({r // self.enc_pad for r in rows if r >= 0}))
                  for rows in dev)
            for dev in self.skip_rows)

    # ---- (device, slot) -> block-row ranges ----------------------------
    def enc_ranges(self) -> list[list[tuple[int, int]]]:
        cuts = self.partition.cuts
        return [[(cuts[s], cuts[s + 1]) for s in ss]
                for ss in self.enc_slots]

    def dec_ranges(self) -> list[list[tuple[int, int]]]:
        """Rows into the decoder-half stack (block index minus mid cut)."""
        part, cuts = self.partition, self.partition.cuts
        mid = cuts[part.num_stages // 2]
        return [[(cuts[s] - mid, cuts[s + 1] - mid) for s in ss]
                for ss in self.dec_slots]

    # ---- padded stacking -------------------------------------------------
    @staticmethod
    def _stack(blocks: Pytree,
               ranges: Sequence[Sequence[tuple[int, int]]],
               pad: int) -> Pytree:
        def f(x):
            devs = []
            for dev_ranges in ranges:
                rows = []
                for lo, hi in dev_ranges:
                    r = x[lo:hi]
                    if hi - lo < pad:
                        z = x.new_zeros((pad - (hi - lo),) + r.shape[1:])
                        r = torch.cat([r, z], 0)
                    rows.append(r)
                devs.append(torch.stack(rows))
            return torch.stack(devs)          # [D, V, pad, ...]

        return tree_map(f, blocks)

    @staticmethod
    def _unstack(stacked: Pytree,
                 ranges: Sequence[Sequence[tuple[int, int]]]) -> Pytree:
        order = sorted(
            ((d, v) for d in range(len(ranges))
             for v in range(len(ranges[d]))),
            key=lambda dv: ranges[dv[0]][dv[1]][0])

        def f(x):
            parts = [x[d, v, : ranges[d][v][1] - ranges[d][v][0]]
                     for d, v in order]
            return torch.cat(parts, 0)

        return tree_map(f, stacked)

    def split(self, stacks: tuple) -> tuple:
        """Model block stacks -> per-(device, slot) padded stage stacks.

        ``stacks`` is ``(blocks,)`` for a homogeneous stack (SkipViT: cut
        at the partition's turnaround, wherever it lands) or
        ``(enc_blocks, dec_blocks)`` (UViT, Hunyuan-DiT)."""
        part = self.partition
        mid = part.cuts[part.num_stages // 2]
        if len(stacks) == 1:
            enc_b = tree_map(lambda x: x[:mid], stacks[0])
            dec_b = tree_map(lambda x: x[mid:], stacks[0])
        else:
            enc_b, dec_b = stacks
            enc_rows = tree_leaves(enc_b)[0].shape[0]
            if enc_rows != mid:
                raise ValueError(
                    f"partition turnaround cut at block {mid} but the "
                    f"model's encoder stack has {enc_rows} rows; two-stack "
                    "models need the mid cut on the stack boundary")
        return (self._stack(enc_b, self.enc_ranges(), self.enc_pad),
                self._stack(dec_b, self.dec_ranges(), self.dec_pad))

    def merge(self, stage_stacks: tuple, n_model_stacks: int) -> tuple:
        """Inverse of :meth:`split` (also correct for gradients)."""
        enc_b = self._unstack(stage_stacks[0], self.enc_ranges())
        dec_b = self._unstack(stage_stacks[1], self.dec_ranges())
        if n_model_stacks == 1:
            return (tree_map(lambda a, b: torch.cat([a, b], 0), enc_b,
                             dec_b),)
        return (enc_b, dec_b)


# ===========================================================================
# Compiled pipeline
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class CompiledPipeline:
    """Planner output lowered to a runnable wave pipeline."""

    graph: BlockGraph
    partition: Partition
    schedule: Schedule
    layout: StageLayout
    pcfg: PipelineConfig
    model_fns: PipelineModelFns
    choice: TunerChoice | None = None      # set when the tuner drove the plan

    @property
    def folded(self) -> bool:
        return self.partition.folded

    # ---- parameter plumbing ----------------------------------------------
    def split_params(self, params: Pytree) -> tuple:
        stacks, edge = self.model_fns.split_blocks(params)
        return self.layout.split(tuple(stacks)), edge

    def merge_params(self, stage_stacks: tuple, edge: Pytree) -> Pytree:
        return self.model_fns.merge_blocks(
            self.layout.merge(tuple(stage_stacks),
                              self.model_fns.num_param_stacks), edge)

    def init_pipeline_params(self, gen: torch.Generator,
                             device="cuda") -> tuple:
        return self.split_params(self.model_fns.init_fn(gen, device))

    # ---- lowering artefacts ----------------------------------------------
    def step_tables(self) -> StepTables:
        """The lowered (memoized) step tables: step programs, channel
        activity masks and the proven liveness windows."""
        return StepTables.from_schedule(
            self.schedule, folded=True, devices=self.partition.devices,
            skip_consumers=self.layout.skip_consumers())

    def state_spec(self) -> dict:
        """JSON-serializable spec of how this plan lays out training state
        at rest: partition cuts, stage->device map, the layout's
        slot/count/pad tables, (dp, zero_stage, V, M, wire_dtype) -- what
        ``checkpoint.store`` records in every manifest and
        ``runtime.resilience`` de-stacks saved state through when the
        restore-time plan differs."""
        from repro_torch.runtime.resilience import compiled_state_spec
        return compiled_state_spec(self)

    def fingerprint(self) -> str:
        """Digest of the state-layout-relevant subset of :meth:`state_spec`:
        equal fingerprints mean a checkpoint loads directly; different ones
        route through the elastic de-stack/re-stack path."""
        from repro_torch.runtime.resilience import plan_fingerprint
        return plan_fingerprint(self.state_spec())

    def certify(self, *, name: str | None = None):
        """Statically verify the lowered plan and return the
        :class:`~repro_torch.analysis.certificate.PlanCertificate`.

        Abstractly interprets the step tables (no execution): race- and
        deadlock-freedom of the ring hops, store/read matching on every
        rotating buffer, wire-dtype flow, and the liveness-window bounds.
        Raises nothing on failure; inspect ``cert.ok`` /
        ``cert.violations`` (a freshly planned pipeline always certifies
        clean -- a FAIL here means a planner/lowering bug).
        """
        from repro_torch.analysis.certificate import certify_plan
        return certify_plan(self, name=name)

    # ---- executor ----------------------------------------------------------
    def build(self) -> Callable:
        """``fn(enc_stack, dec_stack, edge, mbs, aux) -> loss`` over the
        validated schedule's step tables."""
        fns, layout = self.model_fns, self.layout

        # every slot carries its own count and the stash pairing comes from
        # the partition's skip edges, resolved per (device, slot)
        def enc_stage_fn(rows, x, aux, d, slot):
            return scan_blocks_emit(fns.enc_block_fn, rows, x,
                                    layout.enc_counts[d][slot], aux)

        def dec_stage_fn(rows, x, skips, aux, d, slot):
            return scan_blocks_consume(fns.dec_block_fn, rows, skips, x,
                                       layout.dec_counts[d][slot],
                                       layout.skip_rows[d][slot], aux)

        return make_wave_pipeline_from_schedule(
            self.pcfg, self.schedule, embed_fn=fns.embed_fn,
            enc_stage_fn=enc_stage_fn, dec_stage_fn=dec_stage_fn,
            loss_fn=fns.loss_fn, devices=self.partition.devices,
            skip_consumers=layout.skip_consumers())

    def describe(self) -> str:
        part, sched = self.partition, self.schedule
        V = self.layout.V
        kind = "folded wave"
        if V > 1:
            kind += f", interleaved V={V}"
        tabs = self.step_tables()
        live_d, live_u = tabs.live_hops
        lines = [
            f"auto_pipeline: S={part.num_stages} stages over "
            f"D={part.num_devices} devices ({kind}), "
            f"M={self.pcfg.num_microbatches} microbatches",
            f"  cuts={part.cuts} stage sizes={part.stage_sizes()}",
            f"  layout: enc counts={self.layout.enc_counts} "
            f"dec counts={self.layout.dec_counts}"
            + ("" if part.mirror_symmetric() else " (asymmetric fold)"),
            f"  schedule: makespan={sched.makespan} slots, "
            f"bubble={sched.bubble_ratio():.2f}",
            "  executor: table (one process, devices share one card)",
            f"  wire: {self.pcfg.wire_dtype}, live hops "
            f"{live_d}+{live_u}/{tabs.dense_hops} (down+up/dense), "
            f"windows W_down={tabs.W_down} W_up={tabs.W_up} "
            f"W_turn={tabs.W_turn} W_skip={tabs.W_skip} (M={sched.M})",
            f"  comm: exposed hops {tabs.exposed_hops} / "
            f"hidden {tabs.hidden_hops} (of {live_d + live_u} live)",
        ]
        if self.choice is not None:
            c = self.choice
            lines.append(f"  tuner: P={c.P} G={c.G} b={c.b} M={c.M} "
                         f"zero={c.zero_stage} "
                         f"t/sample={c.t_sample*1e3:.3f} ms")
        return "\n".join(lines)


# ===========================================================================
# Entry point
# ===========================================================================

def auto_pipeline(
    graph: BlockGraph,
    model_fns: PipelineModelFns,
    N: int,
    hw: Hardware = H100_SXM,
    *,
    microbatches: int | None = None,
    lam: float = 1.0,
    force_wave: bool | None = None,
    pipeline_devices: int | None = None,
    interleave: int | None = None,
    dp_size: int | None = None,
    zero_stage: int | None = None,
    remat: bool = True,
    use_ilp: bool = False,
    executor: str = "table",
    wire_dtype: str = "bfloat16",
) -> CompiledPipeline:
    """Plan, schedule and lower a pipeline for ``graph`` on ``N`` devices.

    By default the hybrid tuner (§VI) picks (P, G, b) -- and the
    interleave degree V -- and supplies its partition; ``microbatches``
    then defaults to the M the tuner's iteration-time score assumed
    (``TunerChoice.M``), so the executed iteration is the scored one.  The
    port runs one pipeline replica (G = 1) without ZeRO: where the tuner's
    best choice has G > 1 or a ZeRO stage, this raises
    ``NotImplementedError`` naming it, and never falls back to a
    lower-ranked choice (that would be another plan than the JAX
    package's).  Pinning ``interleave`` or ``zero_stage`` restricts the
    tuner's search to that value.

    Pass ``pipeline_devices`` to pin the pipeline degree and call the
    partitioner directly (deterministic; used by the tests and the
    trainer; ``microbatches`` defaults to 2D).  ``interleave`` pins
    V stage-slot pairs per device (S = 2VD).  ``wire_dtype`` sets the
    boundary-hop dtype (``"float32"`` is the exact-wire escape hatch).
    """
    if zero_stage is not None and zero_stage not in (0, 1, 2):
        raise ValueError(f"zero_stage must be in (0, 1, 2), got {zero_stage}")
    if dp_size not in (None, 1):
        raise _not_ported("data parallelism (dp_size > 1)")
    if executor != "table":
        raise _not_ported(f"the {executor!r} executor")
    choice: TunerChoice | None = None
    if pipeline_devices is not None:
        if zero_stage not in (None, 0):
            raise _not_ported("ZeRO (zero_stage > 0)")
        part = partition_graph(graph, pipeline_devices, hw=hw, lam=lam,
                               force_wave=force_wave,
                               interleave=interleave or 1)
    else:
        if force_wave is not None:
            raise ValueError(
                "force_wave requires pipeline_devices: the tuner derives "
                "wave vs linear from graph.skips and would ignore it")
        drops: list[str] = []
        # overlap=True: the tuner prices the JAX package's default,
        # overlapped hop lowering, as the reference's auto_pipeline does
        choices = tune(graph, N, hw=hw, lam=lam, drops=drops,
                       zero_stages=((zero_stage,) if zero_stage is not None
                                    else (0, 1, 2)),
                       interleave_options=(
                           (interleave,) if interleave is not None
                           else None),
                       overlap=True)
        pure_dp = sorted({(c.P, c.G, c.zero_stage) for c in choices
                          if c.partition is None or c.P <= 1})
        drops += [f"P={p} G={g}" + (f" zero{z}" if z else "")
                  + ": pure data parallelism "
                  "(P=1 plans carry no pipeline to lower)"
                  for p, g, z in pure_dp]
        keep = [c for c in choices if c.partition is not None and c.P > 1]
        if not keep:
            # every per-candidate drop reason the tuner and the P>1 filter
            # collected, in full
            detail = "\n  ".join(drops) or "tuner enumerated no candidates"
            raise ValueError(
                f"tuner found no feasible pipeline plan for N={N}; "
                f"candidates considered:\n  {detail}")
        choice = keep[0]
        if choice.G > 1 or choice.zero_stage > 0:
            raise _not_ported(
                f"the tuner's choice P={choice.P} G={choice.G} b={choice.b} "
                f"V={choice.V} M={choice.M} zero_stage={choice.zero_stage} "
                "(data parallelism and ZeRO)")
        part = choice.partition
    if not part.folded:
        raise _not_ported("the linear (skip-free) executor")
    D = part.num_devices
    if microbatches is not None:
        M = microbatches
    elif choice is not None:
        # execute the M the tuner scored -- the planner and the executor
        # must agree on the iteration shape
        M = choice.M
    else:
        M = 2 * D
    # schedule synthesis + full constraint validation happens here; an
    # invalid plan raises before any executor is built
    sched = schedule_for_partition(part, M, use_ilp=use_ilp)
    pcfg = PipelineConfig(num_devices=D, num_microbatches=M,
                          remat=remat,
                          wire_dtype=wire_dtype)
    layout = StageLayout.from_partition(part, graph)
    return CompiledPipeline(graph=graph, partition=part, schedule=sched,
                            layout=layout, pcfg=pcfg, model_fns=model_fns,
                            choice=choice)
