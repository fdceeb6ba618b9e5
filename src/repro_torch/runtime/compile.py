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
   (:class:`StageLayout`), and builds the table-driven executor
   (``runtime.schedule_exec``) over the validated schedule: the wave
   executor for folded plans, the linear one for skip-free linear plans.
   ``executor="closed_form"`` selects the closed-form wave / 1F1B
   executors (``runtime.pipeline``) instead, kept as differential
   references.

:meth:`CompiledPipeline.state_spec` and :meth:`~CompiledPipeline.fingerprint`
record how the plan lays training state out at rest, equal to the JAX
package's for the same graph and plan: checkpoints carry the spec, and a
restore onto another plan de-stacks through it (``runtime.resilience``).
:meth:`CompiledPipeline.certify` proves the lowered step tables race- and
deadlock-free without running them (``repro_torch.analysis``).

Data parallelism and ZeRO (``dp_size``, ``zero_stage``; the tuner's G and
ZeRO stage by default) run as ranks: one process per (data, pipeline)
index of the grid (``launch/mesh.py::make_rank_grid``), each with its
pipeline ring and its data group (``runtime/ring.py``).  A rank's plan is
:meth:`CompiledPipeline.for_rank`; at ZeRO-2 its rows rest sharded over
its data replicas by the JAX package's rules (:meth:`zero_dims`,
``runtime/sharding.py``).  The one-process executors run one replica and
refuse ``dp_size > 1``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.graph import BlockGraph
from repro_torch.core.hw import Hardware, H100_SXM
from repro_torch.core.partition import Partition, partition as partition_graph
from repro_torch.core.schedule import Schedule, schedule_for_partition
from repro_torch.core.tuner import TunerChoice, tune
from repro_torch.runtime.pipeline import (PipelineConfig, check_one_replica,
                                          make_linear_pipeline,
                                          make_wave_pipeline, scan_blocks,
                                          scan_blocks_consume,
                                          scan_blocks_emit)
from repro_torch.runtime.schedule_exec import (
    StepTables, make_linear_pipeline_from_schedule,
    make_wave_pipeline_from_schedule)
from repro_torch.runtime.sharding import (leaf_dims, shard, shard_view,
                                          zero_stack_dims)
from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


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

    Folded plans need ``enc_block_fn`` and ``dec_block_fn`` (or a
    skip-free ``block_fn`` standing in for both); linear plans need
    ``block_fn``, called with ``aux=None``.
    """

    init_fn: Callable        # (generator, device) -> params
    embed_fn: Callable       # (edge_p, mb, aux) -> x
    loss_fn: Callable        # (edge_p, x, mb, aux) -> scalar
    split_blocks: Callable   # params -> (stacks, edge)
    merge_blocks: Callable   # (stacks, edge) -> params
    block_fn: Callable | None = None       # (block_p, x, aux) -> x
    enc_block_fn: Callable | None = None   # (block_p, x, aux) -> (x, skip)
    dec_block_fn: Callable | None = None   # (block_p, x, skip, aux) -> x
    num_param_stacks: int = 2               # len(split_blocks(params)[0])


# ===========================================================================
# Stage layout: partition cuts -> padded per-device stacks
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class StageLayout:
    """Mapping between a model's flat block stack and per-device stage-slot
    stacks for a (possibly uneven, mirror-asymmetric, interleaved)
    partition.

    Device ``d`` runs ``V`` encoder-half (prefix) stage slots and -- for
    folded partitions -- ``V`` decoder-half (suffix) slots;
    ``enc_slots[d][v]`` / ``dec_slots[d][v]`` name the pipeline stages in
    slot order and ``enc_counts[d][v]`` / ``dec_counts[d][v]`` their true
    block counts.  All slots pad to ``enc_pad`` / ``dec_pad`` rows.

    ``skip_rows[d][v][i]`` is the *flat* stash row device d's decoder slot
    v consumes at its row ``i``: ``src_slot * enc_pad + src_row`` into the
    device's ``[V * enc_pad]`` skip stash -- derived from the partition's
    skip edges; ``-1`` marks rows without a skip (they receive zeros).
    Linear partitions use only ``enc_slots`` / ``enc_counts`` /
    ``enc_pad``.
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
        """Lay out ``part``; ``graph`` supplies the skip edges that define
        a folded layout's stash pairing."""
        D = part.num_devices
        sizes = part.stage_sizes()
        if not part.folded:
            slots: list[list[int]] = [[] for _ in range(D)]
            for s in range(part.num_stages):
                slots[part.device_of_stage(s)].append(s)
            V = len(slots[0])
            if any(len(ss) != V for ss in slots):
                raise ValueError(
                    "linear partition is not an even interleave: devices "
                    f"hold {[len(ss) for ss in slots]} stage slots")
            enc_slots = tuple(map(tuple, slots))
            enc_counts = tuple(tuple(sizes[s] for s in ss)
                               for ss in enc_slots)
            pad = max(c for cs in enc_counts for c in cs)
            return cls(part, enc_slots, ((),) * D, enc_counts, ((),) * D,
                       pad, 0)
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

    def split(self, stacks: tuple, device: int | None = None) -> tuple:
        """Model block stacks -> per-(device, slot) padded stage stacks.

        ``stacks`` is ``(blocks,)`` for a homogeneous stack (SkipViT: cut
        at the partition's turnaround, wherever it lands) or
        ``(enc_blocks, dec_blocks)`` (UViT, Hunyuan-DiT); a linear
        partition takes one stack.  ``device`` builds that device's
        ``[V, pad, ...]`` rows alone (a copy of its blocks only)."""
        part = self.partition

        def stack(blocks, ranges, pad):
            if device is None:
                return self._stack(blocks, ranges, pad)
            return tree_map(lambda x: x[0],
                            self._stack(blocks, [ranges[device]], pad))

        if not part.folded:
            if len(stacks) != 1:
                raise ValueError("linear pipeline needs one block stack")
            return (stack(stacks[0], self.enc_ranges(), self.enc_pad),)
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
        return (stack(enc_b, self.enc_ranges(), self.enc_pad),
                stack(dec_b, self.dec_ranges(), self.dec_pad))

    def merge(self, stage_stacks: tuple, n_model_stacks: int) -> tuple:
        """Inverse of :meth:`split` (also correct for gradients)."""
        if not self.partition.folded:
            return (self._unstack(stage_stacks[0], self.enc_ranges()),)
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
    """Planner output lowered to a runnable pipeline."""

    graph: BlockGraph
    partition: Partition
    schedule: Schedule
    layout: StageLayout
    pcfg: PipelineConfig
    model_fns: PipelineModelFns
    choice: TunerChoice | None = None      # set when the tuner drove the plan
    executor: str = "table"                # "table" | "closed_form"
    rank: int | None = None                # one pipeline device's view
    data_index: int = 0                    # ...in data replica data_index

    @property
    def folded(self) -> bool:
        return self.partition.folded

    def for_rank(self, rank: int, data: int = 0) -> "CompiledPipeline":
        """The plan as pipeline device ``rank`` of data replica ``data``
        sees it (the rank grid's pipe and data index):
        :meth:`split_params` and :meth:`init_pipeline_params` give that
        device's stage rows (``[V, pad, ...]``; at ZeRO-2 with ``dp > 1``
        the replica's shard of them) and the edge params, :meth:`build`
        needs the rank's ``ring`` (and ``data`` group, ``dp > 1``), and
        :meth:`merge_params`, which needs every rank's rows, raises."""
        if not 0 <= rank < self.partition.num_devices:
            raise ValueError(f"rank {rank} outside the "
                             f"{self.partition.num_devices}-device plan")
        if not 0 <= data < self.pcfg.dp_size:
            raise ValueError(f"data index {data} outside the plan's "
                             f"{self.pcfg.dp_size} data replicas")
        out = dataclasses.replace(self, rank=rank, data_index=data)
        for k in ("_zero_dims", "_zero_paths"):    # the same at every point
            if k in self.__dict__:
                out.__dict__[k] = self.__dict__[k]
        return out

    # ---- ZeRO ------------------------------------------------------------
    def zero_dims(self) -> tuple | None:
        """Per param stack, the dim of each leaf's slot view ``[pad, ...]``
        that shards over the data replicas (``-1`` replicated): the gather
        dims of the JAX package's ``_zero_layout`` (``zero_stack_specs``,
        here ``runtime.sharding.zero_stack_dims``), or None below ZeRO-1
        or with one replica.  ZeRO-1 shards the AdamW moments by them,
        ZeRO-2 the rows as well.  Shapes come from the model's init on the
        ``meta`` device: no parameter is drawn (once per plan)."""
        return self._zero_dims

    @functools.cached_property
    def _zero_dims(self) -> tuple | None:
        if self.pcfg.zero_stage < 1 or self.pcfg.dp_size <= 1:
            return None
        stacks, _ = self.model_fns.split_blocks(self.model_fns.init_fn(
            torch.Generator().manual_seed(0), "meta"))
        return tuple(zero_stack_dims(st, dp=self.pcfg.dp_size)
                     for st in self.layout.split(tuple(stacks)))

    def piece_dim(self, stack: int, path: str, *,
                  moments: bool = False) -> int:
        """The dim of a rank's rows ``[V, pad, ...]`` of stage stack
        ``stack``'s leaf ``path`` along which its data replica holds only
        its shard at rest (the leaf's :meth:`zero_dims` entry, plus one),
        or -1 when it holds the rows whole: the params are sharded at
        ZeRO-2, the AdamW moments (``moments``) at ZeRO-1 and 2, as
        :meth:`split_params` and :meth:`optimizer_view` place them."""
        dims = self.zero_dims()
        if dims is None or (not moments and self.pcfg.zero_stage < 2):
            return -1
        d = self._zero_paths[stack][path]
        return d + 1 if d >= 0 else -1

    @functools.cached_property
    def _zero_paths(self) -> tuple:
        from repro_torch.tree import tree_paths
        return tuple(dict(tree_paths(ds)) for ds in self.zero_dims())

    def rank_piece(self, rows, stack: int, path: str, *,
                   moments: bool = False):
        """This rank's piece of one stage-stack leaf, given its rows
        ``x[rank]`` of the whole ``[D, V, pad, ...]`` leaf: a view of its
        data replica's shard along :meth:`piece_dim`, or the rows
        themselves.  A checkpoint's writer places each rank's piece with
        it, and a restore cuts the rank's rows with it."""
        dim = self.piece_dim(stack, path, moments=moments)
        if dim < 0:
            return rows
        return shard_view(rows, dim - 1, self.pcfg.dp_size, self.data_index)

    def optimizer_view(self, params: tuple) -> tuple:
        """What a rank's AdamW updates of ``(stage stacks, edge)`` (or of
        their gradients): at ZeRO-1 views of its data replica's shard of
        each sharded leaf (its moments cover only those), else the tree
        itself (at ZeRO-2 the rows are already the shard).  After an
        update of the views, :meth:`gather_params_` brings the rows
        whole again."""
        if self.rank is None or self.pcfg.zero_stage != 1 \
                or self.pcfg.dp_size <= 1:
            return params
        stacks, edge = params
        return tuple(shard_view(st, dims, self.pcfg.dp_size, self.data_index)
                     for st, dims in zip(stacks, self.zero_dims())), edge

    def gather_params_(self, params: tuple, data) -> None:
        """ZeRO-1: all-gather every sharded leaf's updated shards over the
        data group ``data`` back into the rank's whole rows, in place (one
        collective a stack)."""
        if self.rank is None or self.pcfg.zero_stage != 1 \
                or self.pcfg.dp_size <= 1:
            return
        stacks, _ = params
        with torch.no_grad():
            for st, dims in zip(stacks, self.zero_dims()):
                sharded = [(x, d + 1) for x, d in leaf_dims(st, dims)
                           if d >= 0]
                if not sharded:
                    continue
                xs, ds = zip(*sharded)
                data.all_gather(
                    [x.narrow(d, data.index * (x.shape[d] // data.size),
                              x.shape[d] // data.size)
                     for x, d in sharded], list(ds), out=list(xs))

    # ---- parameter plumbing ----------------------------------------------
    def split_params(self, params: Pytree) -> tuple:
        stacks, edge = self.model_fns.split_blocks(params)
        stacks = self.layout.split(tuple(stacks), self.rank)
        if self.rank is not None and self.pcfg.zero_stage >= 2 \
                and self.pcfg.dp_size > 1:     # ZeRO-2: the rows rest sharded
            stacks = tuple(shard(st, dims, self.pcfg.dp_size,
                                 self.data_index)
                           for st, dims in zip(stacks, self.zero_dims()))
        return stacks, edge

    def merge_params(self, stage_stacks: tuple, edge: Pytree) -> Pytree:
        if self.rank is not None:
            raise NotImplementedError(
                "merge_params needs every rank's stage rows; a rank holds "
                "only its own")
        return self.model_fns.merge_blocks(
            self.layout.merge(tuple(stage_stacks),
                              self.model_fns.num_param_stacks), edge)

    def init_pipeline_params(self, gen: torch.Generator,
                             device="cuda") -> tuple:
        """The params of the seed ``gen`` draws, split as this plan (or
        rank) lays them out.  A rank draws the whole model -- the same
        values the one-process path draws -- and keeps its own rows (at
        ZeRO-2 its shard of them): the whole model is on ``device`` until
        this returns."""
        return self.split_params(self.model_fns.init_fn(gen, device))

    # ---- lowering artefacts ----------------------------------------------
    def step_tables(self) -> StepTables:
        """The lowered (memoized) step tables: step programs, channel
        activity masks and the proven liveness windows."""
        if not self.folded:
            return StepTables.from_schedule(
                self.schedule, folded=False, devices=self.partition.devices)
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
    def build(self, ring=None, data=None) -> Callable:
        """Lower to an executor.

        ``executor="table"`` (default) walks the *validated schedule
        itself* through its step tables (``runtime.schedule_exec``), so
        greedy and ILP schedules alike execute as synthesized.
        ``executor="closed_form"`` selects the closed-form wave / 1F1B
        executors (``runtime.pipeline``), whose index arithmetic realizes
        the template orders -- kept as differential references (folded:
        V = 1 and M >= D).

        Folded: ``fn(enc_stack, dec_stack, edge, mbs, aux) -> loss``.
        Linear: ``fn(stack, edge, mbs) -> loss``.

        A rank's plan (:meth:`for_rank`) lowers the table executors to
        that rank's executor over ``ring``
        (:class:`~repro_torch.runtime.ring.Ring`): its stacks are its own
        rows, it returns the loss summed over the group with every leaf's
        ``.grad`` filled (no ``loss.backward()``).  With ``dp_size > 1``
        it also needs the rank's ``data`` group
        (:class:`~repro_torch.runtime.ring.DataGroup`): it runs its data
        shard of each microbatch, and the loss and gradients come back
        averaged over the replicas (``schedule_exec``).  The closed forms
        stay one-process.
        """
        if self.executor not in ("table", "closed_form"):
            raise ValueError(
                f"unknown executor {self.executor!r}; expected 'table' or "
                "'closed_form'")
        if self.executor == "closed_form" and self.pcfg.zero_stage >= 2 \
                and self.pcfg.dp_size > 1:
            raise ValueError(
                "closed-form executors keep stage stacks replicated over "
                f"the data replicas; zero_stage={self.pcfg.zero_stage} "
                "shards them at rest -- lower through executor='table'")
        if ring is None:
            check_one_replica(self.pcfg)
        if (ring is None) != (self.rank is None):
            raise ValueError(
                "a rank's plan (for_rank) builds with its ring, and only "
                f"it: rank={self.rank}, ring={ring}")
        if ring is not None:
            if self.executor != "table":
                raise NotImplementedError(
                    "the closed-form executors over ranks are not ported "
                    "(ROADMAP A1); lower through executor='table'")
            if ring.index != self.rank:
                raise ValueError(f"ring index {ring.index} for rank "
                                 f"{self.rank}'s plan")
            if data is not None and data.index != self.data_index:
                raise ValueError(f"data index {data.index} for data "
                                 f"replica {self.data_index}'s plan")
        fns, pcfg, layout = self.model_fns, self.pcfg, self.layout
        zero_dims = self.zero_dims() if ring is not None else None
        if self.executor == "closed_form" and layout.V > 1:
            raise ValueError(
                f"closed-form executors realize one (enc, dec) stage slot "
                f"pair per device; this plan interleaves V={layout.V} "
                "slots -- lower through executor='table'")

        def squeeze_slot(stack):
            # closed-form executors predate the slot axis: drop the V=1 dim
            return tree_map(lambda t: t[:, 0], stack)

        if self.folded:
            if fns.block_fn is None and (fns.enc_block_fn is None
                                         or fns.dec_block_fn is None):
                raise ValueError(
                    "folded pipeline needs model_fns.block_fn or both "
                    "enc_block_fn and dec_block_fn")
            enc_block = fns.enc_block_fn or (
                lambda bp, x, aux: (fns.block_fn(bp, x, aux), None))
            dec_block = fns.dec_block_fn or (
                lambda bp, x, skip, aux: fns.block_fn(bp, x, aux))

            if self.executor == "table":
                # every slot carries its own count and the stash pairing
                # comes from the partition's skip edges, per (device, slot)
                def enc_stage_fn(rows, x, aux, d, slot):
                    return scan_blocks_emit(enc_block, rows, x,
                                            layout.enc_counts[d][slot], aux)

                def dec_stage_fn(rows, x, skips, aux, d, slot):
                    return scan_blocks_consume(dec_block, rows, skips, x,
                                               layout.dec_counts[d][slot],
                                               layout.skip_rows[d][slot], aux)

                return make_wave_pipeline_from_schedule(
                    pcfg, self.schedule, embed_fn=fns.embed_fn,
                    enc_stage_fn=enc_stage_fn, dec_stage_fn=dec_stage_fn,
                    loss_fn=fns.loss_fn, devices=self.partition.devices,
                    skip_consumers=layout.skip_consumers(), ring=ring,
                    data=data, zero_dims=zero_dims)

            def enc_stage_cf(rows, x, aux, d):
                return scan_blocks_emit(enc_block, rows, x,
                                        layout.enc_counts[d][0], aux)

            def dec_stage_cf(rows, x, skips, aux, d):
                return scan_blocks_consume(dec_block, rows, skips, x,
                                           layout.dec_counts[d][0],
                                           layout.skip_rows[d][0], aux)

            wave = make_wave_pipeline(
                pcfg, embed_fn=fns.embed_fn, enc_stage_fn=enc_stage_cf,
                dec_stage_fn=dec_stage_cf, loss_fn=fns.loss_fn)
            return lambda enc, dec, edge, mbs, aux: wave(
                squeeze_slot(enc), squeeze_slot(dec), edge, mbs, aux)

        if fns.block_fn is None:
            raise ValueError("linear pipeline needs model_fns.block_fn")
        embed = lambda e, mb: fns.embed_fn(e, mb, None)
        loss = lambda e, x, mb: fns.loss_fn(e, x, mb, None)
        if self.executor == "table":
            def stage_fn(rows, x, d, slot):
                return scan_blocks(fns.block_fn, rows, x,
                                   layout.enc_counts[d][slot], None)

            return make_linear_pipeline_from_schedule(
                pcfg, self.schedule, embed_fn=embed, stage_fn=stage_fn,
                loss_fn=loss, devices=self.partition.devices, ring=ring,
                data=data, zero_dims=zero_dims)

        def stage_cf(rows, x, d):
            return scan_blocks(fns.block_fn, rows, x, layout.enc_counts[d][0],
                               None)

        linear = make_linear_pipeline(pcfg, embed_fn=embed, stage_fn=stage_cf,
                                      loss_fn=loss)
        return lambda stack, edge, mbs: linear(squeeze_slot(stack), edge, mbs)

    def describe(self) -> str:
        part, sched = self.partition, self.schedule
        V = self.layout.V
        kind = "folded wave" if part.folded else "linear 1F1B"
        if V > 1:
            kind += f", interleaved V={V}"
        lines = [
            f"auto_pipeline: S={part.num_stages} stages over "
            f"D={part.num_devices} devices ({kind}), "
            f"M={self.pcfg.num_microbatches} microbatches",
            f"  cuts={part.cuts} stage sizes={part.stage_sizes()}",
            (f"  layout: enc counts={self.layout.enc_counts} "
             f"dec counts={self.layout.dec_counts}"
             + ("" if part.mirror_symmetric() else " (asymmetric fold)")
             if part.folded else
             f"  layout: stage counts={self.layout.enc_counts}"),
            f"  schedule: makespan={sched.makespan} slots, "
            f"bubble={sched.bubble_ratio():.2f}",
            (f"  executor: {self.executor} (one process, devices share one "
             "card)" if self.rank is None else
             f"  executor: {self.executor}, rank {self.rank} of "
             f"{part.num_devices}"
             + (f", data replica {self.data_index} of {self.pcfg.dp_size}"
                if self.pcfg.dp_size > 1 else "")
             + " (one process per pipeline device)"),
        ]
        if self.executor == "table":
            tabs = self.step_tables()
            live_d, live_u = tabs.live_hops
            lines += [
                f"  wire: {self.pcfg.wire_dtype}, live hops "
                f"{live_d}+{live_u}/{tabs.dense_hops} (down+up/dense), "
                f"windows W_down={tabs.W_down} W_up={tabs.W_up} "
                f"W_turn={tabs.W_turn} W_skip={tabs.W_skip} (M={sched.M})",
                f"  comm: exposed hops {tabs.exposed_hops} / "
                f"hidden {tabs.hidden_hops} (of {live_d + live_u} live)"]
        if self.pcfg.dp_size > 1 or self.pcfg.zero_stage > 0:
            lines.append(
                f"  hybrid: dp={self.pcfg.dp_size} over ('data',), "
                f"zero_stage={self.pcfg.zero_stage}")
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
    (``TunerChoice.M``), ``dp_size`` to its G and ``zero_stage`` to its
    ZeRO stage, so the executed iteration is the scored one.  Pinning
    ``interleave`` or ``zero_stage`` restricts the tuner's search to that
    value.  A ZeRO stage over one replica drops to 0, as in the JAX
    package (nothing to shard over).

    Pass ``pipeline_devices`` to pin the pipeline degree and call the
    partitioner directly (deterministic; used by the tests and the
    trainer; ``microbatches`` defaults to 2D folded, max(D, 2) linear,
    ``dp_size`` to 1 and ``zero_stage`` to 0).
    ``interleave`` pins V stage slots per device and kind (S = 2VD
    folded, VD linear).

    ``executor`` selects the lowering: ``"table"`` (default) executes the
    validated schedule through per-device step tables;
    ``"closed_form"`` uses the closed-form wave / 1F1B executors as
    differential references (folded plans need M >= D and V = 1;
    ``build()`` raises ``ValueError`` otherwise, and for an unknown
    name).  ``wire_dtype`` sets the table executors' boundary-hop dtype
    (``"float32"`` is the exact-wire escape hatch); the closed forms carry
    the model's dtype.
    """
    if zero_stage is not None and zero_stage not in (0, 1, 2):
        raise ValueError(f"zero_stage must be in (0, 1, 2), got {zero_stage}")
    choice: TunerChoice | None = None
    if pipeline_devices is not None:
        part = partition_graph(graph, pipeline_devices, hw=hw, lam=lam,
                               force_wave=force_wave,
                               interleave=interleave or 1)
        if graph.skips and not part.folded:
            raise ValueError(
                "graph has skip edges but the plan is linear: the linear "
                "executor has no skip transport, so skips would be "
                "silently dropped -- skip graphs need a folded plan")
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
        part = choice.partition
    D = part.num_devices
    if microbatches is not None:
        M = microbatches
    elif choice is not None:
        # execute the M the tuner scored -- the planner and the executor
        # must agree on the iteration shape
        M = choice.M
    else:
        M = 2 * D if part.folded else max(D, 2)
    if dp_size is None:
        dp_size = choice.G if choice is not None else 1
    if choice is not None and zero_stage is None:
        zero_stage = choice.zero_stage
    zero_stage = zero_stage or 0
    if zero_stage > 0 and dp_size <= 1:
        # nothing to shard over: a stage-1/2 request on one replica is the
        # replicated plan, recorded as such (the JAX package's rule)
        zero_stage = 0
    # schedule synthesis + full constraint validation happens here; an
    # invalid plan raises before any executor is built
    sched = schedule_for_partition(part, M, use_ilp=use_ilp)
    pcfg = PipelineConfig(num_devices=D, num_microbatches=M,
                          remat=remat, wire_dtype=wire_dtype,
                          dp_size=dp_size, zero_stage=zero_stage)
    layout = StageLayout.from_partition(part, graph)
    return CompiledPipeline(graph=graph, partition=part, schedule=sched,
                            layout=layout, pcfg=pcfg, model_fns=model_fns,
                            choice=choice, executor=executor)
