"""Pipeline configuration, wire formats, remat, the ring hop and its byte
counts, the masked block loops, and the closed-form executors (the port of
``repro.runtime.pipeline``).

A stage's blocks arrive as a list of per-row param trees (views of the
stage stacks, see :func:`unbind_rows`).  The JAX scans run every padded
row and mask rows ``>= count`` out with ``where``; here the device, slot
and count are host integers, so the loops simply stop at ``count``:
padded rows never run and get zero gradients.

In the one-process executors all D pipeline devices live in one process,
so a device's payloads are entries of per-device lists and a ring hop
(:func:`hop`) moves them between the lists.  :func:`hop` adds the bytes of
every payload it moves to :data:`HOP_BYTES` -- the one-process counterpart
of the JAX package's collective-permute bytes read from the compiled HLO
(``runtime/hlo_analysis.collective_bytes``).  It counts the forward walk
only; on a real ring the backward moves the same bytes in reverse.  The
rank executors (``ring=`` on the makers; ``runtime/ring.py``) run one
device per process and send only the live payloads over a process group;
the closed forms and the skip-carry baseline take ``ring=`` as well, their
arrivals and sends read off the same index arithmetic.

The closed-form executors realize the wave / 1F1B template orders through
index arithmetic (``my_mb = t - d``, ``skip_row = t2 - (D-1) + 2d``), the
JAX package's differential references for the table executors:

- :func:`make_wave_pipeline`: PULSE's folded schedule.  Device d owns
  encoder stage d and decoder stage 2D-1-d.  Phase 1 goes *down* the ring
  with skips and the turnaround stream stashed locally; phase 2 goes *up*,
  each device consuming its own stash.  2(D-1) activations cross a ring
  per microbatch.
- :func:`make_linear_pipeline`: S = D sequential stages for skip-free
  models.
- :func:`make_skip_carry_pipeline`: the paper's *baseline* (sequential
  1F1B on a UNet): every skip tensor rides the boundary payload across
  each hop until its consumer pops it.

Microbatch indices are host integers here, so the ticks whose clipped
microbatch the JAX scans compute only to discard are not run: their
devices send a zero payload, which the dense count still counts (a
``ppermute`` moves it) and the live count does not.  Closed forms carry
activations in the model's dtype (the JAX package's "fp32 wire": no cast;
``wire_dtype`` is ignored).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.runtime.ring import (DOWN, UP, StepPlan, rank_walk,
                                      reduce_edge_grads, reduce_loss)
from repro_torch.runtime.sharding import batch_shard, leaf_dims
from repro_torch.tree import tree_index, tree_leaves, tree_map

Pytree = Any

# Wire formats the table executor may put on the ring.  bf16 halves the
# bytes of every boundary hop (forward and, through the cast's backward,
# the cotangents); float32 is the exact-wire escape hatch the strict
# differential tests pin.
WIRE_DTYPES = ("bfloat16", "float32")

# Bytes the forward walks handed to ring hops: "dense" counts every payload
# a ppermute would move (quiescent zeros included, as the HLO counts them),
# "live" the payloads a receiver stores.
HOP_BYTES: dict[str, int] = {"dense": 0, "live": 0}


def reset_hop_bytes() -> None:
    for k in HOP_BYTES:
        HOP_BYTES[k] = 0


def hop_bytes() -> dict[str, int]:
    return dict(HOP_BYTES)


def ring_perms(D: int, *, wrap: bool = False
               ) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    """(down, up) ``(src, dst)`` pairs of a D-device pipeline ring.

    ``wrap=True`` closes the ring (D-1 -> 0 down, 0 -> D-1 up): the table
    executors use the closed ring so interleaved (V > 1) plans can hand an
    activation from the last device's slot to the first device's next
    slot.  The closed forms keep the open ring (their index arithmetic
    assumes no wraparound).
    """
    if D <= 1:
        return [], []
    if wrap:
        return ([(i, (i + 1) % D) for i in range(D)],
                [(i, (i - 1) % D) for i in range(D)])
    return [(i, i + 1) for i in range(D - 1)], [(i, i - 1)
                                                 for i in range(1, D)]


def _nbytes(payload: Pytree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(payload))


def _move(payloads: list, pairs, live) -> list:
    out: list = [None] * len(payloads)
    for src, dst in pairs:
        n = _nbytes(payloads[src])
        HOP_BYTES["dense"] += n
        if live is None or live[src]:
            HOP_BYTES["live"] += n
        out[dst] = payloads[src]
    return out


def hop(down_pl: list | None, up_pl: list | None, *, down_used: bool = True,
        up_used: bool = True, wrap: bool = True, down_live=None,
        up_live=None) -> tuple[list | None, list | None]:
    """One ring hop: device d's down payload arrives at device d+1 and its
    up payload at device d-1 (``wrap``: both rings closed).  All devices
    share one process here, so the hop moves payloads between the devices'
    lists (the multi-process executor swaps point-to-point sends in here
    and nothing else).  A ring no message ever rides is not hopped (its
    payloads are all zeros anyway); on the open ring the device no pair
    sends to receives ``None`` (a ``ppermute`` gives it zeros, which the
    closed forms never read).  ``down_live`` / ``up_live`` flag the
    senders whose payload a receiver stores (``None``: all)."""
    return (_move(down_pl, ring_perms(len(down_pl), wrap=wrap)[0], down_live)
            if down_used else down_pl,
            _move(up_pl, ring_perms(len(up_pl), wrap=wrap)[1], up_live)
            if up_used else up_pl)


def unbind_rows(stack: Pytree, levels: int = 3) -> list:
    """A stage stack with ``levels`` leading axes (``[D, V, pad, ...]`` for
    the table executors, ``[D, rows, ...]`` for the closed forms) -> nested
    lists of row param trees, ``rows[d][v][i]`` / ``rows[d][i]``.

    Each leaf is unbound once per level, so autograd gathers a leaf's
    gradient with one stack per level instead of one full-size scatter per
    row use (what indexing the stack row by row would cost).
    """
    leaves = tree_leaves(stack)
    parts = {id(x): _split_levels(x, levels) for x in leaves}
    return _build_rows(stack, parts, leaves[0].shape[:levels], ())


# module-level recursion: a nested function that calls itself is a
# reference cycle, which would keep the unbound rows (a ZeRO-2 step's
# gathered slot) alive until the next cyclic collection
def _split_levels(x: torch.Tensor, n: int):
    return x if n == 0 else [_split_levels(y, n - 1) for y in x.unbind(0)]


def _build_rows(stack: Pytree, parts: dict, shape, idx: tuple):
    if len(idx) < len(shape):
        return [_build_rows(stack, parts, shape, idx + (i,))
                for i in range(shape[len(idx)])]

    def pick(x):
        nested = parts[id(x)]
        for i in idx:
            nested = nested[i]
        return nested
    return tree_map(pick, stack)


def rank_rows(stack: Pytree, levels: int) -> tuple[list, Callable]:
    """A rank's stage stack (``levels`` leading axes) -> ``(rows,
    finish)``: nested lists of row param trees whose leaves are fresh
    autograd leaves sharing the stack's storage, and ``finish()``, which
    adds the rows' gradients, stacked (zeros for rows no step ran), to the
    stack leaves' ``.grad``.  A rank walk back-propagates one step at a
    time; rows of their own keep each step's backward from building a
    gradient the size of the whole stack."""
    rows = unbind_rows(tree_map(lambda x: x.detach(), stack), levels)

    def fresh(nested, depth):
        if depth == levels:
            return tree_map(lambda x: x.detach().requires_grad_(), nested)
        return [fresh(n, depth + 1) for n in nested]

    rows = fresh(rows, 0)

    def grads(nested, depth, i):
        if depth == levels:
            leaf = tree_leaves(nested)[i]
            return leaf.grad if leaf.grad is not None else torch.zeros_like(
                leaf)
        return torch.stack([grads(n, depth + 1, i) for n in nested])

    def finish() -> None:
        for i, x in enumerate(tree_leaves(stack)):
            g = grads(rows, 0, i)
            x.grad = g if x.grad is None else x.grad + g

    return rows, finish


class _ZeroGather(torch.autograd.Function):
    """All-gather a slot's sharded leaves over the data group on use, one
    collective for all of them; the backward reduce-scatters their
    gradients the same way (the transpose JAX derives for each leaf's
    ``all_gather``: ``psum_scatter``).  A leaf the step does not read
    gets a zero gradient (autograd materializes it), as in JAX."""

    @staticmethod
    def forward(ctx, data, dims, *xs):
        ctx.data, ctx.dims = data, dims
        return tuple(data.all_gather(list(xs), dims))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.data.reduce_scatter(list(grads), ctx.dims))


def zero_all_gather(tree: Pytree, gather_dims: Pytree, data) -> Pytree:
    """All-gather ZeRO-2 rest-sharded stage params on use (the JAX
    package's ``zero_all_gather``): ``gather_dims`` mirrors ``tree`` (a
    slot view ``[pad, ...]``) with the dim to gather over ``data`` (a
    :class:`~repro_torch.runtime.ring.DataGroup`), ``-1`` passing a
    replicated leaf through.  The rank walk calls it inside the steps it
    runs, so its recompute gathers again instead of keeping the whole
    rows, and the gradient comes back reduce-scattered to the shard.  The
    sharded leaves go in one collective, in ``tree``'s leaf order (the
    same on every data peer)."""
    sharded = [(x, d) for x, d in leaf_dims(tree, gather_dims) if d >= 0]
    if not sharded:
        return tree
    xs, dims = zip(*sharded)
    whole = iter(_ZeroGather.apply(data, list(dims), *xs))
    return tree_map(lambda x, d: x if d < 0 else next(whole), tree,
                    gather_dims)


class GatheredSlots:
    """A rank's ZeRO-2 slot stack ``[V, pad, ...]`` (shards) as the rows
    of one slot at a time: ``slots[v]`` all-gathers slot ``v``'s shards
    (:func:`zero_all_gather`) and unbinds them into ``pad`` row trees.
    The gather runs each time a slot is indexed, so index it inside the
    step that uses the rows."""

    def __init__(self, slots: list, dims: Pytree, data):
        self._slots, self._dims, self._data = slots, dims, data

    def __getitem__(self, v: int) -> list:
        return unbind_rows(zero_all_gather(self._slots[v], self._dims,
                                           self._data), 1)


def rank_slots(stack: Pytree, dims: Pytree, data) -> tuple:
    """A ZeRO-2 rank's ``[V, pad, ...]`` stack of shards -> ``(slots,
    finish)``: :class:`GatheredSlots` over fresh autograd leaves, one per
    slot and leaf, sharing the stack's storage, and ``finish()``, which
    adds the slots' (reduce-scattered) gradients, stacked, to the stack
    leaves' ``.grad`` (the :func:`rank_rows` of a sharded stack)."""
    slots = [tree_map(lambda x: x.detach().requires_grad_(), s)
             for s in unbind_rows(tree_map(lambda x: x.detach(), stack), 1)]

    def finish() -> None:
        for i, x in enumerate(tree_leaves(stack)):
            gs = [tree_leaves(s)[i] for s in slots]
            g = torch.stack([y.grad if y.grad is not None
                             else torch.zeros_like(y) for y in gs])
            x.grad = g if x.grad is None else x.grad + g

    return GatheredSlots(slots, dims, data), finish


def reduce_stage_grads(data, stacks: tuple, dims: tuple | None,
                       zero_stage: int) -> None:
    """Average a rank's stage-row gradients over its data replicas (the
    walk's loss roots carry the ``1/dp``, so this sums), one stack at a
    time: the leaves ZeRO keeps replicated (``dims`` -1, or every leaf
    when ``dims`` is None: below ZeRO-1) in one all-reduce; at ZeRO-1 the
    sharded leaves in one reduce-scatter, each ``.grad`` becoming the sum
    on the rank's own shard and zeros elsewhere (what its AdamW moments
    cover); at ZeRO-2 a sharded leaf's gradient came reduce-scattered from
    the gather's backward."""
    if data is None:
        return
    for i, stack in enumerate(stacks):
        whole, sharded = [], []
        for x, d in leaf_dims(stack, None if dims is None else dims[i]):
            if x.grad is None:
                x.grad = torch.zeros_like(x)
            if d < 0:
                whole.append(x.grad)
            elif zero_stage == 1:
                sharded.append((x.grad, d + 1))
        data.all_reduce_(whole)
        if sharded:
            gs, ds = zip(*sharded)
            parts = [[g.narrow(d, k * (g.shape[d] // data.size),
                               g.shape[d] // data.size)
                      for k in range(data.size)] for g, d in sharded]
            data.reduce_scatter(list(gs), list(ds),
                                out=[p[data.index] for p in parts])
            for p in parts:
                for k, part in enumerate(p):
                    if k != data.index:
                        part.zero_()


def finish_rank(cfg: "PipelineConfig", ring, data, zero_dims, local,
                dones, stacks: tuple, edge_p) -> torch.Tensor:
    """A rank walk's epilogue: each ``done()`` adds its rows' gradients to
    the stack leaves, the stage gradients are averaged over ``data``
    (:func:`reduce_stage_grads`), the edge gradients summed over the ring
    and ``data``; returns the loss reduced over both."""
    for done in dones:
        done()
    reduce_stage_grads(data, stacks, zero_dims, cfg.zero_stage)
    reduce_edge_grads(ring, [x for x in tree_leaves(edge_p)
                             if x.requires_grad], data)
    return reduce_loss(ring, local, data)


def _wrap_remat(fn: Callable, cfg: "PipelineConfig") -> Callable:
    """Recompute ``fn`` in the backward pass instead of keeping its
    activations (``jax.checkpoint`` in the JAX package)."""
    if not cfg.remat:
        return fn

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


# ===========================================================================
# Masked block loops (uneven-partition stages over padded stacks)
# ===========================================================================

def scan_blocks(block_fn: Callable, rows: list, x, count: int, *args):
    """``block_fn(bp, x, *args) -> x`` over rows ``[0, count)``."""
    for i in range(count):
        x = block_fn(rows[i], x, *args)
    return x


def scan_blocks_emit(block_fn: Callable, rows: list, x, count: int, *args):
    """``block_fn(bp, x, *args) -> (x, skip)`` over rows ``[0, count)``;
    returns ``(x, skips)`` with one skip per row of ``rows`` (``None`` on
    padded rows, which consumers never read)."""
    skips: list = [None] * len(rows)
    for i in range(count):
        x, skips[i] = block_fn(rows[i], x, *args)
    return x, skips


def scan_blocks_consume(block_fn: Callable, rows: list, skips: list, x,
                        count: int, skip_rows, *args):
    """``block_fn(bp, x, skip, *args)`` over rows ``[0, count)``; row i
    consumes ``skips[skip_rows[i]]`` (``-1`` = no skip: zeros are passed).

    ``skip_rows`` is the producer/consumer pairing the layout derived from
    the partition's skip edges (``StageLayout.skip_rows``), indexing the
    flat ``[V * enc_pad]`` stash view of the device's encoder slots.
    """
    for i in range(count):
        r = skip_rows[i]
        if r >= 0:
            skip = skips[r]
            if skip is None:
                raise ValueError(f"decoder row {i} reads stash row {r}, "
                                 "which no encoder row wrote")
        else:
            skip = torch.zeros_like(x)
        x = block_fn(rows[i], x, skip, *args)
    return x


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_devices: int            # D pipeline devices
    num_microbatches: int       # M
    remat: bool = True          # recompute each stage call in backward
    wire_dtype: str = "bfloat16"      # table executors' boundary-hop dtype
    #   (WIRE_DTYPES); the closed forms ignore it
    overlap: bool = True        # rank executors: post step t-1's hops at
    #   the top of step t and wait on an arrival only where a step reads it
    #   (the tables' exposed hops); False = the synchronous reference, hops
    #   posted and waited at the bottom of the producing step.  Values are
    #   bitwise equal either way; the one-process walks ignore it
    dp_size: int = 1            # data replicas, each a pipeline of ranks
    zero_stage: int = 0         # ZeRO over the data replicas: 0 = params,
    #   grads and AdamW moments whole on every replica (grads all-reduced);
    #   1 = a rank keeps the moments of its shard of its rows only (grads
    #   reduce-scattered, updated shards all-gathered back); 2 = the rows
    #   themselves rest sharded, all-gathered on use inside each step the
    #   rank walk runs (and again in its recompute), the gather's backward
    #   reduce-scattering the gradient.  The closed forms and the
    #   skip-carry baseline refuse stage 2 with dp_size > 1 (their rows
    #   rest whole)


def _zero_activation(embed_fn: Callable, *args) -> torch.Tensor:
    """Zeros shaped like the embedding (the payload of a tick that runs
    nothing), from one embedding without autograd."""
    with torch.no_grad():
        return torch.zeros_like(embed_fn(*args))


def _mean_loss(losses: list, M: int) -> torch.Tensor:
    if len(losses) != M:
        raise ValueError(f"the walk emitted {len(losses)} losses for M={M} "
                         "microbatches")
    return torch.stack(losses).sum() / M


# ===========================================================================
# Wave pipeline (PULSE)
# ===========================================================================

def make_wave_pipeline(
    cfg: PipelineConfig,
    *,
    embed_fn: Callable,       # (edge_p, mb, aux) -> tokens (b, n, d)
    enc_stage_fn: Callable,   # (rows, x, aux, device) -> (x_out, skips)
    dec_stage_fn: Callable,   # (rows, x, skips, aux, device) -> x_out
    loss_fn: Callable,        # (edge_p, x_final, mb, aux) -> scalar
    ring=None,                # runtime.ring.Ring: this rank's executor
    data=None,                # runtime.ring.DataGroup: its data replicas
    zero_dims=None,           # ZeRO-1 slot-view dims per stack leaf
) -> Callable:
    """``fn(enc_stack, dec_stack, edge_p, mbs, aux) -> loss``.

    - ``enc_stack``/``dec_stack``: ``[D, rows, ...]`` per-device stage
      params; ``dec_stack`` is ordered so index d = decoder stage 2D-1-d
      (the stage collocated with encoder stage d).
    - ``mbs``: ``[M, ...]`` microbatch inputs; ``aux``: ``[M, ...]``
      per-microbatch conditioning every stage sees (may be ``{}``).

    With ``ring`` it is rank ``ring.index``'s executor over its own
    ``[1, rows, ...]`` stacks (a rank plan's one slot), run as the rank
    walk of ``runtime.ring`` (see :func:`_wave_rank`); ``data`` and
    ``zero_dims`` as in :func:`make_skip_carry_pipeline` and the table
    executors.
    """
    D, M = cfg.num_devices, cfg.num_microbatches
    if M < D:
        # phase 2's turn/skip row arithmetic (t2 + D - 1, t2 - (D-1) + 2d)
        # stays within rows phase 1 produced only for M >= D
        raise ValueError(
            f"closed-form wave executor requires M >= D (got M={M}, "
            f"D={D}): its skip/turn row arithmetic reads stale rows for "
            "short iterations.  Lower through the table-driven executor "
            "(auto_pipeline(executor='table')) or raise num_microbatches.")
    T = M + D - 1
    if ring is not None:
        return _wave_rank(cfg, ring, data, zero_dims, embed_fn, enc_stage_fn,
                          dec_stage_fn, loss_fn)
    check_one_replica(cfg)
    enc_stage = _wrap_remat(enc_stage_fn, cfg)
    dec_stage = _wrap_remat(dec_stage_fn, cfg)

    def fn(enc_stack, dec_stack, edge_p, mbs, aux):
        enc_rows = unbind_rows(enc_stack, 2)
        dec_rows = unbind_rows(dec_stack, 2)
        zero_x = _zero_activation(embed_fn, edge_p, tree_index(mbs, 0),
                                  tree_index(aux, 0))
        # phase 1, encoder half, down the ring: device d runs microbatch
        # t - d at tick t and stashes its skips (and, on device D-1, the
        # turnaround output) under row t
        skip_ys = [[None] * T for _ in range(D)]
        turn_ys: list = [None] * T
        down_in: list = [None] * D
        for t in range(T):
            out, live = [zero_x] * D, [False] * D
            for d in range(D):
                m = t - d
                if not 0 <= m < M:
                    continue
                a = tree_index(aux, m)
                x_in = (embed_fn(edge_p, tree_index(mbs, m), a) if d == 0
                        else down_in[d])
                out[d], skip_ys[d][t] = enc_stage(enc_rows[d], x_in, a, d)
                live[d] = True
            turn_ys[t] = out[D - 1]
            down_in, _ = hop(out, None, up_used=False, wrap=False,
                             down_live=live)
        # phase 2, decoder half, up the ring: device d runs microbatch
        # m = t2 - (D-1-d); its stashed skip row is m + d = t2 - (D-1) + 2d
        losses = []
        up_in: list = [None] * D
        for t2 in range(T):
            out, live = [zero_x] * D, [False] * D
            for d in range(D):
                m = t2 - (D - 1 - d)
                if not 0 <= m < M:
                    continue
                a = tree_index(aux, m)
                x_in = turn_ys[t2 + D - 1] if d == D - 1 else up_in[d]
                skips = skip_ys[d][t2 - (D - 1) + 2 * d]
                out[d] = dec_stage(dec_rows[d], x_in, skips, a, d)
                live[d] = True
                if d == 0:
                    losses.append(loss_fn(edge_p, out[d],
                                          tree_index(mbs, m), a))
            _, up_in = hop(None, out, down_used=False, wrap=False,
                           up_live=live)
        return _mean_loss(losses, M)

    return fn


def _closed_form_rank(cfg: PipelineConfig, ring, data) -> tuple[int, int]:
    """``(dp, data index)`` of a closed-form rank, after its refusals: a
    ring of D ranks, a data group of ``dp_size`` members, and rows that
    rest whole (ZeRO-2 over data replicas is the table executors')."""
    D = cfg.num_devices
    if ring.size != D:
        raise ValueError(f"a {ring.size}-rank ring for a D={D} pipeline")
    if cfg.dp_size > 1 and cfg.zero_stage >= 2:
        raise ValueError(
            "closed-form executors keep stage stacks replicated over the "
            f"data replicas; zero_stage={cfg.zero_stage} shards them at "
            "rest -- lower through executor='table'")
    check_data_group(cfg, data)
    return cfg.dp_size, (0 if data is None else data.index)


def _wave_rank(cfg: PipelineConfig, ring, data, zero_dims,
               embed_fn: Callable, enc_stage: Callable, dec_stage: Callable,
               loss_fn: Callable) -> Callable:
    """Rank ``ring.index`` of the closed-form wave (see
    :func:`make_wave_pipeline`): 2T walk steps, phase 1's T ticks and then
    phase 2's, the same index arithmetic as the one-process walk.  Device
    d runs microbatch ``m = t - d`` at phase-1 tick t (embedding on device
    0, a send down from every device but D-1, whose output is the
    turnaround), and ``m = t2 - (D-1-d)`` at phase-2 tick t2 (a send up
    from every device but 0, which takes the loss).  The stash and the
    turnaround stay on the rank as outputs of the phase-1 step that made
    them: microbatch m's skips are those of step ``m + d``
    (``t2 - (D-1) + 2d``), device D-1's turnaround that of step
    ``m + D - 1``.  Every arrival is read at the step it arrives, so one
    receive slot a channel serves.  The stage functions run without
    ``_wrap_remat``: the rank walk recomputes whole steps itself."""
    D, M = cfg.num_devices, cfg.num_microbatches
    T = M + D - 1
    d = ring.index
    dp, di = _closed_form_rank(cfg, ring, data)

    def mb_at(s: int) -> int | None:
        """The microbatch device d runs at walk step s, or None."""
        m = s - d if s < T else (s - T) - (D - 1 - d)
        return m if 0 <= m < M else None

    def arrivals(s):
        if mb_at(s) is None:
            return []
        if s < T:
            return [(DOWN, 0)] if d > 0 else []
        return [(UP, 0)] if d < D - 1 else []

    def sends(s):
        if mb_at(s) is None:
            return []
        if s < T:
            return [DOWN] if d < D - 1 else []
        return [UP] if d > 0 else []

    def fn(enc_stack, dec_stack, edge_p, mbs, aux):
        mbs, aux = batch_shard(mbs, dp, di), batch_shard(aux, dp, di)
        enc_rows, enc_done = rank_rows(enc_stack, 2)
        dec_rows, dec_done = rank_rows(dec_stack, 2)
        enc_rows, dec_rows = enc_rows[0], dec_rows[0]     # the one slot
        zero_x = _zero_activation(embed_fn, edge_p, tree_index(mbs, 0),
                                  tree_index(aux, 0))
        spec = [(tuple(zero_x.shape), zero_x.dtype)]
        del zero_x
        stash: dict[int, list] = {}      # phase-1 step -> its skips
        turn: dict[int, Any] = {}        # phase-1 step -> device D-1's out
        rx: dict = {}

        def received(chan):
            pend, t_arr = rx[(chan, 0)]
            return pend.wait()[0], ("rx", chan, t_arr, 0)

        def encode(s, m):
            ins = {"x": received(DOWN)} if d > 0 else {}

            def step(x):
                a = tree_index(aux, m)
                x_in = (embed_fn(edge_p, tree_index(mbs, m), a) if d == 0
                        else x["x"])
                x_out, skips = enc_stage(enc_rows, x_in, a, d)
                out = {"send/0" if d < D - 1 else "turn": x_out}
                out.update((f"skip/{i}", y) for i, y in enumerate(skips)
                           if y is not None)
                return out

            def after(out):
                stash[s] = [out.get(f"skip/{i}")
                            for i in range(len(enc_rows))]
                if d == D - 1:
                    turn[s] = out["turn"]

            return StepPlan(ins, step, after)

        def decode(m):
            if d == D - 1:
                s_turn = m + D - 1
                ins = {"x": (turn[s_turn], ("out", s_turn, "turn"))}
            else:
                ins = {"x": received(UP)}
            s_enc = m + d                  # the step that stashed m's skips
            ins.update((f"skip/{i}", (y, ("out", s_enc, f"skip/{i}")))
                       for i, y in enumerate(stash[s_enc]) if y is not None)

            def step(x):
                a = tree_index(aux, m)
                skips = [x.get(f"skip/{i}") for i in range(len(enc_rows))]
                x_out = dec_stage(dec_rows, x["x"], skips, a, d)
                if d > 0:
                    return {"send/0": x_out}
                return {"loss": loss_fn(edge_p, x_out, tree_index(mbs, m),
                                        a)}

            return StepPlan(ins, step)

        def plan(s):
            m = mb_at(s)
            if m is None:
                return None
            return encode(s, m) if s < T else decode(m)

        local = rank_walk(ring, T=2 * T, M=M, remat=cfg.remat,
                          overlap=cfg.overlap, specs={DOWN: spec, UP: spec},
                          arrivals=arrivals, sends=sends, plan=plan, rx=rx,
                          dp=dp)
        return finish_rank(cfg, ring, data, zero_dims, local,
                           (enc_done, dec_done), (enc_stack, dec_stack),
                           edge_p)

    return fn


# ===========================================================================
# Linear pipeline (1F1B dataflow; skip-free models)
# ===========================================================================

def make_linear_pipeline(
    cfg: PipelineConfig,
    *,
    embed_fn: Callable,       # (edge_p, mb) -> x (b, s, d)
    stage_fn: Callable,       # (rows, x, device) -> x
    loss_fn: Callable,        # (edge_p, x_final, mb) -> scalar
    ring=None,                # runtime.ring.Ring: this rank's executor
    data=None,                # runtime.ring.DataGroup: its data replicas
    zero_dims=None,           # ZeRO-1 slot-view dims per stack leaf
) -> Callable:
    """``fn(stack, edge_p, mbs) -> loss`` over a ``[D, rows, ...]`` stack.
    S = D stages; embedding on device 0, head and loss on device D-1.
    With ``ring``: rank ``ring.index``'s executor over its ``[1, rows,
    ...]`` stack, as :func:`make_wave_pipeline`'s."""
    D, M = cfg.num_devices, cfg.num_microbatches
    T = M + D - 1
    if ring is not None:
        return _linear_rank(cfg, ring, data, zero_dims, embed_fn, stage_fn,
                            loss_fn)
    check_one_replica(cfg)
    stage = _wrap_remat(stage_fn, cfg)

    def fn(stack, edge_p, mbs):
        rows = unbind_rows(stack, 2)
        zero_x = _zero_activation(embed_fn, edge_p, tree_index(mbs, 0))
        losses = []
        h_in: list = [None] * D
        for t in range(T):
            out, live = [zero_x] * D, [False] * D
            for d in range(D):
                m = t - d
                if not 0 <= m < M:
                    continue
                mb = tree_index(mbs, m)
                x_in = embed_fn(edge_p, mb) if d == 0 else h_in[d]
                out[d] = stage(rows[d], x_in, d)
                live[d] = True
                if d == D - 1:
                    losses.append(loss_fn(edge_p, out[d], mb))
            h_in, _ = hop(out, None, up_used=False, wrap=False,
                          down_live=live)
        return _mean_loss(losses, M)

    return fn


def _linear_rank(cfg: PipelineConfig, ring, data, zero_dims,
                 embed_fn: Callable, stage: Callable,
                 loss_fn: Callable) -> Callable:
    """Rank ``ring.index`` of the closed-form linear walk (see
    :func:`make_linear_pipeline`): device d runs microbatch ``m = t - d``
    at tick t, receiving from d-1 and sending to d+1, down only."""
    D, M = cfg.num_devices, cfg.num_microbatches
    T = M + D - 1
    d = ring.index
    dp, di = _closed_form_rank(cfg, ring, data)

    def live(t: int) -> bool:
        return 0 <= t - d < M

    def fn(stack, edge_p, mbs):
        mbs = batch_shard(mbs, dp, di)
        rows, done = rank_rows(stack, 2)
        rows = rows[0]                                    # the one slot
        zero_x = _zero_activation(embed_fn, edge_p, tree_index(mbs, 0))
        spec = [(tuple(zero_x.shape), zero_x.dtype)]
        del zero_x
        rx: dict = {}

        def plan(t):
            if not live(t):
                return None
            m = t - d
            ins = {}
            if d > 0:
                pend, t_arr = rx[(DOWN, 0)]
                ins["x"] = (pend.wait()[0], ("rx", DOWN, t_arr, 0))

            def step(x):
                mb = tree_index(mbs, m)
                x_in = embed_fn(edge_p, mb) if d == 0 else x["x"]
                x_out = stage(rows, x_in, d)
                if d < D - 1:
                    return {"send/0": x_out}
                return {"loss": loss_fn(edge_p, x_out, mb)}

            return StepPlan(ins, step)

        local = rank_walk(
            ring, T=T, M=M, remat=cfg.remat, overlap=cfg.overlap,
            specs={DOWN: spec},
            arrivals=lambda t: ([(DOWN, 0)] if d > 0 and t < T and live(t)
                                else []),
            sends=lambda t: [DOWN] if d < D - 1 and live(t) else [],
            plan=plan, rx=rx, dp=dp)
        return finish_rank(cfg, ring, data, zero_dims, local, (done,),
                           (stack,), edge_p)

    return fn


# ===========================================================================
# Baseline: sequential partition with skip-carry payload (paper baseline)
# ===========================================================================

def make_skip_carry_pipeline(
    cfg: PipelineConfig,
    *,
    n_skip_slots: int,        # total skip tensors riding the payload
    embed_fn: Callable,
    enc_stage_fn: Callable,   # (rows, x, aux, device) -> (x, k skips)
    dec_stage_fn: Callable,   # (rows, x, skips, aux, device) -> x
    loss_fn: Callable,
    skips_per_stage: int,
    ring=None,                # runtime.ring.Ring: this rank's executor
    data=None,                # runtime.ring.DataGroup: its data replicas
) -> Callable:
    """Sequential block-wise partition of a skip model over D devices:
    the first D/2 devices run encoder stages, the last D/2 decoder stages,
    and every skip activation is carried in the hop payload
    ``(activation, skip stack of n_skip_slots)`` across all intermediate
    boundaries (stacked / transferred / popped -- §VII baselines; the
    paper's Fig. 3 communication blow-up).  Encoder device d writes stack
    rows ``d*k .. d*k+k-1``; decoder device d reads rows ``(D-1-d)*k ..``.

    ``fn(enc_stack, dec_stack, edge_p, mbs, aux) -> loss``; both stacks
    are padded to D rows (enc rows valid on devices < D/2, dec rows on
    the rest).  With ``ring`` it is rank ``ring.index``'s executor: the
    stacks are that device's rows (``[rows, ...]``), the whole payload
    crosses the ring where ``m = t - d`` is a microbatch, the backward is
    the rank walk of ``runtime.ring`` (the loss comes back summed over the
    group and the leaves' ``.grad`` filled).  With ``cfg.dp_size > 1``
    the rank also needs ``data``: it runs its data shard of each
    microbatch and averages the loss and every gradient over the replicas
    (all-reduced at ZeRO 0 and 1 alike, as the JAX executor's; stage 2
    is refused: the rows rest whole).
    """
    D, M = cfg.num_devices, cfg.num_microbatches
    assert D % 2 == 0, "skip-carry baseline assumes half enc / half dec"
    T = M + D - 1
    k = skips_per_stage

    def body(enc_stage, dec_stage, d, m, enc_rows_d, dec_rows_d, edge_p,
             mbs, aux, x_in, stack, dtype):
        """Device d's tick on microbatch m: ``(x_out, stack_out, loss)``
        (``x_in`` None on device 0, which embeds)."""
        a = tree_index(aux, m)
        if d == 0:
            x_in = embed_fn(edge_p, tree_index(mbs, m), a)
        if d < D // 2:
            # encoder: push k skips at rows d*k ..
            x_out, skips = enc_stage(enc_rows_d, x_in, a, d)
            stack = list(stack)
            stack[d * k:(d + 1) * k] = [s.to(dtype) for s in skips]
        else:
            # decoder: read this stage's k skips (dec_stage_fn reverses
            # them); the stack rides on unchanged
            row = (D - 1 - d) * k
            x_out = dec_stage(dec_rows_d, x_in, stack[row:row + k], a, d)
        loss = (loss_fn(edge_p, x_out, tree_index(mbs, m), a)
                if d == D - 1 else None)
        return x_out, stack, loss

    if cfg.dp_size > 1 and cfg.zero_stage >= 2:
        raise ValueError(
            "the skip-carry baseline keeps its stage rows whole on every "
            f"data replica; zero_stage={cfg.zero_stage} shards them at rest "
            "-- lower the plan through the table executor")
    if ring is not None:
        return _skip_carry_rank(cfg, ring, data, body, enc_stage_fn,
                                dec_stage_fn, embed_fn, n_skip_slots)
    check_one_replica(cfg)
    enc_stage = _wrap_remat(enc_stage_fn, cfg)
    dec_stage = _wrap_remat(dec_stage_fn, cfg)

    def fn(enc_stack, dec_stack, edge_p, mbs, aux):
        enc_rows = unbind_rows(enc_stack, 2)
        dec_rows = unbind_rows(dec_stack, 2)
        zero_x = _zero_activation(embed_fn, edge_p, tree_index(mbs, 0),
                                  tree_index(aux, 0))
        zero_stack = [zero_x] * n_skip_slots
        losses = []
        recv: list = [None] * D
        for t in range(T):
            out, live = [(zero_x, zero_stack)] * D, [False] * D
            for d in range(D):
                m = t - d
                if not 0 <= m < M:
                    continue
                x_in, stack = recv[d] if d else (None, zero_stack)
                x_out, stack, loss = body(enc_stage, dec_stage, d, m,
                                          enc_rows[d], dec_rows[d], edge_p,
                                          mbs, aux, x_in, stack, zero_x.dtype)
                out[d], live[d] = (x_out, stack), True
                if loss is not None:
                    losses.append(loss)
            # the whole (activation, skip-stack) payload crosses the boundary
            recv, _ = hop(out, None, up_used=False, wrap=False,
                          down_live=live)
        return _mean_loss(losses, M)

    return fn


def check_one_replica(cfg: PipelineConfig) -> None:
    """The one-process executors run one pipeline replica; data replicas
    run as ranks, one process per (data, pipeline) grid point."""
    if cfg.dp_size > 1:
        raise ValueError(
            f"dp_size={cfg.dp_size}: the port runs data replicas as ranks, "
            "one process per (data, pipeline) index -- build a rank's plan "
            "(for_rank(pipe, data)) with its ring and data group, e.g. "
            "under torchrun")


def check_data_group(cfg: PipelineConfig, data) -> None:
    """A rank of a plan with ``cfg.dp_size`` data replicas needs a data
    group of that size (and a one-replica plan none)."""
    size = 1 if data is None else data.size
    if size != cfg.dp_size:
        raise ValueError(f"a plan of {cfg.dp_size} data replicas needs a "
                         f"data group of that size; got {size}")


def _skip_carry_rank(cfg: PipelineConfig, ring, data, body: Callable,
                     enc_stage: Callable, dec_stage: Callable,
                     embed_fn: Callable, n_skip_slots: int) -> Callable:
    """Rank ``ring.index`` of the skip-carry baseline (see
    :func:`make_skip_carry_pipeline`); the stage functions run without
    ``_wrap_remat``: the rank walk recomputes whole steps itself."""
    D, M = cfg.num_devices, cfg.num_microbatches
    d = ring.index
    if ring.size != D:
        raise ValueError(f"a {ring.size}-rank ring for a D={D} pipeline")
    check_data_group(cfg, data)
    dp, di = cfg.dp_size, (0 if data is None else data.index)
    T = M + D - 1
    n = 1 + n_skip_slots

    def live(t: int) -> bool:
        return 0 <= t - d < M

    def fn(enc_stack, dec_stack, edge_p, mbs, aux):
        mbs, aux = batch_shard(mbs, dp, di), batch_shard(aux, dp, di)
        enc_rows, enc_done = rank_rows(enc_stack, 1)
        dec_rows, dec_done = rank_rows(dec_stack, 1)
        zero_x = _zero_activation(embed_fn, edge_p, tree_index(mbs, 0),
                                  tree_index(aux, 0))
        zero_stack = [zero_x] * n_skip_slots
        spec = (tuple(zero_x.shape), zero_x.dtype)
        rx: dict = {}

        def arrivals(t):
            return [(DOWN, 0)] if d > 0 and t < T and live(t) else []

        def sends(t):
            return [DOWN] if d < D - 1 and live(t) else []

        def plan(t):
            if not live(t):
                return None
            m = t - d
            ins = {}
            if d > 0:
                pend, t_arr = rx[(DOWN, 0)]
                for j, x in enumerate(pend.wait()):
                    ins[f"in/{j}"] = (x, ("rx", DOWN, t_arr, j))

            def step(x):
                x_in, stack = ((x["in/0"], [x[f"in/{j}"] for j in range(1, n)])
                               if d else (None, zero_stack))
                x_out, stack, loss = body(enc_stage, dec_stage, d, m,
                                          enc_rows, dec_rows, edge_p, mbs,
                                          aux, x_in, stack, zero_x.dtype)
                out = ({f"send/{j}": y for j, y in enumerate([x_out, *stack])}
                       if d < D - 1 else {})
                if loss is not None:
                    out["loss"] = loss
                return out

            return StepPlan(ins, step)

        local = rank_walk(ring, T=T, M=M, remat=cfg.remat,
                          overlap=cfg.overlap, specs={DOWN: [spec] * n},
                          arrivals=arrivals, sends=sends, plan=plan, rx=rx,
                          dp=dp)
        return finish_rank(cfg, ring, data, None, local,
                           (enc_done, dec_done), (enc_stack, dec_stack),
                           edge_p)

    return fn
