"""The pipeline ring over a process group, and the rank walk that runs one
pipeline device per process and differentiates it by walking its steps
back (the multi-process counterpart of the JAX package's ``ppermute``
hops, ``repro/runtime/schedule_exec.py``, and of the transposed
``lax.scan`` that differentiates them).

:class:`Ring` is one rank's view of the ring: it sends and receives with
``dist.batch_isend_irecv`` to its down (``index + 1``) and up
(``index - 1``) neighbours, closed at both ends as ``ring_perms(D,
wrap=True)`` closes the table executors' rings.  It moves only the
messages its caller posts -- the executors post the ones their step tables
(or, for the skip-carry baseline, its index arithmetic) flag, and both ends
read the same tables, so they agree without a message -- and counts the
bytes it sends and receives, forward and backward apart: the live bytes,
where the JAX package's HLO count (``hlo_analysis.collective_bytes``) also
counts the zeros of quiescent hops.

Backends (anything else raises):

- NCCL: each rank owns a card; two ranks on one card are refused (NCCL
  itself refuses them at its first collective, "Duplicate GPU detected").
- gloo with CPU tensors (the tests' case).
- gloo with CUDA tensors, ``staged=True``: every payload goes through a
  pinned host buffer (one per channel and message slot, reused), the one
  card's case; chosen by the caller, never a silent stand-in for NCCL.

:func:`rank_walk` drives one rank's forward steps and then walks them back
(t = T-1 ... 0).  A step's inputs -- the arrivals, the stash and turn
entries it reads -- are autograd leaves and its outputs -- its sends, its
stash and turn writes, its loss -- are roots.  A root's gradient is the
cotangent its receiver sent back, the sum of what later steps' leaves of
it collected, or ``1/M`` for a loss; after step t's backward each arrival's
gradient goes back to its sender over the reversed ring, in the wire dtype
it came in.  Every op is back-propagated once: with ``remat`` a step runs
without autograd and is recomputed under it in the backward (the step's
inputs are all it keeps); without, each step's graph is kept.

``torch.distributed`` is imported inside the functions that need it.
"""
from __future__ import annotations

import dataclasses
import socket
from typing import Callable

import torch

# channels: the down and up rings, and the cotangents each carries back.  A
# channel fixes the peer a rank sends to and receives from and is the gloo
# tag; NCCL matches a pair's messages in the order they are posted, which
# both ends take from the same tables.
DOWN, UP, DOWN_GRAD, UP_GRAD = 0, 1, 2, 3
GRAD_OF = {DOWN: DOWN_GRAD, UP: UP_GRAD}
_TO_NEXT = (DOWN, UP_GRAD)          # the others go to index - 1


def _dist():
    import torch.distributed as dist
    return dist


def card_key(device: torch.device) -> str:
    """The card a CUDA device is: host name and the card's UUID."""
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def refuse_shared_cards(group, key: str) -> None:
    """Raise on every rank of ``group`` if two of them name the same card
    (``key``, e.g. :func:`card_key`).  The keys travel over gloo (a side
    group for an NCCL ``group``), so no NCCL communicator is needed to
    find out.
    """
    dist = _dist()
    if str(dist.get_backend(group)).lower() != "gloo":
        group = dist.new_group(dist.get_process_group_ranks(group),
                               backend="gloo",
                               use_local_synchronization=True)
    keys = [None] * dist.get_world_size(group)
    dist.all_gather_object(keys, key, group=group)
    seen: dict[str, int] = {}
    for i, k in enumerate(keys):
        if k in seen:
            raise RuntimeError(
                f"NCCL ranks {seen[k]} and {i} of the pipeline group share "
                f"the card {k}: NCCL refuses two ranks on one device "
                "(ncclInvalidUsage, 'Duplicate GPU detected'); give each "
                "rank its own card, or run the one-card ring with gloo "
                "(--ring gloo, staged through host memory)")
        seen[k] = i


class Pending:
    """A posted receive: :meth:`wait` returns the message's tensors on the
    ring's device (a staged message is copied there from its pinned
    buffers), waiting for it the first time."""

    def __init__(self, works: list, tensors: list, device):
        self._works = works
        self._tensors = tensors
        self._device = device
        self._out = None

    def wait(self) -> list[torch.Tensor]:
        if self._out is None:
            for w in self._works:
                w.wait()
            self._out = [x.to(self._device) if x.device != self._device
                         else x for x in self._tensors]
            self._works = self._tensors = None
        return self._out


class Ring:
    """Rank ``index`` of a ``size``-device pipeline ring over ``group``
    (whose ranks, in group order, are the pipeline indices).  ``device``
    is where the payloads live; ``staged`` routes CUDA payloads over gloo
    through pinned host buffers.  ``bytes`` counts what this rank sent and
    received, by pass (``"fwd"``, ``"bwd"``) and direction."""

    def __init__(self, group, index: int, size: int, device, *,
                 staged: bool = False):
        dist = _dist()
        self.group, self.index, self.size = group, index, size
        self.device = torch.device(device)
        self.staged = staged
        self.backend = str(dist.get_backend(group)).lower()
        ranks = dist.get_process_group_ranks(group)
        if len(ranks) != size or dist.get_rank(group) != index:
            raise ValueError(
                f"ring index {index} of {size} does not match the group: "
                f"rank {dist.get_rank(group)} of {len(ranks)}")
        self._global = ranks
        cuda = self.device.type == "cuda"
        if self.backend == "nccl":
            if not cuda or staged:
                raise ValueError(
                    "an NCCL ring moves CUDA payloads unstaged; got device "
                    f"{self.device}, staged={staged}")
            refuse_shared_cards(group, card_key(self.device))
        elif self.backend == "gloo":
            if cuda and not staged:
                raise ValueError(
                    "a gloo ring moves CPU tensors; CUDA payloads over gloo "
                    "need staged=True (pinned host buffers, the one-card "
                    "case), and several cards need NCCL")
            if staged and not cuda:
                raise ValueError("staged=True stages CUDA payloads; this "
                                 f"ring's device is {self.device}")
        else:
            raise ValueError(f"no ring over the {self.backend!r} backend "
                             "(NCCL, or gloo)")
        self.bytes = {p: {"sent": 0, "received": 0} for p in ("fwd", "bwd")}
        self._bufs: dict[tuple, torch.Tensor] = {}
        self._send_works: dict[int, list] = {}

    # ---- neighbours ------------------------------------------------------
    def peer(self, chan: int, sending: bool) -> int:
        """The global rank a message on ``chan`` goes to (``sending``) or
        comes from."""
        up = (chan in _TO_NEXT) == sending
        return self._global[(self.index + (1 if up else -1)) % self.size]

    def reset_bytes(self) -> None:
        for p in self.bytes.values():
            for k in p:
                p[k] = 0

    def _buf(self, key: tuple, like_shape, dtype) -> torch.Tensor:
        buf = self._bufs.get(key)
        if buf is None or buf.shape != torch.Size(like_shape) \
                or buf.dtype != dtype:
            buf = torch.empty(like_shape, dtype=dtype, pin_memory=True)
            self._bufs[key] = buf
        return buf

    def exchange(self, sends: list, recvs: list) -> list[Pending]:
        """Post one batch: ``sends`` is ``[(chan, tensors)]``, ``recvs``
        ``[(chan, specs, slot)]`` with ``specs`` the ``(shape, dtype)`` of
        each tensor of the message and ``slot`` the receive buffer it goes
        to (the staging key of a message still in flight).  Returns one
        :class:`Pending` per receive, in order."""
        dist = _dist()
        ops, send_idx, recv_meta = [], [], []
        for chan, tensors in sends:
            phase = "fwd" if chan in GRAD_OF else "bwd"
            if self.staged:
                for w in self._send_works.pop(chan, ()):
                    w.wait()          # the staging buffers are free again
            for j, x in enumerate(tensors):
                if x.device.type == "cuda" and not self.staged \
                        and self.backend != "nccl":
                    raise ValueError("CUDA payload on an unstaged gloo ring")
                x = x.contiguous()
                if self.staged:
                    buf = self._buf(("send", chan, j), x.shape, x.dtype)
                    buf.copy_(x)
                    x = buf
                self.bytes[phase]["sent"] += x.numel() * x.element_size()
                send_idx.append((len(ops), chan))
                ops.append(dist.P2POp(dist.isend, x, self.peer(chan, True),
                                      self.group, tag=chan))
        for chan, specs, slot in recvs:
            phase = "fwd" if chan in GRAD_OF else "bwd"
            tensors, first = [], len(ops)
            for j, (shape, dtype) in enumerate(specs):
                if self.staged:
                    x = self._buf(("recv", chan, slot, j), shape, dtype)
                else:
                    x = torch.empty(shape, dtype=dtype, device=self.device)
                self.bytes[phase]["received"] += x.numel() * x.element_size()
                tensors.append(x)
                ops.append(dist.P2POp(dist.irecv, x, self.peer(chan, False),
                                      self.group, tag=chan))
            recv_meta.append((first, len(ops), tensors))
        if not ops:
            return []
        works = dist.batch_isend_irecv(ops)
        per_op = len(works) == len(ops)   # gloo: one work an op; NCCL: one
        for i, chan in send_idx:
            self._send_works.setdefault(chan, []).append(
                works[i] if per_op else works[0])
        return [Pending(works[lo:hi] if per_op else list(works), tensors,
                        self.device)
                for lo, hi, tensors in recv_meta]

    def flush(self) -> None:
        """Wait for every send still in flight."""
        for works in self._send_works.values():
            for w in works:
                w.wait()
        self._send_works.clear()

    def all_reduce_(self, tensors: list[torch.Tensor]) -> None:
        """Sum ``tensors`` over the group, in place, in fp32 (one flat
        buffer; through the host on a staged ring)."""
        if not tensors:
            return
        dist = _dist()
        flat = torch.cat([x.reshape(-1).float() for x in tensors])
        wire = flat.cpu() if self.staged else flat
        dist.all_reduce(wire, group=self.group)
        if wire is not flat:
            flat.copy_(wire)
        off = 0
        for x in tensors:
            n = x.numel()
            x.copy_(flat[off:off + n].view_as(x))
            off += n


# ===========================================================================
# The rank walk: forward steps, then the explicit reverse walk
# ===========================================================================

class Tape:
    """The forward steps of one rank, kept for the reverse walk.  With
    ``remat`` a step runs without autograd and keeps only its inputs; its
    backward recomputes it under autograd.  Without, the step's graph is
    kept.  Either way each op is back-propagated exactly once."""

    def __init__(self, remat: bool):
        self.remat = remat
        self._steps: dict[int, tuple] = {}

    def forward(self, t: int, fn: Callable, inputs: dict) -> dict:
        if self.remat:
            with torch.no_grad():
                out = fn(inputs)
            self._steps[t] = (fn, inputs, None)
            return out
        leaves = {k: v.detach().requires_grad_() for k, v in inputs.items()}
        out = fn(leaves)
        self._steps[t] = (fn, leaves, out)
        return {k: v.detach() for k, v in out.items()}

    def backward(self, t: int, grads: dict) -> dict:
        """Back-propagate step t's roots with ``grads`` (absent or None:
        no gradient); returns each input leaf's gradient (None if none)."""
        fn, inputs, out = self._steps.pop(t)
        if out is None:
            leaves = {k: v.detach().requires_grad_()
                      for k, v in inputs.items()}
            with torch.enable_grad():
                out = fn(leaves)
        else:
            leaves = inputs
        roots, cots = [], []
        for k, g in grads.items():
            r = out.get(k)
            if g is None or r is None or not r.requires_grad:
                continue
            roots.append(r)
            cots.append(g.to(r.dtype))
        if roots:
            torch.autograd.backward(roots, cots)
        return {k: v.grad for k, v in leaves.items()}


@dataclasses.dataclass
class StepPlan:
    """What one forward step of a rank does.  ``inputs`` maps each input
    key to ``(tensor, source)``: ``("rx", chan, t_arrival, j)`` for tensor
    j of a ring arrival, ``("out", t_producer, key)`` for an output of an
    earlier step of this rank (a stash or turn entry).  ``fn(inputs) ->
    outputs``: ``"send/<j>"`` are the message's tensors (sent on every
    channel of ``sends(t)``), ``"loss"`` the microbatch loss, any other
    key a local output a later step reads.  ``after(outputs)`` stores the
    local outputs."""

    inputs: dict
    fn: Callable
    after: Callable = lambda outputs: None


def rank_walk(ring: Ring, *, T: int, M: int, remat: bool, overlap: bool,
              specs: dict, arrivals: Callable, sends: Callable,
              plan: Callable, rx: dict) -> torch.Tensor:
    """Run a rank's T forward steps and walk them back.

    ``arrivals(t)`` lists the ``(chan, slot)`` messages stored at the
    start of step t (what the senders' step t-1 sent); ``sends(t)`` the
    channels step t's message goes out on; ``plan(t)`` gives the step's
    :class:`StepPlan` (or None: an idle step); ``specs[chan]`` the
    ``(shape, dtype)`` of a message's tensors.  The walk stores each posted
    arrival in ``rx[(chan, slot)] = (Pending, t)``; ``plan`` reads them
    from there.  With ``overlap`` step t-1's sends and step t's
    receives are posted at the top of step t and an arrival is waited on
    when a step reads it (the tables' exposed hops are those read at
    once); without, they are posted and waited at the bottom of step t-1.
    The backward places its hops the same way.  Returns the sum of the
    rank's losses over ``M`` (not yet reduced over the group); every
    parameter leaf the steps read has its gradient accumulated."""
    tape = Tape(remat)
    srcs: dict[int, dict] = {}
    losses: list = []
    loss_steps: list[int] = []

    def post(out_msgs, t_arr):
        recvs = [(chan, specs[chan], slot) for chan, slot in arrivals(t_arr)]
        got = ring.exchange(out_msgs, recvs)
        for (chan, slot), p in zip(arrivals(t_arr), got):
            rx[(chan, slot)] = (p, t_arr)
        return got

    pending: list = []
    for t in range(T):
        if overlap:
            post(pending, t)
            pending = []
        step = plan(t)
        if step is None:
            if sends(t):
                raise RuntimeError(f"idle step {t} of rank {ring.index} "
                                   f"sends on {sends(t)}")
        else:
            ins = {k: v for k, (v, _) in step.inputs.items()}
            out = tape.forward(t, step.fn, ins)
            srcs[t] = {k: s for k, (_, s) in step.inputs.items()}
            step.after(out)
            if "loss" in out:
                losses.append(out["loss"])
                loss_steps.append(t)
            msg = [out[f"send/{j}"] for j in range(len(
                [k for k in out if k.startswith("send/")]))]
            pending += [(chan, msg) for chan in sends(t)]
        if not overlap:
            for p in post(pending, t + 1):
                p.wait()
            pending = []
    if pending:
        raise RuntimeError(f"rank {ring.index}: the last step sends")

    # ---- the reverse walk --------------------------------------------------
    roots: dict[int, dict] = {t: {} for t in srcs}
    for t in loss_steps:
        roots[t]["loss"] = torch.full((), 1.0 / M, dtype=torch.float32,
                                      device=ring.device)
    rx_grads: dict[tuple, dict] = {}

    def add(d: dict, k, g):
        d[k] = g if d.get(k) is None else d[k] + g

    def post_back(cot_msgs, t_send):
        """Cotangent sends, and the receives of step ``t_send``'s sends'
        cotangents (added to its roots)."""
        recvs = [(GRAD_OF[chan], specs[chan], 0) for chan in sends(t_send)]
        got = ring.exchange(cot_msgs, recvs)
        for p in got:
            for j, g in enumerate(p.wait()):
                add(roots[t_send], f"send/{j}", g)

    def cotangents(t_arr):
        out = []
        for chan, _ in arrivals(t_arr):
            gs = rx_grads.pop((chan, t_arr), {})
            out.append((GRAD_OF[chan], [
                gs[j] if gs.get(j) is not None
                else torch.zeros(shape, dtype=dtype, device=ring.device)
                for j, (shape, dtype) in enumerate(specs[chan])]))
        return out

    cot: list = []                   # the last step sends nothing
    for t in reversed(range(T)):
        if overlap:
            post_back(cot, t)
        if t in srcs:
            grads = tape.backward(t, roots.pop(t))
            for k, src in srcs.pop(t).items():
                g = grads.get(k)
                if g is None:
                    continue
                if src[0] == "rx":
                    _, chan, t_arr, j = src
                    add(rx_grads.setdefault((chan, t_arr), {}), j, g)
                else:
                    _, t_prod, key = src
                    add(roots[t_prod], key, g)
        cot = cotangents(t)
        if not overlap:
            if t > 0:
                post_back(cot, t - 1)
            else:
                ring.exchange(cot, [])
            cot = []
    if overlap and cot:
        ring.exchange(cot, [])
    ring.flush()
    if rx_grads:
        raise RuntimeError(f"rank {ring.index}: cotangents of arrivals "
                           f"{sorted(rx_grads)} were never sent back")
    if not losses:
        return torch.zeros((), dtype=torch.float32, device=ring.device)
    return torch.stack([x.float() for x in losses]).sum() / M


def reduce_loss(ring: Ring, local: torch.Tensor) -> torch.Tensor:
    """The walk's loss summed over the group: every rank returns the same
    value (the ``psum`` of the JAX executors)."""
    total = local.detach().float().clone()
    ring.all_reduce_([total])
    return total


def reduce_edge_grads(ring: Ring, leaves: list) -> None:
    """Sum the gradients of the parameters every rank holds a copy of (the
    edge params) over the group -- the transpose of the JAX executors'
    replicated inputs -- and give every leaf a gradient (zeros where none
    of the ranks read it)."""
    grads = []
    for x in leaves:
        if x.grad is None:
            x.grad = torch.zeros_like(x)
        grads.append(x.grad)
    ring.all_reduce_(grads)
