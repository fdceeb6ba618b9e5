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
import math
import socket
import time
from typing import Callable

import torch

# channels: the down and up rings, and the cotangents each carries back.  A
# channel fixes the peer a rank sends to and receives from and is the gloo
# tag; NCCL matches a pair's messages in the order they are posted, which
# both ends take from the same tables.
DOWN, UP, DOWN_GRAD, UP_GRAD = 0, 1, 2, 3
GRAD_OF = {DOWN: DOWN_GRAD, UP: UP_GRAD}
_TO_NEXT = (DOWN, UP_GRAD)          # the others go to index - 1


# the largest message of a chunked transfer (``GroupView.send_chunked``): a
# staging buffer's size, however large the tensor moved
CHUNK_BYTES = 64 << 20


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


class GroupView:
    """Rank ``index`` of a ``size``-rank process ``group``, whose payloads
    live on ``device``: what the pipeline ring and the data group share.
    Backends (anything else raises): NCCL with CUDA tensors; gloo with CPU
    tensors; gloo with CUDA tensors ``staged`` through pinned host buffers
    (the one-card case), chosen by the caller, never a silent stand-in for
    NCCL.  :meth:`all_reduce_` sums in fp32, in one flat buffer;
    ``_count`` is the hook a subclass counts its collectives with.
    :meth:`send_chunked` and :meth:`recv_chunked` move one tensor between
    two members in messages of at most :data:`CHUNK_BYTES` (a
    checkpoint's gather, over the whole world)."""

    what = "group"

    def __init__(self, group, index: int, size: int, device, *,
                 staged: bool = False):
        dist = _dist()
        self.group, self.index, self.size = group, index, size
        self.device = torch.device(device)
        self.staged = staged
        self.backend = str(dist.get_backend(group)).lower()
        self._global = dist.get_process_group_ranks(group)
        if len(self._global) != size or dist.get_rank(group) != index:
            raise ValueError(
                f"{self.what} index {index} of {size} does not match the "
                f"group: rank {dist.get_rank(group)} of {len(self._global)}")
        cuda = self.device.type == "cuda"
        if self.backend == "nccl":
            if not cuda or staged:
                raise ValueError(
                    f"an NCCL {self.what} moves CUDA tensors unstaged; got "
                    f"device {self.device}, staged={staged}")
        elif self.backend == "gloo":
            if cuda and not staged:
                raise ValueError(
                    f"a gloo {self.what} moves CPU tensors; CUDA tensors "
                    "over gloo need staged=True (pinned host buffers, the "
                    "one-card case), and several cards need NCCL")
            if staged and not cuda:
                raise ValueError(f"staged=True stages CUDA payloads; this "
                                 f"{self.what}'s device is {self.device}")
        else:
            raise ValueError(f"no {self.what} over the {self.backend!r} "
                             "backend (NCCL, or gloo)")
        self._bufs: dict = {}

    def _count(self, kind: str, nbytes: int, t0: float) -> None:
        """Record one collective (``time.perf_counter()`` at its start)."""

    def _empty(self, shape, dtype, key) -> torch.Tensor:
        """A tensor of ``shape`` the backend reads and writes: on the
        group's device, or a view of ``key``'s pinned host buffer (one a
        key, grown to the largest call's bytes and reused; a buffer still
        in flight needs a key of its own)."""
        if not self.staged:
            return torch.empty(shape, dtype=dtype, device=self.device)
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            self._bufs[key] = buf
        return buf[:n].view(dtype).view(shape)

    def all_reduce_(self, tensors: list[torch.Tensor]) -> None:
        """Sum ``tensors`` over the group, in place, in fp32: one
        collective over one flat buffer (pinned on a staged group), each
        tensor cast back to its dtype on its device."""
        if not tensors:
            return
        t0 = time.perf_counter()
        flat = self._empty((sum(x.numel() for x in tensors),),
                           torch.float32, "all_reduce")
        off = 0
        for x in tensors:
            flat[off:off + x.numel()].view(x.shape).copy_(x.detach())
            off += x.numel()
        _dist().all_reduce(flat, group=self.group)
        off = 0
        for x in tensors:
            x.copy_(flat[off:off + x.numel()].view(x.shape))
            off += x.numel()
        self._count("all_reduce", 4 * flat.numel(), t0)

    def send_chunked(self, x: torch.Tensor, dst: int) -> int:
        """Send ``x``'s bytes to group index ``dst`` in messages of at most
        :data:`CHUNK_BYTES`, each waited on (staged: through one pinned
        buffer of that size, however large ``x``).  Returns the bytes."""
        dist = _dist()
        flat = x.detach().contiguous().reshape(-1).view(torch.uint8)
        for lo in range(0, flat.numel(), CHUNK_BYTES):
            c = flat[lo:lo + CHUNK_BYTES]
            if self.staged:
                buf = self._empty(c.shape, torch.uint8, "chunk_send")
                buf.copy_(c)
                c = buf
            elif self.backend == "gloo" and c.device.type != "cpu":
                raise ValueError(f"CUDA payload on an unstaged gloo "
                                 f"{self.what}")
            dist.send(c, self._global[dst], group=self.group)
        return flat.numel()

    def recv_chunked(self, out: torch.Tensor, src: int) -> int:
        """Receive what :meth:`send_chunked` sends from group index
        ``src`` into ``out``, a contiguous tensor on the host (over NCCL
        each message lands in one buffer on the group's device first).
        Returns the bytes."""
        dist = _dist()
        if out.device.type != "cpu" or not out.is_contiguous():
            raise ValueError("recv_chunked fills a contiguous host tensor")
        flat = out.reshape(-1).view(torch.uint8)
        buf = (torch.empty(min(CHUNK_BYTES, flat.numel()), dtype=torch.uint8,
                           device=self.device)
               if self.backend == "nccl" else None)
        for lo in range(0, flat.numel(), CHUNK_BYTES):
            c = flat[lo:lo + CHUNK_BYTES]
            if buf is None:
                dist.recv(c, self._global[src], group=self.group)
            else:
                dist.recv(buf[:c.numel()], self._global[src],
                          group=self.group)
                c.copy_(buf[:c.numel()])
        return flat.numel()


class Ring(GroupView):
    """Rank ``index`` of a ``size``-device pipeline ring over ``group``
    (whose ranks, in group order, are the pipeline indices).  ``device``
    is where the payloads live; ``staged`` routes CUDA payloads over gloo
    through pinned host buffers.  ``bytes`` counts what this rank sent and
    received, by pass (``"fwd"``, ``"bwd"``) and direction.  NCCL ranks
    that share a card are refused here, before any NCCL call."""

    what = "ring"

    def __init__(self, group, index: int, size: int, device, *,
                 staged: bool = False):
        super().__init__(group, index, size, device, staged=staged)
        if self.backend == "nccl":
            refuse_shared_cards(group, card_key(self.device))
        self.bytes = {p: {"sent": 0, "received": 0} for p in ("fwd", "bwd")}
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
                    buf = self._empty(x.shape, x.dtype, ("send", chan, j))
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
                x = self._empty(shape, dtype, ("recv", chan, slot, j))
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


# ===========================================================================
# The data group: collectives between the data replicas of a pipeline index
# ===========================================================================

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter")


class DataGroup(GroupView):
    """Rank ``index`` of the ``size`` data replicas of one pipeline index
    (the rank grid's ``data_group``): the all-reduce, all-gather and
    reduce-scatter that data parallelism and ZeRO need, beside the ring's
    point-to-point hops.  Backends as :class:`GroupView`'s: NCCL uses
    ``all_reduce``, ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor``; gloo uses ``all_reduce`` and, for the
    gathers and scatters, point-to-point sends: an all-gather sends the
    rank's shard to every peer; a reduce-scatter sends each part to the
    rank that owns it, in the tensors' own dtype, and the owner sums the
    group's parts in fp32.  Gloo's own ``all_gather`` and
    ``reduce_scatter`` (or an all-reduce keeping the shard) take a byte
    several times as long (``tools/time_gloo.py`` times each).

    Reductions sum in fp32 whatever the tensor's dtype and give the
    tensor's dtype back; gathers move the tensor's bytes as they are.
    ``bytes[kind]`` counts, per call, the whole tensor the collective
    handles in the dtype it travels in: the all-reduced tensor (fp32),
    the all-gather's output, the reduce-scatter's input (fp32 over NCCL,
    the tensors' dtype over gloo); ``calls[kind]`` the calls;
    ``seconds[kind]`` the host clock's seconds inside them (staging copies
    included; the whole collective on gloo, which returns when it is done,
    and only its enqueueing on NCCL).  A collective that fails raises;
    nothing falls back.

    Every data peer of a pipeline index runs the same step tables, so the
    peers issue their collectives in the same order without a message;
    the callers rely on it."""

    what = "data group"

    def __init__(self, group, index: int, size: int, device, *,
                 staged: bool = False):
        super().__init__(group, index, size, device, staged=staged)
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.calls = dict.fromkeys(COLLECTIVES, 0)
        self.seconds = dict.fromkeys(COLLECTIVES, 0.0)

    def describe(self) -> str:
        return (f"data index {self.index} of {self.size} ({self.backend}"
                + (", staged" if self.staged else "") + ")")

    def reset_bytes(self) -> None:
        for d in (self.bytes, self.calls, self.seconds):
            for k in d:
                d[k] = 0

    def _count(self, kind: str, nbytes: int, t0: float) -> None:
        self.bytes[kind] += nbytes
        self.calls[kind] += 1
        self.seconds[kind] += time.perf_counter() - t0

    def _peers(self) -> list[int]:
        return [i for i in range(self.size) if i != self.index]

    def _p2p(self, sends: dict, recvs: dict) -> None:
        """Send ``sends[i]`` to data index ``i`` and receive ``recvs[i]``
        from it, posted in one batch, and wait for all of them (gloo: a
        pair's messages match in the order they are posted)."""
        dist = _dist()
        ops = [dist.P2POp(dist.isend, x, self._global[i], self.group)
               for i, x in sends.items()]
        ops += [dist.P2POp(dist.irecv, x, self._global[i], self.group)
                for i, x in recvs.items()]
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    @staticmethod
    def _one_dtype(xs: list, what: str) -> torch.dtype:
        if any(x.dtype != xs[0].dtype for x in xs):
            raise ValueError(f"one {what} moves tensors of one dtype")
        return xs[0].dtype

    def all_gather(self, xs: list, dims: list, out: list | None = None
                   ) -> list:
        """Each tensor's shards over the group concatenated along its dim,
        in index order: new tensors on the group's device, or ``out``'s,
        written in place (which may hold ``xs`` as views: every shard is
        sent before any is written).  The tensors (one dtype) travel as
        one buffer of their bytes: one collective for the list, exact
        whatever the dtype; each shard is copied straight into its place,
        so no whole-size temporary is made."""
        dist = _dist()
        t0 = time.perf_counter()
        dtype = self._one_dtype(xs, "all-gather")
        esize = xs[0].element_size()
        n = sum(x.numel() for x in xs)
        send = self._empty((n * esize,), torch.uint8, "ag_send")
        typed, off = send.view(dtype), 0
        for x in xs:
            typed[off:off + x.numel()].view(x.shape).copy_(x.detach())
            off += x.numel()
        if self.backend == "nccl":
            got = torch.empty((self.size, n * esize), dtype=torch.uint8,
                              device=self.device)
            dist.all_gather_into_tensor(got.view(-1), send, group=self.group)
        else:
            got = [send if i == self.index else self._empty(
                (n * esize,), torch.uint8, ("ag_recv", i))
                for i in range(self.size)]
            self._p2p({i: send for i in self._peers()},
                      {i: got[i] for i in self._peers()})
        full, off = [], 0
        for j, (x, d) in enumerate(zip(xs, dims)):
            shape = list(x.shape)
            shape[d] *= self.size
            y = (torch.empty(shape, dtype=dtype, device=self.device)
                 if out is None else out[j])
            k = x.shape[d]
            for i in range(self.size):
                y.narrow(d, i * k, k).copy_(
                    got[i].view(dtype)[off:off + x.numel()].view(x.shape))
            full.append(y)
            off += x.numel()
        self._count("all_gather", self.size * n * esize, t0)
        return full

    def reduce_scatter(self, xs: list, dims: list, out: list | None = None
                       ) -> list:
        """This index's shard along its dim of each tensor summed over the
        group (the dim splits into ``size`` contiguous shards), in the
        tensor's dtype: new tensors, or ``out``'s, written in place
        (``out[j]`` may be tensor j's own shard: it is read first); one
        collective for the list (one dtype), summed in fp32, each shard
        cast on the group's device."""
        dist = _dist()
        t0 = time.perf_counter()
        dtype = self._one_dtype(xs, "reduce-scatter")
        shards = []
        for x, d in zip(xs, dims):
            if x.shape[d] % self.size:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split into {self.size} shards")
            k = x.shape[d] // self.size
            shards.append([x.detach().narrow(d, i * k, k)
                           for i in range(self.size)])
        n = sum(s[0].numel() for s in shards)

        def pack(i: int, buf: torch.Tensor) -> torch.Tensor:
            off = 0                     # every tensor's shard i, in order
            for s in shards:
                buf[off:off + s[i].numel()].view(s[i].shape).copy_(s[i])
                off += s[i].numel()
            return buf

        if self.backend == "nccl":
            rows = torch.empty((self.size, n), dtype=torch.float32,
                               device=self.device)
            for i in range(self.size):
                pack(i, rows[i])
            summed = torch.empty(n, dtype=torch.float32, device=self.device)
            dist.reduce_scatter_tensor(summed, rows.view(-1),
                                       group=self.group)
            parts, nbytes = [summed], 4 * rows.numel()
        else:
            parts = [None if i == self.index else self._empty(
                (n,), dtype, ("rs_recv", i)) for i in range(self.size)]
            self._p2p({i: pack(i, self._empty((n,), dtype, ("rs_send", i)))
                       for i in self._peers()},
                      {i: parts[i] for i in self._peers()})
            nbytes = self.size * n * xs[0].element_size()
        result, off = [], 0
        for j, (x, s) in enumerate(zip(xs, shards)):
            m = s[0].numel()
            acc = None        # the parts summed in index order (own: None)
            for i, p in enumerate(parts):
                y = (s[i] if p is None else p[off:off + m].view(
                    s[i].shape).to(self.device))
                # one fp32 tensor a shard: later parts add in their dtype
                acc = y.to(torch.float32, copy=True) if acc is None \
                    else acc.add_(y)
            result.append(acc.to(x.dtype) if out is None
                          else out[j].copy_(acc))
            off += m
        self._count("reduce_scatter", nbytes, t0)
        return result

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
              plan: Callable, rx: dict, dp: int = 1) -> torch.Tensor:
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
    parameter leaf the steps read has its gradient accumulated.  With
    ``dp`` data replicas a loss root is ``1/(M dp)``: the gradients are
    those of the loss the replicas' sum divides by ``dp`` (the JAX
    executors' ``psum(total, (model, data)) / dp``), so summing them over
    the data group averages them."""
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
        roots[t]["loss"] = torch.full((), 1.0 / (M * dp),
                                      dtype=torch.float32, device=ring.device)
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


def reduce_loss(ring: Ring, local: torch.Tensor,
                data: "DataGroup | None" = None) -> torch.Tensor:
    """The walk's loss summed over the group, and over ``data`` divided by
    its size: every rank returns the same value (the JAX executors'
    ``psum(total, (model, data)) / dp``)."""
    total = local.detach().float().clone()
    ring.all_reduce_([total])
    if data is not None:
        data.all_reduce_([total])
        total /= data.size
    return total


def reduce_edge_grads(ring: Ring, leaves: list,
                      data: "DataGroup | None" = None) -> None:
    """Sum the gradients of the parameters every rank holds a copy of (the
    edge params) over the group, then over ``data`` -- the transpose of
    the JAX executors' replicated inputs -- and give every leaf a gradient
    (zeros where none of the ranks read it)."""
    grads = []
    for x in leaves:
        if x.grad is None:
            x.grad = torch.zeros_like(x)
        grads.append(x.grad)
    ring.all_reduce_(grads)
    if data is not None:
        data.all_reduce_(grads)
