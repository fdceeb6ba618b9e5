"""Tensor parallelism over a grid's ``model`` axis (the ``tp_axis`` of a
``ParallelPlan``), as Megatron-LM splits a decoder layer.

The JAX package gets it from GSPMD: its specs split ``wq/wk/wv/w_gate/
w_up`` on their output columns and ``wo/w_down`` on their input rows over
``model``, and XLA inserts the collectives.  The port keeps each rank's
TP block of those leaves (``train.steps.GridComm`` never gathers a TP
dim) and computes on it, with these collectives over the ranks of the
model axis (one ``runtime.ring.DataGroup``, ``GridComm.group((axis,))``):

- :meth:`TensorParallel.copy`: forward the identity, backward an
  all-reduce of the gradients.  At the entry of a column-parallel region
  (a layer's normed input), and on a leaf that is whole over the axis but
  read in part by each rank (``wk``/``wv`` replicated by the plans'
  ``custom_rules``, the GELU MLP's ``b_up``): each rank's gradient of it
  is partial, and the all-reduce makes it whole on every rank, so that
  ``GridComm.reduce_grads`` sums no leaf over the axis;
- :meth:`TensorParallel.reduce`: forward an all-reduce, backward the
  identity.  After a row-parallel matmul (``wo``, ``w_down``);
- :meth:`TensorParallel.gather`: forward an all-gather along a dim,
  backward the rank's slice of the gradient (every rank uses the whole
  result alike: the embedding's ``(B, S, d / tp)`` lookup) or, with
  ``partial=True``, a reduce-scatter (each rank reads a part of the
  whole: the q columns of a head cut between ranks, the tied unembedding
  matrix);
- :meth:`TensorParallel.split`: forward the rank's slice, backward an
  all-gather;
- :meth:`TensorParallel.xent`: the vocab-parallel cross-entropy of
  :class:`VocabLogits` (an all-reduce of the rows' maxima, then one of
  the sums of exponentials and the target logits, each over ``(B, S)``);
- :meth:`TensorParallel.argmax`: the vocab-parallel greedy token, the
  lowest global index on a tie (``jnp.argmax``'s).

:func:`lm_traffic` is the arithmetic of a dense LM's collectives over the
model group, which the tests and ``chip_smoke.py`` hold the counts to.

Every rank of the axis issues the same collectives in the same order: the
model code takes the same branches on every rank (decided by the leaves'
shapes and the config, never by the rank's index).  The context is an
explicit argument of the model functions; nothing here is global.  The
activations' all-reduces are ``DataGroup.all_reduce_parts_``: the parts
travel in the tensor's dtype and every rank sums them in fp32 in index
order (the same bits on every rank).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class VocabLogits:
    """Logits ``(..., V_local)``: vocab entries ``[start, start +
    V_local)`` of ``vocab`` (all of them when ``local`` is whole)."""
    local: torch.Tensor
    start: int
    vocab: int

    @property
    def whole(self) -> bool:
        return self.local.shape[-1] == self.vocab


class TensorParallel:
    """The TP context of a rank: ``index`` of ``size`` ranks along
    ``axis`` of ``comm``'s grid (a ``train.steps.GridComm``), whose data
    group over ``(axis,)`` is made on the device of the first tensor it
    moves."""

    def __init__(self, comm, axis: str):
        self.comm, self.axis = comm, axis
        self.index = comm.coords[axis]
        self.size = comm.sizes[axis]

    def group(self, device):
        return self.comm.group((self.axis,), device)

    def block(self, n: int) -> tuple[int, int]:
        """``(start, stop)`` of this rank's block of a dim of ``n``."""
        k = n // self.size
        return self.index * k, (self.index + 1) * k

    # ---- autograd collectives -------------------------------------------
    def copy(self, *xs: torch.Tensor):
        """The identity; the gradients all-reduced in the backward (one
        call a dtype).  One tensor in, one out; several, a tuple."""
        out = _Copy.apply(self, *xs)
        return out if len(xs) > 1 else out[0]

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(self, x)

    def gather(self, x: torch.Tensor, dim: int = -1, *,
               partial: bool = False) -> torch.Tensor:
        return _Gather.apply(self, x, dim % x.dim(), partial)

    def split(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _Split.apply(self, x, dim % x.dim())

    # ---- the vocab-parallel loss and greedy token ------------------------
    def xent(self, logits: VocabLogits, labels: torch.Tensor) -> torch.Tensor:
        """The per-row negative log-likelihood ``(...)`` in fp32 of
        vocab-parallel logits (whole ones: ``logsumexp`` minus the
        target's)."""
        if logits.whole:
            lf = logits.local.float()
            return torch.logsumexp(lf, dim=-1) - lf.gather(
                -1, labels.long()[..., None])[..., 0]
        return _VocabXent.apply(self, logits.local, labels, logits.start)

    @torch.no_grad()
    def argmax(self, logits: VocabLogits) -> torch.Tensor:
        """The global argmax over the vocab, int64 ``(...)``: each rank's
        maximum and its index gathered (one all-gather of fp64 pairs, exact
        for both), the first rank holding the largest value wins, so a tie
        goes to the lowest global index."""
        local = logits.local
        if logits.whole:
            return torch.argmax(local, dim=-1)
        val, idx = local.float().max(dim=-1)
        pair = torch.stack([val.double(), (idx + logits.start).double()], -1)
        (got,) = self.group(local.device).all_gather([pair], [pair.dim() - 1])
        got = got.unflatten(-1, (self.size, 2))
        best = got[..., 0].argmax(dim=-1, keepdim=True)      # first max
        return got[..., 1].gather(-1, best)[..., 0].long()


def lm_traffic(cfg, run: str, *, B: int, S: int, tp: int, esize: int,
               prefix: int = 0) -> dict:
    """The model group's bytes and calls by collective (``DataGroup``'s
    counts) of one train step, forward or serve step of a dense decoder
    LM (``models.lm.LMConfig``) over ``tp`` ranks whose attention and FFN
    leaves are TP blocks (the TP plans'): ``B`` rows a data replica of
    ``S`` tokens (a serve step: one) behind ``prefix`` vision rows,
    activations and weights of ``esize`` bytes.  The arithmetic the
    collectives of this module and ``models.lm`` must meet:

    - forward, each layer: two all-reduces of the ``B x rows x d`` partial
      sums (attention, FFN); where a head is cut between ranks, an
      all-gather of q (``B x rows x Hq D``); the embedding's all-gather
      of the ``(B, S, d / tp)`` lookup; the head: vocab-parallel, the
      cross-entropy's two fp32 all-reduces (the rows' maxima; their sums
      and target logits), or a serve step's all-gather of each rank's
      (max, index) in fp64; tied, the matrix's all-gather (``V x d``), or
      for a few rows the all-reduce of the partial ``rows x V`` logits;
    - train, each layer: the copies' all-reduces of the inputs' gradients
      (the attention's with the whole ``wk``/``wv``'s, the GELU MLP's
      with ``b_up``'s), the cut head's reduce-scatter of q's gradient;
      the vocab-parallel head's copy.

    No all-gather of a weight's TP dim but the tied matrix's."""
    a = cfg.attn
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    HqD, kvD = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    e = esize
    cut = (HqD // tp) % a.head_dim != 0
    seq = 1 if run == "serve" else S
    R = B * (prefix + seq)
    rows_u = B * (1 if run == "serve" else S - 1)
    ar, ag, rs = [], [B * seq * d * e], []
    for _ in range(L):
        ar += [R * d * e, R * d * e]
        ag += [R * HqD * e] if cut else []
    gathered = cfg.tied_embeddings and rows_u * tp > d
    if cfg.tied_embeddings and not gathered:
        ar.append(rows_u * V * e)
    elif gathered:
        ag.append(V * d * e)
    vocab_par = V % tp == 0 and (gathered or not cfg.tied_embeddings)
    if vocab_par and run == "serve":
        ag.append(tp * B * 2 * 8)
    elif vocab_par:
        ar += [rows_u * 4, 2 * rows_u * 4]
    if run == "train":
        for _ in range(L):
            ar += [(R * d + 2 * d * kvD) * e,
                   (R * d + (cfg.d_ff if cfg.mlp_gelu else 0)) * e]
            rs += [R * HqD * e] if cut else []
        ar += [rows_u * d * e] if vocab_par else []
        rs += [V * d * e] if gathered and vocab_par else []
    return {"bytes": {"all_reduce": sum(ar), "all_gather": sum(ag),
                      "reduce_scatter": sum(rs)},
            "calls": {"all_reduce": len(ar), "all_gather": len(ag),
                      "reduce_scatter": len(rs)}}


def greedy(logits, tp: TensorParallel | None = None) -> torch.Tensor:
    """The greedy next token ``(B, 1)`` int32 of the last position's
    logits: a tensor's, or (with ``tp``) :class:`VocabLogits`'."""
    if isinstance(logits, VocabLogits):
        last = dataclasses.replace(logits, local=logits.local[..., -1:, :])
        return tp.argmax(last).to(torch.int32)
    return torch.argmax(logits[..., -1:, :], dim=-1).to(torch.int32)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, *xs):
        ctx.tp = tp
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [g.clone(memory_format=torch.contiguous_format) for g in gs]
        by_dtype: dict = {}
        for g in gs:
            by_dtype.setdefault(g.dtype, []).append(g)
        for ts in by_dtype.values():
            ctx.tp.group(ts[0].device).all_reduce_parts_(ts)
        return (None, *gs)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, x):
        y = x.clone(memory_format=torch.contiguous_format)
        tp.group(y.device).all_reduce_parts_([y])
        return y

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, x, dim, partial):
        ctx.tp, ctx.dim, ctx.partial = tp, dim, partial
        (y,) = tp.group(x.device).all_gather([x], [dim])
        return y

    @staticmethod
    def backward(ctx, g):
        tp, d = ctx.tp, ctx.dim
        if ctx.partial:
            (gx,) = tp.group(g.device).reduce_scatter([g], [d])
        else:
            k = g.shape[d] // tp.size
            gx = g.narrow(d, tp.index * k, k)
        return None, gx, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, x, dim):
        ctx.tp, ctx.dim = tp, dim
        k = x.shape[dim] // tp.size
        return x.narrow(dim, tp.index * k, k)

    @staticmethod
    def backward(ctx, g):
        (gx,) = ctx.tp.group(g.device).all_gather(
            [g.contiguous()], [ctx.dim])
        return None, gx, None


class _VocabXent(torch.autograd.Function):
    """``logsumexp`` over the vocab blocks minus the target's logit, per
    row, in fp32; the gradient ``softmax - onehot`` of the rank's block
    (complete on its rank: no collective in the backward)."""

    @staticmethod
    def forward(ctx, tp, local, labels, start):
        grp = tp.group(local.device)
        lf = local.float()
        m = lf.amax(dim=-1)
        grp.all_reduce_parts_([m], op="max")
        e = torch.exp(lf - m[..., None])
        lab = labels.long() - start
        mine = (lab >= 0) & (lab < lf.shape[-1])
        tgt = torch.where(mine, lf.gather(
            -1, lab.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0], 0.0)
        st = torch.stack([e.sum(dim=-1), tgt])
        grp.all_reduce_parts_([st])
        ctx.save_for_backward(e, st[0], lab, mine)
        ctx.dtype = local.dtype
        return torch.log(st[0]) + m - st[1]

    @staticmethod
    def backward(ctx, g):
        e, s, lab, mine = ctx.saved_tensors
        grad = e / s[..., None]
        onehot = torch.zeros_like(grad).scatter_(
            -1, lab.clamp(0, grad.shape[-1] - 1)[..., None],
            mine[..., None].to(grad.dtype))
        return (None, ((grad - onehot) * g[..., None]).to(ctx.dtype), None,
                None)
