"""Flash attention: ``softmax(q k^T / sqrt(D) + mask) v``, GQA aware.

The port of ``repro.kernels.flash_attention`` (TPU kernel
``kernel.py::flash_attention_fwd``).  Three layers:

- :func:`attention_plain`: the plain PyTorch version, the same function as
  the JAX ``ops._ref_gqa`` over ``ref.py::attention_reference`` (K/V heads
  repeated, fp32 softmax, fully masked rows give zeros, result in
  ``q.dtype``);
- :func:`flash_attention_cuda`: the wrapper of the hand-written CUDA forward
  kernels ``csrc/flash_attention.cu``; checks its inputs, launches on the
  current stream the route :func:`flash_route` names for its dtype and head
  dim, raises on a CUDA error and counts the launch;
- :func:`flash_attention`: the differentiable op ``apply_attention`` calls
  with ``use_flash``.  Its forward takes the plain version for CPU tensors
  and the kernel for CUDA tensors (never falling back); its backward
  recomputes through the plain version, as the JAX custom VJP does (a run
  of kv heads at a time where the scores are large).  A backward kernel
  is later work.

All three take the model's layout: q ``(B, S, Hq, D)``, k and v
``(B, T, Hkv, D)`` with ``Hq % Hkv == 0``; the output is ``(B, S, Hq, D)``.
Over a KV cache (the JAX ``attention``'s ``q_offset`` and
``kv_valid_len``): k and v are the whole ``(B, max_len, Hkv, D)`` cache,
query row ``r`` sits at position ``q_offset + r`` and the keys at
``kv_valid_len`` and past it are masked.  The kernel reads the cache in
place, its key loop stopping at ``kv_valid_len``: no slice, no copy.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.analysis import kernel_check
from repro_torch.kernels import (LAUNCHES, build, dtype_name,
                                 tma_aligned)

NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the kernel is built for, and the bf16 ones on the
# tensor-core route (80, 112 and 224 -- zamba2's and danube's, the SDv2
# UNet's -- padded to whole 64-column boxes inside the kernel): the launch
# rules of repro_torch.analysis.kernel_check
HEAD_DIMS = kernel_check.HEAD_DIMS
WGMMA_HEAD_DIMS = kernel_check.WGMMA_HEAD_DIMS
# q, k, v, out, B, S, T, Hq, Hkv, D, causal, has_window, window, q_offset,
# kv_valid_len, scale, dtype, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# the backward's plain recompute holds a run of kv heads' fp32 scores at
# a time within this many bytes (every head at once below it)
BACKWARD_SCORE_BYTES = 1 << 30


def _mask(S: int, T: int, causal: bool, window: int | None, device,
          q_offset: int = 0, kv_valid_len: int | None = None
          ) -> torch.Tensor:
    """(S, T): key j visible to query row r (at ``q_offset + r``)."""
    q_pos = torch.arange(S, device=device)[:, None] + q_offset
    k_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if kv_valid_len is not None:
        mask &= k_pos < kv_valid_len
    return mask


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0,
                    kv_valid_len: int | None = None) -> torch.Tensor:
    """The plain version: (B,S,Hq,D), (B,T,Hkv,D) x2 -> (B,S,Hq,D)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(D)
    mask = _mask(S, T, causal, window, q.device, q_offset, kv_valid_len)
    row_any = mask.any(-1)[:, None]
    # a row with no visible key takes finite logits (so neither softmax nor
    # its gradient produce NaN) and is zeroed after the softmax
    logits = torch.where(mask, logits, -math.inf)
    logits = torch.where(row_any, logits, 0.0)
    probs = torch.where(row_any, torch.softmax(logits, dim=-1), 0.0)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def flash_route(dtype: torch.dtype, D: int) -> str:
    """Which CUDA kernel runs for inputs of ``dtype`` and head dim ``D``: a
    pure function of the two, never a fallback on failure.  ``"wgmma"``,
    the tensor-core route (TMA loads, wgmma, P kept in registers), for
    bf16 at D in ``WGMMA_HEAD_DIMS``: 64, 128, zamba2's and danube's 80 and
    the SDv2 UNet's heads 112 and 224; ``"simt"``, the FMA kernel, for fp32 at any head dim and
    bf16 at D in (8, 16, 32), the small test configs."""
    if dtype not in _DTYPES:
        raise TypeError(f"{NAME}: dtype {dtype}; the kernel takes float32 "
                        "or bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {D} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    return kernel_check.flash_route(dtype_name(dtype), D)


def _check_cuda_args(q, k, v, q_offset: int = 0,
                     kv_valid_len: int | None = None,
                     window: int | None = None) -> None:
    """Refuse what the kernel does not take: the layout here, the shapes,
    dtypes and TMA strides by :func:`kernel_check.check_flash_attention`'s
    verdict, then the device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{NAME}: {name} must be 4-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{NAME}: dtypes differ ({q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    B, S, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{NAME}: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}; want (B,S,Hq,D), (B,T,Hkv,D) x2")
    # a layer's slice of a stacked KV cache starts 16-byte aligned iff
    # B * max_len * Hkv * D * 2 is a multiple of 16: it is never copied
    kernel_check.check_flash_attention(
        B, S, k.shape[1], Hq, k.shape[2], D, dtype=dtype_name(q.dtype),
        q_offset=q_offset, kv_valid_len=kv_valid_len, window=window,
        bases_aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    ).raise_if_refused()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{NAME}: {name} is on {t.device}, not cuda")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{NAME}: tensors on different devices")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None,
                         q_offset: int = 0,
                         kv_valid_len: int | None = None) -> torch.Tensor:
    """Launch the CUDA forward kernel on contiguous (B,S,Hq,D) / (B,T,Hkv,D)
    tensors of one dtype (float32 or bfloat16) on one card; over a KV cache
    with ``q_offset`` and ``kv_valid_len`` (host ints, launch arguments)."""
    _check_cuda_args(q, k, v, q_offset, kv_valid_len, window)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    valid = T if kv_valid_len is None else int(kv_valid_len)
    out = torch.empty_like(q)
    build.call("flash_attention", "flash_attention_fwd_launch", _ARGTYPES,
               q.device, NAME, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), B, S, T, Hq, Hkv, D, int(causal),
               int(window is not None), int(window or 0), int(q_offset),
               valid, 1.0 / math.sqrt(D), _DTYPES[q.dtype])
    LAUNCHES[NAME] += 1
    return out


def bf16_config(D: int) -> dict:
    """The tensor-core route's tiling at head dim ``D`` (one of
    ``WGMMA_HEAD_DIMS``) and its resident blocks per SM on the current card
    (builds the kernel)."""
    lib = build.load("flash_attention")
    out = (ctypes.c_int * 6)()
    fn = lib.flash_attention_bf16_config
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(lib, fn(D, ctypes.addressof(out)), NAME)
    return dict(zip(("query_rows", "keys_per_tile", "stages", "threads",
                     "smem_bytes", "blocks_per_sm"), out))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_valid_len):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, q_offset, kv_valid_len)
        if q.device.type == k.device.type == v.device.type == "cpu":
            return attention_plain(q, k, v, *ctx.args)
        return flash_attention_cuda(q, k, v, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        """The plain version's gradient, a run of kv heads (with their q
        heads) at a time: as many as keep the run's fp32 scores within
        :data:`BACKWARD_SCORE_BYTES` (all of them at the test shapes), so
        that a long sequence's recompute does not hold every head's ``S x
        T`` scores at once (a rank of h2o-danube-1.8b's TP train step: 16
        heads of 4096 x 4096, 2.1 GB a copy)."""
        q, k, v = ctx.saved_tensors
        B, S, Hq, _ = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        G = Hq // Hkv
        run = max(1, min(Hkv, BACKWARD_SCORE_BYTES // (4 * B * G * S * T)))
        if run == Hkv:
            with torch.enable_grad():
                qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
                out = attention_plain(qd, kd, vd, *ctx.args)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
            return dq, dk, dv, None, None, None, None
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        for h in range(0, Hkv, run):
            kv, qs = slice(h, h + run), slice(h * G, (h + run) * G)
            with torch.enable_grad():
                qd, kd, vd = (t[:, :, s].detach().requires_grad_()
                              for t, s in ((q, qs), (k, kv), (v, kv)))
                out = attention_plain(qd, kd, vd, *ctx.args)
            dq[:, :, qs], dk[:, :, kv], dv[:, :, kv] = torch.autograd.grad(
                out, (qd, kd, vd), g[:, :, qs])
            del out
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0,
                    kv_valid_len: int | None = None) -> torch.Tensor:
    """(B,S,Hq,D), (B,T,Hkv,D) x2 -> (B,S,Hq,D), differentiable.  A view
    of q, k or v that TMA cannot load is copied, except over a KV cache
    (``kv_valid_len`` given): the cache is read in place, and the wrapper
    raises on one that is not contiguous and aligned."""
    if kv_valid_len is None:
        k, v = tma_aligned(k), tma_aligned(v)
    return _FlashAttention.apply(tma_aligned(q), k, v, causal, window,
                                 q_offset, kv_valid_len)
