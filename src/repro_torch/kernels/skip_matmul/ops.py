"""Fused skip-concat matmul ``y = [h | s] @ W`` without the concat.

The port of ``repro.kernels.skip_matmul`` (TPU kernel
``kernel.py::skip_concat_matmul_fwd``).  Three layers:

- :func:`skip_concat_matmul_plain`: the plain PyTorch version, the same
  function as the JAX oracle ``skip_matmul/ref.py`` (fp32 product of the
  concat, result in ``h.dtype``);
- :func:`skip_concat_matmul_cuda`: the wrapper of the hand-written CUDA
  kernel ``csrc/skip_matmul.cu``; checks its inputs, launches on the current
  stream, raises on a CUDA error and counts the launch;
- :func:`skip_concat_matmul`: the differentiable op the model calls.  Its
  forward takes the plain version for CPU tensors and the kernel for CUDA
  tensors (never falling back); its backward is three plain matmuls, as
  the JAX custom VJP (``ops.py::_bwd``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis import kernel_check
from repro_torch.kernels import (LAUNCHES, build, dtype_name,
                                 tma_aligned)

NAME = "skip_concat_matmul"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# h, s, w, y, M, D, N, dtype, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def skip_concat_matmul_plain(h: torch.Tensor, s: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """h, s: (M, D); w: (2D, N) -> (M, N) in ``h.dtype``, fp32 product."""
    x = torch.cat([h, s], dim=-1)
    return (x.float() @ w.float()).to(h.dtype)


def _check_cuda_args(h, s, w) -> tuple[int, int, int]:
    """Refuse what the kernel does not take: the layout here, the shapes,
    dtypes and TMA strides by
    :func:`kernel_check.check_skip_concat_matmul`'s verdict, then the
    device."""
    for name, t in (("h", h), ("s", s), ("w", w)):
        if t.dim() != 2:
            raise ValueError(f"{NAME}: {name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if not (h.dtype == s.dtype == w.dtype):
        raise TypeError(f"{NAME}: dtypes differ ({h.dtype}, {s.dtype}, "
                        f"{w.dtype})")
    M, D = h.shape
    if tuple(s.shape) != (M, D) or w.shape[0] != 2 * D:
        raise ValueError(f"{NAME}: shapes h{tuple(h.shape)} s{tuple(s.shape)} "
                         f"w{tuple(w.shape)}; want (M, D), (M, D), (2D, N)")
    N = w.shape[1]
    kernel_check.check_skip_concat_matmul(
        M, D, N, dtype=dtype_name(h.dtype),
        bases_aligned=all(t.data_ptr() % 16 == 0 for t in (h, s, w))
    ).raise_if_refused()
    for name, t in (("h", h), ("s", s), ("w", w)):
        if t.device.type != "cuda":
            raise ValueError(f"{NAME}: {name} is on {t.device}, not cuda")
    if not (h.device == s.device == w.device):
        raise ValueError(f"{NAME}: tensors on different devices")
    return M, D, N


def skip_concat_matmul_cuda(h: torch.Tensor, s: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: h, s (M, D), w (2D, N) contiguous, same dtype
    (float32 or bfloat16) on one card -> (M, N).  bf16 also needs D % 8 ==
    N % 8 == 0 and 16-byte-aligned bases (TMA's stride rule)."""
    M, D, N = _check_cuda_args(h, s, w)
    y = torch.empty((M, N), dtype=h.dtype, device=h.device)
    build.call("skip_matmul", "skip_concat_matmul_launch", _ARGTYPES,
               h.device, NAME, h.data_ptr(), s.data_ptr(), w.data_ptr(),
               y.data_ptr(), M, D, N, _DTYPES[h.dtype])
    LAUNCHES[NAME] += 1
    return y


def bf16_config() -> dict:
    """The bf16 kernel's tiling and its resident blocks per SM on the
    current card (builds the kernel)."""
    lib = build.load("skip_matmul")
    out = (ctypes.c_int * 7)()
    fn = lib.skip_concat_matmul_bf16_config
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(lib, fn(ctypes.addressof(out)), NAME)
    return dict(zip(("tile_m", "tile_n", "k_step", "stages", "threads",
                     "smem_bytes", "blocks_per_sm"), out))


def _forward_2d(h, s, w):
    if h.device.type == s.device.type == w.device.type == "cpu":
        return skip_concat_matmul_plain(h, s, w)
    return skip_concat_matmul_cuda(h, s, w)


class _SkipConcatMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, s2, w):
        ctx.save_for_backward(h2, s2, w)
        return _forward_2d(h2, s2, w)

    @staticmethod
    def backward(ctx, g):
        h2, s2, w = ctx.saved_tensors
        D = h2.shape[-1]
        gf, hf, sf = g.float(), h2.float(), s2.float()
        w1, w2 = w[:D].float(), w[D:].float()
        dh = (gf @ w1.T).to(h2.dtype)
        ds = (gf @ w2.T).to(s2.dtype)
        dw = torch.cat([hf.T @ gf, sf.T @ gf], dim=0).to(w.dtype)
        return dh, ds, dw


def skip_concat_matmul(h: torch.Tensor, s: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """h, s: (..., D); w: (2D, N) -> (..., N), differentiable."""
    D = h.shape[-1]
    h2 = tma_aligned(h.reshape(-1, D))
    s2 = tma_aligned(s.reshape(-1, D))
    out = _SkipConcatMatmul.apply(h2, s2, tma_aligned(w))
    return out.reshape(*h.shape[:-1], w.shape[1])
