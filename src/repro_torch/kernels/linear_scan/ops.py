"""Gated linear scan ``h_t = a_t * h_{t-1} + x_t`` over ``(R, T, C)``.

The port of ``repro.kernels.linear_scan`` (TPU kernel
``kernel.py::gated_linear_scan_fwd``).  Three layers:

- :func:`gated_linear_scan_plain`: the plain PyTorch version, the same
  function as the JAX oracle ``linear_scan/ref.py`` (a loop over t with an
  fp32 carry from ``h_{-1} = 0``, result in ``x.dtype``);
- :func:`gated_linear_scan_cuda`: the wrapper of the hand-written CUDA
  kernel ``csrc/linear_scan.cu``; checks its inputs, launches on the current
  stream, raises on a CUDA error and counts the launch;
- :func:`gated_linear_scan`: the differentiable op.  Its forward takes the
  plain version for CPU tensors and the kernel for CUDA tensors (never
  falling back); its backward is the JAX custom VJP (``ops.py::_bwd``): the
  same scan, time-reversed over ``a_{t+1}``, gives ``dx``, then
  ``da = dx * h_{t-1}``, so the kernel serves both directions.

Nothing in the repository calls it yet (the JAX package's Mamba2 computes
its own chunked form); it is ported so that every TPU kernel has its
counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build

NAME = "gated_linear_scan"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# a, x, h, R, T, C, dtype, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def gated_linear_scan_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a, x: (R, T, C) -> h: (R, T, C) in ``x.dtype``, fp32 carry."""
    R, T, C = x.shape
    h = torch.zeros((R, C), dtype=torch.float32, device=x.device)
    a32, x32 = a.float(), x.float()
    hs = []
    for t in range(T):
        h = a32[:, t] * h + x32[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype)


def _check_cuda_args(a, x) -> None:
    for name, t in (("a", a), ("x", x)):
        if t.device.type != "cuda":
            raise ValueError(f"{NAME}: {name} is on {t.device}, not cuda")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{NAME}: {name} has dtype {t.dtype}; the "
                            "kernel takes float32 or bfloat16")
        if t.dim() != 3:
            raise ValueError(f"{NAME}: {name} must be 3-D (R, T, C), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if a.dtype != x.dtype:
        raise TypeError(f"{NAME}: dtypes differ ({a.dtype}, {x.dtype})")
    if a.device != x.device:
        raise ValueError(f"{NAME}: tensors on different devices")
    if a.shape != x.shape:
        raise ValueError(f"{NAME}: shapes a{tuple(a.shape)} x{tuple(x.shape)} "
                         "differ")
    if a.shape[0] > 65535:
        raise ValueError(f"{NAME}: R={a.shape[0]} rows exceed the grid's "
                         "65535")


def gated_linear_scan_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: a, x (R, T, C) contiguous, same dtype
    (float32 or bfloat16) on one card -> h (R, T, C)."""
    _check_cuda_args(a, x)
    R, T, C = x.shape
    h = torch.empty_like(x)
    build.call("linear_scan", "gated_linear_scan_launch", _ARGTYPES,
               x.device, NAME, a.data_ptr(), x.data_ptr(), h.data_ptr(), R,
               T, C, _DTYPES[x.dtype])
    LAUNCHES[NAME] += 1
    return h


def _forward(a, x):
    if a.device.type == x.device.type == "cpu":
        return gated_linear_scan_plain(a, x)
    return gated_linear_scan_cuda(a, x)


class _GatedLinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x):
        h = _forward(a, x)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        # dX solves the reversed recurrence dX_t = g_t + a_{t+1} dX_{t+1}
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        dx = _forward(a_next.flip(1), g.flip(1).to(a.dtype)).flip(1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        da = (dx.float() * h_prev.float()).to(a.dtype)
        return da, dx.to(g.dtype)


def gated_linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a, x: (R, T, C) -> h: (R, T, C) with h_t = a_t*h_{t-1} + x_t,
    differentiable."""
    return _GatedLinearScan.apply(a.contiguous(), x.contiguous())
