"""Gated linear scan ``h_t = a_t * h_{t-1} + x_t`` over ``(R, T, C)``.

The port of ``repro.kernels.linear_scan`` (TPU kernel
``kernel.py::gated_linear_scan_fwd`` and the custom VJP ``ops.py::_bwd``).
Three layers:

- :func:`gated_linear_scan_plain` and :func:`gated_linear_scan_bwd_plain`:
  the plain PyTorch versions, the same functions as the JAX oracle
  ``linear_scan/ref.py`` (a loop over t with an fp32 carry from
  ``h_{-1} = 0``, result in ``x.dtype``) and the JAX ``_bwd``;
- :func:`gated_linear_scan_cuda` and :func:`gated_linear_scan_bwd_cuda`:
  the wrappers of the hand-written CUDA kernel ``csrc/linear_scan.cu`` (a
  single-pass chunked scan with decoupled look-back; its backward mode
  computes ``dx`` and ``da`` in one launch); they check their inputs,
  launch on the current stream, raise on a CUDA error and count the launch;
- :func:`gated_linear_scan`: the differentiable op.  Forward and backward
  take the plain versions for CPU tensors and the kernel for CUDA tensors
  (never falling back).

``a`` and ``x`` each take float32 or bfloat16; ``h`` is in ``x.dtype``, as
in the JAX kernel.  Nothing in the repository calls the op yet (the JAX
package's Mamba2 computes its own chunked form); it is ported so that every
TPU kernel has its counterpart.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.analysis import kernel_check
from repro_torch.kernels import LAUNCHES, build, dtype_name

NAME = "gated_linear_scan"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# a, x, h, vals, flags, R, T, C, dtype_a, dtype_x, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# a, h, g, da, dx, vals, flags, R, T, C, dtype_a, dtype_x, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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


def gated_linear_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor,
                                g: torch.Tensor):
    """(da, dx) of ``h = scan(a, x)`` for the cotangent ``g``: the JAX
    ``_bwd`` op by op.  dX solves the reversed recurrence
    ``dX_t = g_t + a_{t+1} dX_{t+1}`` (g rounded to ``a.dtype``, the result
    too), ``da_t = dX_t * h_{t-1}`` in fp32 rounded to ``a.dtype``, and dx
    is dX in ``g.dtype``."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    dx = gated_linear_scan_plain(a_next.flip(1),
                                 g.flip(1).to(a.dtype)).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    da = (dx.float() * h_prev.float()).to(a.dtype)
    return da, dx.to(g.dtype)


@functools.lru_cache(maxsize=None)
def scan_config(dtype_a: torch.dtype, dtype_x: torch.dtype,
                backward: bool = False) -> dict:
    """The kernel's tiling for these dtypes: chunk length (time steps a
    block owns), channels and threads per block, dynamic shared memory and
    resident blocks per SM (on the card first asked)."""
    out = (ctypes.c_int * 5)()
    lib = build.load("linear_scan")
    fn = lib.gated_linear_scan_config
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    build.check(lib, fn(_DTYPES[dtype_a], _DTYPES[dtype_x], int(backward),
                        out), f"{NAME} config")
    return dict(zip(("chunk", "channels", "threads", "smem_bytes",
                     "blocks_per_sm"), out))


def _check_cuda_args(backward: bool = False, **tensors) -> None:
    """Refuse what the kernel does not take: the layout here, the dtypes
    and the grid by :func:`kernel_check.check_gated_linear_scan`'s verdict
    (``a`` and the first other tensor name the instantiation), then the
    device."""
    for name, t in tensors.items():
        if t.dim() != 3:
            raise ValueError(f"{NAME}: {name} must be 3-D (R, T, C), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    first = next(iter(tensors.values()))
    if any(t.shape != first.shape for t in tensors.values()):
        raise ValueError(f"{NAME}: shapes differ: " + ", ".join(
            f"{k}{tuple(v.shape)}" for k, v in tensors.items()))
    a, x = tensors["a"], [t for k, t in tensors.items() if k != "a"][0]
    kernel_check.check_gated_linear_scan(
        *a.shape, dtype_a=dtype_name(a.dtype), dtype_x=dtype_name(x.dtype),
        backward=backward
    ).raise_if_refused()
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{NAME}: {name} is on {t.device}, not cuda")
        if t.device != first.device:
            raise ValueError(f"{NAME}: tensors on different devices")


def _scratch(R: int, T: int, C: int, cfg: dict, device):
    """The look-back's flags (one per row, channel tile and chunk) and the
    ticket after them, zeroed; its values (3 floats a channel each), which
    the kernel writes before it reads."""
    n = R * -(-C // cfg["channels"]) * -(-T // cfg["chunk"])
    flags = torch.zeros(n + 1, dtype=torch.int32, device=device)
    vals = torch.empty(n * 3 * cfg["channels"], dtype=torch.float32,
                       device=device)
    return vals, flags


def gated_linear_scan_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: a, x (R, T, C) contiguous, each float32 or
    bfloat16, on one card -> h (R, T, C) in ``x.dtype``."""
    _check_cuda_args(a=a, x=x)
    R, T, C = x.shape
    h = torch.empty_like(x)
    vals, flags = _scratch(R, T, C, scan_config(a.dtype, x.dtype), x.device)
    build.call("linear_scan", "gated_linear_scan_launch", _ARGTYPES,
               x.device, NAME, a.data_ptr(), x.data_ptr(), h.data_ptr(),
               vals.data_ptr(), flags.data_ptr(), R, T, C, _DTYPES[a.dtype],
               _DTYPES[x.dtype])
    LAUNCHES[NAME] += 1
    return h


def gated_linear_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor,
                               g: torch.Tensor):
    """Launch the kernel's backward mode: a, h = scan(a, x) and the
    cotangent g (R, T, C) contiguous on one card, g in ``h.dtype`` ->
    (da in ``a.dtype``, dx in ``g.dtype``), one launch."""
    if g.dtype != h.dtype:
        raise TypeError(f"{NAME}: g has dtype {g.dtype}, h {h.dtype}; the "
                        "cotangent takes the output's dtype")
    _check_cuda_args(True, a=a, h=h, g=g)
    R, T, C = h.shape
    da, dx = torch.empty_like(a), torch.empty_like(g)
    vals, flags = _scratch(R, T, C, scan_config(a.dtype, h.dtype, True),
                           h.device)
    build.call("linear_scan", "gated_linear_scan_bwd_launch", _BWD_ARGTYPES,
               h.device, NAME, a.data_ptr(), h.data_ptr(), g.data_ptr(),
               da.data_ptr(), dx.data_ptr(), vals.data_ptr(),
               flags.data_ptr(), R, T, C, _DTYPES[a.dtype], _DTYPES[h.dtype])
    LAUNCHES[NAME] += 1
    return da, dx


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


class _GatedLinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x):
        h = (gated_linear_scan_plain(a, x) if _on_cpu(a, x)
             else gated_linear_scan_cuda(a, x))
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        g = g.contiguous()
        if _on_cpu(a, h, g):
            return gated_linear_scan_bwd_plain(a, h, g)
        return gated_linear_scan_bwd_cuda(a, h, g)


def gated_linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a, x: (R, T, C) -> h: (R, T, C) with h_t = a_t*h_{t-1} + x_t,
    differentiable."""
    return _GatedLinearScan.apply(a.contiguous(), x.contiguous())
