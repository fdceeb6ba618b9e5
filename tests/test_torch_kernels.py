"""The port's kernels held to the JAX package's oracles.

On the CPU every kernel wrapper takes its plain PyTorch version, so these
tests hold the plain versions (and their autograd) to the JAX ``ref.py``
oracles on the same numpy inputs, and the gated linear scan also to the
JAX package's Pallas kernel, which runs in interpret mode here.  The CUDA kernels themselves are held to
the plain versions on the card by ``test_torch_gpu.py``.
(The JAX package's Pallas kernels are not the oracle: the installed
``jax.experimental.pallas`` has no ``load``, so they fail on this host.)
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import _ref_gqa
from repro.kernels.linear_scan import (gated_linear_scan as jax_scan,
                                       gated_linear_scan_reference)
from repro.kernels.flash_attention.ref import attention_reference
from repro.kernels.skip_matmul.ref import skip_concat_matmul_reference
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention,
                                                 flash_attention_cuda)
from repro_torch.kernels.linear_scan import (gated_linear_scan,
                                             gated_linear_scan_cuda,
                                             gated_linear_scan_plain)
from repro_torch.kernels.skip_matmul import (skip_concat_matmul,
                                             skip_concat_matmul_cuda,
                                             skip_concat_matmul_plain)

RTOL = 1e-5          # fp32, same arithmetic in another summation order
ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_value_and_vjp(f, g, *args):
    """``(f(*args), vjp(g))`` under one jit (eager vjp compiles op by op)."""
    def run(g, *args):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(g)
    return jax.jit(run)(g, *args)


# ---------------------------------------------------------------------------
# (a) skip_concat_matmul: plain version + autograd vs skip_matmul/ref.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,D,N", [(128, 128, 128), (258, 64, 48),
                                   (7, 5, 3), (33, 17, 129)])
def test_skip_concat_matmul_matches_reference(M, D, N):
    rng = np.random.default_rng(M * 1000 + D)
    h = rng.normal(size=(M, D)).astype(np.float32)
    s = rng.normal(size=(M, D)).astype(np.float32)
    w = (rng.normal(size=(2 * D, N)) / np.sqrt(2 * D)).astype(np.float32)
    g = rng.normal(size=(M, N)).astype(np.float32)

    ref, (dh_r, ds_r, dw_r) = _jax_value_and_vjp(
        skip_concat_matmul_reference, g, h, s, w)

    np.testing.assert_allclose(skip_concat_matmul_plain(_t(h), _t(s), _t(w)),
                               ref, rtol=RTOL, atol=ATOL)
    ht, st, wt = (_t(x).requires_grad_(True) for x in (h, s, w))
    out = skip_concat_matmul(ht, st, wt)
    np.testing.assert_allclose(out.detach(), ref, rtol=RTOL, atol=ATOL)
    out.backward(_t(g))
    for got, want in ((ht.grad, dh_r), (st.grad, ds_r), (wt.grad, dw_r)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_skip_concat_matmul_batched_leading_dims():
    """(b, n, D) activations flatten to (b*n, D) rows, as in the model."""
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 19, 16)).astype(np.float32)
    s = rng.normal(size=(2, 19, 16)).astype(np.float32)
    w = rng.normal(size=(32, 24)).astype(np.float32)
    ref = skip_concat_matmul_reference(h.reshape(-1, 16), s.reshape(-1, 16),
                                       w).reshape(2, 19, 24)
    out = skip_concat_matmul(_t(h), _t(s), _t(w))
    assert out.shape == (2, 19, 24)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    reset_launch_counts()
    x = torch.randn(4, 8)
    skip_concat_matmul(x, x, torch.randn(16, 8))
    q = torch.randn(1, 5, 2, 16)
    flash_attention(q, q, q, False, None)
    a = torch.rand(2, 6, 3)
    gated_linear_scan(a, a)
    assert launch_counts() == {"skip_concat_matmul": 0, "flash_attention": 0,
                               "gated_linear_scan": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back: a CPU tensor is an error."""
    before = launch_counts()
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="not cuda"):
        skip_concat_matmul_cuda(x, x, torch.randn(16, 8))
    q = torch.randn(1, 5, 2, 16)
    with pytest.raises(ValueError, match="not cuda"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="not cuda"):
        gated_linear_scan_cuda(torch.rand(2, 6, 3), torch.rand(2, 6, 3))
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# (b) flash attention: plain version + autograd vs ref.py / ops._ref_gqa
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, S, T, Hq, Hkv, D, causal, window
    (2, 40, 40, 4, 4, 16, False, None),       # UViT self-attention shape
    (1, 37, 37, 2, 2, 32, True, None),        # causal, ragged length
    (1, 50, 50, 2, 2, 16, True, 8),           # causal + sliding window
    (2, 24, 24, 4, 1, 16, True, None),        # GQA (4 q heads per kv head)
    (1, 33, 33, 4, 2, 16, False, 5),          # window, non-causal, GQA 2
    (1, 258, 77, 2, 2, 16, False, None),      # ragged S=258 over T=77
]


@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,causal,window", FLASH_CASES)
def test_flash_attention_matches_reference(B, S, T, Hq, Hkv, D, causal,
                                           window):
    rng = np.random.default_rng(S * 7 + T)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    g = rng.normal(size=(B, S, Hq, D)).astype(np.float32)

    ref, (dq_r, dk_r, dv_r) = _jax_value_and_vjp(
        lambda q, k, v: _ref_gqa(q, k, v, causal, window), g, q, k, v)
    if Hq == Hkv:
        np.testing.assert_allclose(
            attention_reference(q, k, v, causal=causal, window=window), ref,
            rtol=RTOL, atol=ATOL)

    np.testing.assert_allclose(attention_plain(_t(q), _t(k), _t(v), causal,
                                               window),
                               ref, rtol=1e-5, atol=1e-6)
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal, window)
    np.testing.assert_allclose(out.detach(), ref, rtol=1e-5, atol=1e-6)
    out.backward(_t(g))
    for got, want in ((qt.grad, dq_r), (kt.grad, dk_r), (vt.grad, dv_r)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_attention_plain_fully_masked_rows_are_zero_and_finite():
    """window=0 hides every key; the reference zeroes such rows, and the
    plain version must do the same without NaN gradients."""
    q = torch.randn(1, 6, 2, 16, requires_grad=True)
    out = flash_attention(q, q, q, True, 0)
    assert torch.all(out == 0)
    out.sum().backward()
    assert torch.isfinite(q.grad).all()


# ---------------------------------------------------------------------------
# (c) gated linear scan: plain version + the op's backward vs the JAX kernel
#     (interpret mode) and linear_scan/ref.py
# ---------------------------------------------------------------------------

def _scan_inputs(R, T, C):
    rng = np.random.default_rng(R * 10_000 + T * 10 + C)
    a = (1 / (1 + np.exp(-rng.normal(size=(R, T, C))))).astype(np.float32)
    x = rng.normal(size=(R, T, C)).astype(np.float32)
    g = rng.normal(size=(R, T, C)).astype(np.float32)
    return a, x, g


def _check_scan(a, x, g, want, da_r, dx_r):
    np.testing.assert_allclose(gated_linear_scan_plain(_t(a), _t(x)), want,
                               rtol=1e-5, atol=1e-6)
    at, xt = (_t(v).requires_grad_(True) for v in (a, x))
    out = gated_linear_scan(at, xt)
    np.testing.assert_allclose(out.detach(), want, rtol=1e-5, atol=1e-6)
    out.backward(_t(g))
    np.testing.assert_allclose(at.grad, da_r, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad, dx_r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("R,T,C", [(2, 128, 128), (1, 64, 256)])
def test_gated_linear_scan_matches_jax_kernel_and_reference(R, T, C):
    a, x, g = _scan_inputs(R, T, C)
    ref, (da_r, dx_r) = _jax_value_and_vjp(gated_linear_scan_reference, g,
                                           a, x)
    kern, (da_k, dx_k) = _jax_value_and_vjp(jax_scan, g, a, x)
    _check_scan(a, x, g, ref, da_r, dx_r)
    _check_scan(a, x, g, kern, da_k, dx_k)


def test_gated_linear_scan_ragged_matches_reference():
    """T and C that no power-of-two tile divides: the JAX kernel asserts
    divisibility, so only ref.py holds the port here."""
    a, x, g = _scan_inputs(3, 37, 20)
    ref, (da_r, dx_r) = _jax_value_and_vjp(gated_linear_scan_reference, g,
                                           a, x)
    _check_scan(a, x, g, ref, da_r, dx_r)
