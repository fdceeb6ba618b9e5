"""The port's kernels held to the JAX package's oracles.

On the CPU every kernel wrapper takes its plain PyTorch version, so these
tests hold the plain versions (and their autograd) to the JAX ``ref.py``
oracles on the same numpy inputs, and the gated linear scan also to the
JAX package's Pallas kernel, which runs in interpret mode here.  The CUDA kernels themselves are held to
the plain versions on the card by ``test_torch_gpu.py``.
(The JAX package's Pallas kernels are not the oracle: the installed
``jax.experimental.pallas`` has no ``load``, so they fail on this host.)
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import _ref_gqa
from repro.kernels.linear_scan import (gated_linear_scan as jax_scan,
                                       gated_linear_scan_reference)
from repro.kernels.flash_attention.ref import attention_reference
from repro.kernels.skip_matmul.ref import skip_concat_matmul_reference
from repro.models.layers import attention as jax_attention
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention,
                                                 flash_attention_cuda,
                                                 flash_route)
from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS,
                                                     WGMMA_HEAD_DIMS)
from repro_torch.kernels.linear_scan import (gated_linear_scan,
                                             gated_linear_scan_bwd_cuda,
                                             gated_linear_scan_bwd_plain,
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
    with pytest.raises(ValueError, match="not cuda"):
        gated_linear_scan_bwd_cuda(*(torch.rand(2, 6, 3),) * 3)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_route_is_a_function_of_dtype_and_head_dim(dtype, D):
    """bf16 at the head dims of WGMMA_HEAD_DIMS (64, 128, zamba2's and
    danube's 80 and the SDv2 UNet's 112 and 224) takes the tensor-core
    route; fp32 at any head dim and bf16 at the small test head dims take
    the SIMT kernel."""
    assert WGMMA_HEAD_DIMS == (64, 80, 112, 128, 224)
    want = ("wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS
            else "simt")
    assert flash_route(dtype, D) == want


def test_flash_route_refuses_what_is_not_built():
    with pytest.raises(ValueError, match="head dim 48"):
        flash_route(torch.bfloat16, 48)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_route(torch.float16, 64)


def _misaligned_cpu(shape, dtype):
    n = int(np.prod(shape))
    t = torch.zeros(n + 1, dtype=dtype)[1:].view(shape)
    assert t.data_ptr() % 16 != 0
    return t


def test_wrappers_name_the_tma_layout_rule():
    """The bf16 kernels load through TMA: D % 8 == N % 8 == 0 and 16-byte-
    aligned bases for the skip matmul, aligned bases for flash attention's
    tensor-core route; the wrappers raise on anything else before they look
    at the device, and count nothing."""
    before = launch_counts()
    bf = torch.bfloat16
    x = torch.zeros(4, 12, dtype=bf)
    with pytest.raises(ValueError, match="D % 8 == N % 8 == 0"):
        skip_concat_matmul_cuda(x, x, torch.zeros(24, 8, dtype=bf))
    h = _misaligned_cpu((4, 16), bf)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        skip_concat_matmul_cuda(h, h, torch.zeros(32, 8, dtype=bf))
    q = _misaligned_cpu((1, 5, 2, 128), bf)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention_cuda(*(torch.zeros(1, 5, 2, 48),) * 3)
    # fp32 and the SIMT route take any base
    q32 = _misaligned_cpu((1, 5, 2, 16), bf)
    with pytest.raises(ValueError, match="not cuda"):
        flash_attention_cuda(q32, q32, q32)
    assert launch_counts() == before


def test_ops_copy_misaligned_views():
    """The ops hand the kernels 16-byte-aligned copies of views that start
    elsewhere; on the CPU the result is the plain version's."""
    h = _misaligned_cpu((6, 16), torch.float32)
    h.copy_(torch.randn(6, 16))
    w = torch.randn(32, 8)
    torch.testing.assert_close(skip_concat_matmul(h, h, w),
                               skip_concat_matmul_plain(h, h, w))
    q = _misaligned_cpu((1, 5, 2, 16), torch.float32)
    q.copy_(torch.randn(1, 5, 2, 16))
    torch.testing.assert_close(flash_attention(q, q, q, False, None),
                               attention_plain(q, q, q, False, None))


def _tensor_core_flash_emulation(q, k, v, causal, window, q_offset=0,
                                 kv_valid_len=None, bq=64, bkv=64):
    """The tensor-core route's arithmetic on the CPU: bf16 q, k, v, the head
    zero-padded to whole 64-column boxes (80 and 112 -> 128, 224 -> 256) as
    TMA fills them, the scale 1/sqrt(D) of the true head dim; fp32 scores
    per (64-query, 64-key) tile, the K/V tiles visited in order from the
    first one the mask does not hide to the last below the valid length
    (query row r at ``q_offset + r``); an online softmax in base 2 with
    log2(e) folded into the scale; P rounded to bf16 before P.V, which
    accumulates in fp32 over the padded width; 1/l at the end; the first D
    columns stored, rounded to bf16."""
    B, S, H, D = q.shape
    T = k.shape[1]
    valid = T if kv_valid_len is None else kv_valid_len
    DP = -(-D // 64) * 64
    qf, kf, vf = (torch.nn.functional.pad(x.to(torch.bfloat16).float(),
                                          (0, DP - D)) for x in (q, k, v))
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    out = torch.zeros(B, S, H, DP)
    for q0 in range(0, S, bq):
        rows = torch.arange(q0, min(q0 + bq, S))
        pos = rows + q_offset
        kv_hi = min(valid, q_offset + q0 + bq) if causal else valid
        kv_lo = max(0, q_offset + q0 - window + 1) if window is not None \
            else 0
        kv_lo = kv_lo // bkv * bkv
        m = torch.full((B, H, len(rows)), -math.inf)
        l = torch.zeros(B, H, len(rows))
        acc = torch.zeros(B, H, len(rows), DP)
        for kt in range(kv_lo, kv_hi, bkv):
            keys = torch.arange(kt, min(kt + bkv, T))
            s = torch.einsum("bshd,bthd->bhst", qf[:, rows], kf[:, keys])
            vis = (keys[None, :] < valid).expand(len(rows), len(keys))
            if causal:
                vis = vis & (keys[None, :] <= pos[:, None])
            if window is not None:
                vis = vis & (keys[None, :] > pos[:, None] - window)
            s = torch.where(vis, s * scale_log2, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            seen = m_new > -math.inf
            alpha = torch.where(seen, torch.exp2(m - m_new), 1.0)
            p = torch.exp2(s - torch.where(seen, m_new, 0.0)[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhst,bthd->bhsd", p.to(torch.bfloat16).float(), vf[:, keys])
            m = m_new
        o = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
        out[:, rows] = o.permute(0, 2, 1, 3)
    assert torch.all(out[..., D:] == 0)     # the pad columns add nothing
    return out[..., :D].to(torch.bfloat16)


# D = 128: the Hunyuan-DiT self-attention length, the ragged cross-attention
# shape, a causal sliding window; D = 112 and 224: the SDv2 UNet's level-1
# self and cross, level-2 self, level-3 cross, and a causal window; D = 80:
# zamba2's causal shared attention and danube's causal window
FLASH_NUMERICS = [(128, 1024, 1024, False, None), (128, 258, 77, False, None),
                  (128, 300, 300, True, 96), (112, 256, 256, False, None),
                  (112, 256, 77, False, None), (224, 64, 64, False, None),
                  (224, 16, 77, False, None), (224, 130, 130, True, 40),
                  (80, 200, 200, True, None), (80, 150, 150, True, 48)]


@pytest.mark.parametrize(
    "D,S,T,causal,window", FLASH_NUMERICS,
    ids=["-".join(map(str, c[1:] if c[0] == 128 else c))
         for c in FLASH_NUMERICS])
def test_tensor_core_flash_numerics_meet_the_chip_tolerance(D, S, T, causal,
                                                            window):
    """Rounding P to bf16 before P.V (the Pallas body multiplies P.V in
    fp32) and padding the head to whole 64-column boxes keep the route
    within chip_smoke's bf16 tolerance, rtol = atol = 2e-2, of the JAX
    oracle ref.py on the same bf16 inputs (B=1, H=2)."""
    rng = np.random.default_rng(S + T)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, n, 2, D))
                                .astype(np.float32)).to(torch.bfloat16)
               for n in (S, T, T))
    got = _tensor_core_flash_emulation(q, k, v, causal, window)
    want = attention_reference(*(np.asarray(x.float()) for x in (q, k, v)),
                               causal=causal, window=window)
    np.testing.assert_allclose(got.float(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


# over a KV cache: D, S, cache rows T, valid length, q_offset, causal,
# window -- decode steps (S = 1) and a prefill chunk, at head dims 64
# (smollm, whisper) and 80 (zamba2), the rows past the valid length junk
FLASH_CACHE_NUMERICS = [(64, 1, 2112, 2101, 2100, True, None),
                        (80, 1, 288, 271, 270, True, None),
                        (64, 1, 128, 101, 100, True, None),
                        (80, 1, 300, 213, 212, True, 64),
                        (64, 70, 200, 150, 80, True, 33),
                        (80, 24, 100, 24, 0, True, None)]


@pytest.mark.parametrize("D,S,T,valid,q_offset,causal,window",
                         FLASH_CACHE_NUMERICS)
def test_tensor_core_flash_over_a_cache_meets_the_chip_tolerance(
        D, S, T, valid, q_offset, causal, window):
    """The tensor-core route over a cache (its tile loop from the window's
    horizon to the valid length, the mask at the offset positions) within
    chip_smoke's bf16 tolerance of the JAX ``attention`` with ``q_offset``
    and ``kv_valid_len`` on the same bf16 inputs (B=1, H=2)."""
    rng = np.random.default_rng(S + T + D)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, n, 2, D))
                                .astype(np.float32)).to(torch.bfloat16)
               for n in (S, T, T))
    k[:, valid:] = 1e4                        # never read, if masked
    v[:, valid:] = 1e4
    got = _tensor_core_flash_emulation(q, k, v, causal, window, q_offset,
                                       valid)
    want = jax_attention(*(np.asarray(x.float()) for x in (q, k, v)),
                         causal=causal, window=window, q_offset=q_offset,
                         kv_valid_len=valid)
    np.testing.assert_allclose(got.float(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(
        attention_plain(q.float(), k.float(), v.float(), causal, window,
                        q_offset, valid), torch.from_numpy(np.array(want)),
        rtol=1e-5, atol=1e-5)


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


def _chunked_scan_emulation(a, x, L, reverse=False, warps=4, seed=0):
    """``csrc/linear_scan.cu``'s algorithm in fp32 on the CPU.  Time is cut
    into chunks of L steps (zero-filled past T, as TMA fills them; in
    reverse the chunks keep their places in time and are taken last
    first).  Each chunk's steps are split among ``warps`` warps, each of
    which scans its steps from a zero state into the pair (A = prod a, B =
    local h); the pairs combine in scan order, (A2 A1, A2 B1 + B2), into
    the chunk's aggregate.  The carry-in comes from a look-back that
    combines the aggregates of the chunks before until it meets one whose
    inclusive prefix is already published (which ones are is drawn from
    ``seed``; the first chunk's always is).  The fix-up runs each warp's
    steps again from the carry through the warps before it."""
    R, T, C = x.shape
    nch = -(-T // L)
    a, x = (torch.nn.functional.pad(v.float(), (0, 0, 0, nch * L - T))
            for v in (a, x))
    if reverse:
        a, x = a.flip(1), x.flip(1)
    rng = np.random.default_rng(seed)
    one, zero = torch.ones(R, C), torch.zeros(R, C)
    h = torch.empty(R, nch * L, C)
    aggregates, inclusive = [], []
    for k in range(nch):
        segments = np.array_split(np.arange(k * L, (k + 1) * L), warps)
        pairs = []
        for seg in segments:
            A, B = one, zero
            for t in seg:
                A, B = a[:, t] * A, a[:, t] * B + x[:, t]
            pairs.append((A, B))
        tA, tB = one, zero
        for A, B in pairs:
            tA, tB = A * tA, A * tB + B
        carry = zero
        if k > 0:
            accA, accB = one, zero
            for j in range(k - 1, -1, -1):
                if j == 0 or rng.random() < 0.5:
                    carry = accA * inclusive[j] + accB
                    break
                Aj, Bj = aggregates[j]
                accA, accB = accA * Aj, accA * Bj + accB
        aggregates.append((tA, tB))
        inclusive.append(tA * carry + tB)
        pA, pB = one, zero
        for (A, B), seg in zip(pairs, segments):
            state = pA * carry + pB
            for t in seg:
                state = a[:, t] * state + x[:, t]
                h[:, t] = state
            pA, pB = A * pA, A * pB + B
    if reverse:
        h = h.flip(1)
    return h[:, :T]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [1, 5, 16, 64])
def test_chunked_scan_algorithm_matches_reference(L, reverse):
    """The kernel's chunked local pass, pair combine, look-back and fix-up
    equal ``ref.py`` in fp32 (T = 37 ragged against every chunk length
    and below L = 64, C = 20 ragged against the lanes' 8 channels); in
    reverse, as the backward runs it, they equal the reference on the
    time-flipped inputs."""
    a, x, _ = _scan_inputs(3, 37, 20)
    if reverse:
        want = np.asarray(gated_linear_scan_reference(
            a[:, ::-1], x[:, ::-1]))[:, ::-1]
    else:
        want = np.asarray(gated_linear_scan_reference(a, x))
    got = _chunked_scan_emulation(_t(a), _t(x), L, reverse=reverse, seed=L)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True])
def test_chunked_scan_is_no_less_accurate_than_the_loop(reverse):
    """At decays near 1 (exp(-0.01 softplus(normal)), Mamba2's regime) with
    unit-variance x, h reaches ~40 and two fp32 summation orders of the
    same scan differ by more than 1e-4 at the extremes.  There the
    kernel's chunked order (L = 64 forward, 32 in reverse as the fp32
    backward runs) is no further from an fp64 loop than the plain fp32
    loop is: the card's checks scale x and g to keep h and the adjoint at
    unit variance, and this is why."""
    rng = np.random.default_rng(4)
    R, T, C = 2, 512, 256
    a = np.exp(-0.01 * np.logaddexp(0, rng.normal(size=(R, T, C))))
    a, x = a.astype(np.float32), rng.normal(size=(R, T, C)).astype(np.float32)
    if reverse:
        a_s, x_s = a[:, ::-1], x[:, ::-1]
    else:
        a_s, x_s = a, x
    want = np.zeros((R, T, C))
    state = np.zeros((R, C))
    for t in range(T):
        state = a_s[:, t].astype(np.float64) * state + x_s[:, t]
        want[:, t] = state
    loop = gated_linear_scan_plain(_t(a_s.copy()), _t(x_s.copy())).numpy()
    chunked = _chunked_scan_emulation(_t(a), _t(x), 32 if reverse else 64,
                                      reverse=reverse, seed=1).numpy()
    if reverse:
        chunked = chunked[:, ::-1]
    err_loop = np.abs(loop - want).max()
    assert err_loop > 1e-5              # the regime where the orders differ
    assert np.abs(chunked - want).max() <= err_loop


@pytest.mark.parametrize("R,T,C", [(3, 37, 20), (2, 100, 13)])
def test_gated_linear_scan_bwd_plain_matches_jax_vjp(R, T, C):
    """The plain backward from (a, h, g) against ``jax.vjp`` of the JAX
    kernel (interpret mode, its custom VJP) and of ``ref.py`` (autodiff
    through the scan), ragged T and C."""
    a, x, g = _scan_inputs(R, T, C)
    for f in (jax_scan, gated_linear_scan_reference):
        h, (da, dx) = _jax_value_and_vjp(f, g, a, x)
        got_da, got_dx = gated_linear_scan_bwd_plain(_t(a), _t(h), _t(g))
        np.testing.assert_allclose(got_da, da, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_dx, dx, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype_a,dtype_x", [("float32", "bfloat16"),
                                             ("bfloat16", "float32")])
def test_gated_linear_scan_mixed_dtypes_match_jax_kernel(dtype_a, dtype_x):
    """a and x of different dtypes, as the JAX kernel takes them: h in
    x's dtype, da in a's and dx in x's, equal to the JAX kernel (interpret
    mode) and its VJP at bf16's 2e-2."""
    a, x, g = _scan_inputs(2, 64, 24)
    ja, jx, jg = (jax.numpy.asarray(v).astype(dt) for v, dt in
                  ((a, dtype_a), (x, dtype_x), (g, dtype_x)))
    h, (da, dx) = _jax_value_and_vjp(jax_scan, jg, ja, jx)
    at, xt, gt = (_t(v).to(getattr(torch, dt)) for v, dt in
                  ((a, dtype_a), (x, dtype_x), (g, dtype_x)))
    at.requires_grad_(True)
    xt.requires_grad_(True)
    out = gated_linear_scan(at, xt)
    out.backward(gt)
    assert (out.dtype, at.grad.dtype, xt.grad.dtype) == (
        xt.dtype, at.dtype, xt.dtype)
    for got, want in ((out.detach(), h), (at.grad, da), (xt.grad, dx)):
        np.testing.assert_allclose(got.float(),
                                   np.asarray(want.astype("float32")),
                                   rtol=2e-2, atol=2e-2)
