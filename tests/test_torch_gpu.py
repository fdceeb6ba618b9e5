"""The port's CUDA kernels held to their plain PyTorch versions on the card.

Every test here needs a CUDA device and carries the ``gpu`` marker; without
a card each skips.  The file imports neither jax nor the JAX package, so
it runs on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports jax.)  fp32 is compared
with TF32 off at rtol 1e-4; bf16 at rtol/atol 2e-2, for bf16 rounding in
another summation order.
"""
import math

import pytest
import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention,
                                                 flash_attention_cuda,
                                                 flash_route)
from repro_torch.kernels.flash_attention.ops import (_ARGTYPES,
                                                     WGMMA_HEAD_DIMS,
                                                     bf16_config)
from repro_torch.kernels.linear_scan import (gated_linear_scan,
                                             gated_linear_scan_bwd_cuda,
                                             gated_linear_scan_bwd_plain,
                                             gated_linear_scan_cuda,
                                             gated_linear_scan_plain)
from repro_torch.kernels.skip_matmul import (skip_concat_matmul,
                                             skip_concat_matmul_cuda,
                                             skip_concat_matmul_plain)

FLASH_CASES = [
    # B, S, T, Hq, Hkv, D, causal, window
    (2, 40, 40, 4, 4, 16, False, None),       # uvit-pp self-attention
    (1, 37, 37, 2, 2, 32, True, None),        # causal, ragged length
    (1, 50, 50, 2, 2, 16, True, 8),           # causal + sliding window
    (2, 24, 24, 4, 1, 16, True, None),        # GQA (4 q heads per kv head)
    (1, 33, 33, 4, 2, 64, False, 5),          # window, non-causal, GQA 2
    (1, 258, 77, 2, 2, 16, False, None),      # ragged S=258 over T=77
    (2, 258, 258, 20, 20, 128, False, None),  # UViT-H, b=2
    (2, 16, 4, 4, 4, 8, False, None),         # hunyuan-pp cross
    (2, 1024, 77, 16, 16, 128, False, None),  # Hunyuan-DiT cross, b=2
    (1, 1024, 1024, 16, 16, 128, False, None),  # Hunyuan-DiT self
    # bf16 here takes the tensor-core route (D = 64, 128):
    (1, 258, 77, 2, 2, 128, False, None),     # ragged S=258 over T=77
    (2, 77, 200, 4, 4, 64, False, None),      # ragged, T > S
    (1, 300, 300, 8, 2, 64, True, 96),        # causal + window + GQA 4
    (1, 130, 130, 2, 2, 64, True, 0),         # every row fully masked
    (1, 100, 300, 4, 2, 128, False, 40),      # window, non-causal, GQA 2
    # the SDv2 UNet's heads (896 / 8 = 112, 1792 / 8 = 224), the tensor-core
    # route in bf16 (the head padded to 128 and 256 in shared memory), SIMT
    # in fp32: self and cross at each resolution, b=2, then ragged lengths,
    # causal + window + GQA
    (2, 256, 256, 8, 8, 112, False, None),    # level 1 self, 16x16
    (2, 256, 77, 8, 8, 112, False, None),     # level 1 cross
    (2, 64, 64, 8, 8, 224, False, None),      # level 2 self, 8x8
    (2, 64, 77, 8, 8, 224, False, None),      # level 2 cross
    (2, 16, 16, 8, 8, 224, False, None),      # level 3 and mid self, 4x4
    (2, 16, 77, 8, 8, 224, False, None),      # level 3 and mid cross
    (1, 45, 45, 4, 2, 112, True, 9),          # causal + window + GQA 2
    (1, 37, 70, 4, 1, 224, False, 20),        # window, non-causal, GQA 4
    # head dim 80 (zamba2-2.7b's shared attention, h2o-danube-1.8b): the
    # tensor-core route in bf16, the head padded to 128 columns
    (2, 200, 200, 4, 4, 80, False, None),     # zamba2's, non-causal
    (1, 130, 130, 8, 2, 80, True, 40),        # danube's: causal + window
    (1, 70, 33, 2, 1, 80, False, None),       # ragged cross, MQA
]

# attention over a KV cache of T rows: B, S, T, valid, q_offset, Hq, Hkv,
# D, causal, window -- decode steps (S = 1) and prefill chunks (S > 1)
CACHE_CASES = [
    (2, 1, 40, 31, 30, 4, 2, 64, True, None),     # a decode step, GQA
    (2, 1, 40, 40, 39, 4, 4, 80, True, None),     # the cache full, D = 80
    (1, 1, 300, 213, 212, 8, 2, 80, True, 64),    # window, D = 80
    (2, 1, 130, 65, 64, 4, 1, 16, True, None),    # MQA, SIMT in bf16
    (2, 7, 50, 19, 12, 4, 2, 64, True, None),     # a chunk of 7 at 12
    (1, 70, 200, 150, 80, 4, 2, 80, True, 33),    # a chunk over 2 q tiles
    (2, 24, 100, 24, 0, 4, 2, 128, True, None),   # a prefill: valid = S
    (2, 1, 90, 57, 0, 4, 4, 112, False, None),    # non-causal, D = 112
]


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _tol(dtype):
    return 1e-4 if dtype == "float32" else 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,D,N", [(516, 256, 256), (37, 24, 40),
                                   (130, 72, 200), (516, 2560, 2560),
                                   (37, 2560, 2560)])
def test_skip_concat_matmul_kernel_matches_plain(M, D, N, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    h, s = (torch.randn(M, D, device="cuda", generator=gen).to(dt)
            for _ in range(2))
    w = (torch.randn(2 * D, N, device="cuda", generator=gen)
         / (2 * D) ** 0.5).to(dt)
    before = LAUNCHES["skip_concat_matmul"]
    got = skip_concat_matmul_cuda(h, s, w)
    torch.cuda.synchronize()
    assert LAUNCHES["skip_concat_matmul"] == before + 1
    want = skip_concat_matmul_plain(h, s, w)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    # the differentiable op launches the kernel for CUDA tensors too
    x = skip_concat_matmul(h[None], s[None], w)
    assert x.shape == (1, M, N)
    assert LAUNCHES["skip_concat_matmul"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(B, S, T, Hq, Hkv, D, causal,
                                              window, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(B, S, Hq, D, device="cuda", generator=gen).to(dt)
    k, v = (torch.randn(B, T, Hkv, D, device="cuda", generator=gen).to(dt)
            for _ in range(2))
    # the route is a pure function of (dtype, head dim)
    assert flash_route(dt, D) == ("wgmma" if dtype == "bfloat16"
                                  and D in WGMMA_HEAD_DIMS else "simt")
    before = LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    want = attention_plain(q, k, v, causal, window)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    out = flash_attention(q.requires_grad_(True), k, v, causal, window)
    out.float().sum().backward()
    assert torch.isfinite(q.grad).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,valid,q_offset,Hq,Hkv,D,causal,window",
                         CACHE_CASES)
def test_flash_over_a_kv_cache_matches_plain(B, S, T, valid, q_offset, Hq,
                                             Hkv, D, causal, window, dtype):
    """Query row r at position ``q_offset + r`` over the first ``valid``
    rows of a cache of T rows, the kernel reading a layer's slice of a
    stacked cache in place: against the plain version, with the rows past
    ``valid`` filled with values that would change the result if read."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn(B, S, Hq, D, device="cuda", generator=gen).to(dt)
    cache = torch.randn(3, 2, B, T, Hkv, D, device="cuda",
                        generator=gen).to(dt)
    cache[:, :, :, valid:] = 1e4             # never summed, if masked
    k, v = cache[1, 0], cache[1, 1]          # layer 1's K and V, in place
    assert k.data_ptr() % 16 == 0 and k.is_contiguous()
    before = LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal, window, q_offset, valid)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    want = attention_plain(q, k, v, causal, window, q_offset, valid)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    # the op takes the same path; its backward recomputes through the plain
    # version with the same offset and valid length
    qg = q.clone().requires_grad_(True)
    out = flash_attention(qg, k, v, causal, window, q_offset=q_offset,
                          kv_valid_len=valid)
    assert LAUNCHES["flash_attention"] == before + 2
    torch.testing.assert_close(out, got, rtol=0, atol=0)
    out.float().sum().backward()
    assert torch.isfinite(qg.grad).all()
    with pytest.raises(ValueError, match="kv_valid_len"):
        flash_attention_cuda(q, k, v, causal, window, q_offset, T + 1)


@pytest.mark.gpu
def test_flash_decode_rounds_an_fp32_query_to_the_bf16_cache():
    """Zamba2's shared attention at a decode step (heads of 80): an fp32
    residual stream against bf16 weights and a bf16 KV cache.  With
    ``use_flash`` ``apply_attention`` rounds q to the cache's dtype for the
    kernel, where JAX computes the attention in fp32 with the fp32 q, as
    the dense ``attention`` does: the two held at the bf16 tolerance."""
    import dataclasses

    from repro_torch.models import layers as L

    bf = torch.bfloat16
    cfg = L.AttnConfig(d_model=512, n_heads=32, n_kv_heads=32, head_dim=80,
                       use_flash=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    p = L.init_attention(gen, cfg, bf, "cuda")
    B, max_len, pos = 2, 48, 30
    prefix = torch.randn(B, pos, cfg.d_model, device="cuda", generator=gen)
    x = torch.randn(B, 1, cfg.d_model, device="cuda", generator=gen)
    outs = []
    for use_flash in (True, False):
        c = dataclasses.replace(cfg, use_flash=use_flash)
        cache = L.init_kv_cache(B, max_len, c, bf, "cuda")
        _, cache = L.apply_attention(p, prefix, c, cache=cache)
        before = LAUNCHES["flash_attention"]
        out, cache = L.apply_attention(
            p, x, c, cache=cache,
            positions=torch.full((1, 1), pos, device="cuda"))
        assert LAUNCHES["flash_attention"] == before + use_flash
        assert out.dtype == torch.float32 and cache["pos"] == pos + 1
        outs.append(out)
    torch.testing.assert_close(outs[0], outs[1], rtol=_tol("bfloat16"),
                               atol=_tol("bfloat16"))


@pytest.mark.gpu
def test_flash_refuses_a_misaligned_cache_and_never_copies_it():
    """A cache the TMA route cannot load in place (its base 2 bytes past a
    16-byte boundary) is refused by the op as by the wrapper: over a cache
    nothing is copied."""
    bf = torch.bfloat16
    q = torch.randn(2, 1, 4, 80, device="cuda").to(bf)
    k = _misaligned((2, 40, 4, 80), bf)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flash_attention_cuda(q, k, k, True, None, 20, 21)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flash_attention(q, k, k, True, None, q_offset=20, kv_valid_len=21)
    # without a cache the op copies the view, as before
    torch.testing.assert_close(
        flash_attention(q, k, k, False, None).float(),
        attention_plain(q, k, k, False, None).float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_flash_at_the_smollm_attention_shape():
    """smollm-360m's attention at its full shape in the ``lm`` phase's
    pipeline: a microbatch of 2 at sequence 4096, causal GQA 15:5 at head
    dim 64 (bf16: the tensor-core route), through the differentiable op
    against the plain version, forward and the gradients (the op's backward
    recomputes through the plain version; the cotangent is the same)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(2, 4096, 15, 64, device="cuda", generator=gen)
    k, v = (torch.randn(2, 4096, 5, 64, device="cuda", generator=gen)
            for _ in range(2))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    g = torch.randn(2, 4096, 15, 64, device="cuda",
                    generator=gen).to(torch.bfloat16)
    assert flash_route(torch.bfloat16, 64) == "wgmma"
    before = LAUNCHES["flash_attention"]
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*ins, True, None)
    out.backward(g)
    assert LAUNCHES["flash_attention"] == before + 1
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = attention_plain(*ref, True, None)
    want.backward(g)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    for a, b in zip(ins, ref):
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,causal", [(447, 4096, False), (447, 447, True)])
def test_flash_at_the_whisper_attention_shapes(S, T, causal):
    """whisper-base's decoder attention at its full shape (batch 8, 8
    heads of 64, bf16: the tensor-core route): cross-attention of the 447
    decoder positions over 4096 encoded frames, and the causal self-
    attention over 447, a partial last tile; through the differentiable op
    against the plain version, forward and gradients."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(8, S, 8, 64, device="cuda", generator=gen)
    k, v = (torch.randn(8, T, 8, 64, device="cuda", generator=gen)
            for _ in range(2))
    g = torch.randn(8, S, 8, 64, device="cuda", generator=gen)
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    before = LAUNCHES["flash_attention"]
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*ins, causal, None)
    out.backward(g)
    assert LAUNCHES["flash_attention"] == before + 1
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = attention_plain(*ref, causal, None)
    want.backward(g)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    for a, b in zip(ins, ref):
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,D", [(256, 256, 112), (256, 77, 112),
                                   (64, 64, 224), (16, 77, 224),
                                   (200, 200, 80), (1, 77, 80)])
def test_flash_tensor_core_route_stores_no_pad_column(S, T, D):
    """At D = 80, 112 and 224 the kernel computes 128, 128 and 256 columns,
    those past D zero; it must store only the first D (and at S = 1 only
    the first of the tile's 64 rows).  With one head, the last
    row's pad columns would land past the output tensor: the launch writes
    into the head of a larger buffer filled with a sentinel, which must
    stay untouched behind the output, and the output must equal the plain
    version (the full-tensor comparison alone can miss a pad store that a
    later row's correct store overwrites)."""
    assert flash_route(torch.bfloat16, D) == "wgmma"
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(2, S, 1, D, device="cuda", generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(2, T, 1, D, device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    sentinel = 12345.0                       # exact in bf16, no output's value
    buf = torch.full((q.numel() + 4096,), sentinel, device="cuda",
                     dtype=torch.bfloat16)
    out = buf[:q.numel()].view(q.shape)
    build.call("flash_attention", "flash_attention_fwd_launch", _ARGTYPES,
               q.device, "flash_attention", q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), 2, S, T, 1, 1, D, 0, 0, 0, 0,
               T, 1.0 / math.sqrt(D), 1)
    torch.cuda.synchronize()
    assert torch.all(buf[q.numel():] == sentinel)
    torch.testing.assert_close(out.float(),
                               attention_plain(q, k, v, False).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("D", WGMMA_HEAD_DIMS)
def test_flash_bf16_config_fits_the_card(D):
    """The tensor-core route's tiling at each of its head dims: 64 queries
    by 64 keys, a 2-slot ring, a warpgroup and a producer warp, the head
    padded to whole 64-column boxes in shared memory (Q and the ring,
    barriers and 1 KB of alignment slack), and at least one resident
    block an SM (two at D <= 128)."""
    cfg = bf16_config(D)
    dp = -(-D // 64) * 64
    assert (cfg["query_rows"], cfg["keys_per_tile"], cfg["stages"],
            cfg["threads"]) == (64, 64, 2, 160)
    assert cfg["smem_bytes"] == 64 * dp * 2 * 5 + 5 * 8 + 1024
    assert cfg["smem_bytes"] <= 227 * 1024
    assert cfg["blocks_per_sm"] >= (2 if D <= 128 else 1)


SCAN_DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
               ("float32", "bfloat16"), ("bfloat16", "float32")]


def _scan_inputs(R, T, C, dtype_a, dtype_x, seed=2, misaligned=False,
                 decay="sigmoid", scaled=True):
    """a = sigmoid(normal) or, with ``decay="near 1"``,
    exp(-0.01 softplus(normal)) (Mamba2's regime: a chunk's product of a is
    ~0.6, so the carry between warps and the look-back over many chunks
    decide h); x and the cotangent g normal, near 1 ``scaled`` by
    sqrt(1 - a^2) to keep h and the adjoint at unit variance (see
    ``chip_smoke.scan_inputs``).  With ``misaligned``, each a contiguous
    view 2 or 4 bytes past a 16-byte boundary (the kernel's masked
    path)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    make = _misaligned if misaligned else (
        lambda shape, dt: torch.empty(shape, device="cuda", dtype=dt))
    v, x, g = (torch.randn(R, T, C, device="cuda", generator=gen)
               for _ in range(3))
    if decay == "sigmoid":
        a = torch.sigmoid(v)
    else:
        a = torch.exp(-0.01 * torch.nn.functional.softplus(v))
        if scaled:
            x, g = (t * torch.sqrt(1 - a * a) for t in (x, g))
    out = []
    for dt, val in ((dtype_a, a), (dtype_x, x), (dtype_x, g)):
        t = make((R, T, C), getattr(torch, dt))
        t.copy_(val)
        out.append(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_a,dtype_x", SCAN_DTYPES)
@pytest.mark.parametrize("R,T,C,misaligned", [
    (4, 512, 5120, False),     # zamba2-2.7b's Mamba2 width
    (3, 300, 200, False),      # one ragged channel tile
    (2, 100, 512, False),      # T ragged against every chunk length
    (1, 1, 7, False),          # C % 8 != 0: the masked path
    (2, 129, 7, False),        # the masked path over several chunks
    (2, 70, 64, True),         # misaligned bases: the masked path
    (70_000, 3, 8, False),     # R beyond the grid's y limit
    (2, 32, 327_680, False),   # zamba2-2.7b's carry across 4096/128 chunks
])
@pytest.mark.parametrize("decay", ["sigmoid", "near 1"])
def test_gated_linear_scan_kernel_matches_plain(R, T, C, misaligned,
                                                dtype_a, dtype_x, decay):
    """Forward and backward kernels against the plain versions on the
    same inputs, and the op's forward and backward (one launch each)
    against autograd through the plain version."""
    a, x, g = _scan_inputs(R, T, C, dtype_a, dtype_x, misaligned=misaligned,
                           decay=decay)
    tol = max(_tol(dtype_a), _tol(dtype_x))
    before = LAUNCHES["gated_linear_scan"]
    got = gated_linear_scan_cuda(a, x)
    torch.cuda.synchronize()
    assert LAUNCHES["gated_linear_scan"] == before + 1
    assert got.dtype == x.dtype
    torch.testing.assert_close(got.float(),
                               gated_linear_scan_plain(a, x).float(),
                               rtol=tol, atol=tol)
    da, dx = gated_linear_scan_bwd_cuda(a, got, g)
    torch.cuda.synchronize()
    want_da, want_dx = gated_linear_scan_bwd_plain(a, got, g)
    assert (da.dtype, dx.dtype) == (a.dtype, g.dtype)
    torch.testing.assert_close(da.float(), want_da.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol,
                               atol=tol)
    before = LAUNCHES["gated_linear_scan"]
    ins = [t.clone().requires_grad_(True) for t in (a, x)]
    gated_linear_scan(*ins).backward(g)
    assert LAUNCHES["gated_linear_scan"] == before + 2   # forward, backward
    if dtype_a == dtype_x:
        ref = [t.clone().requires_grad_(True) for t in (a, x)]
        gated_linear_scan_plain(*ref).backward(g)
        want = [r.grad for r in ref]
    else:
        # the JAX VJP rounds g to a's dtype before the reversed scan, which
        # autograd through the plain version does not: hold the op to the
        # plain transcription of that VJP
        want = gated_linear_scan_bwd_plain(a, gated_linear_scan_plain(a, x),
                                           g)
    for got_g, want_g in zip((i.grad for i in ins), want):
        torch.testing.assert_close(got_g.float(), want_g.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
def test_mamba2_scan_route_matches_the_chunk_loop():
    """A Mamba2 block (d_model 256: 8 heads, N = P = 64, chunk 128) at
    S=512, batch 2, fp32: ``_ssd_chunked`` (the carry through the scan
    kernel, one launch forward and one backward) against
    ``_ssd_chunked_plain`` (the loop over chunks) on the card, the output
    and every gradient leaf at rtol 1e-4 (atol 1e-5 of the leaf's
    largest magnitude)."""
    from repro_torch.models import mamba
    cfg = mamba.Mamba2Config(d_model=256)
    gen = torch.Generator(device="cuda").manual_seed(6)
    p = mamba.init_mamba2_block(gen, cfg, torch.float32, "cuda")
    x = torch.randn(2, 512, 256, device="cuda", generator=gen)
    outs = {}
    for route, ssd in (("scan", mamba._ssd_chunked),
                       ("plain", mamba._ssd_chunked_plain)):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xi = x.clone().requires_grad_(True)
        before = LAUNCHES["gated_linear_scan"]
        y, _ = mamba.apply_mamba2_block(leaves, xi, cfg, ssd=ssd)
        y.square().sum().backward()
        torch.cuda.synchronize()
        launched = LAUNCHES["gated_linear_scan"] - before
        assert launched == (2 if route == "scan" else 0)
        outs[route] = {"y": y.detach(), "x": xi.grad,
                       **{k: v.grad for k, v in leaves.items()}}
    for k, want in outs["plain"].items():
        got = outs["scan"][k]
        atol = 1e-5 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=atol,
                                   msg=lambda m: f"{k}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_linear_scan_graph_replays_agree(dtype):
    """The forward and backward captured in one CUDA graph and replayed
    twice: the look-back's flags and ticket are zeroed inside the capture,
    so each replay equals the plain version again."""
    a, x, g = _scan_inputs(2, 300, 512, dtype, dtype)
    tol = _tol(dtype)
    gated_linear_scan_bwd_cuda(a, gated_linear_scan_cuda(a, x), g)
    torch.cuda.synchronize()         # built and loaded outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h = gated_linear_scan_cuda(a, x)
        da, dx = gated_linear_scan_bwd_cuda(a, h, g)
    want_h = gated_linear_scan_plain(a, x)
    want_da, want_dx = gated_linear_scan_bwd_plain(a, want_h, g)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in ((h, want_h), (da, want_da), (dx, want_dx)):
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.gpu
def test_gated_linear_scan_kernel_is_no_less_accurate_than_plain():
    """fp32 at decays near 1 with unscaled x and g, where h and the adjoint
    reach ~40: the kernel's h and dx are no further from an fp64 loop than
    the plain version's fp32 loop is."""
    a, x, g = _scan_inputs(4, 512, 5120, "float32", "float32",
                           decay="near 1", scaled=False)

    def loop64(av, xv):
        state = torch.zeros(av.shape[0], av.shape[2], dtype=torch.float64,
                            device="cuda")
        out = torch.empty(av.shape, dtype=torch.float64, device="cuda")
        for t in range(av.shape[1]):
            state = av[:, t].double() * state + xv[:, t].double()
            out[:, t] = state
        return out

    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    want_h = loop64(a, x)
    want_dx = loop64(a_next.flip(1), g.flip(1)).flip(1)
    h = gated_linear_scan_cuda(a, x)
    _, dx = gated_linear_scan_bwd_cuda(a, h, g)
    plain_h = gated_linear_scan_plain(a, x)
    _, plain_dx = gated_linear_scan_bwd_plain(a, plain_h, g)
    for got, plain, want in ((h, plain_h, want_h), (dx, plain_dx, want_dx)):
        assert ((got.double() - want).abs().max()
                <= (plain.double() - want).abs().max())


def _misaligned(shape, dtype):
    """A contiguous view of ``shape`` whose base is 2 bytes past a 16-byte
    boundary."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.randn(n + 1, device="cuda").to(dtype)
    t = buf[1:].view(shape)
    assert t.data_ptr() % 16 != 0
    return t


@pytest.mark.gpu
def test_misaligned_views_are_copied_by_the_ops_and_refused_by_wrappers():
    """TMA needs 16-byte-aligned bases: the ops copy a view that starts
    elsewhere, the wrappers name the rule."""
    bf = torch.bfloat16
    h, s = _misaligned((130, 72), bf), _misaligned((130, 72), bf)
    w = (torch.randn(144, 200, device="cuda") / 12).to(bf)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        skip_concat_matmul_cuda(h, s, w)
    torch.testing.assert_close(skip_concat_matmul(h, s, w).float(),
                               skip_concat_matmul_plain(h, s, w).float(),
                               rtol=2e-2, atol=2e-2)
    q = _misaligned((1, 70, 2, 128), bf)
    k = torch.randn(1, 50, 2, 128, device="cuda").to(bf)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flash_attention_cuda(q, k, k, False, None)
    torch.testing.assert_close(
        flash_attention(q, k, k, False, None).float(),
        attention_plain(q, k, k, False, None).float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_bf16_kernels_launch_on_each_card_after_a_device_switch():
    """The tensor-core kernels' shared-memory opt-in holds per device
    context, so each launch sets it: the bf16 routes run on every card in
    turn, the current device switched between them, and again on the
    first card after the others (on a one-card machine, that card)."""
    bf = torch.bfloat16
    n = torch.cuda.device_count()
    for i in list(range(n)) + [0]:
        with torch.cuda.device(i):
            gen = torch.Generator(device="cuda").manual_seed(i)
            h, s = (torch.randn(130, 72, device="cuda", generator=gen).to(bf)
                    for _ in range(2))
            w = (torch.randn(144, 200, device="cuda", generator=gen)
                 / 12).to(bf)
            torch.testing.assert_close(
                skip_concat_matmul_cuda(h, s, w).float(),
                skip_concat_matmul_plain(h, s, w).float(), rtol=2e-2,
                atol=2e-2)
            q, k = (torch.randn(1, 70, 2, 128, device="cuda",
                                generator=gen).to(bf) for _ in range(2))
            torch.testing.assert_close(
                flash_attention_cuda(q, k, k, False, None).float(),
                attention_plain(q, k, k, False, None).float(), rtol=2e-2,
                atol=2e-2)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.randn(8, 16, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        skip_concat_matmul_cuda(x, x, torch.randn(32, 8, device="cuda",
                                                  dtype=torch.float16))
    y = torch.randn(8, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        skip_concat_matmul_cuda(y.t().contiguous().t(), y,
                                torch.randn(32, 8, device="cuda"))
    q = torch.randn(1, 4, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q, q)
    z = torch.randn(8, 12, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D % 8 == N % 8 == 0"):
        skip_concat_matmul_cuda(z, z, torch.randn(
            24, 8, device="cuda", dtype=torch.bfloat16))
    a = torch.rand(2, 5, 3, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gated_linear_scan_cuda(a, a.to(torch.float16))
    with pytest.raises(ValueError, match="3-D"):
        gated_linear_scan_cuda(a[0], a[0])
    with pytest.raises(TypeError, match="output's dtype"):
        gated_linear_scan_bwd_cuda(a, a, a.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the profiler and the tuner's plan on the card
# ---------------------------------------------------------------------------

def _uvit(dtype, **over):
    from repro_torch.models.diffusion import UViTConfig
    kw = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
              n_heads=4, d_ff=64, n_classes=10)
    kw.update(over)
    return UViTConfig("t", use_skip_kernel=True, use_flash=True, dtype=dtype,
                      param_dtype=dtype, **kw)


@pytest.mark.gpu
def test_measure_block_times_on_cuda_agrees_with_cuda_events():
    """Every block's forward through the kernels (bf16: flash attention's
    tensor-core route at head dim 128, the skip matmul's wgmma GEMM in each
    decoder block), timed by ``measure_block_times`` three ways, each
    within 2x of the others: first on blocks never called before, with only
    the profiler's own warm-up (the cold run); then again, warm; then by a
    CUDA event pair around the same calls.  The blocks are wide enough
    (batch 32 of 258 tokens, d_model 1024) that the device, not the host's
    issue rate, sets their time."""
    from repro_torch.core.profiler import measure_block_times
    from repro_torch.runtime.adapters import diffusion_model_fns
    from repro_torch.tree import tree_map

    cfg = _uvit(torch.bfloat16, img_size=32, d_model=1024, n_heads=8,
                d_ff=4096, n_layers=4)
    fns = diffusion_model_fns(cfg)
    params = fns.init_fn(torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    (enc, dec), _ = fns.split_blocks(params)
    x = torch.randn(32, cfg.n_tokens, cfg.d_model, device="cuda").to(
        torch.bfloat16)
    calls = ([(fns.enc_block_fn, (tree_map(lambda a: a[r], enc), x, {}))
              for r in range(cfg.half)]
             + [(fns.dec_block_fn, (tree_map(lambda a: a[r], dec), x, x, {}))
                for r in range(cfg.half)])
    iters = 10
    with torch.no_grad():
        before = dict(LAUNCHES)
        cold = measure_block_times([f for f, _ in calls],
                                   [a for _, a in calls], iters=iters)
        launched = {k: LAUNCHES[k] - before[k] for k in before}
        warm = measure_block_times([f for f, _ in calls],
                                   [a for _, a in calls], iters=iters)
        want = []
        for f, a in calls:
            f(*a)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                f(*a)
            end.record()
            end.synchronize()
            want.append(start.elapsed_time(end) / 1e3 / iters)
    assert launched["flash_attention"] == 2 * cfg.half * (1 + iters)
    assert launched["skip_concat_matmul"] == cfg.half * (1 + iters)
    assert len(cold) == len(warm) == len(calls)
    for c, g, w in zip(cold, warm, want):
        assert isinstance(c, float) and c > 0
        assert g / 2 <= c <= 2 * g, (cold, warm, want)
        assert w / 2 <= g <= 2 * w, (cold, warm, want)


@pytest.mark.gpu
def test_tuner_plan_step_on_cuda_matches_cpu():
    """``auto_pipeline(graph, fns, 2)`` plans by itself (P=2, V=2, M=2) and
    one fp32 step of that plan on the card equals the same step on the CPU
    at rtol 1e-4, with both kernels launched on the card."""
    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.models.diffusion import uvit_pipeline_graph
    from repro_torch.runtime.adapters import (diffusion_model_fns,
                                              make_diffusion_microbatches)
    from repro_torch.runtime.compile import auto_pipeline
    from repro_torch.tree import tree_map, tree_paths

    cfg = _uvit(torch.float32)
    cp = auto_pipeline(uvit_pipeline_graph(cfg, batch=2),
                       diffusion_model_fns(cfg), 2, wire_dtype="float32")
    assert (cp.choice.P, cp.choice.G, cp.layout.V) == (2, 1, 2)
    assert cp.certify().ok
    M = cp.pcfg.num_microbatches
    params = cp.model_fns.init_fn(torch.Generator().manual_seed(0), "cpu")
    raw = SyntheticLatentDataset(img_size=8, channels=4).batch(0, 0, 2 * M)
    gen = torch.Generator().manual_seed(1)
    t = torch.rand((2 * M,), generator=gen)
    noise = torch.randn((2 * M, 8, 8, 4), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.detach().to(dev).clone().requires_grad_(True),
                     cp.split_params(params))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        mb, aux = make_diffusion_microbatches(batch, M, t=t.to(dev),
                                              noise=noise.to(dev))
        (enc, dec), edge = p
        before = dict(LAUNCHES)
        loss = cp.build()(enc, dec, edge, mb, aux)
        loss.backward()
        launched = {k: LAUNCHES[k] - before[k] for k in before}
        grads = cp.merge_params(*tree_map(
            lambda a: a.grad if a.grad is not None else torch.zeros_like(a),
            p))
        out[dev] = (float(loss.detach()),
                    {k: v.cpu() for k, v in tree_paths(grads)},
                    launched)
    assert out["cpu"][2] == {k: 0 for k in LAUNCHES}
    assert out["cuda"][2]["flash_attention"] > 0
    assert out["cuda"][2]["skip_concat_matmul"] > 0
    assert math.isclose(out["cuda"][0], out["cpu"][0], rel_tol=1e-4)
    for k, want in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], want, rtol=1e-4,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the closed-form executors, the skip-carry baseline and the linear
# executors on the card
# ---------------------------------------------------------------------------

def _uvit_inputs(cfg, M):
    """fp32 UViT params on the CPU from seed 0, and one step's batch."""
    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.runtime.adapters import diffusion_model_fns
    params = diffusion_model_fns(cfg).init_fn(
        torch.Generator().manual_seed(0), "cpu")
    raw = SyntheticLatentDataset(img_size=8, channels=4).batch(0, 0, 2 * M)
    gen = torch.Generator().manual_seed(1)
    return (params, raw, torch.rand((2 * M,), generator=gen),
            torch.randn((2 * M, 8, 8, 4), generator=gen))


def _card_vs_cpu(step, kernels):
    """``step(dev) -> (loss, grads by path)`` on the CPU and on the card:
    loss and every gradient at rtol 1e-4, the ``kernels`` launched on the
    card only."""
    out = {}
    for dev in ("cpu", "cuda"):
        before = dict(LAUNCHES)
        loss, grads = step(dev)
        launched = {k: LAUNCHES[k] - before[k] for k in before}
        out[dev] = (loss, grads, launched)
    assert out["cpu"][2] == {k: 0 for k in LAUNCHES}
    for k in kernels:
        assert out["cuda"][2][k] > 0, out["cuda"][2]
    assert math.isclose(out["cuda"][0], out["cpu"][0], rel_tol=1e-4)
    assert sorted(out["cuda"][1]) == sorted(out["cpu"][1])
    for k, want in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], want, rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("executor", ["closed_form", "skip_carry"])
def test_closed_form_and_skip_carry_on_cuda_match_cpu(executor):
    """The closed-form wave (``auto_pipeline(..., executor="closed_form")``,
    D=4, M=4) and the paper's skip-carry baseline
    (``DiffusionPipelineAdapter``, D=4, M=4) in fp32, one step on the card
    against the same step on the CPU, both kernels launched on the card."""
    from repro_torch.models.diffusion import uvit_pipeline_graph
    from repro_torch.runtime.adapters import (DiffusionPipelineAdapter,
                                              diffusion_model_fns,
                                              make_diffusion_microbatches)
    from repro_torch.runtime.compile import auto_pipeline
    from repro_torch.runtime.pipeline import PipelineConfig
    from repro_torch.tree import tree_map, tree_paths

    D, M = 4, 4
    cfg = _uvit(torch.float32)
    params, raw, t, noise = _uvit_inputs(cfg, M)
    if executor == "closed_form":
        cp = auto_pipeline(uvit_pipeline_graph(cfg, batch=2),
                           diffusion_model_fns(cfg), D, pipeline_devices=D,
                           microbatches=M, executor="closed_form")
        split, build = cp.split_params, cp.build
    else:
        ad = DiffusionPipelineAdapter(cfg, PipelineConfig(D, M), "uvit")
        split, build = ad.split_params_skip_carry, ad.build_skip_carry_baseline

    def step(dev):
        p = tree_map(lambda a: a.detach().to(dev).clone().requires_grad_(True),
                     split(params))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        mb, aux = make_diffusion_microbatches(batch, M, t=t.to(dev),
                                              noise=noise.to(dev))
        (enc, dec), edge = p
        loss = build()(enc, dec, edge, mb, aux)
        loss.backward()
        grads = tree_map(lambda a: a.grad if a.grad is not None
                         else torch.zeros_like(a), p)
        return float(loss.detach()), {k: v.cpu()
                                      for k, v in tree_paths(grads)}

    _card_vs_cpu(step, ("flash_attention", "skip_concat_matmul"))


@pytest.mark.gpu
@pytest.mark.parametrize("executor", ["table", "closed_form"])
def test_linear_executors_on_cuda_match_cpu(executor):
    """The linear executors on a skip-free graph of UViT encoder blocks
    (D=2, M=4, uneven cuts, fp32, fp32 wire), card against CPU; flash
    attention launches on the card (no block has a skip to project)."""
    from repro_torch.core.graph import Block, BlockGraph
    from repro_torch.models import diffusion as dm
    from repro_torch.runtime.adapters import make_diffusion_microbatches
    from repro_torch.runtime.compile import PipelineModelFns, auto_pipeline
    from repro_torch.tree import tree_map, tree_paths

    D, M = 2, 4
    cfg = _uvit(torch.float32, n_layers=16)
    fns = PipelineModelFns(
        init_fn=None,
        embed_fn=lambda e, mb, aux: dm.uvit_embed(e, mb["xt"], mb["t"], mb,
                                                  cfg),
        loss_fn=lambda e, x, mb, aux: torch.mean(torch.square(
            dm.uvit_output(e, x, cfg) - mb["noise"])),
        split_blocks=lambda p: ((p["enc_blocks"],), {
            k: v for k, v in p.items() if k != "enc_blocks"}),
        merge_blocks=lambda s, e: {**e, "enc_blocks": s[0]},
        block_fn=lambda bp, x, aux: dm._apply_vit_block(bp, x, cfg),
        num_param_stacks=1)
    graph = BlockGraph(tuple(Block(f"b{i}", float(c), param_bytes=1 << 10,
                                   act_bytes=1 << 10)
                             for i, c in enumerate([4, 2, 1, 1, 1, 1, 1, 1])))
    cp = auto_pipeline(graph, fns, D, pipeline_devices=D, microbatches=M,
                       lam=0.0, wire_dtype="float32", executor=executor)
    assert not cp.folded and len(set(cp.partition.stage_sizes())) > 1
    params, raw, t, noise = _uvit_inputs(cfg, M)
    params = {k: v for k, v in params.items() if k != "dec_blocks"}

    def step(dev):
        p = tree_map(lambda a: a.detach().to(dev).clone().requires_grad_(True),
                     cp.split_params(params))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        mb, aux = make_diffusion_microbatches(batch, M, t=t.to(dev),
                                              noise=noise.to(dev))
        (stack,), edge = p
        loss = cp.build()(stack, edge, {**mb, "t": aux["t"]})
        loss.backward()
        grads = cp.merge_params(*tree_map(
            lambda a: a.grad if a.grad is not None else torch.zeros_like(a),
            p))
        return float(loss.detach()), {k: v.cpu()
                                      for k, v in tree_paths(grads)}

    _card_vs_cpu(step, ("flash_attention",))


@pytest.mark.gpu
def test_two_ranks_on_one_card_train_as_one_process(tmp_path):
    """The trainer over two ranks sharing the card (``torchrun``, ``--ring
    gloo --device cuda``: payloads staged through pinned host memory),
    ``uvit-pp`` fp32 with an fp32 wire, 3 steps, against the one-process
    trainer on the card: losses at rtol 1e-4 on both ranks, each rank on a
    CUDA device with both kernels launched in its own process."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    import repro_torch
    from repro_torch.launch import train

    argv = ["--arch", "uvit-pp", "--pipeline", "--devices", "2", "--steps",
            "3", "--microbatches", "4", "--global-batch", "8",
            "--wire-dtype", "float32", "--device", "cuda"]
    want = train.run(train._parse_args(argv)).losses
    src = str(pathlib.Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *argv,
         "--ring", "gloo", "--out-json", str(tmp_path / "r{rank}.json")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("[train] device: cuda:") == 2, proc.stdout
    assert "gloo ring (staged through pinned host memory)" in proc.stdout
    for r in range(2):
        doc = json.loads((tmp_path / f"r{r}.json").read_text())
        for s in range(3):
            assert math.isclose(doc["losses"][str(s)], want[s],
                                rel_tol=1e-4), (r, s)
        for k in ("flash_attention", "skip_concat_matmul"):
            assert doc["launches"][k] > 0, (r, doc["launches"])


@pytest.mark.gpu
def test_int8_adamw_update_on_cuda_matches_cpu():
    """Three int8 AdamW steps on the card and on the CPU from the same
    params and gradients (clipping off: its global norm is a reduction in
    another order): codes and scales equal, params at rtol 1e-6.  Every
    other operation is elementwise or a max, correctly rounded on both."""
    from repro_torch.optim import (AdamWConfig, int8_adamw_init,
                                   int8_adamw_update)
    from repro_torch.tree import tree_map, tree_paths

    gen = torch.Generator().manual_seed(3)
    shapes = {"a": (37, 50), "b": (8192,), "c": {"d": (3, 3, 3)}}
    params = {"a": torch.randn(37, 50, generator=gen),
              "b": torch.randn(8192, generator=gen),
              "c": {"d": torch.randn(3, 3, 3, generator=gen)}}
    cfg = AdamWConfig(lr=1e-2, clip_norm=0.0)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev).clone(), params)
        s = int8_adamw_init(p)
        g = torch.Generator().manual_seed(4)
        for step in range(3):
            grads = tree_map(lambda x: (torch.randn(x.shape, generator=g)
                                        * (step + 1)).to(dev), p)
            int8_adamw_update(p, grads, s, cfg)
        runs[dev] = (p, s)
    assert sorted(shapes) == sorted(runs["cuda"][0])
    (pc, sc), (pg, sg) = runs["cpu"], runs["cuda"]
    for k, x in tree_paths(pg):
        torch.testing.assert_close(x.cpu(), dict(tree_paths(pc))[k],
                                   rtol=1e-6, atol=0.0)
    for mom in ("m", "v"):
        want = dict(tree_paths(sc[mom]))
        for k, x in tree_paths(sg[mom]):
            assert x.device.type == "cuda"
            assert torch.equal(x.cpu(), want[k]), (mom, k)


@pytest.mark.gpu
def test_lm_pipeline_adapter_wave_with_flash_matches_dense_cpu():
    """``LMPipelineAdapter``'s folded wave (D=2, M=4) on a bf16 LM with
    heads of 64 (flash's tensor-core route) on the card, against the same
    params through dense attention on the CPU: the loss and every gradient
    at this file's bf16 rtol/atol 2e-2, each gradient also at ||err|| /
    ||g|| <= 5e-2, the bf16 pipeline parity bar of ``chip_smoke.py`` (bf16
    rounding alone puts these gradients 1.6-2.1e-2 from fp32 on the CPU);
    flash once a layer and microbatch, twice with the stage remat."""
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.models.layers import AttnConfig
    from repro_torch.runtime.adapters import LMPipelineAdapter
    from repro_torch.runtime.pipeline import PipelineConfig
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    cfg = lm.LMConfig("wave-smoke", vocab=256, d_model=128, n_layers=4,
                      attn=AttnConfig(128, 2, 1, 64, use_flash=True),
                      d_ff=256, tied_embeddings=True, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    dense = dataclasses.replace(
        cfg, attn=dataclasses.replace(cfg.attn, use_flash=False))
    gen = torch.Generator().manual_seed(5)
    params = lm.init_lm(gen, cfg, "cpu")
    tokens = torch.randint(0, 256, (4, 2, 64), generator=gen,
                           dtype=torch.int32)
    out = {}
    for dev, c in (("cuda", cfg), ("cpu", dense)):
        ad = LMPipelineAdapter(c, PipelineConfig(2, 4), wave=True)
        stacks, edge = ad.split_params(tree_map(lambda x: x.to(dev).clone(),
                                                params))
        for x in tree_leaves((stacks, edge)):
            x.requires_grad_(True)
        before = LAUNCHES["flash_attention"]
        loss = ad.build()(*stacks, edge, {"tokens": tokens.to(dev)})
        loss.backward()
        launched = LAUNCHES["flash_attention"] - before
        grads = ad.merge_params(*tree_map(lambda x: x.grad, (stacks, edge)))
        out[dev] = (float(loss.detach()), {k: v.float().cpu()
                                  for k, v in tree_paths(grads)}, launched)
    assert out["cuda"][2] == cfg.n_layers * 4 * 2 and out["cpu"][2] == 0
    assert math.isclose(out["cuda"][0], out["cpu"][0], rel_tol=2e-2)
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
        err = float(torch.linalg.vector_norm(got - want)
                    / torch.linalg.vector_norm(want))
        assert err <= 5e-2, (k, err)


# ---------------------------------------------------------------------------
# the launch predicates against the kernels
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_kernel_check_tilings_are_the_kernels_reports():
    """Every route's predicted tiles and shared memory are what the kernel
    reports (blocks per SM aside), and the budget is the card's opt-in
    shared memory a block."""
    from repro_torch.analysis import kernel_check as kc
    from repro_torch.kernels.linear_scan import scan_config
    from repro_torch.kernels.skip_matmul.ops import bf16_config as skip_cfg

    def same(pred, cuda):
        assert {k: v for k, v in cuda.items() if k != "blocks_per_sm"} == \
            {k: v for k, v in pred.items() if k != "route"}
    assert kc.SMEM_OPTIN == torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin
    for D in WGMMA_HEAD_DIMS:
        same(kc.flash_tiling("bfloat16", D), bf16_config(D))
    same(kc.skip_tiling("bfloat16"), skip_cfg())
    for a in kc.DTYPES:
        for x in kc.DTYPES:
            for bwd in (False, True):
                same(kc.scan_tiling(a, x, bwd), scan_config(
                    getattr(torch, a), getattr(torch, x), bwd))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 70, 70, 4, 2, 64), (2, 70, 70, 4, 2, 48), (1, 64, 64, 6, 4, 64),
    (1, 64, 64, 6, 3, 224)])
def test_flash_predicate_agrees_with_the_launch(dtype, shape):
    """An accepted shape launches (one count) and equals the plain
    version; a refused one raises before a launch."""
    from repro_torch.analysis import kernel_check as kc
    B, S, T, Hq, Hkv, D = shape
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, Hq, D, device="cuda").to(dt)
    k = torch.randn(B, T, Hkv, D, device="cuda").to(dt)
    before = LAUNCHES["flash_attention"]
    if kc.flash_attention_supported(*shape, dtype=dtype):
        got = flash_attention_cuda(q, k, k, True, None)
        tol = 1e-4 if dtype == "float32" else 2e-2
        torch.testing.assert_close(got.float(), attention_plain(
            q, k, k, True, None).float(), rtol=tol, atol=tol)
        assert LAUNCHES["flash_attention"] == before + 1
    else:
        with pytest.raises(ValueError):
            flash_attention_cuda(q, k, k, True, None)
        assert LAUNCHES["flash_attention"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,D,N", [(516, 256, 256), (64, 12, 8),
                                   (64, 16, 12), (64, 12, 7)])
def test_skip_predicate_agrees_with_the_launch(dtype, M, D, N):
    from repro_torch.analysis import kernel_check as kc
    dt = getattr(torch, dtype)
    h = torch.randn(M, D, device="cuda").to(dt)
    w = (torch.randn(2 * D, N, device="cuda") / math.sqrt(D)).to(dt)
    before = LAUNCHES["skip_concat_matmul"]
    if kc.skip_concat_matmul_supported(M, D, N, dtype=dtype):
        got = skip_concat_matmul_cuda(h, h, w)
        tol = 1e-4 if dtype == "float32" else 2e-2
        torch.testing.assert_close(got.float(), skip_concat_matmul_plain(
            h, h, w).float(), rtol=tol, atol=tol)
        assert LAUNCHES["skip_concat_matmul"] == before + 1
    else:
        with pytest.raises(ValueError, match="D % 8 == N % 8 == 0"):
            skip_concat_matmul_cuda(h, h, w)
        assert LAUNCHES["skip_concat_matmul"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_a,dtype_x", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16"),
    ("float16", "float32")])
def test_scan_predicate_agrees_with_the_launch(dtype_a, dtype_x):
    from repro_torch.analysis import kernel_check as kc
    a = torch.sigmoid(torch.randn(2, 130, 300, device="cuda")).to(
        getattr(torch, dtype_a))
    x = torch.randn(2, 130, 300, device="cuda").to(getattr(torch, dtype_x))
    before = LAUNCHES["gated_linear_scan"]
    if kc.gated_linear_scan_supported(2, 130, 300, dtype_a=dtype_a,
                                      dtype_x=dtype_x):
        tol = 1e-4 if "bfloat16" not in (dtype_a, dtype_x) else 2e-2
        torch.testing.assert_close(
            gated_linear_scan_cuda(a, x).float(),
            gated_linear_scan_plain(a, x).float(), rtol=tol, atol=tol)
        assert LAUNCHES["gated_linear_scan"] == before + 1
    else:
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            gated_linear_scan_cuda(a, x)
        assert LAUNCHES["gated_linear_scan"] == before
