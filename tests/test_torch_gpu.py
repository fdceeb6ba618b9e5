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
@pytest.mark.parametrize("S,T,D", [(256, 256, 112), (256, 77, 112),
                                   (64, 64, 224), (16, 77, 224)])
def test_flash_tensor_core_route_stores_no_pad_column(S, T, D):
    """At D = 112 and 224 the kernel computes 128 and 256 columns, those
    past D zero; it must store only the first D.  With one head, the last
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
               v.data_ptr(), out.data_ptr(), 2, S, T, 1, 1, D, 0, 0, 0,
               1.0 / math.sqrt(D), 1)
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
