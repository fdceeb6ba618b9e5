"""The port's CUDA kernels held to their plain PyTorch versions on the card.

Every test here needs a CUDA device and carries the ``gpu`` marker; without
a card each skips.  The file imports neither jax nor the JAX package, so
it runs on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports jax.)  fp32 is compared
with TF32 off at rtol 1e-4; bf16 at rtol/atol 2e-2, for bf16 rounding in
another summation order.
"""
import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention,
                                                 flash_attention_cuda,
                                                 flash_route)
from repro_torch.kernels.linear_scan import (gated_linear_scan,
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
                                  and D in (64, 128) else "simt")
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
@pytest.mark.parametrize("R,T,C", [(4, 512, 5120), (3, 300, 200),
                                   (1, 1, 7)])
def test_gated_linear_scan_kernel_matches_plain(R, T, C, dtype):
    """Forward, and the op's backward (the kernel on the time-reversed
    scan) against autograd through the plain version."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(2)
    a = torch.sigmoid(torch.randn(R, T, C, device="cuda",
                                  generator=gen)).to(dt)
    x = torch.randn(R, T, C, device="cuda", generator=gen).to(dt)
    g = torch.randn(R, T, C, device="cuda", generator=gen).to(dt)
    before = LAUNCHES["gated_linear_scan"]
    got = gated_linear_scan_cuda(a, x)
    torch.cuda.synchronize()
    assert LAUNCHES["gated_linear_scan"] == before + 1
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(),
                               gated_linear_scan_plain(a, x).float(),
                               rtol=tol, atol=tol)
    ins = [t.clone().requires_grad_(True) for t in (a, x)]
    gated_linear_scan(*ins).backward(g)
    assert LAUNCHES["gated_linear_scan"] == before + 3   # forward + dx scan
    ref = [t.clone().requires_grad_(True) for t in (a, x)]
    gated_linear_scan_plain(*ref).backward(g)
    for got_g, want_g in zip((i.grad for i in ins), (r.grad for r in ref)):
        torch.testing.assert_close(got_g.float(), want_g.float(), rtol=tol,
                                   atol=tol)


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
    with pytest.raises(TypeError, match="dtypes differ"):
        gated_linear_scan_cuda(a, a.to(torch.bfloat16))
    with pytest.raises(ValueError, match="3-D"):
        gated_linear_scan_cuda(a[0], a[0])
