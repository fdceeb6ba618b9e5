#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. build: the three CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (one process per source, started together), with ``-Xptxas -v``;
   then the bf16 kernels' and the scan's tiles, resident blocks per SM and
   grids at the shapes they are timed at;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes of the UViT-H, Hunyuan-DiT-3B and SDv2 UNet train steps
   (flash attention at the UNet's six: self and cross at head dim 112 and
   224, B=16; bf16 on the tensor-core route, the head padded to 128 and
   256 in shared memory, fp32 on the SIMT route) and of the plan phase
   (batch 8: flash self and cross, the skip matmul at M=2064 and 8192;
   rows under path ``plan``) and of the small models the ``skipvit`` and
   ``supervisor`` phases train (``uvit-nano``: flash at 6 tokens, 2 heads
   of 16, the skip matmul at M=12 D=N=32; ``skipvit``: flash at 18
   tokens, 4 heads of 16; microbatch 2) (the gated
   linear scan, which no train path calls, at zamba2-2.7b's Mamba2 width
   over 4k steps and at R=32 over 2k steps, forward and backward kernels,
   with mixed dtypes of a and x, and with decays near 1, whose carry spans
   many chunks; see ``check_scan``), forward and
   gradients (fp32 with TF32 off at rtol =
   atol = 1e-4; bf16 at rtol = atol = 2e-2, bf16 rounding in another
   summation order; only the skip matmul's weight gradient, a sum over all
   M rows, takes atol = rtol x max|value|), then timed beside its bound,
   the plain version and a yardstick PyTorch call the port never makes:
   ``ms``, ``plain_ms`` and ``library_ms`` with CUDA events around 20
   calls as issued from Python (host cost included, as a train step pays
   it), and ``device_ms``, ``plain_device_ms`` and ``library_device_ms``
   as the replay of the same 20 calls captured in one CUDA graph (the
   device's time alone); each flash row names its route (``flash_route``);
4. pipeline parity: the port's wave executor at ``uvit-pp`` size (D=4, M=8),
   at ``hunyuan-pp`` size (D=2 and D=4, M=4) and at the supervisor drills'
   ``uvit-nano`` plan (D=4, M=4, global batch 8), each config the trainer's
   own, fp32, fp32 wire, kernels on, on the card against the same step on
   the CPU (plain versions): loss and grads at rtol 1e-3; then in bf16 through the kernels' bf16 routes (a
   Hunyuan-DiT config with 2 heads of 128, 4 blocks, 77 text tokens, D=2,
   M=4) against the same params in fp32 on the CPU: loss at rtol 2e-2,
   each gradient at ||err|| / ||g|| <= 5e-2; then a narrow SDv2 UNet
   whose single heads are 112 and 224 wide (``UNET_PARITY``), flash on,
   on the card against the CPU: fp32 loss and grads at rtol 1e-4, bf16
   loss at rtol 2e-2, two flash launches per attention block;
5. plan (``plan_phase``): every one of the 32 blocks of UViT-H and of
   Hunyuan-DiT-3B (full width, bf16, seed 0) timed forward by
   ``core.profiler.measure_block_times`` at batch 8 (one microbatch of
   global batch 16 at the tuner's M=2), every block through flash
   attention and every decoder block through the skip matmul (launches
   counted exactly); the measured graphs (``fwd_times``) beside the
   roofline ones: block ms, the cuts at D=4 V=1 and ``tune``'s top five
   choices and drops at N=2 and 4 on both; ``auto_pipeline(graph, fns, 4)``
   on the measured graphs must refuse the tuner's choice by name where it
   has G > 1 (and otherwise plan and certify); then UViT-H on the tuner's
   own N=2 plan (``auto_pipeline(graph, fns, 2)``, certified), 4 steps
   through ``repro_torch.launch.train.run(args, compiled=plan)`` at global
   batch 16, the plan's M, bf16 wire, both pipeline
   devices on the one card: losses finite, both kernels launched, the
   peak device memory beside twice the busiest device's Eq. 14
   prediction;
6. train UViT-H: ``repro_torch.launch.train`` with ``--arch uvit-h
   --pipeline --devices 4 --microbatches 8 --global-batch 16 --steps 4``
   (UViT-2.7B at full width and depth, bf16, bf16 wire) with the launch
   counts reset just before and read just after: every loss finite, both
   kernels of the path launched; then every reference to the trainer is
   dropped and the card's memory released;
7. checkpoint UViT-H (``checkpoint_phase``), full width and depth, the
   same argv plus a ``--ckpt-dir`` under ``build/``: A trains steps 0-1
   and saves step 2 (27.8 GB), B resumes at the same plan (restored state
   bitwise A's, steps 2-3 within 2e-2 of phase 6's losses), C resumes
   elastically at D=2 (logical params bitwise A's, one finite step); the
   launch counts are reset before B and before C and read after each;
   prints bytes, the save's blocking and total seconds, write and verify
   rates, each restore's seconds and peak device memory;
8. train Hunyuan-DiT-3B: the same as 6 with ``--arch hunyuan-dit``
   (d=2048, 32 blocks, 1024 tokens, cross-attention over 77 text tokens,
   full width and depth, bf16), after checking that less than 1 GB is
   still allocated;
9. train the SDv2 UNet: ``--arch sdv2-unet-full`` without ``--pipeline``
   (1.84e9 params at full width, bf16, global batch 16, 4 steps, random
   weights from seed 0, nothing cut): every loss finite, exactly 32 flash
   launches a step (every attention call through the kernel), peak
   device memory printed;
10. skipvit (``skipvit_train``, ``skipvit_wave_asym``): ``repro_torch.launch.train.run`` with
    ``--arch skipvit --pipeline --devices 2`` (M=4, global batch 8, 3
    steps, fp32 wire) on the card, launch counts reset just before, against
    the same argv, params and draws on the CPU: losses at rtol 1e-3; then
    the SkipViT wave step on the JAX package's ``wave-asym`` config with its
    block costs (the fold's turnaround cut off-centre), card against CPU,
    fp32, loss and grads at rtol 1e-3; flash attention must launch in both,
    the skip matmul never (SkipViT's skip is additive);
11. supervisor (``supervisor_phase``), after releasing this process's
    memory: (a) ``repro_torch.launch.supervisor.Supervisor`` over two
    ``uvit-nano`` workers on the card (2 hosts x 2 devices, dp=1 pp=4,
    M=4, global batch 8, 12 steps, fp32 wire, a checkpoint every 4
    steps): ``hostdown@8:1`` must detect, roll back to 8, shrink to
    (1, 2, 0) on one host and finish; ``hang@6`` the same with the hang on
    host 0 within ``stall_timeout x miss_budget`` + 5 polls and a rollback
    to 4; each merged trajectory at rtol 1e-4 to the port's uninterrupted
    run on the card; (b) one full-width UViT-H worker (the phase-6 plan)
    with ``hang@3`` and no checkpoint: launch, gen-live, heartbeat-miss
    only after the step-2 beat, hang (host 0, step 2), rollback (None),
    abort (no surviving hosts), and the worker's memory back within 1 GB;
    the workers load the kernels phase 2 built (``REPRO_TORCH_BUILD_DIR``
    inherited, ``REPRO_TORCH_NO_BUILD=1``; the build directory must hold
    the same files after the phase) and every worker log must name its
    CUDA device;
12. the ``kernels`` JSON line (each kernel's launches by path: ``plan``,
    ``skipvit train``, ``skipvit wave-asym`` and ``supervisor workers``,
    the last read from the workers' result files, among them), then the
    device line as the last line.

The full record goes to ``chiprun_out/chip_smoke.json``.  Without a CUDA
device the script exits 1 at once and prints no result.
"""
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
TRAIN_ARGV = ["--pipeline", "--devices", "4", "--microbatches", "8",
              "--global-batch", "16", "--steps", "4", "--log-every", "1",
              "--device", "cuda"]
TRAIN_ARCHS = ("uvit-h", "hunyuan-dit")      # in this order, one at a time
# the SDv2 UNet at full width, the whole model in one step (no --pipeline)
UNET_ARGV = ["--arch", "sdv2-unet-full", "--global-batch", "16", "--steps",
             "4", "--log-every", "1", "--device", "cuda"]
UNET_FLASH_PER_STEP = 32     # 16 attention blocks, self + cross each
SOURCES = {   # kernel -> (CUDA source, the TPU kernel it replaces)
    "skip_concat_matmul": ("src/repro_torch/kernels/csrc/skip_matmul.cu",
                           "src/repro/kernels/skip_matmul/kernel.py:40"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:64"),
    "gated_linear_scan": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                          "src/repro/kernels/linear_scan/kernel.py:45"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, warmup: int = 3, iters: int = 20,
            graph: bool = False) -> float:
    """Mean ms per call of ``fn``: CUDA events around ``iters`` calls as
    issued from Python, so a call whose host cost exceeds its device time
    is timed by the host.  With ``graph`` the ``iters`` calls are captured
    in one CUDA graph and its replay is timed instead: the device's time
    for the work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        run()
    else:
        for _ in range(iters):
            run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """Least time in ms: max(operations / peak, bytes / HBM rate), with the
    peak of the type the operations run in."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_close(torch, got, want, dtype: str, what: str,
                row_sum: bool = False) -> float:
    """rtol = atol = ``tol``.  ``row_sum`` (a weight gradient, summed over
    thousands of rows) sets atol to ``tol`` x max|want|: its entries near
    zero keep no relative precision when the sum is taken in another
    order."""
    tol = 1e-4 if dtype == "float32" else 2e-2
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    atol = tol * float(want.abs().max()) if row_sum else tol
    try:
        torch.testing.assert_close(got, want, rtol=tol, atol=atol)
    except AssertionError as e:
        fail(f"{what}: kernel disagrees with its plain version "
             f"(max abs err {err:.3e}, rtol={tol}, atol={atol:.3e}):\n{e}")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------

def _ms(row: dict, key: str) -> str:
    """``key`` as issued and, beside it, as a graph replay; "none" where
    the row has no such call."""
    if row[f"{key}ms"] is None:
        return "none"
    dev = row[f"{key}device_ms"]
    return (f"{row[f'{key}ms']:.4f} ms"
            + (f" (device {dev:.4f})" if dev is not None else ""))


def _row_line(what: str, row: dict, lib_name: str) -> str:
    grads = row.get("grad_max_abs_err") or {}
    return (f"[kernels] {what}: max|err| {row['max_abs_err']:.3e}"
            + ("  grads " + " ".join(f"{k} {v:.3e}" for k, v in grads.items())
               if grads else "")
            + f"  kernel {_ms(row, '')}  plain {_ms(row, 'plain_')}"
            f"  {lib_name} {_ms(row, 'library_')}"
            f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{row['bound_ms'] / row['device_ms']:.1%} of the device time)")


def _times(torch, kernel, plain, library) -> dict:
    """Each of the three timed as issued and as a graph replay."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[f"{key}ms"] = out[f"{key}device_ms"] = None
        if fn is not None:
            out[f"{key}ms"] = time_ms(torch, fn)
            out[f"{key}device_ms"] = time_ms(torch, fn, graph=True)
    return out


def check_skip_matmul(torch, rec) -> dict:
    """Returns the bf16 row of each train path's shape, by path."""
    from repro_torch.kernels.skip_matmul import (skip_concat_matmul,
                                                 skip_concat_matmul_cuda,
                                                 skip_concat_matmul_plain)
    rows, main = [], {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # path, M, D=N: b=2 and b=16 at UViT-H's 258 tokens, and
               # b=2 at Hunyuan-DiT's 1024 tokens; the plan phase's b=8
        ("uvit-h", 516, 2560), (None, 4128, 2560), ("hunyuan-dit", 2048, 2048),
        ("plan uvit-h", 2064, 2560), ("plan hunyuan-dit", 8192, 2048),
        ("uvit-nano", 12, 32)]   # the supervisor drills' b=2 x 6 tokens
    for dtype in ("bfloat16", "float32"):
        for path, M, D in cases:
            N = D
            dt = getattr(torch, dtype)
            h = torch.randn(M, D, device="cuda", generator=gen).to(dt)
            s = torch.randn(M, D, device="cuda", generator=gen).to(dt)
            w = (torch.randn(2 * D, N, device="cuda", generator=gen)
                 / math.sqrt(2 * D)).to(dt)
            what = f"skip_concat_matmul {dtype} M={M} D=N={D}"
            got = skip_concat_matmul_cuda(h, s, w)
            torch.cuda.synchronize()
            err = check_close(torch, got, skip_concat_matmul_plain(h, s, w),
                              dtype, what)
            # gradients: kernel forward + the op's matmul backward against
            # autograd through the plain version
            g = torch.randn(M, N, device="cuda", generator=gen).to(dt)
            ins = [x.clone().requires_grad_(True) for x in (h, s, w)]
            skip_concat_matmul(*ins).backward(g)
            ref = [x.clone().requires_grad_(True) for x in (h, s, w)]
            skip_concat_matmul_plain(*ref).backward(g)
            grad_err = {nm: check_close(torch, a.grad, b.grad, dtype,
                                        f"{what} {nm}", row_sum=nm == "dw")
                        for a, b, nm in zip(ins, ref, ("dh", "ds", "dw"))}
            del ins, ref, g
            times = _times(torch, lambda: skip_concat_matmul_cuda(h, s, w),
                           lambda: skip_concat_matmul_plain(h, s, w),
                           lambda: torch.cat([h, s], -1) @ w)
            esz = h.element_size()
            b_ms, b_by = bound(4.0 * M * D * N,
                               esz * (2 * M * D + 2 * D * N + M * N), dtype)
            row = dict(path=path, dtype=dtype, M=M, D=D, N=N,
                       max_abs_err=err, grad_max_abs_err=grad_err, **times,
                       device_tflops=4.0 * M * D * N / times["device_ms"] / 1e9,
                       bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            log(_row_line(what, row, "cat+matmul"))
            if dtype == "bfloat16" and path:
                main[path] = row             # the train step's shape
            del h, s, w, got
    rec["skip_concat_matmul"] = rows
    return main


def check_flash(torch, rec) -> dict:
    """Returns the bf16 row of each train path's shape, by path."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention,
                                                     flash_attention_cuda,
                                                     flash_route)
    rows, main = [], {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # path, B, S, T, Hq, Hkv, D, causal, window
        ("uvit-h", 2, 258, 258, 20, 20, 128, False, None),      # b=2
        ("hunyuan-dit", 2, 1024, 1024, 16, 16, 128, False, None),
        ("hunyuan-dit cross", 2, 1024, 77, 16, 16, 128, False, None),
        # the plan phase's b=8: its block profiles and its steps
        ("plan uvit-h", 8, 258, 258, 20, 20, 128, False, None),
        ("plan hunyuan-dit", 8, 1024, 1024, 16, 16, 128, False, None),
        ("plan hunyuan-dit cross", 8, 1024, 77, 16, 16, 128, False, None),
        (None, 1, 300, 300, 8, 2, 64, True, 96),          # causal+win+GQA
        # the SDv2 UNet's train step (sdv2-unet-full, B=16, 8 heads): self
        # and cross-attention over 77 text tokens at 16x16 (head dim 112),
        # 8x8 and 4x4 (level 3 and the middle block; head dim 224)
        ("sdv2-unet L1 self", 16, 256, 256, 8, 8, 112, False, None),
        ("sdv2-unet L1 cross", 16, 256, 77, 8, 8, 112, False, None),
        ("sdv2-unet L2 self", 16, 64, 64, 8, 8, 224, False, None),
        ("sdv2-unet L2 cross", 16, 64, 77, 8, 8, 224, False, None),
        ("sdv2-unet L3+mid self", 16, 16, 16, 8, 8, 224, False, None),
        ("sdv2-unet L3+mid cross", 16, 16, 77, 8, 8, 224, False, None),
        # the small models of the skipvit and supervisor phases, b=2
        ("uvit-nano", 2, 6, 6, 2, 2, 16, False, None),
        ("skipvit", 2, 18, 18, 4, 4, 16, False, None),
    ]
    for path, B, S, T, Hq, Hkv, D, causal, window in cases:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q = torch.randn(B, S, Hq, D, device="cuda", generator=gen).to(dt)
            k = torch.randn(B, T, Hkv, D, device="cuda", generator=gen).to(dt)
            v = torch.randn(B, T, Hkv, D, device="cuda", generator=gen).to(dt)
            what = (f"flash_attention {dtype} B={B} S={S} T={T} Hq={Hq} "
                    f"Hkv={Hkv} D={D} causal={causal} window={window}")
            got = flash_attention_cuda(q, k, v, causal, window)
            torch.cuda.synchronize()
            err = check_close(torch, got,
                              attention_plain(q, k, v, causal, window),
                              dtype, what)
            g = torch.randn(B, S, Hq, D, device="cuda", generator=gen).to(dt)
            ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
            flash_attention(*ins, causal, window).backward(g)
            ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
            attention_plain(*ref, causal, window).backward(g)
            grad_err = {nm: check_close(torch, a.grad, b.grad, dtype,
                                        f"{what} {nm}")
                        for a, b, nm in zip(ins, ref, ("dq", "dk", "dv"))}
            del ins, ref, g
            library = None
            if Hq == Hkv and window is None:
                qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))

                def library():
                    return F.scaled_dot_product_attention(qh, kh, vh,
                                                          is_causal=causal)
            times = _times(
                torch, lambda: flash_attention_cuda(q, k, v, causal, window),
                lambda: attention_plain(q, k, v, causal, window), library)
            # score pairs this data needs: every (query, visible key)
            qp = torch.arange(S)[:, None]
            kp = torch.arange(T)[None, :]
            vis = torch.ones(S, T, dtype=torch.bool)
            if causal:
                vis &= kp <= qp
            if window is not None:
                vis &= kp > qp - window
            pairs = int(vis.sum())
            esz = q.element_size()
            b_ms, b_by = bound(
                4.0 * B * Hq * pairs * D,
                esz * (2 * B * S * Hq * D + 2 * B * T * Hkv * D), dtype)
            row = dict(path=path, dtype=dtype, B=B, S=S, T=T, Hq=Hq, Hkv=Hkv,
                       D=D, causal=causal, window=window,
                       route=flash_route(dt, D), max_abs_err=err,
                       grad_max_abs_err=grad_err, **times,
                       device_tflops=(4.0 * B * Hq * pairs * D
                                      / times["device_ms"] / 1e9),
                       bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            log(_row_line(f"{what} route={row['route']}", row, "sdpa"))
            if dtype == "bfloat16" and path:
                main[path] = row
            del q, k, v, got
    rec["flash_attention"] = rows
    return main


SCAN_SHAPES = {"zamba2-2.7b mamba2, T=4096": (4, 4096, 5120),
               "wide, R=32 T=2048": (32, 2048, 5120)}
# the decay a of each check: sigmoid(normal), whose product over a warp's 16
# steps is ~3e-6, so h hardly depends on what came before; and
# exp(-0.01 softplus(normal)), near 1 as Mamba2's exp(dt A) are, whose
# product over a 64-step chunk is ~0.6, so the carry from warp to warp and
# the look-back over many chunks decide h.  Timed on the second.
SCAN_DECAYS = ("sigmoid", "near 1")


def scan_inputs(torch, gen, R, T, C, dtype_a, dtype_x, decay):
    """(a, x, g) of the scan on the card: a by ``decay`` (``SCAN_DECAYS``)
    in ``dtype_a``, x and the cotangent g normal in ``dtype_x``.  Near 1,
    x and g are scaled by sqrt(1 - a^2), as Mamba2 scales its input by dt,
    so that h and the adjoint dX keep unit variance: unscaled, both reach
    ~40, and two fp32 summation orders of the same scan (the plain loop
    against an fp64 one, too) then differ by more than the checks' 1e-4
    (``test_chunked_scan_is_no_less_accurate_than_the_loop``)."""
    v = torch.randn(R, T, C, device="cuda", generator=gen)
    x, g = (torch.randn(R, T, C, device="cuda", generator=gen)
            for _ in range(2))
    if decay == "sigmoid":
        a = torch.sigmoid(v)
    else:
        a = torch.exp(-0.01 * torch.nn.functional.softplus(v))
        x, g = (t * torch.sqrt(1 - a * a) for t in (x, g))
    return a.to(dtype_a), x.to(dtype_x), g.to(dtype_x)


def check_scan(torch, rec) -> tuple[dict, int]:
    """The gated linear scan.  No train path calls it, so this phase is its
    path.  Each check runs at both decays of ``SCAN_DECAYS``.  (1) The
    op's forward and backward (one kernel launch each) against the plain
    versions at T=512 and at a ragged shape, for each pair of dtypes of a
    and x (bf16 and fp32, and both mixed pairs: the mixed ones against the
    plain transcription of the JAX VJP, which rounds g to a's dtype where
    autograd through the plain forward does not).  (2) At zamba2-2.7b's
    Mamba2 width (R=4 rows of C=5120 channels, T=4096) and at a wide shape
    (R=32, T=2048), each of bf16 and fp32: the op's forward and backward,
    and the forward and backward kernels called directly, each against its
    plain version on the same inputs; on the decay near 1, each kernel
    then timed beside its bound (forward 3 N elements moved, backward
    5 N).  Returns the bf16 forward row at zamba2's shape and the launches
    of the op's calls (not the direct kernel calls of checks and timing
    loops)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.linear_scan import (gated_linear_scan,
                                                 gated_linear_scan_bwd_cuda,
                                                 gated_linear_scan_bwd_plain,
                                                 gated_linear_scan_cuda,
                                                 gated_linear_scan_plain)
    rows, main, launches = [], None, 0
    gen = torch.Generator(device="cuda").manual_seed(2)

    def op(a, x, g):
        """The op's h and (da, dx), counting its launches."""
        nonlocal launches
        before = LAUNCHES["gated_linear_scan"]
        ins = [t.clone().requires_grad_(True) for t in (a, x)]
        h = gated_linear_scan(*ins)
        h.backward(g)
        torch.cuda.synchronize()
        launches += LAUNCHES["gated_linear_scan"] - before
        return h.detach(), [t.grad for t in ins]

    for dta, dtx in (("bfloat16", "bfloat16"), ("float32", "float32"),
                     ("float32", "bfloat16"), ("bfloat16", "float32")):
        # rtol = atol = 2e-2 where either side is bf16
        tol_dtype = "float32" if dta == dtx == "float32" else "bfloat16"
        for (R, T, C), decay in itertools.product(
                ((4, 512, 5120), (3, 300, 200)), SCAN_DECAYS):
            a, x, g = scan_inputs(torch, gen, R, T, C, getattr(torch, dta),
                                  getattr(torch, dtx), decay)
            what = (f"gated_linear_scan op a {dta} x {dtx} R={R} T={T} C={C} "
                    f"a {decay}")
            h, got = op(a, x, g)
            want_h = gated_linear_scan_plain(a, x)
            err = check_close(torch, h, want_h, tol_dtype, f"{what} h")
            if dta == dtx:
                ref = [t.clone().requires_grad_(True) for t in (a, x)]
                gated_linear_scan_plain(*ref).backward(g)
                want = [t.grad for t in ref]
            else:
                want = gated_linear_scan_bwd_plain(a, want_h, g)
            grad_err = {nm: check_close(torch, i, r, tol_dtype, f"{what} {nm}")
                        for i, r, nm in zip(got, want, ("da", "dx"))}
            rec.setdefault("gated_linear_scan_op", []).append(
                dict(dtype_a=dta, dtype_x=dtx, R=R, T=T, C=C, decay=decay,
                     max_abs_err=err, grad_max_abs_err=grad_err))
            log(f"[kernels] {what}: h {err:.3e}, grads "
                + " ".join(f"{k} {v:.3e}" for k, v in grad_err.items()))
            del a, x, g, h, got, want, want_h

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for shape_name, (R, T, C) in SCAN_SHAPES.items():
            n = R * T * C
            for decay in SCAN_DECAYS:
                a, x, g = scan_inputs(torch, gen, R, T, C, dt, dt, decay)
                esz = a.element_size()
                what = f"gated_linear_scan {dtype} R={R} T={T} C={C} a {decay}"
                # the op, then each kernel called directly, against the
                # plain versions on the same inputs
                h, (op_da, op_dx) = op(a, x, g)
                want_h = gated_linear_scan_plain(a, x)
                want_da, want_dx = gated_linear_scan_bwd_plain(a, h, g)
                da, dx = gated_linear_scan_bwd_cuda(a, h, g)
                err = {"forward": max(
                    check_close(torch, h, want_h, dtype, f"{what} op h"),
                    check_close(torch, gated_linear_scan_cuda(a, x), want_h,
                                dtype, f"{what} forward kernel")),
                       "backward": max(
                    check_close(torch, op_da, want_da, dtype, f"{what} op da"),
                    check_close(torch, op_dx, want_dx, dtype, f"{what} op dx"),
                    check_close(torch, da, want_da, dtype,
                                f"{what} backward kernel da"),
                    check_close(torch, dx, want_dx, dtype,
                                f"{what} backward kernel dx"))}
                del op_da, op_dx, da, dx, want_h, want_da, want_dx
                if decay != SCAN_DECAYS[-1]:
                    log(f"[kernels] {what}: max|err| forward "
                        f"{err['forward']:.3e}, backward {err['backward']:.3e}")
                    del a, x, g, h
                    continue
                for direction in ("forward", "backward"):
                    if direction == "forward":
                        def kernel():
                            return gated_linear_scan_cuda(a, x)

                        def plain():
                            return gated_linear_scan_plain(a, x)
                        # fp32 arithmetic on the carry whatever the storage
                        b_ms, b_by = bound(2.0 * n, 3.0 * n * esz, "float32")
                    else:
                        def kernel():
                            return gated_linear_scan_bwd_cuda(a, h, g)

                        def plain():
                            return gated_linear_scan_bwd_plain(a, h, g)
                        b_ms, b_by = bound(3.0 * n, 5.0 * n * esz, "float32")
                    times = _times(torch, kernel, None, None)
                    # a Python loop of T steps: timed as issued only (3 calls)
                    times["plain_ms"] = time_ms(torch, plain, warmup=1, iters=3)
                    row = dict(shape=shape_name, direction=direction,
                               dtype=dtype, R=R, T=T, C=C, decay=decay,
                               max_abs_err=err[direction], **times,
                               bound_ms=b_ms, bound_by=b_by)
                    rows.append(row)
                    log(_row_line(f"gated_linear_scan {direction} {dtype} "
                                  f"R={R} T={T} C={C} a {decay}", row,
                                  "library"))
                    if (dtype, direction, R) == ("bfloat16", "forward", 4):
                        main = row
                del a, x, g, h
            torch.cuda.empty_cache()
    rec["gated_linear_scan"] = rows
    return main, launches


# ---------------------------------------------------------------------------
# phase 4: pipeline parity, card vs CPU
# ---------------------------------------------------------------------------

def _parity_model(kind: str, B: int, M: int, **over):
    """(cfg, pipeline graph, dataset) of a small config of ``kind``, kernels
    on; ``over`` replaces config fields."""
    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.models import diffusion as dm
    if kind == "uvit":
        kw = dict(img_size=8, in_ch=4, patch=2, d_model=64, n_layers=8,
                  n_heads=4, d_ff=128, n_classes=10)
        kw.update(over)
        cfg = dm.UViTConfig(kw.pop("name", "uvit-pp"), use_skip_kernel=True,
                            use_flash=True, **kw)
        return (cfg, dm.uvit_pipeline_graph(cfg, batch=B // M),
                SyntheticLatentDataset(img_size=8, channels=4))
    kw = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8, n_heads=4,
              d_ff=64, ctx_dim=16, ctx_len=4)
    kw.update(over)
    cfg = dm.HunyuanDiTConfig(kw.pop("name", "hunyuan-pp"),
                              use_skip_kernel=True, use_flash=True, **kw)
    return (cfg, dm.hunyuan_pipeline_graph(cfg, batch=B // M),
            SyntheticLatentDataset(img_size=8, channels=4,
                                   text_dim=cfg.ctx_dim,
                                   text_len=cfg.ctx_len))


def _model_fns(cfg, kind: str):
    from repro_torch.runtime.adapters import model_fns
    return model_fns(cfg, kind)


def _pipeline_step(torch, cfg, graph, kind: str, D: int, M: int, params,
                   raw, t, noise, dev: str, wire_dtype: str, **plan_kw):
    """One step of the port's wave executor for ``cfg`` on ``dev`` from the
    merged fp32 ``params`` (cast to ``cfg.param_dtype``): the loss, every
    gradient as fp32 on the CPU by path, and the plan's first line.
    ``plan_kw`` goes to ``auto_pipeline``."""
    import numpy as np

    from repro_torch.runtime.adapters import make_diffusion_microbatches
    from repro_torch.runtime.compile import auto_pipeline
    from repro_torch.tree import tree_map, tree_paths

    cp = auto_pipeline(graph, _model_fns(cfg, kind), D,
                       pipeline_devices=D, microbatches=M,
                       wire_dtype=wire_dtype, **plan_kw)
    p = tree_map(lambda x: x.detach().to(dev, cfg.param_dtype).clone()
                 .requires_grad_(True), cp.split_params(params))
    batch = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in raw.items()}
    (enc, dec), edge = p
    mb, aux = make_diffusion_microbatches(
        batch, M, cfg, kind, t=t.to(dev), noise=noise.to(dev), params=edge)
    loss = cp.build()(enc, dec, edge, mb, aux)
    loss.backward()
    grads = cp.merge_params(*tree_map(
        lambda x: x.grad if x.grad is not None else torch.zeros_like(x), p))
    return (float(loss.detach().float()),
            {k: v.detach().float().cpu() for k, v in tree_paths(grads)},
            cp.describe().splitlines()[0])


def _parity_inputs(torch, cfg, kind, M, ds):
    """fp32 params on the CPU from seed 0, a batch, and (t, noise) from
    seed 1."""
    B = 2 * M
    params = _model_fns(cfg, kind).init_fn(
        torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    t = torch.rand((B,), generator=gen)
    noise = torch.randn((B, cfg.img_size, cfg.img_size, cfg.in_ch),
                        generator=gen)
    return params, ds.batch(0, 0, B), t, noise


def _check_launched(launched: dict, name: str) -> None:
    for k in ("skip_concat_matmul", "flash_attention"):
        if not launched[k]:
            fail(f"pipeline parity {name}: the card's run launched "
                 f"{launched}; both kernels of the path must run")


# (kind, D, M, config fields): uvit-pp, hunyuan-pp, and the supervisor
# drills' uvit-nano at their plan (D=4, M=4, global batch 8)
PARITY_CASES = (("uvit", 4, 8, {}), ("hunyuan", 2, 4, {}),
                ("hunyuan", 4, 4, {}),
                ("uvit", 4, 4, dict(name="uvit-nano", patch=4, d_model=32,
                                    n_heads=2, d_ff=64)))


def pipeline_parity(torch, rec, kind: str, D: int, M: int, **over) -> None:
    from repro_torch.launch import train as train_mod
    cfg, graph, ds = _parity_model(kind, 2 * M, M, **over)
    if cfg != train_mod._model_config(train_mod._parse_args(
            ["--arch", cfg.name, "--pipeline"])):
        fail(f"pipeline parity: {cfg} is not the trainer's {cfg.name}")
    params, raw, t, noise = _parity_inputs(torch, cfg, kind, M, ds)
    out = {}
    before = dict(_launches())
    for dev in ("cpu", "cuda"):
        out[dev] = _pipeline_step(torch, cfg, graph, kind, D, M, params, raw,
                                  t, noise, dev, "float32")
    launched = {k: _launches()[k] - before[k] for k in before}
    name = f"{cfg.name} D={D} M={M}"
    _check_launched(launched, name)
    lc, gc_, plan = out["cpu"]
    lg, gg, _ = out["cuda"]
    if not math.isclose(lg, lc, rel_tol=1e-3):
        fail(f"pipeline parity {name}: loss on the card {lg} vs CPU {lc}")
    worst = 0.0
    for k, want in gc_.items():
        got = gg[k]
        try:
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)
        except AssertionError as e:
            fail(f"pipeline parity {name}: grad {k} differs:\n{e}")
        worst = max(worst, float((got - want).abs().max()))
    rec.setdefault("pipeline_parity", {})[name] = dict(
        loss_cuda=lg, loss_cpu=lc, max_abs_grad_err=worst, grads=len(gg),
        launches=launched, plan=plan)
    log(f"[parity] {name} fp32 wire: loss card {lg:.7f} cpu {lc:.7f}; "
        f"{len(gg)} grads, max|err| {worst:.3e}; launches {launched}")


def pipeline_parity_bf16(torch, rec, D: int = 2, M: int = 4) -> None:
    """The wave executor in bf16 on the card, through the kernels' bf16
    routes (the skip matmul's wgmma kernel and flash attention's
    tensor-core route, head dim 128: self-attention over 16 tokens and
    cross-attention over 77 text tokens), against the same params in fp32
    on the CPU (plain versions).  A Hunyuan-DiT config of d_model 256, 2
    heads of 128, 4 blocks, 8x8 latents.  The loss is held at rtol 2e-2;
    each gradient at ||g_card - g_cpu|| / ||g_cpu|| <= 5e-2: bf16 params,
    activations and wire round at every op across the whole block stack
    and back, so an elementwise bound would measure bf16's own rounding,
    not the kernels.  A gradient that is zero on the CPU (time_mlp, the
    unread xattn.wk/wv) must be zero on the card."""
    over = dict(name="hunyuan-bf16", d_model=256, n_layers=4, n_heads=2,
                d_ff=1024, ctx_dim=128, ctx_len=77)
    cfg32, graph32, ds = _parity_model("hunyuan", 2 * M, M, **over)
    cfg16, graph16, _ = _parity_model("hunyuan", 2 * M, M,
                                      dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16, **over)
    params, raw, t, noise = _parity_inputs(torch, cfg32, "hunyuan", M, ds)
    lc, gc_, plan = _pipeline_step(torch, cfg32, graph32, "hunyuan", D, M,
                                   params, raw, t, noise, "cpu", "float32")
    before = dict(_launches())
    lg, gg, _ = _pipeline_step(torch, cfg16, graph16, "hunyuan", D, M,
                               params, raw, t, noise, "cuda", "bfloat16")
    torch.cuda.synchronize()
    launched = {k: _launches()[k] - before[k] for k in before}
    name = f"{cfg16.name} D={D} M={M}"
    _check_launched(launched, name)
    if not (math.isfinite(lg) and math.isclose(lg, lc, rel_tol=2e-2)):
        fail(f"pipeline parity {name}: bf16 loss on the card {lg} vs fp32 "
             f"CPU {lc} (rtol 2e-2)")
    worst, worst_k = 0.0, None
    for k, want in gc_.items():
        got = gg[k]
        ref = float(want.norm())
        if ref == 0.0:
            if float(got.norm()) != 0.0:
                fail(f"pipeline parity {name}: grad {k} is zero on the CPU "
                     f"but not on the card")
            continue
        rel = float((got - want).norm()) / ref
        if not rel <= 5e-2:
            fail(f"pipeline parity {name}: grad {k} relative error {rel:.3e}"
                 " > 5e-2")
        if rel > worst:
            worst, worst_k = rel, k
    rec.setdefault("pipeline_parity", {})[name] = dict(
        loss_cuda=lg, loss_cpu=lc, max_rel_grad_err=worst,
        worst_grad=worst_k, grads=len(gg), launches=launched, plan=plan)
    log(f"[parity] {name} bf16 on the card vs fp32 CPU: loss card {lg:.7f} "
        f"cpu {lc:.7f}; {len(gg)} grads, worst ||err||/||g|| {worst:.3e} "
        f"({worst_k}); launches {launched}")


def _launches() -> dict:
    from repro_torch.kernels import launch_counts
    return launch_counts()


# ---------------------------------------------------------------------------
# phase 4b: the UNet, card vs CPU
# ---------------------------------------------------------------------------

# a narrow SDv2 UNet whose single heads are exactly the full model's head
# dims: 112 at level 1 (16x16), 224 at level 2 (8x8) and in the middle
UNET_PARITY = dict(img_size=16, base_ch=56, ch_mults=(1, 2, 4),
                   attn_levels=(1, 2), n_heads=1, ctx_dim=64, ctx_len=77)


def _unet_step(torch, cfg, params, batch, t, noise, dev):
    """The UNet's loss and every gradient (fp32, on the CPU, by path; an
    unread leaf, the cross-attention's wk/wv, gets zeros) on ``dev``."""
    from repro_torch.models.diffusion import unet_loss
    from repro_torch.tree import tree_map, tree_paths
    p = tree_map(lambda x: x.detach().to(dev).clone().requires_grad_(True),
                 params)
    b = {k: v.to(dev) for k, v in batch.items()}
    loss = unet_loss(p, b, t.to(dev), noise.to(dev), cfg)
    loss.backward()
    return (float(loss.detach().float()),
            {k: (x.grad if x.grad is not None else torch.zeros_like(x))
             .detach().float().cpu() for k, x in tree_paths(p)})


def unet_parity(torch, rec) -> None:
    """``UNET_PARITY`` with flash attention on (head dims 112 and 224):
    fp32 on the card (the kernel, cuDNN's convs, TF32 off) against the
    same step on the CPU (plain versions): loss at rtol 1e-4, each gradient
    at rtol 1e-4 with atol 1e-4 x its largest entry (a conv weight's
    gradient sums over every pixel of the batch, so its entries near zero
    keep no relative precision in another summation order); then bf16
    params (norm leaves fp32, as ``init_unet`` makes them) and activations
    on the card, flash attention on its tensor-core route at both head
    dims, against the fp32 CPU step: loss at rtol 2e-2, the worst
    gradient's ||err|| / ||g|| reported.  Each card run must launch the
    kernel twice per attention block."""
    import numpy as np

    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.models.diffusion import UNetConfig, init_unet
    from repro_torch.tree import tree_map, tree_paths
    B = 4
    cfg32 = UNetConfig("sdv2-parity", use_flash=True, **UNET_PARITY)
    cfg16 = UNetConfig("sdv2-parity-bf16", use_flash=True,
                       dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                       **UNET_PARITY)
    params = init_unet(torch.Generator().manual_seed(0), cfg32, "cpu")
    # one launch per attention (self and cross: each has its own wq)
    want_launches = sum(k.endswith("/wq") for k, _ in tree_paths(params))
    like16 = init_unet(torch.Generator().manual_seed(0), cfg16, "cpu")
    params16 = tree_map(lambda x, y: x.to(y.dtype), params, like16)
    del like16
    ds = SyntheticLatentDataset(img_size=16, channels=4,
                                text_dim=cfg32.ctx_dim,
                                text_len=cfg32.ctx_len)
    batch = {k: torch.as_tensor(np.asarray(v))
             for k, v in ds.batch(0, 0, B).items() if k != "labels"}
    gen = torch.Generator().manual_seed(1)
    t = torch.rand((B,), generator=gen)
    noise = torch.randn((B, 16, 16, 4), generator=gen)
    lc, gc_ = _unet_step(torch, cfg32, params, batch, t, noise, "cpu")
    out = {}
    for name, cfg, p in (("fp32", cfg32, params), ("bf16", cfg16, params16)):
        before = _launches()["flash_attention"]
        lg, gg = _unet_step(torch, cfg, p, batch, t, noise, "cuda")
        torch.cuda.synchronize()
        launched = _launches()["flash_attention"] - before
        if launched != want_launches:
            fail(f"unet parity {name}: {launched} flash launches, want "
                 f"{want_launches} (self and cross in every attention "
                 "block)")
        tol = 1e-4 if name == "fp32" else 2e-2
        if not (math.isfinite(lg) and math.isclose(lg, lc, rel_tol=tol)):
            fail(f"unet parity {name}: loss on the card {lg} vs fp32 CPU "
                 f"{lc} (rtol {tol})")
        worst, worst_k = 0.0, None
        for k, want in gc_.items():
            got = gg[k]
            if name == "fp32":
                try:
                    torch.testing.assert_close(
                        got, want, rtol=1e-4,
                        atol=1e-4 * float(want.abs().max()))
                except AssertionError as e:
                    fail(f"unet parity fp32: grad {k} differs:\n{e}")
            ref = float(want.norm())
            if ref == 0.0:
                if float(got.norm()) != 0.0:
                    fail(f"unet parity {name}: grad {k} is zero on the CPU "
                         "but not on the card")
                continue
            rel = float((got - want).norm()) / ref
            if rel > worst:
                worst, worst_k = rel, k
        out[name] = dict(loss_cuda=lg, loss_cpu=lc, launches=launched,
                         max_rel_grad_err=worst, worst_grad=worst_k,
                         grads=len(gg))
        log(f"[parity] {cfg.name} (heads 112/224) {name} on the card vs "
            f"fp32 CPU: loss card {lg:.7f} cpu {lc:.7f}; {len(gg)} grads, "
            f"worst ||err||/||g|| {worst:.3e} ({worst_k}); flash launches "
            f"{launched}")
    rec["unet_parity"] = out


# ---------------------------------------------------------------------------
# phase 5: plan -- measured block costs, the hybrid tuner, and UViT-H
# trained on the plan the tuner picks
# ---------------------------------------------------------------------------

PLAN_ARCHS = ("uvit-h", "hunyuan-dit")
PLAN_BATCH = 16          # global batch of the steps on the tuner's plan
PLAN_STEPS = 4
PLAN_M = 2               # the tuner's M at N=2 (M = P, P = 2)
PLAN_PROFILE = dict(warmup=2, iters=10)


def _plan_model(arch: str):
    """(cfg, kind, model fns) of ``arch`` as the trainer configures it:
    full width and depth, bf16, both kernels on."""
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.adapters import diffusion_model_fns
    args = train_mod._parse_args(["--arch", arch, "--pipeline"])
    cfg, kind = train_mod._model_config(args), train_mod._kind(args)
    return cfg, kind, diffusion_model_fns(cfg, kind)


def _graph(cfg, kind: str, fwd_times=None):
    """The pipeline graph at the microbatch the steps run (``PLAN_BATCH //
    PLAN_M`` samples, the batch the trainer builds its graph at), with the
    roofline's costs or measured ones."""
    from repro_torch.core.hw import H100_SXM
    from repro_torch.models.diffusion import (hunyuan_pipeline_graph,
                                              uvit_pipeline_graph)
    fn = hunyuan_pipeline_graph if kind == "hunyuan" else uvit_pipeline_graph
    return fn(cfg, batch=PLAN_BATCH // PLAN_M, fwd_times=fwd_times,
              hw=H100_SXM)


def measure_blocks(torch, cfg, kind: str, fns) -> list:
    """Seconds per forward call of each of the model's blocks, in graph
    order, by ``measure_block_times`` on the card at the graph's batch:
    random bf16 weights from seed 0, random activations (and for
    Hunyuan-DiT the 77 text tokens and the adaLN conditioning), no
    autograd."""
    from repro_torch.core.profiler import measure_block_times
    from repro_torch.models.diffusion import hunyuan_temb
    from repro_torch.tree import tree_map
    B = PLAN_BATCH // PLAN_M
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = fns.init_fn(gen, "cuda")
        (enc, dec), edge = fns.split_blocks(params)
        x = torch.randn(B, cfg.n_tokens, cfg.d_model, device="cuda",
                        generator=gen).to(cfg.dtype)
        skip = torch.randn(x.shape, device="cuda", generator=gen).to(
            cfg.dtype)
        aux = {}
        if kind == "hunyuan":
            t = torch.rand((B,), device="cuda", generator=gen)
            aux = {"ctx": torch.randn(B, cfg.ctx_len, cfg.ctx_dim,
                                      device="cuda", generator=gen).to(
                                          cfg.dtype),
                   "temb": hunyuan_temb(edge, t, cfg)}
        calls = ([(fns.enc_block_fn,
                   (tree_map(lambda a: a[r], enc), x, aux))
                  for r in range(cfg.half)]
                 + [(fns.dec_block_fn,
                     (tree_map(lambda a: a[r], dec), x, skip, aux))
                    for r in range(cfg.half)])
        times = measure_block_times([f for f, _ in calls],
                                    [a for _, a in calls], **PLAN_PROFILE)
        torch.cuda.synchronize()
    del params, enc, dec, edge, calls
    return times


def _choice_row(c) -> dict:
    return dict(P=c.P, G=c.G, b=c.b, V=c.V, M=c.M, zero_stage=c.zero_stage,
                t_sample=c.t_sample, t_sched=c.t_sched,
                peak_gb=c.peak_mem / 1e9,
                cuts=list(c.partition.cuts) if c.partition else None)


def _choice_text(c) -> str:
    return (f"P={c.P} G={c.G} b={c.b} V={c.V} M={c.M} "
            f"zero_stage={c.zero_stage}")


def plans_of(graph, what: str) -> dict:
    """The cuts at D=4, V=1 and the tuner's ranked choices at N=2 and 4
    (top five, the best with P > 1, the drops), printed and returned."""
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.partition import partition
    from repro_torch.core.tuner import tune
    out = {"cuts_D4": list(partition(graph, 4, hw=H100_SXM).cuts)}
    log(f"[plan] {what}: cuts at D=4 V=1 {out['cuts_D4']}")
    for N in (2, 4):
        drops: list = []
        choices = tune(graph, N, hw=H100_SXM, drops=drops)
        pipe = [c for c in choices if c.partition is not None and c.P > 1]
        out[f"N{N}"] = dict(top5=[_choice_row(c) for c in choices[:5]],
                            best_pipeline=_choice_row(pipe[0]) if pipe
                            else None, drops=drops, n=len(choices))
        for i, c in enumerate(choices[:5]):
            log(f"[plan] {what}: N={N} #{i} {_choice_text(c)} t/sample "
                f"{c.t_sample:.6e} s t_sched {c.t_sched:.6e} s peak "
                f"{c.peak_mem / 1e9:.3f} GB")
        if pipe:
            c = pipe[0]
            log(f"[plan] {what}: N={N} best with P>1 (#"
                f"{choices.index(c)}): {_choice_text(c)} t/sample "
                f"{c.t_sample:.6e} s peak {c.peak_mem / 1e9:.3f} GB cuts "
                f"{list(c.partition.cuts)}")
        log(f"[plan] {what}: N={N} drops {drops or 'none'}")
    return out


def check_n4(graph, fns, arch: str) -> dict:
    """``auto_pipeline(graph, fns, 4)`` against the tuner's own choice: a
    choice with G > 1 or a ZeRO stage must be refused by name
    (``NotImplementedError``), a G = 1 choice must plan and certify."""
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.tuner import tune
    from repro_torch.runtime.compile import auto_pipeline
    keep = [c for c in tune(graph, 4, hw=H100_SXM) if c.partition is not None
            and c.P > 1]
    want = keep[0]
    refused = want.G > 1 or want.zero_stage > 0
    try:
        cp = auto_pipeline(graph, fns, 4, hw=H100_SXM)
    except NotImplementedError as e:
        if not refused or _choice_text(want) not in str(e):
            fail(f"plan {arch} N=4: refused ({e}) but the tuner's choice is "
                 f"{_choice_text(want)}")
        log(f"[plan] {arch} measured N=4: the tuner's choice "
            f"{_choice_text(want)} has data parallelism, refused as "
            f"expected: {e}")
        return dict(choice=_choice_row(want), outcome="refused",
                    error=str(e))
    if refused:
        fail(f"plan {arch} N=4: planned {cp.describe()} but the tuner's "
             f"choice {_choice_text(want)} needs data parallelism")
    cert = cp.certify(name=f"{arch}-N4")
    if _choice_text(cp.choice) != _choice_text(want) or not cert.ok:
        fail(f"plan {arch} N=4: choice {_choice_text(cp.choice)} vs tuner "
             f"{_choice_text(want)}; certificate {cert.summary()}")
    log(f"[plan] {arch} measured N=4: planned {_choice_text(cp.choice)}; "
        f"{cert.summary()}")
    return dict(choice=_choice_row(want), outcome="planned",
                certificate=cert.summary())


def train_on_plan(torch, arch: str, graph, fns) -> dict:
    """``auto_pipeline(graph, fns, 2)``: the tuner's plan, certified, then
    ``PLAN_STEPS`` steps of the model at full width on it through the
    trainer (``train.run(args, compiled=cp)``: global batch
    ``PLAN_BATCH``, the tuner's M, bf16 wire, both pipeline devices in
    this process on the one card): every loss finite, no step skipped, the
    peak device memory against twice the busiest device's Eq. 14
    prediction at the executed microbatch."""
    from repro_torch.core.comm_model import WIRE_BYTES
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.tuner import peak_memory, profile_partition
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.compile import auto_pipeline

    cp = auto_pipeline(graph, fns, 2, hw=H100_SXM)
    c = cp.choice
    cert = cp.certify(name=f"{arch}-tuner-N2")
    log(f"[plan] tuner's plan at N=2: {_choice_text(c)}; "
        + cp.describe().replace("\n", "\n[plan]   "))
    log(f"[plan] {cert.summary()}")
    if not cert.ok:
        fail(f"plan: the tuner's plan does not certify: {cert.summary()}")
    if c.G != 1 or cp.pcfg.num_microbatches != PLAN_M:
        fail(f"plan: the tuner's N=2 choice {_choice_text(c)} is not the "
             f"one-replica M={PLAN_M} plan the graph's batch was built for")
    # Eq. 14 for the busiest device at the executed microbatch: one
    # microbatch of the graph's batch is b = 1
    tabs = cp.step_tables()
    predicted = peak_memory(
        profile_partition(graph, cp.partition), c.P, 1, wave=True, V=c.V,
        windows=(tabs.W_down + tabs.W_up, tabs.W_turn, tabs.W_skip),
        wire_bytes=WIRE_BYTES[cp.pcfg.wire_dtype])
    args = train_mod._parse_args([
        "--arch", arch, "--pipeline", "--global-batch", str(PLAN_BATCH),
        "--steps", str(PLAN_STEPS), "--log-every", "1", "--device", "cuda"])
    res = train_mod.run(args, compiled=cp)
    losses = [res.losses[s] for s in sorted(res.losses)]
    if len(losses) != PLAN_STEPS or not all(math.isfinite(x)
                                            for x in losses):
        fail(f"plan: losses on the tuner's plan {losses}")
    if res.skipped_steps:
        fail(f"plan: {res.skipped_steps} non-finite updates skipped")
    step_s = [res.step_seconds[s] for s in sorted(res.step_seconds)]
    peak = res.peak_bytes
    del res
    return dict(choice=_choice_row(c), describe=cp.describe(),
                certificate=cert.to_dict(), losses=losses,
                step_seconds=step_s, predicted_device_bytes=predicted,
                predicted_card_bytes=2 * predicted, peak_bytes=peak,
                peak_over_prediction=peak / (2 * predicted))


def plan_phase(torch, rec) -> dict:
    """Phase 5: measure every block of UViT-H and Hunyuan-DiT-3B, print the
    plans on analytic and measured costs, check N=4 against the tuner's
    choice, and train UViT-H on the tuner's N=2 plan.  Returns the kernel
    launches of the phase (profiling and training)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    out: dict = {}
    reset_launch_counts()
    models = {}
    for arch in PLAN_ARCHS:
        cfg, kind, fns = _plan_model(arch)
        before = launch_counts()
        times = measure_blocks(torch, cfg, kind, fns)
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        calls = PLAN_PROFILE["warmup"] + PLAN_PROFILE["iters"]
        want = {"flash_attention": (2 if kind == "hunyuan" else 1)
                * 2 * cfg.half * calls,
                "skip_concat_matmul": cfg.half * calls}
        if any(launched[k] != v for k, v in want.items()):
            fail(f"plan {arch}: profiling launched {launched}, want {want} "
                 "(every block through flash, every decoder block through "
                 "the skip matmul)")
        analytic = _graph(cfg, kind)
        graph = _graph(cfg, kind, fwd_times=times)
        models[arch] = (cfg, kind, fns, graph)
        ana_ms = [b.fwd_time * 1e3 for b in analytic.blocks]
        ms = [t * 1e3 for t in times]
        ratio = [m / a for m, a in zip(ms, ana_ms)]
        log(f"[plan] {arch}: block forward ms at batch "
            f"{PLAN_BATCH // PLAN_M}, measured {[round(x, 4) for x in ms]}")
        log(f"[plan] {arch}: roofline ms {[round(x, 4) for x in ana_ms]}")
        log(f"[plan] {arch}: measured / roofline: enc mean "
            f"{sum(ratio[:cfg.half]) / cfg.half:.3f}, dec mean "
            f"{sum(ratio[cfg.half:]) / cfg.half:.3f}, min {min(ratio):.3f}"
            f", max {max(ratio):.3f}; sum {sum(ms):.4f} ms vs "
            f"{sum(ana_ms):.4f} ms; launches {launched}")
        out[arch] = dict(batch=PLAN_BATCH // PLAN_M, measured_ms=ms,
                         roofline_ms=ana_ms, launches=launched,
                         analytic=plans_of(analytic, f"{arch} roofline"),
                         measured=plans_of(graph, f"{arch} measured"))
        torch.cuda.empty_cache()
    for arch in PLAN_ARCHS:
        cfg, kind, fns, graph = models[arch]
        out[arch]["N4"] = check_n4(graph, fns, arch)
    _, _, fns, graph = models["uvit-h"]
    before = launch_counts()
    out["train"] = train_on_plan(torch, "uvit-h", graph, fns)
    counts = launch_counts()
    launched = {k: v - before[k] for k, v in counts.items()}
    if not (launched["flash_attention"] and launched["skip_concat_matmul"]):
        fail(f"plan: training on the tuner's plan launched {launched}; both "
             "kernels of the path must run")
    tr = out["train"]
    tr["launches"] = launched
    log(f"[plan] uvit-h on the tuner's plan: losses {tr['losses']}; step s "
        f"{[round(x, 4) for x in tr['step_seconds']]}; launches {launched}")
    log(f"[plan] peak device memory {tr['peak_bytes'] / 1e9:.3f} GB against "
        f"2 x {tr['predicted_device_bytes'] / 1e9:.3f} GB = "
        f"{tr['predicted_card_bytes'] / 1e9:.3f} GB predicted (Eq. 14, both "
        f"pipeline devices on one card): ratio "
        f"{tr['peak_over_prediction']:.3f}")
    out["launches"] = counts
    rec["plan"] = out
    return counts


# ---------------------------------------------------------------------------
# phases 6 and 8: train UViT-H, then Hunyuan-DiT-3B
# ---------------------------------------------------------------------------

def train(torch, rec, arch: str) -> dict:
    """``arch`` through ``repro_torch.launch.train``: the pipeline archs
    with ``TRAIN_ARGV`` (both model kernels must launch), the full UNet
    with ``UNET_ARGV`` (flash attention exactly ``UNET_FLASH_PER_STEP``
    times a step: every attention call through the kernel)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod

    unet = arch == "sdv2-unet-full"
    argv = UNET_ARGV if unet else ["--arch", arch] + TRAIN_ARGV
    args = train_mod._parse_args(argv)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = train_mod.run(args)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = [res.losses[s] for s in sorted(res.losses)]
    if len(losses) != args.steps or not all(math.isfinite(x) for x in losses):
        fail(f"train {arch}: losses {losses}")
    if res.skipped_steps:
        fail(f"train {arch}: {res.skipped_steps} non-finite updates skipped")
    if unet:
        if counts["flash_attention"] != UNET_FLASH_PER_STEP * args.steps:
            fail(f"train {arch}: kernel launch counts {counts}; want "
                 f"{UNET_FLASH_PER_STEP} flash launches a step")
    else:
        for k in ("skip_concat_matmul", "flash_attention"):
            if not counts[k]:
                fail(f"train {arch}: kernel launch counts {counts}; every "
                     "kernel of the path must run")
    steps = [res.step_seconds[s] for s in sorted(res.step_seconds)]
    steady = steps[1:] or steps
    sps = args.global_batch / (sum(steady) / len(steady))
    n_params = sum(x.numel() for x in _leaves(res.params))
    rec.setdefault("train", {})[arch] = dict(
        argv=argv, losses=losses, step_seconds=steps,
        samples_per_s_after_first=sps, peak_bytes=res.peak_bytes, wall_s=wall,
        launches=counts,
        launches_per_step={k: v / args.steps for k, v in counts.items()},
        params=n_params, plan=res.plan)
    log(f"[train] {arch}: {n_params} params; losses {losses}; step s "
        f"{[round(x, 4) for x in steps]}; {sps:.3f} samples/s after step "
        f"0; peak {res.peak_bytes / 1e9:.2f} GB; launches {counts} "
        f"({ {k: v / args.steps for k, v in counts.items()} } per step)")
    del res
    return counts


# ---------------------------------------------------------------------------
# phase 7: checkpoint, exact and elastic resume of UViT-H (between the
# train phases 6 and 8)
# ---------------------------------------------------------------------------

CKPT_STOP, CKPT_END = 2, 4          # A saves step 2; B trains steps 2-3


def _host(tree):
    """A host copy of every leaf (a copy on the CPU too)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def _bitwise_equal(torch, got: list, want: list, what: str) -> int:
    """Leaf by leaf, the same dtype, shape and bytes; returns the bytes
    compared."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} leaves, want {len(want)}")
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{what}: leaf {i} is {g.dtype}{list(g.shape)}, want "
                 f"{w.dtype}{list(w.shape)}")
        gb = g.contiguous().view(-1).view(torch.uint8)
        wb = w.contiguous().view(-1).view(torch.uint8)
        if not torch.equal(gb, wb):
            fail(f"{what}: leaf {i} ({w.dtype}{list(w.shape)}) differs")
        n += gb.numel()
    return n


def checkpoint_phase(torch, rec, smi_line: str) -> dict:
    """UViT-H at full width and depth through ``repro_torch.launch.train``
    with ``TRAIN_ARGV`` plus a fresh ``--ckpt-dir`` under ``build/``:

    A. ``--ckpt-every 2 --faults stop@2``: steps 0-1, an async save of step
       2 (host snapshot, then a background write of the verified
       checkpoint), stop;
    B. ``--resume --ckpt-every 100 --faults stop@4``: restores step 2 at the
       same plan, trains steps 2-3.  The restored state must equal A's
       state at the save bitwise, leaf by leaf on the host; the losses are
       held to the uninterrupted UViT-H phase's steps 2-3 at rtol 2e-2;
       both model kernels must launch;
    C. ``--devices 2 --resume --faults stop@3``: restores step 2 elastically
       (D=4 -> D=2); the restored params, merged to model space, must
       equal A's bitwise; one step with a finite loss.

    A degraded save, an unverifiable step or a missing launch fails the
    run.  Prints the checkpoint's bytes, the save's blocking (snapshot) and
    total seconds, its write rate, verify-and-restore seconds and the peak
    device memory of each restore, beside ``nvidia-smi``'s line.  The
    directory is removed at the end.  Returns the launch counts of B and
    C."""
    import shutil
    import tempfile
    import warnings

    from repro_torch.checkpoint import verify_step
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.tree import tree_flatten

    base = rec["train"]["uvit-h"]["losses"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                             dir=os.path.join(ROOT, "build"))
    out, counts = {}, {}

    def run(what, extra, devices="4", on_restore=None):
        argv = ["--arch", "uvit-h"] + TRAIN_ARGV + ["--ckpt-dir", ckdir] \
            + extra
        argv[argv.index("--devices") + 1] = devices
        left = release(torch)
        if left >= 1e9:
            fail(f"checkpoint {what}: {left / 1e9:.2f} GB still allocated "
                 "before the run; the previous one was not released")
        reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = train_mod.run(train_mod._parse_args(argv),
                                on_restore=on_restore)
        counts[what] = launch_counts()
        for w in caught:
            if issubclass(w.category, RuntimeWarning):
                fail(f"checkpoint {what}: warned: {w.message}")
        losses = [res.losses[s] for s in sorted(res.losses)]
        if not all(math.isfinite(x) for x in losses) or res.skipped_steps:
            fail(f"checkpoint {what}: losses {res.losses}, "
                 f"{res.skipped_steps} skipped")
        out[what] = dict(argv=argv, losses=res.losses, start=res.start,
                         wall_s=time.perf_counter() - t0,
                         saves=res.saves, restore=res.restore,
                         peak_bytes=res.peak_bytes, launches=counts[what])
        return res

    def log_restore(what, r):
        log(f"[ckpt] {what}: verify-and-restore {r['total_s']:.2f} s "
            f"(verify + read + place {r['restore_s']:.2f} s, copy into the "
            f"live tensors {r['copy_s']:.2f} s), peak device memory "
            f"{r['peak_bytes'] / 1e9:.2f} GB")

    try:
        # A: two steps, the save of step 2, stop
        res = run("A", ["--ckpt-every", "2", "--faults",
                        f"stop@{CKPT_STOP}"])
        if sorted(res.losses) != list(range(CKPT_STOP)):
            fail(f"checkpoint A: trained steps {sorted(res.losses)}")
        saves = res.saves
        if [s["step"] for s in saves] != [CKPT_STOP] or not saves[0]["path"]:
            fail(f"checkpoint A: saves {saves}")
        saved = _host({"params": res.params, "opt": res.opt_state})
        logical = res.logical_params
        del res
        save = saves[0]
        gb = save["bytes"] / 1e9
        t0 = time.perf_counter()
        leaves = verify_step(ckdir, CKPT_STOP)["num_leaves"]
        verify_s = time.perf_counter() - t0
        log(f"[ckpt] {smi_line}: uvit-h full width and depth, {leaves} "
            f"leaves, {save['bytes']} bytes; save: snapshot "
            f"{save['snapshot_s']:.2f} s (blocking), total "
            f"{save['total_s']:.2f} s (shard write + its hash "
            f"{save['write_s']:.2f} s = {gb / save['write_s']:.2f} GB/s, GC "
            f"re-verify {save['gc_s']:.2f} s); one verify pass "
            f"{verify_s:.2f} s ({gb / verify_s:.2f} GB/s)")

        # B: exact resume at the same plan
        checked = {}

        def check_b(state, info):
            if info.elastic or info.step != CKPT_STOP:
                fail(f"checkpoint B: restored {info}")
            checked["bytes"] = _bitwise_equal(
                torch, tree_flatten(state)[0], tree_flatten(saved)[0],
                "checkpoint B: restored vs saved state")

        res = run("B", ["--resume", "--ckpt-every", "100", "--faults",
                        f"stop@{CKPT_END}"], on_restore=check_b)
        if not checked or res.start != CKPT_STOP or \
                sorted(res.losses) != list(range(CKPT_STOP, CKPT_END)):
            fail(f"checkpoint B: start {res.start}, steps "
                 f"{sorted(res.losses)}, checked {checked}")
        rel = max(abs(res.losses[s] - base[s]) / abs(base[s])
                  for s in range(CKPT_STOP, CKPT_END))
        if not rel <= 2e-2:
            fail(f"checkpoint B: losses {res.losses} vs the uninterrupted "
                 f"run's {base[CKPT_STOP:CKPT_END]} (largest relative "
                 f"difference {rel:.3e} > 2e-2)")
        out["B"].update(max_rel_loss_diff=rel, checked_bytes=checked["bytes"])
        del res, saved
        log_restore("B same plan", out["B"]["restore"])
        log(f"[ckpt] B: restored state bitwise ({checked['bytes']} bytes), "
            f"losses {list(out['B']['losses'].values())} vs "
            f"{base[CKPT_STOP:CKPT_END]}, largest relative difference "
            f"{rel:.3e}; launches {counts['B']}")

        # C: elastic resume onto D=2
        got = {}

        def check_c(state, info):
            if not info.elastic or info.step != CKPT_STOP:
                fail(f"checkpoint C: restored {info}")
            got["params"] = _host(state["params"])

        res = run("C", ["--resume", "--faults", f"stop@{CKPT_STOP + 1}"],
                  devices="2", on_restore=check_c)
        if "params" not in got or sorted(res.losses) != [CKPT_STOP]:
            fail(f"checkpoint C: steps {sorted(res.losses)}")
        merged = res.compiled.merge_params(*got["params"])
        out["C"]["checked_bytes"] = _bitwise_equal(
            torch, tree_flatten(merged)[0], tree_flatten(logical)[0],
            "checkpoint C: elastic logical params vs A's")
        out["C"]["plan"] = res.plan.splitlines()[0]
        del res, got, merged, logical
        log_restore("C elastic D=4->2", out["C"]["restore"])
        log(f"[ckpt] C: {out['C']['plan']}; logical params bitwise "
            f"({out['C']['checked_bytes']} bytes); loss "
            f"{out['C']['losses'][CKPT_STOP]:.4f}; launches {counts['C']}")
        release(torch)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    for what in ("B", "C"):
        for k in ("skip_concat_matmul", "flash_attention"):
            if not counts[what][k]:
                fail(f"checkpoint {what}: kernel launch counts "
                     f"{counts[what]}; both model kernels must launch")
    rec["checkpoint"] = dict(runs=out, summary=dict(
        bytes=save["bytes"], leaves=leaves, snapshot_s=save["snapshot_s"],
        save_total_s=save["total_s"], write_s=save["write_s"],
        gc_s=save["gc_s"], write_GBps=gb / save["write_s"],
        verify_s=verify_s, verify_GBps=gb / verify_s,
        restore_B=out["B"]["restore"], restore_C=out["C"]["restore"],
        card=smi_line))
    return {"uvit-h resume": counts["B"], "uvit-h elastic": counts["C"]}


# ---------------------------------------------------------------------------
# phase 10: SkipViT on the wave pipeline, card vs CPU
# ---------------------------------------------------------------------------

SKIPVIT_ARGV = ["--arch", "skipvit", "--pipeline", "--devices", "2",
                "--microbatches", "4", "--global-batch", "8", "--steps", "3",
                "--wire-dtype", "float32", "--log-every", "100"]
# the JAX package's wave-asym differential: its block costs pull the fold's
# turnaround cut off-centre (D=2, M=4, lam 0)
WAVE_ASYM = dict(n_enc=3, n_mid=2, n_dec=3)
WAVE_ASYM_TIMES = [1, 1, 4, 0.5, 0.5, 0.5, 1, 1]


def _skipvit_launched(launched: dict, what: str) -> None:
    if not launched["flash_attention"] or launched["skip_concat_matmul"]:
        fail(f"{what}: the card's run launched {launched}; flash attention "
             "must run, the skip matmul must not (SkipViT's skip is "
             "additive)")


def skipvit_train(torch, rec) -> dict:
    """The trainer's entry point, ``--arch skipvit --pipeline`` at D=2, on
    the card (launch counts reset just before, read just after) and on the
    CPU from the same params (seed 0, made on the CPU) and draws: the
    losses at rtol 1e-3.  Returns the card's launches."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.adapters import model_fns
    from repro_torch.tree import tree_map

    args = train_mod._parse_args(SKIPVIT_ARGV)
    cfg = train_mod._model_config(args)
    init = tree_map(lambda x: x.numpy(), model_fns(cfg, "skipvit").init_fn(
        torch.Generator().manual_seed(0), "cpu"))
    shape = (args.global_batch, cfg.img_size, cfg.img_size, cfg.in_ch)

    def draw(step):
        rng = np.random.default_rng(step)
        return (rng.random(shape[0], dtype=np.float32),
                rng.standard_normal(shape, dtype=np.float32))

    losses = {}
    for dev in ("cpu", "cuda"):
        a = train_mod._parse_args(SKIPVIT_ARGV + ["--device", dev])
        reset_launch_counts()
        res = train_mod.run(a, init_params=init, draw=draw)
        launched = launch_counts()
        losses[dev] = [res.losses[s] for s in sorted(res.losses)]
        plan = res.plan.splitlines()[0]
        del res
    what = "skipvit train"
    _skipvit_launched(launched, what)
    lc, lg = losses["cpu"], losses["cuda"]
    if len(lg) != args.steps or not all(
            math.isfinite(g) and math.isclose(g, c, rel_tol=1e-3)
            for g, c in zip(lg, lc)):
        fail(f"{what}: losses on the card {lg} vs CPU {lc} (rtol 1e-3)")
    worst = max(abs(g - c) / abs(c) for g, c in zip(lg, lc))
    rec.setdefault("skipvit_parity", {})["train"] = dict(
        argv=SKIPVIT_ARGV, losses_cuda=lg, losses_cpu=lc, max_rel_err=worst,
        launches=launched, plan=plan)
    log(f"[skipvit] train {' '.join(SKIPVIT_ARGV)}: {plan}; losses card "
        f"{lg} cpu {lc}; max rel err {worst:.3e}; launches {launched}")
    return launched


def skipvit_wave_asym(torch, rec) -> dict:
    """The SkipViT wave step on ``wave-asym`` on the card against the same
    step on the CPU, fp32, fp32 wire, at ``pipeline_parity``'s tolerance
    (loss rtol 1e-3, grads rtol 1e-3 atol 1e-5); its cuts must not be
    mirror-symmetric.  Returns the card's launches."""
    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.models import diffusion as dm
    from repro_torch.runtime.compile import auto_pipeline
    name, D, M = "wave-asym", 2, 4
    cfg = dm.SkipViTConfig(name, use_flash=True, **WAVE_ASYM)
    graph = dm.skipvit_pipeline_graph(cfg, batch=2, fwd_times=WAVE_ASYM_TIMES)
    ds = SyntheticLatentDataset(img_size=8, channels=4)
    params, raw, t, noise = _parity_inputs(torch, cfg, "skipvit", M, ds)
    out = {}
    for dev in ("cpu", "cuda"):
        before = dict(_launches())
        out[dev] = _pipeline_step(torch, cfg, graph, "skipvit", D, M, params,
                                  raw, t, noise, dev, "float32", lam=0.0)
        torch.cuda.synchronize()
        launched = {k: _launches()[k] - before[k] for k in before}
    _skipvit_launched(launched, f"skipvit {name}")
    lc, gc_, plan = out["cpu"]
    lg, gg, _ = out["cuda"]
    part = auto_pipeline(graph, _model_fns(cfg, "skipvit"), D,
                         pipeline_devices=D, microbatches=M,
                         lam=0.0).partition
    if part.mirror_symmetric():
        fail(f"skipvit {name}: cuts {part.cuts} are symmetric")
    plan += f", cuts {part.cuts}"
    if not math.isclose(lg, lc, rel_tol=1e-3):
        fail(f"skipvit {name}: loss on the card {lg} vs CPU {lc}")
    worst = 0.0
    for k, want in gc_.items():
        try:
            torch.testing.assert_close(gg[k], want, rtol=1e-3, atol=1e-5)
        except AssertionError as e:
            fail(f"skipvit {name}: grad {k} differs:\n{e}")
        worst = max(worst, float((gg[k] - want).abs().max()))
    rec.setdefault("skipvit_parity", {})[name] = dict(
        loss_cuda=lg, loss_cpu=lc, max_abs_grad_err=worst, grads=len(gg),
        launches=launched, plan=plan)
    log(f"[skipvit] {name} D={D} M={M} fp32 wire: {plan}; loss card "
        f"{lg:.7f} cpu {lc:.7f}; {len(gg)} grads, max|err| {worst:.3e}; "
        f"launches {launched}")
    return launched


# ---------------------------------------------------------------------------
# phase 11: the supervisor -- recovery drills at uvit-nano, then a
# supervised UViT-H worker at full width
# ---------------------------------------------------------------------------

DRILL_STEPS = 12
DRILL_PLAN = ["--arch", "uvit-nano", "--pipeline", "--devices", "4", "--pp",
              "4", "--microbatches", "4", "--global-batch", "8", "--steps",
              str(DRILL_STEPS), "--lr", "1e-3", "--wire-dtype", "float32",
              "--log-every", "4", "--device", "cuda"]
# (faults, rollback step, detecting event)
DRILLS = (("hostdown@8:1", 8, "hostdown"), ("hang@6", 4, "hang"))


def _free_bytes(torch) -> int:
    return torch.cuda.mem_get_info()[0]


def _wait_memory_back(torch, free0: int, what: str) -> int:
    """Wait (at most 60 s) until the card's free memory is back within 1 GB
    of ``free0``: a torn-down worker's memory returns when its process
    ends."""
    deadline = time.time() + 60.0
    while True:
        free = _free_bytes(torch)
        if free >= free0 - 1e9:
            return free
        if time.time() > deadline:
            fail(f"{what}: {(free0 - free) / 1e9:.2f} GB of the card's "
                 "memory not returned after teardown")
        time.sleep(0.5)


def _worker_results(logs_dir: str) -> dict:
    out = {}
    for n in sorted(os.listdir(logs_dir)):
        if n.startswith("result_") and n.endswith(".json"):
            try:
                with open(os.path.join(logs_dir, n)) as f:
                    out[n[len("result_"):-len(".json")]] = json.load(f)
            except (OSError, ValueError):
                pass
    return out


def _check_worker_logs(logs_dir: str, what: str) -> list:
    """Every worker's log names the CUDA device it ran on."""
    names = []
    for n in sorted(os.listdir(logs_dir)):
        if not n.endswith(".log"):
            continue
        with open(os.path.join(logs_dir, n)) as f:
            text = f.read()
        line = next((x for x in text.splitlines()
                     if x.startswith("[train] device: cuda:")), None)
        if line is None:
            fail(f"{what}: worker log {n} names no CUDA device:\n"
                 f"{text[-3000:]}")
        names.append(f"{n}: {line[len('[train] device: '):]}")
    return names


def _gen_timing(events: list) -> dict:
    """Seconds from each generation's launch to its gen-live, and from the
    detection (hostdown/hang/escalate) to the next generation's gen-live."""
    launch = {e["gen"]: e["t"] for e in events if e["kind"] == "launch"}
    live = {e["gen"]: e["t"] for e in events if e["kind"] == "gen-live"}
    detect = [e for e in events
              if e["kind"] in ("hostdown", "hang", "escalate")]
    out = {"launch_to_live_s": {g: live[g] - launch[g] for g in live}}
    if detect and 1 in live:
        out["detect_to_next_live_s"] = live[1] - detect[0]["t"]
    return out


def supervisor_phase(torch, rec, smi_line: str) -> dict:
    """(a) the two drills of the JAX supervisor at the port's plan on the
    card, each merged trajectory at rtol 1e-4 to the port's uninterrupted
    run; (b) a supervisor over one full-width UViT-H worker with hang@3.
    The workers load the kernels phase 2 built (``REPRO_TORCH_BUILD_DIR``
    inherited, ``REPRO_TORCH_NO_BUILD=1``: a worker may not run nvcc, and
    the build directory must hold the same files after the phase).
    Returns the workers' launches, read from their result files."""
    import shutil

    from repro_torch.kernels import build
    from repro_torch.launch import supervisor as sup
    from repro_torch.launch import train as train_mod

    out = {"card": smi_line}
    libs = sorted(os.listdir(build.build_dir()))
    base = os.path.join(ROOT, "build", "chip_smoke_supervisor")
    shutil.rmtree(base, ignore_errors=True)
    worker_env = {"REPRO_TORCH_NO_BUILD": "1"}
    launched = dict.fromkeys(_launches(), 0)

    # (a) reference, then the drills
    t0 = time.perf_counter()
    ref = train_mod.run(train_mod._parse_args(DRILL_PLAN))
    ref_losses = dict(ref.losses)
    del ref
    release(torch)
    out["reference_s"] = time.perf_counter() - t0
    free0 = _free_bytes(torch)
    drills = {}
    for faults, rollback, detect in DRILLS:
        t0 = time.perf_counter()
        run_dir = os.path.join(base, detect)
        cfg = sup.SupervisorConfig(
            run_dir=run_dir, num_hosts=2, devices_per_host=2,
            steps=DRILL_STEPS, global_batch=8, arch="uvit-nano", dp=1, pp=4,
            microbatches=4, wire_dtype="float32", lr=1e-3, ckpt_every=4,
            faults=faults, stall_timeout=8.0, miss_budget=2, poll=0.2,
            backoff_base=0.2, log_every=4, device="cuda",
            worker_env=worker_env)
        res = sup.Supervisor(cfg).run()
        wall = time.perf_counter() - t0
        events = sup.read_events(res.events_path)
        kinds = [e["kind"] for e in events]
        what = f"supervisor drill {faults}"
        if not (res.ok and res.outcome == "done"
                and (res.generations, res.restarts) == (2, 1)
                and (res.final_hosts, tuple(res.final_plan)) == (1,
                                                                 (1, 2, 0))):
            fail(f"{what}: {res} events {kinds}")
        for k in (detect, "rollback", "shrink", "restart", "gen-live",
                  "done"):
            if k not in kinds:
                fail(f"{what}: no {k!r} event in {kinds}")
        rb = next(e for e in events if e["kind"] == "rollback")
        if rb["step"] != rollback:
            fail(f"{what}: rolled back to {rb['step']}, want {rollback}")
        hit = next(e for e in events if e["kind"] == detect)
        budget = cfg.stall_timeout * cfg.miss_budget + 5 * cfg.poll
        if hit["host"] != (1 if detect == "hostdown" else 0) or (
                detect == "hang" and hit["age"] > budget):
            fail(f"{what}: {hit} (hang budget {budget} s)")
        if sorted(res.losses) != list(range(DRILL_STEPS)):
            fail(f"{what}: merged trajectory {sorted(res.losses)}")
        for s in range(DRILL_STEPS):
            a, b = ref_losses[s], res.losses[s]
            if not (math.isfinite(b) and abs(a - b) <= 1e-4 * abs(a)):
                fail(f"{what}: step {s} loss {b} vs uninterrupted {a} "
                     "(rtol 1e-4)")
        logs_dir = os.path.join(run_dir, "logs")
        devices = _check_worker_logs(logs_dir, what)
        results = _worker_results(logs_dir)
        for doc in results.values():
            for k, v in doc.get("launches", {}).items():
                launched[k] += v
        free = _wait_memory_back(torch, free0, what)
        timing = _gen_timing(events)
        drills[faults] = dict(
            wall_s=wall, kinds=kinds, rollback=rb["step"],
            detect={k: hit[k] for k in ("host", "age", "step") if k in hit},
            final_plan=list(res.final_plan), devices=devices,
            worker_launches={k: d.get("launches") for k, d in
                             results.items()},
            max_rel_err=max(abs(res.losses[s] - ref_losses[s])
                            / abs(ref_losses[s]) for s in range(DRILL_STEPS)),
            free_gb_after=free / 1e9, **timing)
        log(f"[supervisor] drill {faults}: {' -> '.join(kinds)}; "
            f"rollback({rb['step']}) shrink(1, 2, 0); detection "
            f"{drills[faults]['detect']}; launch->gen-live s "
            f"{ {g: round(v, 3) for g, v in timing['launch_to_live_s'].items()} }"
            f"; detect->next gen-live {timing.get('detect_to_next_live_s', 0):.3f}"
            f" s; max rel err {drills[faults]['max_rel_err']:.2e}; "
            f"{wall:.1f} s")
        for d in devices:
            log(f"[supervisor]   {d}")
    out["drills"] = drills

    # (b) full width: one supervised UViT-H worker, hang@3, no checkpoint
    steady = rec["train"]["uvit-h"]["step_seconds"][1:]
    step_max = max(steady)
    # the watchdog judges steps after the first train beat on
    # stall_timeout: 4x the slowest steady UViT-H step of phase 6, at least
    # 5 s, leaves room for a slower step than any measured without letting
    # a hang go unseen for long; startup_timeout stays 300 s, which the
    # cold start (import, CUDA context, 2.78e9 params, plan) and steps 0-1
    # are judged on
    stall = max(5.0, 4.0 * step_max)
    release(torch)
    free0 = _free_bytes(torch)
    t0 = time.perf_counter()
    run_dir = os.path.join(base, "uvit-h")
    cfg = sup.SupervisorConfig(
        run_dir=run_dir, num_hosts=1, devices_per_host=4, steps=8,
        global_batch=16, arch="uvit-h", dp=1, pp=4, microbatches=8,
        wire_dtype="bfloat16", ckpt_every=1000, faults="hang@3",
        stall_timeout=stall, startup_timeout=300.0, miss_budget=2, poll=0.2,
        log_every=1, device="cuda", worker_env=worker_env)
    res = sup.Supervisor(cfg).run()
    wall = time.perf_counter() - t0
    events = sup.read_events(res.events_path)
    kinds = [e["kind"] for e in events]
    what = "supervisor uvit-h"
    logs_dir = os.path.join(run_dir, "logs")
    devices = _check_worker_logs(logs_dir, what)
    doc = _worker_results(logs_dir).get("h0.g0", {})
    beat_t = {int(k): v for k, v in doc.get("beat_t", {}).items()}
    steps = {int(k): v for k, v in doc.get("step_seconds", {}).items()}
    for k, v in doc.get("launches", {}).items():
        launched[k] += v
    want = ["launch", "gen-live", "heartbeat-miss", "hang", "rollback",
            "abort"]
    if kinds != want:
        fail(f"{what}: events {kinds}, want {want}")
    hang = next(e for e in events if e["kind"] == "hang")
    miss = next(e for e in events if e["kind"] == "heartbeat-miss")
    budget = stall * cfg.miss_budget + 5 * cfg.poll
    if (hang["host"], hang["step"]) != (0, 2) or hang["age"] > budget:
        fail(f"{what}: {hang}, want host 0 step 2 within {budget} s")
    if sorted(beat_t) != [0, 1, 2] or miss["t"] <= beat_t[2]:
        fail(f"{what}: heartbeat-miss at {miss['t']} before the step-2 beat "
             f"(beats {beat_t})")
    rb = next(e for e in events if e["kind"] == "rollback")
    abort = events[-1]
    if rb["step"] is not None or abort["reason"] != "no surviving hosts":
        fail(f"{what}: rollback {rb}, abort {abort}")
    if res.ok or res.final_hosts != 0:
        fail(f"{what}: {res}")
    free = _wait_memory_back(torch, free0, what)
    launch_t = events[0]["t"]
    out["uvit_h"] = dict(
        wall_s=wall, kinds=kinds, stall_timeout=stall,
        steady_step_s_phase6=steady, startup_s=beat_t[0] - launch_t,
        step_seconds=steps, detection_age=hang["age"],
        miss_age=miss["age"], devices=devices,
        launches=doc.get("launches"), free_gb_before=free0 / 1e9,
        free_gb_after=free / 1e9)
    log(f"[supervisor] uvit-h: {' -> '.join(kinds)}; stall_timeout "
        f"{stall:.2f} s (4 x the slowest steady step of the UViT-H phase, "
        f"{step_max:.3f} s; at least 5 s); first train beat "
        f"{beat_t[0] - launch_t:.2f} s after launch; step s "
        f"{[round(steps[s], 4) for s in sorted(steps)]}; heartbeat-miss "
        f"age {miss['age']} s; hang detected at age {hang['age']} s "
        f"(budget {budget:.2f} s); free memory {free0 / 1e9:.2f} GB before, "
        f"{free / 1e9:.2f} GB after teardown; {wall:.1f} s")
    for d in devices:
        log(f"[supervisor]   {d}")
    log(f"[supervisor] worker launches, read from the workers' result files "
        f"(other processes; a killed worker's count stops at its last "
        f"step's dump): {launched}")
    out["worker_launches"] = launched
    if sorted(os.listdir(build.build_dir())) != libs:
        fail(f"supervisor: the build directory changed under the workers: "
             f"{libs} -> {sorted(os.listdir(build.build_dir()))}")
    rec["supervisor"] = out
    shutil.rmtree(base, ignore_errors=True)
    return launched


def release(torch) -> int:
    """Drop what the last phase left and return the bytes still allocated
    on the card (the trainer resets the peak statistics itself, so each
    train phase reports its own peak)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device visible (torch.cuda.is_available() is False); "
             "this smoke test runs only on a GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    rec: dict = {}
    t_start = time.perf_counter()

    # 1. card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    rec["card"] = dict(name=name, nvidia_smi=smi_line,
                       count=torch.cuda.device_count(),
                       torch=torch.__version__, cuda=torch.version.cuda)
    log(f"[card] {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[card] nvidia-smi: {smi_line}")

    # 2. build, from the checkout's sources into a fresh directory
    from repro_torch.kernels import build
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build",
                                                       "chip_smoke")
    for f in os.listdir(build.build_dir()) if os.path.isdir(
            build.build_dir()) else ():
        os.remove(os.path.join(build.build_dir(), f))
    t0 = time.perf_counter()
    built = build.build(verbose=True)
    if sorted(built) != sorted(build.SOURCES):
        fail(f"build: built {sorted(built)}, want {sorted(build.SOURCES)}")
    rec["build"] = dict(wall_s=time.perf_counter() - t0,
                        seconds={k: v["seconds"] for k, v in built.items()})
    log(f"[build] {sorted(built)} in {rec['build']['wall_s']:.1f} s "
        f"(nvcc each: {rec['build']['seconds']})")
    for k, v in built.items():
        for line in v["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"[build] {k}: {line.strip()}")

    # the bf16 kernels' tiling and the grids of the train steps' shapes
    from repro_torch.kernels.flash_attention.ops import bf16_config as fcfg
    from repro_torch.kernels.skip_matmul.ops import bf16_config as scfg
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    from repro_torch.kernels.linear_scan import scan_config
    tiling = {"skip_concat_matmul bf16": scfg(),
              **{f"flash_attention bf16 D={d}": fcfg(d)
                 for d in (64, 112, 128, 224)}}
    for d in ("bfloat16", "float32"):
        for bwd in (False, True):
            tiling[f"gated_linear_scan {d} {('forward', 'backward')[bwd]}"] = (
                scan_config(getattr(torch, d), getattr(torch, d), bwd))
    sk = tiling["skip_concat_matmul bf16"]
    grids = {f"skip M={M} N={N}": -(-M // sk["tile_m"]) * -(-N // sk["tile_n"])
             for M, N in ((516, 2560), (2048, 2048))}
    # UViT-H, Hunyuan-DiT (D=128) and the UNet's levels (B*H = 16*8, S =
    # 256 at D=112, 64 and 16 at D=224)
    grids.update({
        f"flash D={d} B*H={bh} S={S}":
            bh * -(-S // tiling[f"flash_attention bf16 D={d}"]["query_rows"])
        for d, bh, S in ((128, 40, 258), (128, 32, 1024), (112, 128, 256),
                         (224, 128, 64), (224, 128, 16))})
    grids.update({f"{k} R={R} T={T} C={C}":
                  R * -(-C // v["channels"]) * -(-T // v["chunk"])
                  for k, v in tiling.items() if k.startswith("gated")
                  for R, T, C in SCAN_SHAPES.values()})
    rec["tiling"] = dict(kernels=tiling, grids=grids, sms=sms)
    for k, v in tiling.items():
        log(f"[tiling] {k}: {v}; {v['blocks_per_sm'] * sms} blocks resident "
            f"on {sms} SMs")
    log(f"[tiling] grids (blocks): {grids}")

    # 3. kernels
    main_rows = {"skip_concat_matmul": check_skip_matmul(torch, rec),
                 "flash_attention": check_flash(torch, rec)}
    scan_row, scan_launches = check_scan(torch, rec)
    torch.cuda.empty_cache()

    # 4. pipeline parity, then the UNet's card-vs-CPU parity
    for kind, D, M, over in PARITY_CASES:
        pipeline_parity(torch, rec, kind, D, M, **over)
    pipeline_parity_bf16(torch, rec)
    unet_parity(torch, rec)
    torch.cuda.empty_cache()

    # 5. plan: measured block costs, the tuner, UViT-H on the tuner's plan
    counts = {}
    left = release(torch)
    if left >= 1e9:
        fail(f"plan: {left / 1e9:.2f} GB still allocated before the phase")
    counts["plan"] = plan_phase(torch, rec)

    # 6-8. train, one model at a time; after UViT-H, its checkpoint phase
    for arch in TRAIN_ARCHS:
        left = release(torch)
        log(f"[train] {left / 1e9:.3f} GB allocated before {arch}")
        if left >= 1e9:
            fail(f"train {arch}: {left / 1e9:.2f} GB still allocated; the "
                 "previous phase was not released")
        counts[arch] = train(torch, rec, arch)
        if arch == "uvit-h":
            release(torch)
            counts.update(checkpoint_phase(torch, rec, smi_line))

    # 9. train the SDv2 UNet at full width, without the pipeline
    left = release(torch)
    if left >= 1e9:
        fail(f"train sdv2-unet-full: {left / 1e9:.2f} GB still allocated; "
             "the previous phase was not released")
    counts["sdv2-unet-full"] = train(torch, rec, "sdv2-unet-full")
    release(torch)

    # 10. SkipViT on the wave pipeline, card vs CPU
    t0 = time.perf_counter()
    counts["skipvit train"] = skipvit_train(torch, rec)
    counts["skipvit wave-asym"] = skipvit_wave_asym(torch, rec)
    rec.setdefault("phase_s", {})["skipvit"] = time.perf_counter() - t0
    log(f"[skipvit] phase {rec['phase_s']['skipvit']:.1f} s")

    # 11. the supervisor: drills at uvit-nano, a supervised UViT-H worker
    left = release(torch)
    if left >= 1e9:
        fail(f"supervisor: {left / 1e9:.2f} GB still allocated; the "
             "previous phase was not released")
    t0 = time.perf_counter()
    counts["supervisor workers"] = supervisor_phase(torch, rec, smi_line)
    rec["phase_s"]["supervisor"] = time.perf_counter() - t0
    log(f"[supervisor] phase {rec['phase_s']['supervisor']:.1f} s")

    # 12. results: each kernel's numbers at the Hunyuan-DiT train step's
    # shape (the scan: its own phase's), every train path's beside them
    kernels = []
    for kname, (source, replaces) in SOURCES.items():
        if kname == "gated_linear_scan":
            row, by_path = scan_row, {"kernel phase": scan_launches}
            by_shape = {f"{r['shape']} {r['direction']} {r['dtype']}": r
                        for r in rec["gated_linear_scan"]}
        else:
            row = main_rows[kname]["hunyuan-dit"]
            by_path = {path: c[kname] for path, c in counts.items()}
            by_shape = main_rows[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"],
            "library_device_ms": row["library_device_ms"],
            "launches_by_path": by_path,
            "by_shape": {k: {f: r.get(f) for f in (
                "dtype", "route", "max_abs_err", "ms", "device_ms",
                "device_tflops", "plain_ms", "plain_device_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")}
                for k, r in by_shape.items()}})
    rec["kernels"] = kernels
    rec["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    log(f"[done] {rec['wall_s']:.1f} s")
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
