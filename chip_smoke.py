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
   rows under path ``plan``) and of the ``hybrid`` phase (a data
   replica's microbatch of UViT-H, batch 4: flash at B=4, the skip matmul
   at M=1032, whose last row tile holds 8 rows) and of the small models the ``skipvit`` and
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
   each gradient at ||err|| / ||g|| <= 5e-2; then the linear (skip-free)
   executors, table and closed form, on a graph of UViT encoder blocks
   (D=2, M=4, uneven cuts, fp32, fp32 wire) against the CPU: loss and
   grads at rtol 1e-3, flash launched; then a narrow SDv2 UNet
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
   on the measured graphs must plan the tuner's own choice (P=2 with two
   data replicas, G=2) and certify it; then UViT-H on the tuner's
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
   kernels of the path launched; recorded for phase 12: step 0's gradient
   fingerprints before its update and the ``HOP_BYTES`` a step; then
   every reference to the trainer is dropped and the card's memory
   released;
6b. baseline (``baseline_phase``), after checking that less than 1 GB is
   still allocated: UViT-H at full width and depth (bf16, random weights
   from seed 0, the trainer's plan D=4 M=8, global batch 16) through the
   table wave executor (fp32 wire), the same plan's closed-form wave and
   the paper's skip-carry baseline, one at a time from the same params
   and microbatches, the card released between them; each one warm-up
   and 3 timed forward+backward steps: step ms (median, spread), peak
   memory, flash and skip launches a step, the bytes handed to the ring
   (dense and live, forward only), beside ``partition_comm_volume`` of
   the PULSE and the sequential partitions; closed form vs table at loss
   rtol 1e-3 and ||err||/||g|| <= 1e-2 per gradient, skip-carry vs table
   at 2e-2 and 5e-2;
7. checkpoint UViT-H (``checkpoint_phase``), full width at 8 of its 32
   blocks (``CKPT_LAYERS``), the same argv plus a ``--ckpt-dir`` under
   ``build/``: R trains steps 0-3 without a save, A trains steps 0-1 and
   saves step 2, B resumes at the same plan (restored state bitwise A's,
   steps 2-3 within 2e-2 of R's losses) and saves step 4 beside step 2
   (GC hashes neither; step 4 is then removed), C resumes
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
12. ranks (``ranks_phase``), after checking that less than 1 GB is still
    allocated: ``python -m torch.distributed.run --standalone
    --nproc-per-node 4 -m repro_torch.launch.train`` with phase 6's UViT-H
    plan and ``--ring gloo --device cuda --rank-report``: four processes,
    one per pipeline device, on the one card, the ring's payloads staged
    through pinned host memory, each running its own stage rows with the
    skip and flash kernels in its own process (they load what phase 2
    built).  Each rank runs 3 AdamW steps (the first one's
    forward+backward, read before its update, is the probe), then one
    forward+backward of the skip-carry baseline from the seed-0 params.  Held: the first loss to phase 6's
    at rtol 1e-5 and AdamW steps 1-2 at 2e-2; every gradient leaf's
    fingerprint (norm and 8 seeded random dots) to phase 6's step 0 at
    ||err||/||g|| <= 1e-2; the ring bytes, forward and backward, sent and
    received, to phase 6's ``HOP_BYTES`` live count a step (table walk,
    bf16 wire) and to the baseline phase's (skip-carry), exactly; the
    ranks' flash and skip launches of one forward+backward to phase 6's a
    step; the skip-carry loss to the table walk's at rtol 1e-5.  Prints
    each rank's peak memory beside Eq. 14's per-device prediction, the
    step seconds, and that NCCL was not run (one card);
13. hybrid (``hybrid_phase``), after checking that less than 1 GB is
    still allocated: the tuner's own N=4 plan for UViT-H at full width and
    depth (P=2, G=2, V=2, M=2; global batch 16, bf16) as ``torchrun
    --nproc-per-node 4 ... --dp 2 --pp 2 --interleave 2 --zero-stage Z
    --ring gloo --device cuda --rank-report``, at ZeRO-1 and then ZeRO-2:
    two data replicas of a two-device pipeline, four processes on the one
    card, the ring and the data group staged through pinned host memory;
    before them the same plan in one process (one data replica, the whole
    batch: ``HOP_BYTES``, launches, losses and step 0's fingerprints).
    ZeRO-0 is not run: Eq. 14 puts its four ranks past the card (printed
    beside ZeRO-1's and ZeRO-2's).  Held: P, G, V and M are the tuner's
    N=4 choice, and the ranks' cuts (the trainer's, on roofline costs;
    the tuner's, on the plan phase's measured costs, are printed beside)
    the one-process run's; every rank's step-0 loss to that run's at
    rtol 1e-2 (bf16); every gradient leaf's fingerprint, gathered
    whole, to its step 0 at ||err||/||g|| <= 2e-2; ZeRO-1's and ZeRO-2's
    losses of steps 0-2 within 1e-3; the data group's bytes and calls by
    collective, of the probe and of every step, to their arithmetic from
    the step tables and the leaves' shapes, exactly; the ring's bytes to
    the one-process ``HOP_BYTES`` live count a step, exactly; the probe's
    flash and skip launches over the ranks to twice the one-process
    step's; each rank's ZeRO-2 peak below its ZeRO-1 peak.  Prints each
    rank's peaks beside Eq. 14's per-device prediction at its stage, the
    step seconds and the collectives' host seconds; torchrun's output in
    ``chiprun_out/hybrid_zero{1,2}.log``.  The ZeRO-2 run also takes
    ``--ckpt-dir --ckpt-every 3 --steps 4 --faults stop@4``: it saves step
    3 (every rank writes its shard of the full-depth checkpoint), trains
    step 3 and stops without a final save;
14. rank checkpoint (``rank_checkpoint_phase``): four ranks of phase 12's
    plan (P=4, one replica, ZeRO-0) resume that checkpoint under
    ``torchrun --resume --rank-report``, elastically (the fingerprints
    differ), and train step 3.  Held: every rank's save landed at the
    first attempt; every rank restored step 3 elastically; bitwise, by
    SHA-256 in the rank against SHA-256 of the same range of the saved
    member (hashed here): each saving ZeRO-2 rank's pieces at the save
    (its shard of each block), each resumed rank's rows after the
    restore, and every edge leaf; each rank read no more than its blocks
    and the edge leaves, and the ranks hashed every shard once; the
    resumed step-3 loss within 1e-2 of the saving world's; flash and
    skip launched.  Prints the checkpoint's bytes, each writer's gather
    bytes and seconds, write, hash and GC seconds, each rank's blocking
    seconds at the save, each rank's restore seconds and bytes read;
    torchrun's output in ``chiprun_out/rank_checkpoint.log``; the
    directory is removed;
15. the ``kernels`` JSON line (each kernel's launches by path: ``plan``,
    ``baseline``, ``skipvit train``, ``skipvit wave-asym``,
    ``supervisor workers``, ``ranks``, ``hybrid`` and ``rank checkpoint``,
    the last four read from the workers' and ranks' result files, among
    them), then the device line as the last line.

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


def rel_errs(torch, got: dict, want: dict, bar: float, what: str) -> tuple:
    """||got - want|| / ||want|| for every gradient by path, each at most
    ``bar`` (one zero in ``want`` must be zero in ``got``): bf16 rounds at
    every op, so an elementwise bound would measure bf16's own rounding.
    Returns the worst and its path."""
    if sorted(got) != sorted(want):
        fail(f"{what}: gradient leaves differ")
    worst, worst_k = 0.0, None
    for k, w in want.items():
        ref = float(torch.linalg.vector_norm(w.float()))
        err = float(torch.linalg.vector_norm(got[k].float() - w.float()))
        if ref == 0.0:
            if err != 0.0:
                fail(f"{what}: grad {k} is zero in the reference but not "
                     "here")
            continue
        if not err / ref <= bar:
            fail(f"{what}: grad {k} relative error {err / ref:.3e} > {bar}")
        if err / ref > worst:
            worst, worst_k = err / ref, k
    return worst, worst_k


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
        ("hybrid uvit-h", 1032, 2560),   # a replica's microbatch, b=4
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
        # the hybrid phase: a data replica's microbatch of UViT-H, b=4
        ("hybrid uvit-h", 4, 258, 258, 20, 20, 128, False, None),
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
    worst, worst_k = rel_errs(torch, gg, gc_, 5e-2, f"pipeline parity {name}")
    rec.setdefault("pipeline_parity", {})[name] = dict(
        loss_cuda=lg, loss_cpu=lc, max_rel_grad_err=worst,
        worst_grad=worst_k, grads=len(gg), launches=launched, plan=plan)
    log(f"[parity] {name} bf16 on the card vs fp32 CPU: loss card {lg:.7f} "
        f"cpu {lc:.7f}; {len(gg)} grads, worst ||err||/||g|| {worst:.3e} "
        f"({worst_k}); launches {launched}")


# the linear executors' skip-free model: the 8 encoder blocks of a 16-layer
# UViT (no skip projection), its embedding reading t from the microbatch,
# on a hand-built graph whose costs cut it unevenly (D=2, M=4)
LINEAR_TIMES = (4, 2, 1, 1, 1, 1, 1, 1)


def _linear_model(torch):
    """(cfg, model fns, graph) of the linear parity model, flash on."""
    from repro_torch.core.graph import Block, BlockGraph
    from repro_torch.models import diffusion as dm
    from repro_torch.runtime.compile import PipelineModelFns
    cfg = dm.UViTConfig("linear-uvit", img_size=8, in_ch=4, patch=2,
                        d_model=64, n_layers=16, n_heads=4, d_ff=128,
                        n_classes=10, use_flash=True)
    fns = PipelineModelFns(
        init_fn=lambda gen, device: {
            k: v for k, v in dm.init_uvit(gen, cfg, device).items()
            if k != "dec_blocks"},
        embed_fn=lambda e, mb, aux: dm.uvit_embed(e, mb["xt"], mb["t"], mb,
                                                  cfg),
        loss_fn=lambda e, x, mb, aux: torch.mean(torch.square(
            dm.uvit_output(e, x, cfg).float() - mb["noise"].float())),
        split_blocks=lambda p: ((p["enc_blocks"],), {
            k: v for k, v in p.items() if k != "enc_blocks"}),
        merge_blocks=lambda st, e: {**e, "enc_blocks": st[0]},
        block_fn=lambda bp, x, aux: dm._apply_vit_block(bp, x, cfg),
        num_param_stacks=1)
    graph = BlockGraph(tuple(Block(f"b{i}", float(c), param_bytes=1 << 10,
                                   act_bytes=1 << 10)
                             for i, c in enumerate(LINEAR_TIMES)))
    return cfg, fns, graph


def linear_parity(torch, rec, D: int = 2, M: int = 4) -> None:
    """The linear (skip-free) executors, table and closed form, fp32 and
    fp32 wire, one step on the card against the same step on the CPU
    (plain versions): loss and grads at rtol 1e-3, flash attention
    launched on the card (no block projects a skip)."""
    import numpy as np

    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.runtime.adapters import make_diffusion_microbatches
    from repro_torch.runtime.compile import auto_pipeline
    from repro_torch.tree import tree_map, tree_paths

    cfg, fns, graph = _linear_model(torch)
    params = fns.init_fn(torch.Generator().manual_seed(0), "cpu")
    B = 2 * M
    raw = SyntheticLatentDataset(img_size=8, channels=4).batch(0, 0, B)
    gen = torch.Generator().manual_seed(1)
    t, noise = torch.rand((B,), generator=gen), torch.randn(
        (B, 8, 8, 4), generator=gen)
    for executor in ("table", "closed_form"):
        cp = auto_pipeline(graph, fns, D, pipeline_devices=D,
                           microbatches=M, lam=0.0, wire_dtype="float32",
                           executor=executor)
        out = {}
        before = dict(_launches())
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda x: x.detach().to(dev).clone()
                         .requires_grad_(True), cp.split_params(params))
            batch = {k: torch.as_tensor(np.asarray(v), device=dev)
                     for k, v in raw.items()}
            mb, aux = make_diffusion_microbatches(
                batch, M, t=t.to(dev), noise=noise.to(dev))
            (stack,), edge = p
            loss = cp.build()(stack, edge, {**mb, "t": aux["t"]})
            loss.backward()
            grads = cp.merge_params(*tree_map(
                lambda x: x.grad if x.grad is not None
                else torch.zeros_like(x), p))
            out[dev] = (float(loss.detach()),
                        {k: v.detach().cpu() for k, v in tree_paths(grads)})
        launched = {k: _launches()[k] - before[k] for k in before}
        name = f"linear {executor} D={D} M={M} cuts {cp.partition.cuts}"
        if not launched["flash_attention"] or launched["skip_concat_matmul"]:
            fail(f"pipeline parity {name}: launches {launched}; flash must "
                 "run, the skip matmul must not (no skips)")
        (lc, gc_), (lg, gg) = out["cpu"], out["cuda"]
        if not math.isclose(lg, lc, rel_tol=1e-3):
            fail(f"pipeline parity {name}: loss on the card {lg} vs CPU {lc}")
        worst = 0.0
        for k, want in gc_.items():
            try:
                torch.testing.assert_close(gg[k], want, rtol=1e-3, atol=1e-5)
            except AssertionError as e:
                fail(f"pipeline parity {name}: grad {k} differs:\n{e}")
            worst = max(worst, float((gg[k] - want).abs().max()))
        rec.setdefault("pipeline_parity", {})[name] = dict(
            loss_cuda=lg, loss_cpu=lc, max_abs_grad_err=worst,
            grads=len(gg), launches=launched,
            plan=cp.describe().splitlines()[0])
        log(f"[parity] {name} fp32 wire: loss card {lg:.7f} cpu {lc:.7f}; "
            f"{len(gg)} grads, max|err| {worst:.3e}; launches {launched}")


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
    """``auto_pipeline(graph, fns, 4)`` plans the tuner's own choice (P=2
    with two data replicas, G=2, on both models), with ``dp_size`` its G,
    and certifies it."""
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.tuner import tune
    from repro_torch.runtime.compile import auto_pipeline
    keep = [c for c in tune(graph, 4, hw=H100_SXM) if c.partition is not None
            and c.P > 1]
    want = keep[0]
    cp = auto_pipeline(graph, fns, 4, hw=H100_SXM)
    cert = cp.certify(name=f"{arch}-N4")
    if _choice_text(cp.choice) != _choice_text(want) or not cert.ok \
            or cp.pcfg.dp_size != want.G:
        fail(f"plan {arch} N=4: choice {_choice_text(cp.choice)} dp "
             f"{cp.pcfg.dp_size} vs tuner {_choice_text(want)}; certificate "
             f"{cert.summary()}")
    log(f"[plan] {arch} measured N=4: planned the tuner's choice "
        f"{_choice_text(cp.choice)} (dp_size {cp.pcfg.dp_size}); "
        f"{cert.summary()}")
    return dict(choice=_choice_row(want), outcome="planned",
                certificate=cert.summary(), describe=cp.describe())


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
    from repro_torch.runtime import pipeline as rp

    unet = arch == "sdv2-unet-full"
    argv = UNET_ARGV if unet else ["--arch", arch] + TRAIN_ARGV
    args = train_mod._parse_args(argv)
    # UViT-H's record for the ranks phase: step 0's gradient fingerprints
    # before its update, and the ring bytes of the one-process walk
    fingerprints = {}

    def on_grads(step, grads):
        if step == 0:
            fingerprints.update(train_mod.grad_fingerprints(grads))

    reset_launch_counts()
    rp.reset_hop_bytes()
    t0 = time.perf_counter()
    res = train_mod.run(args, on_grads=on_grads if arch == "uvit-h" else None)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    hops = rp.hop_bytes()
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
        params=n_params, plan=res.plan,
        hop_bytes_per_step={k: v / args.steps for k, v in hops.items()},
        fingerprints=fingerprints)
    log(f"[train] {arch}: {n_params} params; losses {losses}; step s "
        f"{[round(x, 4) for x in steps]}; {sps:.3f} samples/s after step "
        f"0; peak {res.peak_bytes / 1e9:.2f} GB; launches {counts} "
        f"({ {k: v / args.steps for k, v in counts.items()} } per step)")
    del res
    return counts


# ---------------------------------------------------------------------------
# phase 6b: baseline -- PULSE against the paper's skip-carry baseline, at
# UViT-H's full width and depth
# ---------------------------------------------------------------------------

BASELINE_D, BASELINE_M, BASELINE_B = 4, 8, 16     # the trainer's plan
BASELINE_TIMED = 3


def _skip_carry_merged(stacks, edge, D: int) -> dict:
    """The skip-carry layout's gradients merged back to the model's tree
    (encoder rows on devices < D/2, decoder rows on the rest)."""
    from repro_torch.tree import tree_map
    enc, dec = stacks
    return {**edge,
            "enc_blocks": tree_map(lambda x: x[:D // 2].flatten(0, 1), enc),
            "dec_blocks": tree_map(lambda x: x[D // 2:].flatten(0, 1), dec)}


def baseline_phase(torch, rec) -> dict:
    """UViT-H at full width and depth (bf16, random weights from seed 0)
    through three executors, one at a time, from the same params and the
    same microbatches (the trainer's plan: D=4, M=8, global batch 16):
    the table wave executor (fp32 wire), the same plan with
    ``executor="closed_form"``, and the paper's skip-carry baseline
    (``DiffusionPipelineAdapter.build_skip_carry_baseline``).  For each,
    one warm-up forward+backward and ``BASELINE_TIMED`` timed ones
    (synchronized, host clock): step ms, peak device memory, flash and skip
    launches a step, and the bytes each handed to its ring (dense: every
    payload a ppermute would move; live: what a receiver stores; forward
    only).  Beside them the analytic volumes of the PULSE and sequential
    partitions (``partition_comm_volume``).  Closed form vs table: loss at
    rtol 1e-3, each merged gradient at ||err||/||g|| <= 1e-2; skip-carry
    vs table: 2e-2 and 5e-2 (bf16).  Returns the phase's launches."""
    from repro_torch.core.comm_model import partition_comm_volume
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.partition import blockwise_partition
    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.models.diffusion import ddpm_draw, uvit_pipeline_graph
    from repro_torch.runtime import pipeline as rp
    from repro_torch.runtime.adapters import (DiffusionPipelineAdapter,
                                              make_diffusion_microbatches,
                                              model_fns)
    from repro_torch.runtime.compile import auto_pipeline
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    t_phase = time.perf_counter()
    D, M, B = BASELINE_D, BASELINE_M, BASELINE_B
    cfg = train_mod._model_config(train_mod._parse_args(
        ["--arch", "uvit-h", "--pipeline"]))
    fns = model_fns(cfg, "uvit")
    graph = uvit_pipeline_graph(cfg, batch=B // M, hw=H100_SXM)
    plan = dict(hw=H100_SXM, pipeline_devices=D, microbatches=M,
                wire_dtype="float32")
    cps = {"table": auto_pipeline(graph, fns, D, **plan),
           "closed_form": auto_pipeline(graph, fns, D,
                                        executor="closed_form", **plan)}
    ad = DiffusionPipelineAdapter(cfg, cps["table"].pcfg, "uvit")
    with torch.no_grad():
        params = fns.init_fn(torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    raw = SyntheticLatentDataset(img_size=cfg.img_size,
                                 channels=cfg.in_ch).batch(0, 0, B)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in raw.items()}
    t, noise = ddpm_draw(batch["latents"], 0)
    mb, aux = make_diffusion_microbatches(batch, M, cfg, "uvit", t=t,
                                          noise=noise)
    b = B // M
    act_elems = b * cfg.n_tokens * cfg.d_model        # one microbatch's
    # the payloads' dtype: the table executor's wire, the closed forms' the
    # model's own
    executors = {
        "table": (cps["table"].split_params, cps["table"].build,
                  cps["table"].merge_params, torch.float32),
        "closed_form": (cps["closed_form"].split_params,
                        cps["closed_form"].build,
                        cps["closed_form"].merge_params, cfg.dtype),
        "skip_carry": (ad.split_params_skip_carry,
                       ad.build_skip_carry_baseline,
                       lambda st, e: _skip_carry_merged(st, e, D), cfg.dtype)}
    out, ref, launched_all = {}, None, {}
    for name, (split, build, merge, payload_dtype) in executors.items():
        left = release(torch)
        p = tree_map(lambda x: x.detach().requires_grad_(True),
                     split(params))
        (enc, dec), edge = p
        fn = build()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launch_counts()
        rp.reset_hop_bytes()
        losses, secs = [], []
        for i in range(1 + BASELINE_TIMED):
            for x in tree_leaves(p):
                x.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = fn(enc, dec, edge, mb, aux)
            loss.backward()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss.detach().float()))
            del loss
        steps = 1 + BASELINE_TIMED
        launched = launch_counts()
        hops = rp.hop_bytes()
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            fail(f"baseline {name}: losses {losses}")
        for k in ("skip_concat_matmul", "flash_attention"):
            if not launched[k]:
                fail(f"baseline {name}: launches {launched}; both kernels "
                     "of the path must run")
        grads = dict(tree_paths(merge(*tree_map(
            lambda x: x.grad if x.grad is not None else torch.zeros_like(x),
            p))))
        timed = sorted(x * 1e3 for x in secs[1:])
        unit = act_elems * payload_dtype.itemsize
        row = dict(
            loss=losses[-1], losses=losses, step_ms=timed[len(timed) // 2],
            step_ms_all=[x * 1e3 for x in secs],
            spread_ms=timed[-1] - timed[0],
            peak_bytes=peak, held_bytes_before=base, bytes_left_before=left,
            launches_per_step={k: v / steps for k, v in launched.items()},
            hop_bytes_per_step={k: v / steps for k, v in hops.items()},
            hop_activations_per_microbatch={
                k: v / steps / unit / M for k, v in hops.items()},
            payload_dtype=str(payload_dtype).removeprefix("torch."))
        if name == "table":
            ref = (losses[-1], grads)
        else:
            close_loss, bar = ((1e-3, 1e-2) if name == "closed_form"
                               else (2e-2, 5e-2))
            if not math.isclose(losses[-1], ref[0], rel_tol=close_loss):
                fail(f"baseline {name}: loss {losses[-1]} vs the table "
                     f"executor's {ref[0]} (rtol {close_loss})")
            row["worst_rel_grad_err"], row["worst_grad"] = rel_errs(
                torch, grads, ref[1], bar, f"baseline {name} vs table")
        out[name] = row
        for k, v in launched.items():
            launched_all[k] = launched_all.get(k, 0) + v
        log(f"[baseline] {name}: loss {losses[-1]:.6f}; step "
            f"{row['step_ms']:.1f} ms median of {BASELINE_TIMED} (spread "
            f"{row['spread_ms']:.1f}; warm-up {secs[0] * 1e3:.1f}); peak "
            f"{peak / 1e9:.2f} GB ({base / 1e9:.2f} held before); launches a "
            f"step {row['launches_per_step']}; hop bytes a step (forward; "
            f"the backward moves the same in reverse on a real ring) dense "
            f"{hops['dense'] / steps:.0f} live {hops['live'] / steps:.0f} = "
            f"{row['hop_activations_per_microbatch']['dense']:.3f} / "
            f"{row['hop_activations_per_microbatch']['live']:.3f} "
            f"{row['payload_dtype']} activations per microbatch"
            + (f"; ||err||/||g|| worst {row['worst_rel_grad_err']:.3e} "
               f"({row['worst_grad']})" if name != "table" else ""))
        del p, enc, dec, edge, fn, grads
    del ref, params
    act = graph.blocks[0].act_bytes
    pulse = partition_comm_volume(graph, cps["table"].partition)
    seq = partition_comm_volume(graph, blockwise_partition(graph, D))
    analytic = dict(pulse=pulse.fwd_total / act,
                    sequential=seq.fwd_total / act,
                    sequential_skip=seq.skip_bytes / act)
    analytic["reduction"] = 1 - analytic["pulse"] / analytic["sequential"]
    live = {k: out[k]["hop_activations_per_microbatch"]["live"]
            for k in ("closed_form", "skip_carry")}
    dense = {k: out[k]["hop_activations_per_microbatch"]["dense"]
             for k in ("closed_form", "skip_carry")}
    measured = dict(live=1 - live["closed_form"] / live["skip_carry"],
                    dense=1 - dense["closed_form"] / dense["skip_carry"])
    rec["baseline"] = dict(params=n_params, plan=cps["table"].describe(),
                           executors=out, analytic=analytic,
                           measured_reduction=measured, launches=launched_all,
                           wall_s=time.perf_counter() - t_phase)
    log(f"[baseline] UViT-H {n_params} params, D={D} M={M} b={b}; "
        f"analytic forward volume per microbatch (partition_comm_volume): "
        f"PULSE {analytic['pulse']:.3f} activations, sequential "
        f"{analytic['sequential']:.3f} ({analytic['sequential_skip']:.3f} of "
        f"them skips): {100 * analytic['reduction']:.1f} % less; the "
        f"executors' payloads, closed-form wave against skip-carry: "
        f"live {100 * measured['live']:.1f} % less, dense "
        f"{100 * measured['dense']:.1f} % less; phase "
        f"{rec['baseline']['wall_s']:.1f} s")
    return launched_all


# ---------------------------------------------------------------------------
# phase 7: checkpoint, exact and elastic resume of UViT-H (between the
# train phases 6 and 8)
# ---------------------------------------------------------------------------

CKPT_STOP, CKPT_END = 2, 4          # A saves step 2; B trains steps 2-3
# the checkpoint phase's UViT-H: full width, a quarter of its 32 blocks.
# Its state is hashed four times on one host core (write, a verify pass,
# B's and C's restores); the ``rank checkpoint`` phase saves and restores
# the full depth over four ranks.
CKPT_LAYERS = 8


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
    """UViT-H at full width and ``CKPT_LAYERS`` blocks through
    ``repro_torch.launch.train`` with ``TRAIN_ARGV`` plus a fresh
    ``--ckpt-dir`` under ``build/``:

    R. ``--ckpt-every 100 --faults stop@4``: the uninterrupted steps 0-3,
       no save, the reference of B's losses;
    A. ``--ckpt-every 2 --faults stop@2``: steps 0-1, an async save of step
       2 (host snapshot, then a background write of the verified
       checkpoint), stop;
    B. ``--resume --ckpt-every 2 --faults stop@4``: restores step 2 at the
       same plan, trains steps 2-3, saves step 4 beside step 2.  The
       restored state must equal A's state at the save bitwise, leaf by
       leaf on the host; the losses are held to R's steps 2-3 at rtol
       2e-2; GC at the save of step 4 meets two step directories and
       hashes neither (step 2 verified at the restore, step 4 written by
       this process); both model kernels must launch.  Step 4 is then
       removed;
    C. ``--devices 2 --resume --faults stop@3``: restores step 2 elastically
       (D=4 -> D=2); the restored params, merged to model space, must
       equal A's bitwise; one step with a finite loss.

    A degraded save, an unverifiable step or a missing launch fails the
    run.  Prints the checkpoint's bytes, the save's blocking (snapshot) and
    total seconds, its write rate, verify-and-restore seconds and the peak
    device memory of each restore, beside ``nvidia-smi``'s line.  The
    directory is removed at the end.  Returns the launch counts of B and
    C."""
    import dataclasses
    import shutil
    import tempfile
    import warnings

    from repro_torch.checkpoint import verify_step
    from repro_torch.configs import uvit_h
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.tree import tree_flatten

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

    full = uvit_h.CFG       # the trainer reads it at each build
    uvit_h.CFG = dataclasses.replace(full, n_layers=CKPT_LAYERS)
    try:
        # R: the uninterrupted reference, no save
        res = run("R", ["--ckpt-every", "100", "--faults",
                        f"stop@{CKPT_END}"])
        base = [res.losses[s] for s in range(CKPT_END)]
        if os.listdir(ckdir):
            fail(f"checkpoint R: wrote {os.listdir(ckdir)}")
        nparams = sum(x.numel() for x in _leaves(res.logical_params))
        out["R"]["params"] = nparams
        del res

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
        log(f"[ckpt] {smi_line}: uvit-h full width, {CKPT_LAYERS} of "
            f"{full.n_layers} blocks ({nparams} params), {leaves} "
            f"leaves, {save['bytes']} bytes; save: snapshot "
            f"{save['snapshot_s']:.2f} s (blocking), total "
            f"{save['total_s']:.2f} s (shard write {save['write_s']:.2f} s "
            f"= {gb / save['write_s']:.2f} GB/s, its hash "
            f"{save['hash_s']:.2f} s, GC {save['gc_s']:.2f} s); one verify "
            f"pass "
            f"{verify_s:.2f} s ({gb / verify_s:.2f} GB/s)")

        # B: exact resume at the same plan
        checked = {}

        def check_b(state, info):
            if info.elastic or info.step != CKPT_STOP:
                fail(f"checkpoint B: restored {info}")
            checked["bytes"] = _bitwise_equal(
                torch, tree_flatten(state)[0], tree_flatten(saved)[0],
                "checkpoint B: restored vs saved state")

        res = run("B", ["--resume", "--ckpt-every", str(CKPT_STOP),
                        "--faults", f"stop@{CKPT_END}"], on_restore=check_b)
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
        # its save of step 4, beside step 2: GC hashes neither
        got = [(x["step"], bool(x["path"]), x["gc_hashed"])
               for x in res.saves]
        steps = sorted(os.listdir(ckdir))
        if got != [(CKPT_END, True, [])] or steps != [
                f"step_{CKPT_STOP:09d}", f"step_{CKPT_END:09d}"]:
            fail(f"checkpoint B: saves {res.saves}, step directories "
                 f"{steps}")
        gc2 = res.saves[0]
        shutil.rmtree(os.path.join(ckdir, f"step_{CKPT_END:09d}"))
        del res, saved
        log_restore("B same plan", out["B"]["restore"])
        log(f"[ckpt] B: restored state bitwise ({checked['bytes']} bytes), "
            f"losses {list(out['B']['losses'].values())} vs "
            f"{base[CKPT_STOP:CKPT_END]}, largest relative difference "
            f"{rel:.3e}; launches {counts['B']}; its save of step "
            f"{CKPT_END} beside step {CKPT_STOP}: snapshot "
            f"{gc2['snapshot_s']:.2f} s, npz {gc2['write_s']:.2f} s, "
            f"SHA-256 {gc2['hash_s']:.2f} s, GC {gc2['gc_s']:.4f} s over "
            f"two step directories, hashing none")

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
        uvit_h.CFG = full
        shutil.rmtree(ckdir, ignore_errors=True)
    for what in ("B", "C"):
        for k in ("skip_concat_matmul", "flash_attention"):
            if not counts[what][k]:
                fail(f"checkpoint {what}: kernel launch counts "
                     f"{counts[what]}; both model kernels must launch")
    rec["checkpoint"] = dict(runs=out, summary=dict(
        bytes=save["bytes"], leaves=leaves, snapshot_s=save["snapshot_s"],
        save_total_s=save["total_s"], write_s=save["write_s"],
        hash_s=save["hash_s"], gc_s=save["gc_s"], save_beside=gc2,
        write_GBps=gb / save["write_s"],
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


# ---------------------------------------------------------------------------
# phase 12: ranks -- UViT-H with one process per pipeline device, four
# ranks on the one card over the gloo ring staged through host memory
# ---------------------------------------------------------------------------

RANKS_D = 4
RANKS_STEPS = 3
RANKS_ARGV = ["--arch", "uvit-h", "--pipeline", "--devices", str(RANKS_D),
              "--microbatches", "8", "--global-batch", "16", "--steps",
              str(RANKS_STEPS), "--log-every", "1", "--ring", "gloo",
              "--device", "cuda"]
RANKS_TIMEOUT = 900          # seconds for the whole torchrun (a rank
#                              waiting on a peer fails after 600 s)
FINGERPRINT_BAR = 1e-2       # ||err|| / ||g|| per gradient leaf


def _fingerprint_errs(got: dict, want: dict) -> tuple[float, str]:
    """Worst ||err|| / ||g|| over the leaves, each estimated from the
    fingerprints (``train.grad_fingerprints``): the larger of the norms'
    difference and the root mean square of the probe dots' differences.
    A leaf whose gradient is zero in ``want`` must be zero in ``got``."""
    worst, at = 0.0, ""
    for k, w in want.items():
        g = got[k]
        dots = [a - b for a, b in zip(g[1:], w[1:])]
        err = max(abs(g[0] - w[0]),
                  math.sqrt(sum(x * x for x in dots) / len(dots)))
        rel = err / w[0] if w[0] else (0.0 if err == 0 else math.inf)
        if rel > worst or not at:
            worst, at = rel, k
    return worst, at


def ranks_phase(torch, rec, smi_line: str) -> dict:
    """Four ranks of ``repro_torch.launch.train`` on the one card
    (``torch.distributed.run --standalone --nproc-per-node 4``, ``--ring
    gloo --device cuda``: payloads staged through pinned host memory), the
    UViT-H plan of phase 6.  Each rank (``--rank-report``) runs
    ``RANKS_STEPS`` AdamW steps from the same seed-0 params and batches as
    phase 6 (the probe: the first step's forward+backward, read before its
    update), then one forward+backward of the skip-carry baseline from
    those params.
    Held: the first loss to phase 6's at rtol 1e-5, AdamW steps 1-2 at
    2e-2; each gradient leaf's fingerprint to phase 6's step 0 at
    ``FINGERPRINT_BAR``; the table walk's ring bytes, each direction, to
    phase 6's ``HOP_BYTES`` live count a step, exactly, and the
    baseline's to the baseline phase's; the ranks' flash and skip
    launches of the probe to phase 6's a step (more would mean some op
    back-propagated twice); the baseline's loss to the table walk's at
    rtol 1e-5.  Printed: each rank's peaks beside Eq. 14's per-device
    prediction, and the step seconds.  The ranks load the kernels phase 2
    built (``REPRO_TORCH_NO_BUILD=1``).  Returns the ranks' launches."""
    import shutil

    from repro_torch.core.comm_model import WIRE_BYTES
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.tuner import peak_memory, profile_partition
    from repro_torch.launch import train as train_mod
    from repro_torch.models.diffusion import uvit_pipeline_graph
    from repro_torch.runtime.adapters import model_fns
    from repro_torch.runtime.compile import auto_pipeline

    t_phase = time.perf_counter()
    one = rec["train"]["uvit-h"]
    base_row = rec["baseline"]["executors"]["skip_carry"]
    out_dir = os.path.join(ROOT, "build", "chip_smoke_ranks")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, REPRO_TORCH_NO_BUILD="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(RANKS_D), "-m", "repro_torch.launch.train",
           *RANKS_ARGV, "--rank-report", out_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=RANKS_TIMEOUT)
    wall = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "ranks.log"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        fail(f"ranks: torchrun exited {proc.returncode}:\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    docs = []
    for r in range(RANKS_D):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            docs.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    for d in docs:
        if not d["device"].startswith("cuda") or d["ring"] != "gloo" \
                or not d["staged"]:
            fail(f"ranks: rank {d['rank']} ran on {d['device']} over "
                 f"{d['ring']} (staged {d['staged']})")
    what = "ranks"

    # losses
    first = one["losses"][0]
    probe_losses = [d["probe"]["loss"] for d in docs]
    train_losses = [[d["train"]["losses"][str(s)] for s in range(RANKS_STEPS)]
                    for d in docs]
    if len({*probe_losses}) != 1 or any(x != train_losses[0]
                                         for x in train_losses):
        fail(f"{what}: the ranks disagree on the loss: probe "
             f"{probe_losses}, steps {train_losses}")
    loss0 = probe_losses[0]
    if not math.isclose(loss0, first, rel_tol=1e-5) or not math.isclose(
            train_losses[0][0], first, rel_tol=1e-5):
        fail(f"{what}: first loss {loss0} (step 0 {train_losses[0][0]}) vs "
             f"phase 6's {first} (rtol 1e-5)")
    for s in (1, 2):
        a, b = train_losses[0][s], one["losses"][s]
        if not (math.isfinite(a) and abs(a - b) <= 2e-2 * abs(b)):
            fail(f"{what}: AdamW step {s} loss {a} vs phase 6's {b} "
                 "(rtol 2e-2)")
    if any(d["train"]["skipped_steps"] for d in docs):
        fail(f"{what}: a rank skipped a step")

    # gradient fingerprints against phase 6's step 0
    got = {}
    for d in docs:
        for k, v in d["probe"]["fingerprints"].items():
            if k.startswith("edge/"):
                k = f"{k} (rank {d['rank']})"
            got[k] = v
    want = {}
    for k, v in one["fingerprints"].items():
        if k.startswith("edge/"):
            want.update({f"{k} (rank {r})": v for r in range(RANKS_D)})
        else:
            want[k] = v
    if sorted(got) != sorted(want):
        fail(f"{what}: fingerprint keys differ: "
             f"{sorted(set(got) ^ set(want))[:10]}")
    worst, worst_at = _fingerprint_errs(got, want)
    if worst > FINGERPRINT_BAR:
        fail(f"{what}: gradient {worst_at} ||err||/||g|| {worst:.3e} "
             f"against phase 6's step 0 (bar {FINGERPRINT_BAR})")

    # ring bytes, each direction, exact
    def ring_sum(key):
        return {f"{p} {k}": sum(d[key]["ring_bytes"][p][k] for d in docs)
                for p in ("fwd", "bwd") for k in ("sent", "received")}

    table_bytes, base_bytes = ring_sum("probe"), ring_sum("baseline")
    live = one["hop_bytes_per_step"]["live"]
    base_live = base_row["hop_bytes_per_step"]["live"]
    if set(table_bytes.values()) != {live}:
        fail(f"{what}: table walk ring bytes {table_bytes}, want "
             f"{live} (phase 6's HOP_BYTES live a step) each")
    if set(base_bytes.values()) != {base_live}:
        fail(f"{what}: skip-carry ring bytes {base_bytes}, want "
             f"{base_live} (the baseline phase's live a step) each")

    # launches: the probe's, summed over the ranks, are phase 6's a step
    probe_launches = {k: sum(d["probe"]["launches"][k] for d in docs)
                      for k in docs[0]["probe"]["launches"]}
    for k in ("flash_attention", "skip_concat_matmul"):
        if probe_launches[k] != one["launches_per_step"][k]:
            fail(f"{what}: {k} launched {probe_launches[k]} times in the "
                 f"ranks' forward+backward, phase 6's step "
                 f"{one['launches_per_step'][k]}")
    base_launches = {k: sum(d["baseline"]["launches"][k] for d in docs)
                     for k in docs[0]["baseline"]["launches"]}
    for k in ("flash_attention", "skip_concat_matmul"):
        if base_launches[k] != one["launches_per_step"][k]:
            fail(f"{what}: the baseline launched {k} {base_launches[k]} "
                 f"times, phase 6's step {one['launches_per_step'][k]}")
    base_loss = docs[0]["baseline"]["loss"]
    if not math.isclose(base_loss, loss0, rel_tol=1e-5):
        fail(f"{what}: skip-carry loss {base_loss} vs the table walk's "
             f"{loss0} (rtol 1e-5)")
    launched = {k: sum(d["launches"][k] for d in docs)
                for k in docs[0]["launches"]}

    # Eq. 14's per-device prediction for the plan (prints, not gates)
    cfg = train_mod._model_config(train_mod._parse_args(RANKS_ARGV))
    graph = uvit_pipeline_graph(cfg, batch=2, hw=H100_SXM)
    cp = auto_pipeline(graph, model_fns(cfg, "uvit"), RANKS_D, hw=H100_SXM,
                       pipeline_devices=RANKS_D, microbatches=8,
                       wire_dtype="bfloat16")
    tabs = cp.step_tables()
    # one microbatch of the graph's batch (2 samples) is b = 1
    predicted = peak_memory(
        profile_partition(graph, cp.partition), RANKS_D, 1, wave=True,
        windows=(tabs.W_down + tabs.W_up, tabs.W_turn, tabs.W_skip),
        wire_bytes=WIRE_BYTES["bfloat16"])
    steps = {s: [d["train"]["step_seconds"][str(s)] for d in docs]
             for s in range(RANKS_STEPS)}
    step_max = [max(v) for v in steps.values()]
    steady = step_max[1:]
    out = dict(
        card=smi_line, argv=RANKS_ARGV, wall_s=wall,
        first_loss=loss0, phase6_first_loss=first, losses=train_losses[0],
        phase6_losses=one["losses"][:RANKS_STEPS],
        worst_rel_grad_err=worst, worst_grad=worst_at,
        ring_bytes_table=table_bytes, ring_bytes_skip_carry=base_bytes,
        hop_bytes_live=live, hop_bytes_live_skip_carry=base_live,
        reduction=1 - table_bytes["fwd sent"] / base_bytes["fwd sent"],
        probe_launches=probe_launches, baseline_launches=base_launches,
        baseline_loss=base_loss, launches=launched,
        probe_seconds=[d["probe"]["seconds"] for d in docs],
        baseline_seconds=[d["baseline"]["seconds"] for d in docs],
        step_seconds=steps, step_seconds_max=step_max,
        spread_after_first=(max(steady) - min(steady)) if steady else None,
        peaks={d["rank"]: dict(init=d["probe"]["init_peak_bytes"],
                               probe=d["probe"]["peak_bytes"],
                               train=d["train"]["peak_bytes"],
                               baseline=d["baseline"]["peak_bytes"])
               for d in docs},
        eq14_per_device_bytes=predicted, nccl="not run (1 card)")
    rec["ranks"] = out
    log(f"[ranks] UViT-H D={RANKS_D} M=8 b=2, four ranks on one card over "
        f"the gloo ring (staged through pinned host memory); torchrun "
        f"{wall:.1f} s; {smi_line}")
    log(f"[ranks] first loss {loss0!r} (phase 6 {first!r}); AdamW losses "
        f"{train_losses[0]} (phase 6 {one['losses'][:RANKS_STEPS]}); "
        f"skip-carry loss {base_loss!r}")
    log(f"[ranks] gradient fingerprints vs phase 6's step 0: worst "
        f"||err||/||g|| {worst:.3e} ({worst_at}) over {len(want)} leaves")
    log(f"[ranks] ring bytes, table walk (bf16 wire): {table_bytes} = "
        f"HOP_BYTES live {live}; skip-carry: {base_bytes} = {base_live}; "
        f"PULSE moves {100 * out['reduction']:.1f} % less")
    log(f"[ranks] launches of the forward+backward summed over the ranks: "
        f"table {probe_launches}, skip-carry {base_launches}; whole run "
        f"{launched}")
    for d in docs:
        pk = out["peaks"][d["rank"]]
        log(f"[ranks] rank {d['rank']}: peak GB set-up (the whole model "
            f"drawn, then its rows kept) {pk['init'] / 1e9:.3f}, probe "
            f"{pk['probe'] / 1e9:.3f}, train {pk['train'] / 1e9:.3f}, "
            f"skip-carry {pk['baseline'] / 1e9:.3f}; Eq. 14 per device "
            f"{predicted / 1e9:.3f}; probe {d['probe']['seconds']:.3f} s, "
            f"skip-carry {d['baseline']['seconds']:.3f} s")
    log(f"[ranks] step s (slowest rank) {[round(x, 4) for x in step_max]}; "
        f"spread after step 0 {out['spread_after_first']}; "
        f"nccl: not run (1 card); phase {time.perf_counter() - t_phase:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# phase 13: hybrid -- the tuner's N=4 plan for UViT-H (P=2, G=2, V=2, M=2):
# two data replicas of a 2-device pipeline, four ranks on the one card, at
# ZeRO-1 and ZeRO-2
# ---------------------------------------------------------------------------

HYBRID_DP, HYBRID_PP, HYBRID_V, HYBRID_M = 2, 2, 2, 2
HYBRID_STEPS = 3
HYBRID_ZERO = (1, 2)
# the plan in one process (one data replica), then as the ranks run it
HYBRID_ONE_ARGV = ["--arch", "uvit-h", "--pipeline", "--pp", str(HYBRID_PP),
                   "--interleave", str(HYBRID_V), "--microbatches",
                   str(HYBRID_M), "--global-batch", str(PLAN_BATCH),
                   "--steps", str(HYBRID_STEPS), "--log-every", "1",
                   "--device", "cuda"]
HYBRID_ARGV = HYBRID_ONE_ARGV + ["--dp", str(HYBRID_DP), "--ring", "gloo"]
HYBRID_LOSS_BAR = 1e-2          # step 0 against the one-process run, bf16
HYBRID_FINGERPRINT_BAR = 2e-2   # ||err|| / ||g|| per gradient leaf, bf16
HYBRID_ZERO_BAR = 1e-3          # ZeRO-1 against ZeRO-2, steps 0-2


def _hybrid_plan(zero: int):
    """The trainer's plan of ``HYBRID_ARGV`` at ``zero`` (its graph at the
    batch of a microbatch, as ``train.build_trainer`` builds it), and the
    model's config."""
    from repro_torch.core.hw import H100_SXM
    from repro_torch.launch import train as train_mod
    from repro_torch.models.diffusion import uvit_pipeline_graph
    from repro_torch.runtime.adapters import model_fns
    from repro_torch.runtime.compile import auto_pipeline
    cfg = train_mod._model_config(train_mod._parse_args(HYBRID_ARGV))
    graph = uvit_pipeline_graph(cfg, batch=PLAN_BATCH // HYBRID_M,
                                hw=H100_SXM)
    return auto_pipeline(
        graph, model_fns(cfg, "uvit"), HYBRID_DP * HYBRID_PP, hw=H100_SXM,
        pipeline_devices=HYBRID_PP, microbatches=HYBRID_M,
        interleave=HYBRID_V, dp_size=HYBRID_DP, zero_stage=zero,
        wire_dtype="bfloat16"), cfg


def hybrid_bytes(cp, pipe: int, step: bool) -> tuple[dict, dict]:
    """The data group's bytes and calls of pipeline index ``pipe`` in one
    forward+backward (``step`` False: the probe) or one training step,
    from the plan's step tables and the leaves' shapes (drawn on the
    ``meta`` device): one fp32 all-reduce each of the loss, the edge
    gradients and, per stack, the stage gradients ZeRO keeps whole; ZeRO-1
    reduce-scatters each stack's sharded gradients in one call and, in a
    step, all-gathers their updated shards in one call; ZeRO-2
    all-gathers the sharded leaves of the slot each step of the walk
    runs, in one call, in the forward and again in the recompute, and
    reduce-scatters their gradients once; gathers and gloo's
    reduce-scatters move the params' dtype (bf16); a step adds the grid's
    norm and finite flag (8 bytes, one call)."""
    import torch as t

    from repro_torch.runtime.sharding import leaf_dims
    from repro_torch.tree import tree_leaves
    z = cp.pcfg.zero_stage
    stacks, edge = cp.model_fns.split_blocks(cp.model_fns.init_fn(
        t.Generator().manual_seed(0), "meta"))
    rows = cp.layout.split(tuple(stacks), pipe)
    edge_n = [x.numel() for x in tree_leaves(edge)]
    nb = {"all_reduce": 4 * (1 + sum(edge_n)) + (8 if step else 0),
          "all_gather": 0, "reduce_scatter": 0}
    calls = {"all_reduce": 2 + (1 if step else 0), "all_gather": 0,
             "reduce_scatter": 0}
    sel = cp.step_tables().sel[pipe]
    for i, (st, ds) in enumerate(zip(rows, cp.zero_dims())):
        whole = sharded = slot = 0    # slot: sharded bytes of a [pad, ...]
        for x, d in leaf_dims(st, ds):
            if d < 0:
                whole += 4 * x.numel()
            elif z == 1:
                sharded += x.element_size() * x.numel()
            else:
                slot += x.element_size() * x[0].numel()
        if whole:
            nb["all_reduce"] += whole
            calls["all_reduce"] += 1
        if sharded:
            nb["reduce_scatter"] += sharded
            calls["reduce_scatter"] += 1
            if step:
                nb["all_gather"] += sharded
                calls["all_gather"] += 1
        if slot:
            runs = int((sel == i + 1).sum())
            nb["all_gather"] += 2 * runs * slot
            nb["reduce_scatter"] += runs * slot
            calls["all_gather"] += 2 * runs
            calls["reduce_scatter"] += runs
    return nb, calls


def _hybrid_reference() -> dict:
    """``HYBRID_ONE_ARGV`` through the trainer in this process: the ranks'
    plan (P, V, M and the trainer's cuts) with one data replica on the
    whole global batch.  Its cuts, losses, step 0's gradient fingerprints
    before its update, the ring's bytes a step and the kernel launches a
    step: what every data replica of the ranks is held to."""
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime import pipeline as rp
    fingerprints = {}

    def on_grads(step, grads):
        if step == 0:
            fingerprints.update(train_mod.grad_fingerprints(grads))

    before = launch_counts()
    rp.reset_hop_bytes()
    res = train_mod.run(train_mod._parse_args(HYBRID_ONE_ARGV),
                        on_grads=on_grads)
    hops = rp.hop_bytes()
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    out = dict(cuts=list(res.compiled.partition.cuts),
               losses=[res.losses[s] for s in sorted(res.losses)],
               fingerprints=fingerprints,
               hop_bytes_per_step={k: v / HYBRID_STEPS
                                   for k, v in hops.items()},
               launches=launched,
               launches_per_step={k: v / HYBRID_STEPS
                                  for k, v in launched.items()},
               peak_bytes=res.peak_bytes)
    del res
    return out


def _hybrid_run(zero: int, out_dir: str, env: dict,
                extra: list = ()) -> tuple[list, float]:
    """One torchrun of ``HYBRID_ARGV`` at ``zero`` (and ``extra``): the
    four ranks' report documents and the wall seconds."""
    import shutil
    shutil.rmtree(out_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(HYBRID_DP * HYBRID_PP), "-m",
           "repro_torch.launch.train", *HYBRID_ARGV, "--zero-stage",
           str(zero), "--rank-report", out_dir, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=RANKS_TIMEOUT)
    wall = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, f"hybrid_zero{zero}.log"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        fail(f"hybrid ZeRO-{zero}: torchrun exited {proc.returncode}:\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    docs = []
    for r in range(HYBRID_DP * HYBRID_PP):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            docs.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    return docs, wall


def hybrid_phase(torch, rec, smi_line: str, ckdir: str) -> tuple:
    """Four ranks of ``repro_torch.launch.train`` on the one card over the
    staged gloo ring and data group: the tuner's own N=4 plan for UViT-H
    at full width and depth (P=2 pipeline devices, G=2 data replicas,
    V=2, M=2), global batch ``PLAN_BATCH``, bf16, at ZeRO-1 and then
    ZeRO-2, each ``HYBRID_STEPS`` AdamW steps (``--rank-report``; the
    probe is the first step's forward+backward, read before its update).
    ZeRO-0 is left out: Eq. 14 puts four of its ranks past the card's
    memory (printed).  First the same plan in one process
    (:func:`_hybrid_reference`).
    Held: P, G, V and M are the tuner's N=4 choice; the ranks' cuts (the
    trainer's own partition on roofline costs, which the tuner's on the
    plan phase's measured costs may differ from by a block) are the
    one-process run's; every rank's step-0 loss to that run's at
    ``HYBRID_LOSS_BAR``; every gradient leaf's fingerprint, gathered
    whole, to its step 0 at ``HYBRID_FINGERPRINT_BAR``; the ZeRO-1 and
    ZeRO-2 losses of steps 0-2 within ``HYBRID_ZERO_BAR``; the data
    group's bytes and calls, by collective, of the probe and of every
    step, to their arithmetic (:func:`hybrid_bytes`), exactly; the ring's
    bytes, each direction summed over the ranks, to the one-process run's
    ``HOP_BYTES`` live count a step, exactly; the flash and skip launches
    of the probe, summed over the ranks, to twice the one-process run's a
    step (each replica runs every block call); each rank's ZeRO-2 peak
    below its ZeRO-1 peak.  Printed: peaks beside Eq. 14's per-device
    prediction at each stage, step seconds, the collectives' host seconds.
    The ZeRO-2 run also saves a checkpoint into ``ckdir`` for the ``rank
    checkpoint`` phase (:data:`RANK_CKPT_SAVE`: a save of step 3, then
    step 3, then a stop without a final save).  Returns the launches by
    path, the ranks' own (``hybrid``) and the one-process reference's
    (``hybrid reference``), and the ZeRO-2 ranks' report documents."""
    from repro_torch.core.comm_model import WIRE_BYTES
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.tuner import peak_memory, profile_partition
    from repro_torch.models.diffusion import uvit_pipeline_graph

    t_phase = time.perf_counter()
    choice = rec["plan"]["uvit-h"]["N4"]["choice"]
    want = dict(P=HYBRID_PP, G=HYBRID_DP, V=HYBRID_V, M=HYBRID_M)
    if {k: choice[k] for k in want} != want:
        fail(f"hybrid: the tuner's N=4 choice is {choice}, not the "
             f"{want} this phase runs")

    # Eq. 14 per device at each stage, for a replica's microbatch
    built = {z: _hybrid_plan(z) for z in (0, *HYBRID_ZERO)}
    plans = {z: cp for z, (cp, _) in built.items()}
    cfg = built[0][1]
    graph = uvit_pipeline_graph(cfg, batch=PLAN_BATCH // HYBRID_M
                                // HYBRID_DP, hw=H100_SXM)
    tabs = plans[0].step_tables()
    eq14 = {z: peak_memory(
        profile_partition(graph, plans[z].partition), HYBRID_PP, 1,
        wave=True, V=HYBRID_V,
        windows=(tabs.W_down + tabs.W_up, tabs.W_turn, tabs.W_skip),
        wire_bytes=WIRE_BYTES["bfloat16"], dp=HYBRID_DP, zero_stage=z)
        for z in plans}
    card = torch.cuda.get_device_properties(0).total_memory
    n_ranks = HYBRID_DP * HYBRID_PP
    log(f"[hybrid] Eq. 14 per device, UViT-H P={HYBRID_PP} dp={HYBRID_DP} "
        f"V={HYBRID_V} M={HYBRID_M}, {PLAN_BATCH // HYBRID_M // HYBRID_DP} "
        "samples a replica's microbatch: "
        + ", ".join(f"ZeRO-{z} {eq14[z] / 1e9:.3f} GB (x{n_ranks} = "
                    f"{n_ranks * eq14[z] / 1e9:.3f} GB)" for z in eq14)
        + f"; the card holds {card / 1e9:.3f} GB, so ZeRO-0 is not run")
    one = _hybrid_reference()
    left = release(torch)
    if left >= 1e9:
        fail(f"hybrid: {left / 1e9:.2f} GB still allocated after the "
             "one-process reference")
    for z in plans:
        if list(plans[z].partition.cuts) != one["cuts"]:
            fail(f"hybrid: the ranks' cuts {plans[z].partition.cuts} at "
                 f"ZeRO-{z} are not the one-process reference's "
                 f"{one['cuts']}")
    log(f"[hybrid] one-process reference on the same plan (cuts "
        f"{one['cuts']}; the tuner's measured-cost cuts at N=4: "
        f"{choice['cuts']}): losses {one['losses']}; launches "
        f"{one['launches']}; peak {one['peak_bytes'] / 1e9:.3f} GB")

    env = dict(os.environ, REPRO_TORCH_NO_BUILD="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    runs, walls = {}, {}
    for z in HYBRID_ZERO:
        runs[z], walls[z] = _hybrid_run(
            z, os.path.join(ROOT, "build", f"chip_smoke_hybrid{z}"), env,
            RANK_CKPT_SAVE + ["--ckpt-dir", ckdir] if z == 2 else [])
    out = dict(card=smi_line, argv=HYBRID_ARGV, wall_s=walls,
               eq14_per_device_bytes=eq14, card_bytes=card, zero={})
    launched = {}
    first = one["losses"][0]
    live = one["hop_bytes_per_step"]["live"]
    for z, docs in runs.items():
        what = f"hybrid ZeRO-{z}"
        for d in docs:
            if not d["device"].startswith("cuda") or d["ring"] != "gloo" \
                    or not d["staged"] or d["dp"] != HYBRID_DP:
                fail(f"{what}: rank {d['rank']} ran on {d['device']} over "
                     f"{d['ring']} (staged {d['staged']}, dp {d['dp']})")
            spec = d["spec"]
            if (spec["P"], spec["V"], spec["M"], spec["dp"],
                    spec["zero_stage"], spec["cuts"]) != (
                    HYBRID_PP, HYBRID_V, HYBRID_M, HYBRID_DP, z,
                    one["cuts"]):
                fail(f"{what}: rank {d['rank']} planned {spec}")
        # losses: the ranks agree; step 0 against the one-process run
        probe = [d["probe"]["loss"] for d in docs]
        losses = [[d["train"]["losses"][str(s)] for s in range(HYBRID_STEPS)]
                  for d in docs]
        if len(set(probe)) != 1 or any(x != losses[0] for x in losses):
            fail(f"{what}: the ranks disagree: probe {probe}, {losses}")
        for x in (probe[0], losses[0][0]):
            if not abs(x - first) <= HYBRID_LOSS_BAR * abs(first):
                fail(f"{what}: step 0 loss {x} vs the one-process run's "
                     f"{first} (bar {HYBRID_LOSS_BAR})")
        if any(d["train"]["skipped_steps"] for d in docs):
            fail(f"{what}: a rank skipped a step")
        # fingerprints of the whole gradient, each data replica's ranks
        worst, worst_at = 0.0, ""
        for di in range(HYBRID_DP):
            got = {}
            for d in docs:
                if d["data"] == di:
                    got.update(d["probe"]["fingerprints"])
            if sorted(got) != sorted(one["fingerprints"]):
                fail(f"{what}: fingerprint keys differ: "
                     f"{sorted(set(got) ^ set(one['fingerprints']))[:10]}")
            w, at = _fingerprint_errs(got, one["fingerprints"])
            if w > worst or not worst_at:
                worst, worst_at = w, f"{at} (data {di})"
        if worst > HYBRID_FINGERPRINT_BAR:
            fail(f"{what}: gradient {worst_at} ||err||/||g|| {worst:.3e} "
                 f"against the one-process step 0 (bar "
                 f"{HYBRID_FINGERPRINT_BAR})")
        # the data group's bytes and calls, probe and every step
        for d in docs:
            for key, step in [("probe", False)] + [
                    (str(s), True) for s in range(HYBRID_STEPS)]:
                nb, calls = hybrid_bytes(plans[z], d["pipe"], step)
                got = (d["probe"]["data_bytes"], d["probe"]["data_calls"]) \
                    if key == "probe" else (
                        d["step_data_bytes"][key]["bytes"],
                        d["step_data_bytes"][key]["calls"])
                if got != (nb, calls):
                    fail(f"{what}: rank {d['rank']} {key} data group "
                         f"{got}, arithmetic {(nb, calls)}")
        # ring bytes, each direction over the ranks: the one-process walk's
        ring = {f"{p} {k}": sum(d["probe"]["ring_bytes"][p][k] for d in docs)
                for p in ("fwd", "bwd") for k in ("sent", "received")}
        if set(ring.values()) != {live}:
            fail(f"{what}: ring bytes {ring}, want the one-process "
                 f"HOP_BYTES live {live} a step each")
        # launches: every replica runs every block call of a step
        probe_l = {k: sum(d["probe"]["launches"][k] for d in docs)
                   for k in docs[0]["probe"]["launches"]}
        for k in ("flash_attention", "skip_concat_matmul"):
            if probe_l[k] != HYBRID_DP * one["launches_per_step"][k]:
                fail(f"{what}: {k} launched {probe_l[k]} times in the "
                     f"ranks' forward+backward; want {HYBRID_DP} x the "
                     f"one-process step's {one['launches_per_step'][k]}")
        ranks_l = {k: sum(d["launches"][k] for d in docs)
                   for k in docs[0]["launches"]}
        for k, v in ranks_l.items():
            launched[k] = launched.get(k, 0) + v
        steps = {s: [d["train"]["step_seconds"][str(s)] for d in docs]
                 for s in range(HYBRID_STEPS)}
        coll = {k: [d["step_data_bytes"][str(s)]["seconds"][k]
                    for d in docs for s in range(1, HYBRID_STEPS)]
                for k in ("all_reduce", "all_gather", "reduce_scatter")}
        out["zero"][z] = dict(
            probe_loss=probe[0], losses=losses[0],
            one_process_losses=one["losses"][:HYBRID_STEPS],
            worst_rel_grad_err=worst, worst_grad=worst_at,
            ring_bytes=ring, hop_bytes_live=live,
            probe_data_bytes={d["rank"]: d["probe"]["data_bytes"]
                              for d in docs},
            step_data_bytes={d["rank"]: d["step_data_bytes"]["1"]
                             for d in docs},
            probe_launches=probe_l, launches=ranks_l,
            step_seconds=steps,
            step_seconds_max=[max(v) for v in steps.values()],
            collective_seconds_after_first=coll,
            probe_seconds=[d["probe"]["seconds"] for d in docs],
            peaks={d["rank"]: dict(init=d["probe"]["init_peak_bytes"],
                                   probe=d["probe"]["peak_bytes"],
                                   train=d["train"]["peak_bytes"])
                   for d in docs},
            data_group=docs[0]["data_group"])
    z1, z2 = (out["zero"][z] for z in HYBRID_ZERO)
    for s in range(HYBRID_STEPS):
        a, b = z1["losses"][s], z2["losses"][s]
        if not abs(a - b) <= HYBRID_ZERO_BAR * abs(a):
            fail(f"hybrid: step {s} loss ZeRO-1 {a} vs ZeRO-2 {b} (bar "
                 f"{HYBRID_ZERO_BAR})")
    for r in z1["peaks"]:
        if not z2["peaks"][r]["train"] < z1["peaks"][r]["train"]:
            fail(f"hybrid: rank {r} peaked at {z2['peaks'][r]['train']} B "
                 f"at ZeRO-2, not below ZeRO-1's {z1['peaks'][r]['train']}")
    rec["hybrid"] = out
    log(f"[hybrid] UViT-H on the tuner's N=4 plan P={HYBRID_PP} "
        f"G={HYBRID_DP} V={HYBRID_V} M={HYBRID_M}, global batch "
        f"{PLAN_BATCH}, four ranks on one card (gloo ring and data group "
        f"staged through pinned host memory; {z1['data_group']}); {smi_line}")
    for z in HYBRID_ZERO:
        o = out["zero"][z]
        log(f"[hybrid] ZeRO-{z}: torchrun {walls[z]:.1f} s; step-0 loss "
            f"{o['probe_loss']!r} (one process {first!r}); AdamW losses "
            f"{o['losses']} (one process {o['one_process_losses']}); "
            f"gradient fingerprints worst ||err||/||g|| "
            f"{o['worst_rel_grad_err']:.3e} ({o['worst_grad']})")
        log(f"[hybrid] ZeRO-{z}: ring bytes {o['ring_bytes']} = HOP_BYTES "
            f"live {live}; data group a step (rank: bytes, calls, host s) "
            + "; ".join(f"{r}: {v['bytes']} {v['calls']} "
                        f"{ {k: round(x, 4) for k, x in v['seconds'].items()} }"
                        for r, v in o["step_data_bytes"].items())
            + " = the arithmetic")
        log(f"[hybrid] ZeRO-{z}: launches of the forward+backward over the "
            f"ranks {o['probe_launches']} = {HYBRID_DP} x the one-process "
            f"step's; step s (slowest rank) "
            f"{[round(x, 4) for x in o['step_seconds_max']]}")
        for r, pk in o["peaks"].items():
            log(f"[hybrid] ZeRO-{z} rank {r}: peak GB set-up "
                f"{pk['init'] / 1e9:.3f}, probe {pk['probe'] / 1e9:.3f}, "
                f"train {pk['train'] / 1e9:.3f}; Eq. 14 per device "
                f"{eq14[z] / 1e9:.3f}")
    log(f"[hybrid] not measurable on one card: the all-gather and "
        f"reduce-scatter over NVLink (NCCL, a card a rank); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"hybrid": launched, "hybrid reference": one["launches"]}, runs[2]


# ---------------------------------------------------------------------------
# phase 14: checkpoints over ranks -- the hybrid ZeRO-2 world's save, and an
# elastic resume of it as the ranks phase's four pipeline ranks
# ---------------------------------------------------------------------------

# the hybrid phase's ZeRO-2 run: a save of step 3, step 3, a stop (no final
# save)
RANK_CKPT_SAVE = ["--steps", str(HYBRID_STEPS + 1), "--ckpt-every",
                  str(HYBRID_STEPS), "--faults", f"stop@{HYBRID_STEPS + 1}"]
RANK_CKPT_STEP = HYBRID_STEPS


def _set_arg(argv: list, flag: str, value: str) -> list:
    """``argv`` with ``flag``'s value replaced by ``value``."""
    out = list(argv)
    out[out.index(flag) + 1] = value
    return out


# the resume: the ranks phase's plan (P=4, one replica, ZeRO-0) trains step
# 3 and stops (a second full-size checkpoint would pass the disk writes a
# chip run may make: the phase writes 27.8 GB)
RANK_CKPT_RESUME = _set_arg(RANKS_ARGV, "--steps", str(RANK_CKPT_STEP + 1)) \
    + ["--resume", "--faults", f"stop@{RANK_CKPT_STEP + 1}"]
HASH_WORKERS = 6          # host processes hashing the saved blocks


def _npz_members(path: str) -> dict:
    """``name -> (shape, dtype, offset)`` of every ``.npy`` member of an
    uncompressed npz: the file offset of each array's first byte, read
    from the zip's local headers and the ``.npy`` headers."""
    import zipfile

    import numpy as np
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                fail(f"{path}: {info.filename} is compressed")
            f.seek(info.header_offset)
            local = f.read(30)
            f.seek(info.header_offset + 30 + int.from_bytes(local[26:28],
                                                            "little")
                   + int.from_bytes(local[28:30], "little"))
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, _, dtype = read(f)
            out[info.filename[:-len(".npy")]] = (shape, dtype, f.tell())
    return out


def _sha256_ranges(path: str, ranges: list) -> list:
    """SHA-256 of each ``(offset, nbytes, cut)`` range of a file (a worker
    of the hash pool): of the range's bytes, or with ``cut = (shape,
    itemsize, dim, parts, part)`` of the C-ordered bytes of part ``part``
    of the range seen as an array of ``shape`` cut along ``dim`` into
    ``parts`` equal parts (a rank's ZeRO shard of a block)."""
    import hashlib

    import numpy as np
    out = []
    with open(path, "rb") as f:
        for off, n, cut in ranges:
            f.seek(off)
            h = hashlib.sha256()
            if cut is not None:
                shape, itemsize, dim, parts, part = cut
                b = f.read(n)
                if len(b) != n:
                    raise EOFError(f"{path}: short at {off}")
                a = np.frombuffer(b, dtype=f"u{itemsize}").reshape(shape)
                h.update(np.ascontiguousarray(
                    np.split(a, parts, axis=dim)[part]))
                out.append(h.hexdigest())
                continue
            left = n
            while left:
                b = f.read(min(left, 1 << 24))
                if not b:
                    raise EOFError(f"{path}: short at {off}")
                h.update(b)
                left -= len(b)
            out.append(h.hexdigest())
    return out


def _slot_ranges(spec: dict) -> list:
    """Per stage stack, ``ranges[d][v]``: the blocks (of that stack's own
    numbering: the decoder's from the turnaround cut) slot ``v`` of device
    ``d`` holds, from a manifest's or a rank report's state spec."""
    cuts = spec["cuts"]
    mid = cuts[(len(cuts) - 1) // 2]
    return [[[(cuts[s], cuts[s + 1]) for s in ss] for ss in spec["enc_slots"]],
            [[(cuts[s] - mid, cuts[s + 1] - mid) for s in ss]
             for ss in spec["dec_slots"]]]


def _digest_tasks(doc: dict, digests: dict, man: dict, members: dict,
                  tasks: dict, want: dict, what: str) -> int:
    """Add to ``tasks`` (path -> ``[(offset, nbytes, cut)]``) and ``want``
    (path -> ``[(what, rank, leaf, slot, row, digest)]``) every range of
    the saved members that rank report ``doc``'s ``digests``
    (``held_digests``) name: each edge leaf whole, and each real block of
    the rank's rows of a stage leaf, found in the saved layout
    (``man["plan"]``) through the rank's own (``doc["spec"]``), cut to the
    rank's ZeRO shard where it holds one.  Returns the bytes of the
    ranges the rank holds whole (its blocks and edge leaves)."""
    saved = _slot_ranges(man["plan"])
    spec, dev = doc["spec"], doc["pipe"]
    if spec["num_param_stacks"] != 2 or man["plan"]["num_param_stacks"] != 2:
        fail(f"rank checkpoint: {what}: the block check reads two stacks")
    new = _slot_ranges(spec)
    counts = (spec["enc_counts"][dev], spec["dec_counts"][dev])
    nb = 0
    for i in range(man["num_leaves"]):
        path, shape, dtype, off = members[i]
        size = int(math.prod(shape)) * dtype.itemsize
        got = digests.get(str(i))
        if got is None:
            fail(f"rank checkpoint: {what}: rank {doc['rank']} has no "
                 f"digest of leaf {i}")
        if isinstance(got, str):                        # an edge leaf
            want.setdefault(path, []).append(
                (what, doc["rank"], i, None, None, got))
            tasks.setdefault(path, []).append((off, size, None))
            nb += size
            continue
        block = size // int(math.prod(shape[:3]))
        cut = ((tuple(shape[3:]), dtype.itemsize, got["dim"], got["parts"],
                got["part"]) if "dim" in got else None)
        stack = got["stack"]
        if [len(x) for x in got["rows"]] != list(counts[stack]):
            fail(f"rank checkpoint: {what}: rank {doc['rank']} leaf {i}: "
                 f"{[len(x) for x in got['rows']]} rows a slot, its plan's "
                 f"counts {counts[stack]}")
        for v, rows in enumerate(got["rows"]):
            lo = new[stack][dev][v][0]
            for r, digest in enumerate(rows):
                b = lo + r
                (ds, vs), rs = next(
                    ((dd, vv), b - a) for dd, sl in enumerate(saved[stack])
                    for vv, (a, z) in enumerate(sl) if a <= b < z)
                row = (ds * shape[1] + vs) * shape[2] + rs
                tasks.setdefault(path, []).append(
                    (off + row * block, block, cut))
                want.setdefault(path, []).append(
                    (what, doc["rank"], i, v, r, digest))
                nb += block
    return nb


def _members(step_dir: str, man: dict) -> dict:
    """Leaf index -> ``(path, shape, dtype, offset)`` of its member."""
    out = {}
    for sh in man["shards"]:
        path = os.path.join(step_dir, sh)
        for name, meta in _npz_members(path).items():
            out[int(name[1:])] = (path,) + meta
    return out


def _saves(doc: dict) -> list:
    """A rank report's save records, without their digests."""
    return [{k: v for k, v in x.items() if k != "digests"}
            for x in doc["saves"]]


def rank_checkpoint_phase(torch, rec, smi_line: str, ckdir: str,
                          save_docs: list) -> dict:
    """The ``hybrid`` phase's ZeRO-2 world (UViT-H at full width and depth,
    the tuner's N=4 plan P=2 G=2 V=2 M=2, bf16, four ranks on the card
    over the staged gloo groups) saved step ``RANK_CKPT_STEP`` into
    ``ckdir`` (``RANK_CKPT_SAVE``: every rank gathers its share of the
    leaves whole into host memory and writes ``shard_<rank>.npz``), then
    trained that step (loss L3) and stopped.  Here one torchrun of four
    ranks on the ``ranks`` phase's plan (P=4, one replica, ZeRO-0,
    ``RANK_CKPT_RESUME``) resumes it: the fingerprints differ, so each
    rank reads the saved blocks its new rows hold (the elastic path),
    and trains step 3.
    Held, bitwise, by SHA-256 (``--rank-report``'s ``held_digests``
    against the same ranges of the saved members, hashed here by
    ``HASH_WORKERS`` processes): each saving ZeRO-2 rank's pieces at the
    save (its shard of each block, cut from the saved block) and each
    resumed rank's rows after the restore are the saved members' bytes.
    Held besides: every save landed at the first attempt; every rank
    resumed step 3 elastically; each rank read no more than the blocks
    its rows hold plus the edge leaves, and the ranks hashed every shard
    once; the resumed step-3 loss within ``HYBRID_LOSS_BAR`` of L3;
    flash and skip launched in the resumed ranks.  Printed: the
    checkpoint's bytes, each writer's gather bytes and seconds, write,
    hash and GC seconds, each rank's blocking seconds at the save, each
    rank's restore seconds and bytes read.  The directory is removed at
    the end.  Returns the resumed ranks' launches (``rank checkpoint``)."""
    import concurrent.futures
    import multiprocessing
    import shutil

    def step_dir(step):
        return os.path.join(ckdir, f"step_{step:09d}")

    t_phase = time.perf_counter()
    step3 = RANK_CKPT_STEP
    try:
        # ---- the save, as the ZeRO-2 ranks report it
        if sorted(os.listdir(ckdir)) != [os.path.basename(step_dir(step3))]:
            fail(f"rank checkpoint: {sorted(os.listdir(ckdir))} under the "
                 f"checkpoint directory, want step {step3} alone")
        for d in save_docs:
            got = [(x["step"], x["attempts"], bool(x["path"]),
                    x.get("landed"), "digests" in x) for x in d["saves"]]
            if got != [(step3, 1, True, True, True)]:
                fail(f"rank checkpoint: rank {d['rank']} saves "
                     f"{_saves(d)}")
        l3 = save_docs[0]["train"]["losses"].get(str(step3))
        if l3 is None or any(d["train"]["losses"].get(str(step3))
                             != l3 for d in save_docs):
            fail("rank checkpoint: the saving ranks' step "
                 f"{step3} losses differ or are missing")
        with open(os.path.join(step_dir(step3), "manifest.json")) as f:
            man = json.load(f)
        nranks = HYBRID_DP * HYBRID_PP
        if man["num_hosts"] != nranks or len(man["shards"]) != nranks:
            fail(f"rank checkpoint: manifest of {man['num_hosts']} hosts, "
                 f"shards {man['shards']}")
        shard_bytes = {sh: os.path.getsize(os.path.join(step_dir(step3), sh))
                       for sh in man["shards"]}
        total = sum(shard_bytes.values())
        log(f"[rank-ckpt] {smi_line}: UViT-H at full width and depth, the "
            f"ZeRO-2 world P={HYBRID_PP} G={HYBRID_DP} V={HYBRID_V} saved "
            f"step {step3}: {man['num_leaves']} leaves, {total} "
            f"bytes in {nranks} shards {list(shard_bytes.values())}")
        for d in save_docs:
            x = d["saves"][0]
            log(f"[rank-ckpt] save rank {d['rank']}: blocking "
                f"{x['blocking_s']:.2f} s (gather {x['gather_s']:.2f} s: "
                f"{x['gather_bytes_in']} bytes in, {x['gather_bytes_out']} "
                f"out); writes {x['leaves_written']} leaves, {x['bytes']} "
                f"bytes: npz {x['write_s']:.2f} s, SHA-256 "
                f"{x['hash_s']:.2f} s, GC {x['gc_s']:.3f} s")

        # ---- the elastic resume, four pipeline ranks
        out_dir = os.path.join(ROOT, "build", "chip_smoke_rank_ckpt")
        shutil.rmtree(out_dir, ignore_errors=True)
        env = dict(os.environ, REPRO_TORCH_NO_BUILD="1",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(ROOT, "src")]
                       + [p for p in os.environ.get("PYTHONPATH", "").split(
                           os.pathsep) if p]))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(RANKS_D), "-m",
               "repro_torch.launch.train", *RANK_CKPT_RESUME, "--ckpt-dir",
               ckdir, "--rank-report", out_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                              text=True, timeout=RANKS_TIMEOUT)
        wall = time.perf_counter() - t0
        with open(os.path.join(OUT_DIR, "rank_checkpoint.log"), "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        if proc.returncode != 0:
            fail(f"rank checkpoint: the resume exited {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        docs = []
        for r in range(RANKS_D):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                docs.append(json.load(f))
        shutil.rmtree(out_dir, ignore_errors=True)
        for d in docs:
            got = d["resumed"]
            if not got or got["step"] != step3 or not got["elastic"] \
                    or got["saved_fingerprint"] == got["fingerprint"]:
                fail(f"rank checkpoint: rank {d['rank']} resumed {got}")
            loss = d["train"]["losses"].get(str(step3))
            if sorted(d["train"]["losses"]) != [str(step3)] or \
                    not abs(loss - l3) <= HYBRID_LOSS_BAR * abs(l3):
                fail(f"rank checkpoint: rank {d['rank']} losses "
                     f"{d['train']['losses']}, the saving world's step "
                     f"{step3} {l3} (bar {HYBRID_LOSS_BAR})")

        # ---- bitwise: what each rank held against the saved members
        members = _members(step_dir(step3), man)
        tasks, want, bound = {}, {}, {}
        for d in save_docs:
            _digest_tasks(d, d["saves"][0]["digests"], man, members, tasks,
                          want, f"saved step {step3}")
        for d in docs:
            bound[d["rank"]] = _digest_tasks(
                d, d["restore"]["digests"], man, members, tasks, want,
                f"restored step {step3}")
        t0 = time.perf_counter()
        # spawned, not forked: this process holds threads and a CUDA context
        with concurrent.futures.ProcessPoolExecutor(
                HASH_WORKERS, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            futs = {p: pool.submit(_sha256_ranges, p, rs)
                    for p, rs in tasks.items()}
            hashed = {p: f.result() for p, f in futs.items()}
        hash_s = time.perf_counter() - t0
        checked = {}
        for p in tasks:
            for w, h in zip(want[p], hashed[p]):
                n, bad = checked.setdefault(w[0], [0, []])
                checked[w[0]][0] = n + 1
                if w[5] != h:
                    bad.append(w[1:5])
        for what, (n, bad) in checked.items():
            if bad:
                fail(f"rank checkpoint: {what}: {len(bad)} of {n} blocks "
                     f"and edge leaves differ from the saved bytes: "
                     f"{bad[:8]}")
        checked_bytes = sum(x[1] for rs in tasks.values() for x in rs)

        # ---- bytes read, hashing once, launches
        for d in docs:
            if d["restore"]["bytes_read"] > bound[d["rank"]]:
                fail(f"rank checkpoint: rank {d['rank']} read "
                     f"{d['restore']['bytes_read']} bytes, more than its "
                     f"blocks and edge leaves, {bound[d['rank']]}")
        hashed_by_ranks = sum(d["restore"]["hashed_bytes"] for d in docs)
        if hashed_by_ranks != total:
            fail(f"rank checkpoint: the ranks hashed {hashed_by_ranks} "
                 f"bytes, the shards hold {total}")
        launched = {k: sum(d["launches"][k] for d in docs)
                    for k in docs[0]["launches"]}
        for k in ("flash_attention", "skip_concat_matmul"):
            if not launched[k]:
                fail(f"rank checkpoint: {k} never launched in the resumed "
                     f"ranks ({launched})")
        peaks = {d["rank"]: d["train"]["peak_bytes"] for d in docs}
        out = dict(card=smi_line, bytes=total, shard_bytes=shard_bytes,
                   leaves=man["num_leaves"],
                   saves={d["rank"]: _saves(d)[0] for d in save_docs},
                   l3=l3, resume_wall_s=wall, resume_argv=RANK_CKPT_RESUME,
                   restores={d["rank"]: {k: v for k, v in
                                          d["restore"].items()
                                          if k != "digests"} for d in docs},
                   bytes_bound=bound, losses={d["rank"]: d["train"][
                       "losses"][str(step3)] for d in docs},
                   checked={k: n for k, (n, _) in checked.items()},
                   checked_bytes=checked_bytes, parent_hash_s=hash_s,
                   launches=launched, peaks=peaks)
        rec["rank checkpoint"] = out
        log(f"[rank-ckpt] resume as {RANKS_D} ranks P={RANKS_D} dp=1 "
            f"ZeRO-0: elastic (fingerprint "
            f"{docs[0]['resumed']['saved_fingerprint']} -> "
            f"{docs[0]['resumed']['fingerprint']}); torchrun "
            f"{wall:.1f} s; step {step3} loss "
            f"{docs[0]['train']['losses'][str(step3)]!r} "
            f"(the saving world's {l3!r})")
        for d in docs:
            x = d["restore"]
            log(f"[rank-ckpt] restore rank {d['rank']}: {x['total_s']:.2f} s "
                f"(verify {x['verify_s']:.2f} s hashing {x['hashed_bytes']} "
                f"bytes, read {x['read_s']:.2f} s); read {x['bytes_read']} "
                f"bytes (its blocks and edge leaves: {bound[d['rank']]}); "
                f"peak {d['train']['peak_bytes'] / 1e9:.3f} GB")
        log(f"[rank-ckpt] bitwise the saved members, blocks and edge "
            f"leaves: {out['checked']}, {checked_bytes} bytes (hashed "
            f"here in {hash_s:.1f} s by {HASH_WORKERS} processes); launches "
            f"{launched}; phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
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
    linear_parity(torch, rec)
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
            # 6b. PULSE against the skip-carry baseline at UViT-H's width
            left = release(torch)
            if left >= 1e9:
                fail(f"baseline: {left / 1e9:.2f} GB still allocated; the "
                     "previous phase was not released")
            counts["baseline"] = baseline_phase(torch, rec)
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

    # 12. ranks: one process per pipeline device, four on the one card
    left = release(torch)
    if left >= 1e9:
        fail(f"ranks: {left / 1e9:.2f} GB still allocated; the previous "
             "phase was not released")
    t0 = time.perf_counter()
    counts["ranks"] = ranks_phase(torch, rec, smi_line)
    rec["phase_s"]["ranks"] = time.perf_counter() - t0

    # 13. hybrid: the tuner's N=4 plan, two data replicas, ZeRO-1 and 2
    left = release(torch)
    if left >= 1e9:
        fail(f"hybrid: {left / 1e9:.2f} GB still allocated; the previous "
             "phase was not released")
    import shutil
    ckdir = os.path.join(ROOT, "build", "chip_smoke_rank_ckpt_dir")
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        hybrid_counts, save_docs = hybrid_phase(torch, rec, smi_line, ckdir)
        counts.update(hybrid_counts)
        rec["phase_s"]["hybrid"] = time.perf_counter() - t0

        # 14. checkpoints over ranks: the ZeRO-2 world's save, resumed
        # elastically as four pipeline ranks
        t0 = time.perf_counter()
        counts["rank checkpoint"] = rank_checkpoint_phase(
            torch, rec, smi_line, ckdir, save_docs)
        rec["phase_s"]["rank checkpoint"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # 15. results: each kernel's numbers at the Hunyuan-DiT train step's
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
