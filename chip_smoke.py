#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (one process per source, started together), with ``-Xptxas -v``;
3. kernels: each kernel against its plain PyTorch version on the card at
   UViT-H shapes, forward and gradients (fp32 with TF32 off at rtol = atol
   = 1e-4; bf16 at rtol = atol = 2e-2, bf16 rounding in another summation
   order; only the skip matmul's weight gradient, a sum over all M rows,
   takes atol = rtol x max|value|), then timed with CUDA events beside its
   bound, the plain version and a yardstick PyTorch call the port never
   makes;
4. pipeline parity: the port's wave executor at ``uvit-pp`` size (fp32,
   fp32 wire, D=4, M=8, kernels on) on the card against the same step on
   the CPU (plain versions): loss and grads at rtol 1e-3;
5. train: ``repro_torch.launch.train`` with ``--arch uvit-h --pipeline
   --devices 4 --microbatches 8 --global-batch 16 --steps 4`` (UViT-2.7B at
   full width and depth, bf16, bf16 wire) with the launch counts reset just
   before and read just after: every loss finite, both kernels launched;
6. the ``kernels`` JSON line, then the device line as the last line.

The full record goes to ``chiprun_out/chip_smoke.json``.  Without a CUDA
device the script exits 1 at once and prints no result.
"""
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
TRAIN_ARGV = ["--arch", "uvit-h", "--pipeline", "--devices", "4",
              "--microbatches", "8", "--global-batch", "16", "--steps", "4",
              "--log-every", "1", "--device", "cuda"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """Least time in ms: max(operations / peak, bytes / HBM rate)."""
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

def check_skip_matmul(torch, rec) -> dict:
    from repro_torch.kernels.skip_matmul import (skip_concat_matmul,
                                                 skip_concat_matmul_cuda,
                                                 skip_concat_matmul_plain)
    rows, main = [], None
    gen = torch.Generator(device="cuda").manual_seed(0)
    D = N = 2560
    for dtype in ("bfloat16", "float32"):
        for M in (516, 4128):                # b = 2 and b = 16 at 258 tokens
            dt = getattr(torch, dtype)
            h = torch.randn(M, D, device="cuda", generator=gen).to(dt)
            s = torch.randn(M, D, device="cuda", generator=gen).to(dt)
            w = (torch.randn(2 * D, N, device="cuda", generator=gen)
                 / math.sqrt(2 * D)).to(dt)
            what = f"skip_concat_matmul {dtype} M={M}"
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
            ms = time_ms(torch, lambda: skip_concat_matmul_cuda(h, s, w))
            plain_ms = time_ms(torch, lambda: skip_concat_matmul_plain(h, s, w))
            lib_ms = time_ms(torch, lambda: torch.cat([h, s], -1) @ w)
            esz = h.element_size()
            b_ms, b_by = bound(4.0 * M * D * N,
                               esz * (2 * M * D + 2 * D * N + M * N), dtype)
            row = dict(dtype=dtype, M=M, D=D, N=N, max_abs_err=err,
                       grad_max_abs_err=grad_err, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            log(f"[kernels] {what}: max|err| {err:.3e}  grads "
                + " ".join(f"{k} {v:.3e}" for k, v in grad_err.items())
                + f"  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  cat+matmul {lib_ms:.4f} ms  "
                f"bound {b_ms:.4f} ms ({b_by})")
            if dtype == "bfloat16" and M == 516:
                main = row                   # the training step's shape
            del h, s, w, got
    rec["skip_concat_matmul"] = rows
    return main


def check_flash(torch, rec) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention,
                                                     flash_attention_cuda)
    rows, main = [], None
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # B, S, T, Hq, Hkv, D, causal, window, dtype
        (2, 258, 258, 20, 20, 128, False, None, "bfloat16"),   # UViT-H, b=2
        (2, 258, 258, 20, 20, 128, False, None, "float32"),
        (1, 300, 300, 8, 2, 64, True, 96, "bfloat16"),         # causal+win+GQA
        (1, 300, 300, 8, 2, 64, True, 96, "float32"),
    ]
    for B, S, T, Hq, Hkv, D, causal, window, dtype in cases:
        dt = getattr(torch, dtype)
        q = torch.randn(B, S, Hq, D, device="cuda", generator=gen).to(dt)
        k = torch.randn(B, T, Hkv, D, device="cuda", generator=gen).to(dt)
        v = torch.randn(B, T, Hkv, D, device="cuda", generator=gen).to(dt)
        what = (f"flash_attention {dtype} B={B} S={S} T={T} Hq={Hq} "
                f"Hkv={Hkv} D={D} causal={causal} window={window}")
        got = flash_attention_cuda(q, k, v, causal, window)
        torch.cuda.synchronize()
        err = check_close(torch, got, attention_plain(q, k, v, causal, window),
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
        ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, causal,
                                                         window))
        plain_ms = time_ms(torch, lambda: attention_plain(q, k, v, causal,
                                                          window))
        lib_ms = None
        if Hq == Hkv and window is None:
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal))
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
        b_ms, b_by = bound(4.0 * B * Hq * pairs * D,
                           esz * (2 * B * S * Hq * D + 2 * B * T * Hkv * D),
                           dtype)
        row = dict(dtype=dtype, B=B, S=S, T=T, Hq=Hq, Hkv=Hkv, D=D,
                   causal=causal, window=window, max_abs_err=err,
                   grad_max_abs_err=grad_err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a"
        log(f"[kernels] {what}: max|err| {err:.3e}  grads "
            + " ".join(f"{k} {v:.3e}" for k, v in grad_err.items())
            + f"  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  sdpa {lib}  bound {b_ms:.4f} ms "
            f"({b_by})")
        if main is None:
            main = row
        del q, k, v, got
    rec["flash_attention"] = rows
    return main


# ---------------------------------------------------------------------------
# phase 4: pipeline parity, card vs CPU
# ---------------------------------------------------------------------------

def pipeline_parity(torch, rec) -> None:
    import numpy as np

    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.models.diffusion import UViTConfig, uvit_pipeline_graph
    from repro_torch.runtime.adapters import (diffusion_model_fns,
                                              make_diffusion_microbatches)
    from repro_torch.runtime.compile import auto_pipeline
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    cfg = UViTConfig("uvit-pp", img_size=8, in_ch=4, patch=2, d_model=64,
                     n_layers=8, n_heads=4, d_ff=128, n_classes=10,
                     use_skip_kernel=True, use_flash=True)
    D, M, B = 4, 8, 16
    cp = auto_pipeline(uvit_pipeline_graph(cfg, batch=B // M),
                       diffusion_model_fns(cfg), D, pipeline_devices=D,
                       microbatches=M, wire_dtype="float32")
    params = cp.model_fns.init_fn(torch.Generator().manual_seed(0), "cpu")
    raw = SyntheticLatentDataset(img_size=8, channels=4).batch(0, 0, B)
    gen = torch.Generator().manual_seed(1)
    t = torch.rand((B,), generator=gen)
    noise = torch.randn((B, 8, 8, 4), generator=gen)
    fn = cp.build()
    out = {}
    before = dict(_launches())
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.detach().to(dev).clone().requires_grad_(True),
                     cp.split_params(params))
        batch = {"latents": torch.as_tensor(np.asarray(raw["latents"]),
                                            device=dev),
                 "labels": torch.as_tensor(np.asarray(raw["labels"]),
                                           device=dev)}
        mb, aux = make_diffusion_microbatches(batch, M, t=t.to(dev),
                                              noise=noise.to(dev))
        (enc, dec), edge = p
        loss = fn(enc, dec, edge, mb, aux)
        loss.backward()
        grads = cp.merge_params(*tree_map(lambda x: x.grad, p))
        out[dev] = (float(loss.detach()),
                    {k: v.detach().cpu() for k, v in tree_paths(grads)})
    launched = {k: _launches()[k] - before[k] for k in before}
    if not all(launched.values()):
        fail(f"pipeline parity: the card's run launched {launched}; both "
             "kernels must run")
    lc, gc = out["cpu"]
    lg, gg = out["cuda"]
    if not math.isclose(lg, lc, rel_tol=1e-3):
        fail(f"pipeline parity: loss on the card {lg} vs CPU {lc}")
    worst = 0.0
    for k, want in gc.items():
        got = gg[k]
        try:
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)
        except AssertionError as e:
            fail(f"pipeline parity: grad {k} differs:\n{e}")
        worst = max(worst, float((got - want).abs().max()))
    n = len(tree_leaves(gg))
    rec["pipeline_parity"] = dict(loss_cuda=lg, loss_cpu=lc,
                                  max_abs_grad_err=worst, grads=n,
                                  launches=launched,
                                  plan=cp.describe().splitlines()[0])
    log(f"[parity] uvit-pp D={D} M={M} fp32 wire: loss card {lg:.7f} "
        f"cpu {lc:.7f}; {n} grads, max|err| {worst:.3e}; launches "
        f"{launched}")


def _launches() -> dict:
    from repro_torch.kernels import launch_counts
    return launch_counts()


# ---------------------------------------------------------------------------
# phase 5: train UViT-H
# ---------------------------------------------------------------------------

def train(torch, rec) -> dict:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod

    args = train_mod._parse_args(TRAIN_ARGV)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = train_mod.run(args)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = [res.losses[s] for s in sorted(res.losses)]
    if len(losses) != args.steps or not all(math.isfinite(x) for x in losses):
        fail(f"train: losses {losses}")
    if res.skipped_steps:
        fail(f"train: {res.skipped_steps} non-finite updates skipped")
    if not all(counts.values()):
        fail(f"train: kernel launch counts {counts}; every kernel of the "
             "path must run")
    steps = [res.step_seconds[s] for s in sorted(res.step_seconds)]
    steady = steps[1:] or steps
    sps = args.global_batch / (sum(steady) / len(steady))
    n_params = sum(x.numel() for x in _leaves(res.params))
    rec["train"] = dict(argv=TRAIN_ARGV, losses=losses, step_seconds=steps,
                        samples_per_s_after_first=sps,
                        peak_bytes=res.peak_bytes, wall_s=wall,
                        launches=counts,
                        launches_per_step={k: v / args.steps
                                           for k, v in counts.items()},
                        params=n_params, plan=res.plan)
    log(f"[train] uvit-h: {n_params} params; losses {losses}; step s "
        f"{[round(x, 4) for x in steps]}; {sps:.3f} samples/s after step "
        f"0; peak {res.peak_bytes / 1e9:.2f} GB; launches {counts}")
    del res
    return counts


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
    rec["build"] = dict(wall_s=time.perf_counter() - t0,
                        seconds={k: v["seconds"] for k, v in built.items()})
    log(f"[build] {sorted(built)} in {rec['build']['wall_s']:.1f} s "
        f"(nvcc each: {rec['build']['seconds']})")
    for k, v in built.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {k}: {line.strip()}")

    # 3. kernels
    main_rows = {"skip_concat_matmul": check_skip_matmul(torch, rec),
                 "flash_attention": check_flash(torch, rec)}
    torch.cuda.empty_cache()

    # 4. pipeline parity
    pipeline_parity(torch, rec)
    torch.cuda.empty_cache()

    # 5. train
    counts = train(torch, rec)

    # 6. results
    src_of = {"skip_concat_matmul": ("src/repro_torch/kernels/csrc/"
                                     "skip_matmul.cu",
                                     "src/repro/kernels/skip_matmul/"
                                     "kernel.py:40"),
              "flash_attention": ("src/repro_torch/kernels/csrc/"
                                  "flash_attention.cu",
                                  "src/repro/kernels/flash_attention/"
                                  "kernel.py:64")}
    kernels = []
    for kname, row in main_rows.items():
        source, replaces = src_of[kname]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[kname],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    rec["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
