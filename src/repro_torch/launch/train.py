"""Pipelined diffusion training driver (the port of ``repro.launch.train``,
``--pipeline`` path): graph -> skip-aware partition -> validated schedule ->
table-driven wave executor -> DDPM loss -> AdamW, step after step.

All ``--devices`` pipeline devices run in this one process on one card (or
on the CPU with ``--device cpu``), as the JAX package runs them as
host-simulated devices.  The kernels are always on: the decoder skip-in
goes through the fused skip-concat matmul and self-attention through
flash attention (on the CPU, through the kernels' plain versions).

Archs: ``uvit-pp`` (alias ``uvit``) and ``uvit-nano``, the JAX driver's
small pipeline configs, and ``uvit-h``, the paper's UViT-2.7B at full
width and depth (``configs/uvit_h.py``) in bf16; ``hunyuan-pp``, the small
Hunyuan-DiT of the JAX package's ``wave-hunyuan`` differential, and
``hunyuan-dit``, Hunyuan-DiT-3B at full width and depth
(``configs/hunyuan_dit.py``) in bf16, whose blocks also take cross-attention
through the flash kernel and adaLN conditioning.

Not ported yet, and refused with ``NotImplementedError``: checkpoints and
resume, fault plans, heartbeats and multi-host workers, data parallelism
and ZeRO (``--dp``/``--zero-stage``), and the non-pipeline smoke archs.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch uvit-h \
        --pipeline --devices 4 --microbatches 8 --global-batch 16 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch hunyuan-dit \
        --pipeline --devices 4 --microbatches 8 --global-batch 16 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch uvit-pp \
        --pipeline --devices 2 --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any

ARCHS = ("uvit", "uvit-pp", "uvit-nano", "uvit-h", "hunyuan-pp",
         "hunyuan-dit")


# flags of the JAX driver whose features are not ported yet: any value but
# the default is refused (the non-pipeline path is refused separately)
UNPORTED = {"ckpt_dir": "checkpoints", "ckpt_every": "checkpoints",
            "keep": "checkpoints", "resume": "checkpoints and resume",
            "faults": "fault plans", "simulate_failure": "fault plans",
            "nan_skip_budget": "the GradGuard skip budget",
            "escalation": "the GradGuard escalation",
            "host_id": "multi-host workers", "num_hosts": "multi-host workers",
            "heartbeat_dir": "heartbeats", "gen": "heartbeats",
            "commit_timeout": "multi-host checkpoint commits",
            "dp": "data parallelism", "zero_stage": "ZeRO"}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="uvit", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="wave pipeline over --devices pipeline devices")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree (only 1 is ported)")
    ap.add_argument("--pp", type=int, default=None,
                    help="pipeline degree (default: --devices)")
    ap.add_argument("--zero-stage", type=int, default=0, choices=(0, 1, 2))
    ap.add_argument("--interleave", type=int, default=None,
                    help="virtual stage slots per device (V)")
    ap.add_argument("--wire-dtype", default="bfloat16",
                    help="boundary-hop dtype; float32 = exact wire")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--faults", default=None)
    ap.add_argument("--nan-skip-budget", type=int, default=3)
    ap.add_argument("--escalation", default="abort",
                    choices=("abort", "rollback"))
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--heartbeat-dir", default=None)
    ap.add_argument("--gen", type=int, default=0)
    ap.add_argument("--commit-timeout", type=float, default=60.0)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--out-json", default=None,
                    help="write the step->loss trajectory and step times "
                         "here on exit")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pipeline runs (no silent CPU fallback)")
    ap.add_argument("--profile", default=None,
                    help="trace every step after the first with "
                         "torch.profiler and write device time by kernel, "
                         "busy and idle share here (JSON)")
    return ap


def _parse_args(argv=None):
    return _parser().parse_args(argv)


def _profile_summary(prof, wall_s: float, steps: int, device) -> dict:
    """Device time by kernel name over the traced steps, and the share of
    their wall time the device sat idle (busy = the sum of kernel times,
    which counts overlapping kernels twice, so idle is a lower bound; the
    trace's own overhead stretches the wall time, so idle is read against
    untraced step times too).  A CPU run has no device: it records only
    its wall time."""
    from torch.autograd import DeviceType
    if device.type != "cuda":
        return {"device": "cpu", "steps": steps, "wall_s": wall_s}
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue                # host-side op rows repeat kernel time
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": ev.key, "device_ms": dev_us / 1e3,
                         "calls": ev.count})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_s = sum(r["device_ms"] for r in rows) / 1e3
    return {"device": str(device), "steps": steps, "wall_s": wall_s,
            "device_busy_s": busy_s,
            "idle_share": (1.0 - busy_s / wall_s) if wall_s else None,
            "kernels": rows[:40]}


@dataclasses.dataclass
class TrainResult:
    """What one driver invocation did."""
    final_loss: float | None
    losses: dict                    # step -> float
    step_seconds: dict              # step -> wall seconds (device synced)
    plan: str                       # CompiledPipeline.describe()
    skipped_steps: int = 0          # non-finite updates skipped
    peak_bytes: int | None = None   # torch.cuda.max_memory_allocated
    compiled: Any = None
    params: Any = None              # (stage stacks, edge) after training


def main(argv=None):
    return run(_parse_args(argv)).final_loss


def _refuse_unported(args) -> None:
    if not args.pipeline:
        raise NotImplementedError("the non-pipeline smoke-arch path is not "
                                  "yet ported to repro_torch (pass "
                                  "--pipeline)")
    ap = _parser()
    for dest, what in UNPORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(f"{what} ({flag}) is not yet ported "
                                      "to repro_torch")


def _kind(args) -> str:
    return "hunyuan" if args.arch.startswith("hunyuan") else "uvit"


def _model_config(args):
    from repro_torch.models.diffusion import HunyuanDiTConfig, UViTConfig
    if args.arch == "hunyuan-dit":
        from repro_torch.configs.hunyuan_dit import CFG
        cfg = CFG
    elif args.arch == "hunyuan-pp":
        cfg = HunyuanDiTConfig("hunyuan-pp", img_size=8, in_ch=4, patch=2,
                               d_model=32, n_layers=8, n_heads=4, d_ff=64,
                               ctx_dim=16, ctx_len=4)
    elif args.arch == "uvit-h":
        from repro_torch.configs.uvit_h import CFG
        cfg = CFG
    elif args.arch == "uvit-nano":
        cfg = UViTConfig("uvit-nano", img_size=8, in_ch=4, patch=4,
                         d_model=32, n_layers=8, n_heads=2, d_ff=64,
                         n_classes=10)
    else:
        cfg = UViTConfig("uvit-pp", img_size=8, in_ch=4, patch=2,
                         d_model=64, n_layers=8, n_heads=4, d_ff=128,
                         n_classes=10)
    return dataclasses.replace(cfg, use_skip_kernel=True, use_flash=True)


def build_trainer(args):
    """(compiled, params, opt_state, loss_fn, loader, device) for ``args``."""
    import torch

    from repro_torch.core.hw import H100_SXM
    from repro_torch.data import ShardedLoader, SyntheticLatentDataset
    from repro_torch.models.diffusion import (hunyuan_pipeline_graph,
                                              uvit_pipeline_graph)
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.adapters import diffusion_model_fns
    from repro_torch.runtime.compile import auto_pipeline
    from repro_torch.tree import tree_leaves

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; "
                           "pass --device cpu to train on the CPU")
    device = torch.device(args.device)
    cfg = _model_config(args)
    P = args.pp or args.devices
    M = args.microbatches
    if args.global_batch % M:
        raise ValueError(f"--global-batch {args.global_batch} does not split "
                         f"into {M} microbatches")
    kind = _kind(args)
    graph_fn = (hunyuan_pipeline_graph if kind == "hunyuan"
                else uvit_pipeline_graph)
    graph = graph_fn(cfg, batch=args.global_batch // M, hw=H100_SXM)
    compiled = auto_pipeline(graph, diffusion_model_fns(cfg, kind), P,
                             hw=H100_SXM, pipeline_devices=P, microbatches=M,
                             interleave=args.interleave,
                             wire_dtype=args.wire_dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        stacks, edge = compiled.init_pipeline_params(gen, device)
    params = (stacks, edge)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt_state = adamw_init(params)
    fn = compiled.build()

    def loss_fn(params, mb, aux):
        (enc, dec), edge = params
        return fn(enc, dec, edge, mb, aux)

    text = (dict(text_dim=cfg.ctx_dim, text_len=cfg.ctx_len)
            if kind == "hunyuan" else {})
    ds = SyntheticLatentDataset(img_size=cfg.img_size, channels=cfg.in_ch,
                                n_classes=10, **text)
    loader = ShardedLoader(ds, global_batch=args.global_batch)
    return compiled, params, opt_state, loss_fn, loader, device


def run(args) -> TrainResult:
    _refuse_unported(args)
    import torch

    from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
    from repro_torch.runtime.adapters import make_diffusion_microbatches
    from repro_torch.tree import tree_leaves, tree_map

    compiled, params, opt_state, loss_fn, loader, device = \
        build_trainer(args)
    kind = _kind(args)
    cfg = _model_config(args)
    plan = compiled.describe()
    print("[train] " + plan.replace("\n", "\n[train] "), flush=True)
    opt_cfg = AdamWConfig(lr=args.lr)
    M = compiled.pcfg.num_microbatches
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    losses: dict[int, float] = {}
    step_s: dict[int, float] = {}
    skipped = 0
    prof = None
    t0 = time.perf_counter()
    for step in range(args.steps):
        if args.profile and step == 1:
            from torch.profiler import ProfilerActivity, profile
            # device kernels only on a card (host op events would slow
            # the step they measure); host ops on the CPU
            prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                       else ProfilerActivity.CPU])
            prof.__enter__()
        t_step = time.perf_counter()
        raw = loader.get(step)
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in raw.items()}
        gen = torch.Generator(device=device).manual_seed(step)
        # Hunyuan's temb comes from the current edge params (time_mlp)
        mb, aux = make_diffusion_microbatches(batch, M, cfg, kind,
                                              generator=gen,
                                              params=params[1])
        loss = loss_fn(params, mb, aux)
        loss.backward()
        # a leaf the step never reads (Hunyuan's time_mlp, whose temb
        # enters as data, and the xattn wk/wv cross-attention ignores) has
        # no grad: a zero gradient, as jax.grad gives it
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
        lr = cosine_schedule(step, base_lr=args.lr, warmup=20,
                             total=args.steps)
        if finite:
            adamw_update(params, grads, opt_state, opt_cfg, lr=lr)
        else:
            skipped += 1            # the JAX step's all_finite gate
        for p in tree_leaves(params):
            p.grad = None
        if cuda:
            torch.cuda.synchronize(device)
        step_s[step] = time.perf_counter() - t_step
        losses[step] = float(loss.detach())
        if step % args.log_every == 0 or step == args.steps - 1:
            sps = (step + 1) * args.global_batch / (time.perf_counter() - t0)
            print(f"[train] step {step:5d} loss {losses[step]:.4f} "
                  f"lr {lr:.2e} step {step_s[step]:.3f}s "
                  f"({sps:.2f} samples/s)", flush=True)
    if prof is not None:
        prof.__exit__(None, None, None)
        traced = [step_s[s] for s in range(1, args.steps)]
        with open(args.profile, "w") as f:
            json.dump(_profile_summary(prof, sum(traced), len(traced),
                                       device), f, indent=1)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    final = losses[args.steps - 1] if args.steps else None
    if final is not None:
        print(f"[train] done: final loss {final:.4f}"
              + (f", peak device memory {peak / 1e9:.2f} GB" if cuda else ""),
              flush=True)
    res = TrainResult(final_loss=final, losses=losses, step_seconds=step_s,
                      plan=plan, skipped_steps=skipped, peak_bytes=peak,
                      compiled=compiled, params=params)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"final_loss": final,
                       "losses": {str(k): v for k, v in losses.items()},
                       "step_seconds": {str(k): v
                                        for k, v in step_s.items()},
                       "skipped_steps": skipped, "peak_bytes": peak}, f)
    return res


if __name__ == "__main__":
    main()
