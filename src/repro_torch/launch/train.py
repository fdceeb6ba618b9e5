"""Diffusion trainer (the port of ``repro.launch.train``): AdamW
step after step, on the wave pipeline (``--pipeline``) or on the whole
model at once.

``--pipeline``: graph -> skip-aware partition -> validated schedule ->
table-driven wave executor -> DDPM loss.  All ``--devices`` pipeline
devices run in this one process on one card (or on the CPU with
``--device cpu``), as the JAX package runs them as host-simulated
devices.  Archs: ``uvit-pp`` (alias ``uvit``) and ``uvit-nano``, the JAX
trainer's small pipeline configs, and ``uvit-h``, the paper's UViT-2.7B at
full width and depth (``configs/uvit_h.py``) in bf16; ``hunyuan-pp``, the
small Hunyuan-DiT of the JAX package's ``wave-hunyuan`` differential, and
``hunyuan-dit``, Hunyuan-DiT-3B at full width and depth
(``configs/hunyuan_dit.py``) in bf16, whose blocks also take
cross-attention through the flash kernel and adaLN conditioning.

Without ``--pipeline`` (the JAX trainer's ``_build_smoke_trainer``): one
value-and-grad of the whole model's loss per step, the GradGuard's finite
check, the grad norm, AdamW.  Archs: the JAX smoke configs of the three
diffusion models (``uvit-h`` (alias ``uvit``), ``hunyuan-dit``,
``sdv2-unet``: ``configs/smoke.py``), so the two trainers can be held to
each other, and ``sdv2-unet-full``, the SDv2 UNet at full width
(``configs/sdv2_unet.py``, 1.84e9 params) in bf16.  The LM smoke keys of
the JAX trainer are refused: not ported yet.

The kernels are always on: the decoder skip-in of UViT and Hunyuan-DiT
goes through the fused skip-concat matmul and every attention through
flash attention (on the CPU, through the kernels' plain versions).

Fault-tolerance contract, the JAX trainer's single-host one:

- ``--ckpt-dir D --ckpt-every N --keep K`` saves every N steps
  asynchronously (a host copy of params and AdamW state, then a background
  write of a verified checkpoint in the JAX package's format) and once
  more at the end, keeping the K newest verified steps;
- ``--resume`` restores the newest *verified* step (a corrupt or partial
  one is skipped, and said so) into the live tensors, in place, and
  the step-indexed data and noise make the continuation exact; on the
  pipeline path, when the manifest's plan fingerprint differs (another
  ``--devices``/``--pp``/``--interleave``), the saved stage stacks are
  de-stacked through the saved plan's spec and re-stacked onto this one
  (``runtime.resilience``);
- ``--faults`` (else ``$REPRO_FAULTS``): ``kill@K`` exits 42 after step K,
  ``stop@K`` returns after step K without a final save, ``nan@K``
  poisons step K's batch, ``corrupt@K[:shard]``/``truncate@K[:shard]``
  damage the newest checkpoint, ``iofail@K:N`` fails the next N save
  attempts (retries, then a warning), and the one-host forms of the
  multi-host verbs (``hostdown@K:0``, ``hang@K``, ``slow@K:factor``) run
  too; ``--simulate-failure K`` is ``kill@K``;
- the GradGuard skips non-finite updates; more than
  ``--nan-skip-budget`` in a row abort, or with ``--escalation rollback``
  exit 43 for a supervisor to roll back;
- ``--heartbeat-dir D`` writes a heartbeat per step (``--gen`` tags it).

Not ported yet, and refused with ``NotImplementedError``: multi-host
workers (``--host-id``/``--num-hosts``/``--commit-timeout``), data
parallelism and ZeRO (``--dp``/``--zero-stage``), and the LM smoke archs.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch uvit-h \
        --pipeline --devices 4 --microbatches 8 --global-batch 16 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch hunyuan-dit \
        --pipeline --devices 4 --microbatches 8 --global-batch 16 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch sdv2-unet-full \
        --global-batch 16 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch uvit-pp \
        --pipeline --devices 2 --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch sdv2-unet \
        --global-batch 4 --steps 5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch uvit-pp \
        --pipeline --devices 4 --steps 6 --device cpu --ckpt-dir /tmp/ck \
        --ckpt-every 3 --faults stop@3          # then add --resume
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Callable

PIPELINE_ARCHS = ("uvit", "uvit-pp", "uvit-nano", "uvit-h", "hunyuan-pp",
                  "hunyuan-dit")
# without --pipeline: the JAX trainer's diffusion smoke keys ("uvit" is its
# alias of "uvit-h") and the UNet at full width
SMOKE_ARCHS = ("uvit", "uvit-h", "hunyuan-dit", "sdv2-unet", "sdv2-unet-full")
# the JAX trainer's other smoke keys, refused until their models are ported
LM_SMOKE_ARCHS = ("smollm-360m", "h2o-danube-1.8b", "internlm2-20b",
                  "granite-34b", "whisper-base", "xlstm-125m", "internvl2-2b",
                  "qwen3-moe-30b-a3b", "deepseek-v3-671b", "zamba2-2.7b")
ARCHS = tuple(dict.fromkeys(PIPELINE_ARCHS + SMOKE_ARCHS + LM_SMOKE_ARCHS))


# flags of the JAX trainer whose features are not ported yet: any value but
# the default is refused (the LM smoke archs are refused separately)
UNPORTED = {"host_id": "multi-host workers", "num_hosts": "multi-host workers",
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
    ap.add_argument("--keep", type=int, default=3,
                    help="checkpoint retention (verified-complete steps)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest verified step of --ckpt-dir "
                         "(elastically when the plan changed)")
    ap.add_argument("--pipeline", action="store_true",
                    help="wave pipeline over --devices pipeline devices "
                         "(else the whole model in one step)")
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
    ap.add_argument("--faults", default=None,
                    help="fault plan, e.g. 'stop@6,nan@2,corrupt@4,"
                         "iofail@2:2' (default: $REPRO_FAULTS)")
    ap.add_argument("--nan-skip-budget", type=int, default=3,
                    help="max consecutive non-finite steps before the "
                         "escalation policy fires")
    ap.add_argument("--escalation", default="abort",
                    choices=("abort", "rollback"),
                    help="exhausted GradGuard budget: 'abort' raises; "
                         "'rollback' exits 43 for a supervisor to roll "
                         "back to the last verified checkpoint")
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--heartbeat-dir", default=None,
                    help="write a heartbeat per step here")
    ap.add_argument("--gen", type=int, default=0,
                    help="supervisor generation stamped into heartbeats")
    ap.add_argument("--commit-timeout", type=float, default=60.0)
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="legacy alias for --faults kill@K")
    ap.add_argument("--out-json", default=None,
                    help="write the step->loss trajectory and step times "
                         "here on exit")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (no silent CPU fallback)")
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
            "kernels": rows}


@dataclasses.dataclass
class TrainResult:
    """What one trainer run did."""
    final_loss: float | None
    losses: dict                    # step -> float
    step_seconds: dict              # step -> wall seconds (device synced)
    plan: str                       # the plan's text (Trainer.plan)
    start: int = 0                  # first step this invocation ran
    resumed: Any = None             # RestoreInfo | None
    skipped_steps: int = 0          # non-finite updates the guard skipped
    peak_bytes: int | None = None   # torch.cuda.max_memory_allocated
    compiled: Any = None            # CompiledPipeline (pipeline path)
    params: Any = None              # Trainer.params after training
    opt_state: Any = None           # AdamW state after training
    logical_params: Any = None      # model-space params (merge_params), CPU
    saves: list = dataclasses.field(default_factory=list)  # manager history
    restore: dict | None = None     # seconds and peak memory of the resume


def _dump_losses(path: str, losses: dict, start: int) -> None:
    doc = {"losses": {str(k): v for k, v in losses.items()},
           "start": start, "partial": True}
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def main(argv=None):
    return run(_parse_args(argv)).final_loss


def _refuse_unported(args) -> None:
    if args.arch in LM_SMOKE_ARCHS:
        raise NotImplementedError(f"the LM smoke arch {args.arch!r} is not "
                                  "yet ported to repro_torch")
    if args.pipeline and args.arch not in PIPELINE_ARCHS:
        raise ValueError(f"--arch {args.arch} has no pipeline path; the "
                         "pipeline archs are " + ", ".join(PIPELINE_ARCHS))
    if not args.pipeline and args.arch not in SMOKE_ARCHS:
        raise ValueError(f"--arch {args.arch} trains only with --pipeline")
    ap = _parser()
    for dest, what in UNPORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(f"{what} ({flag}) is not yet ported "
                                      "to repro_torch")


def _kind(args) -> str:
    return "hunyuan" if args.arch.startswith("hunyuan") else "uvit"


def _model_config(args):
    """The pipeline path's model config of ``args``, kernels on."""
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


def _smoke_bundle(args):
    """The non-pipeline path's ``(loss_fn, init_fn, make_batch, cfg)`` of
    ``args``, kernels on: a JAX smoke config's (``configs/smoke.py``), or
    the full-width UNet's (``configs/sdv2_unet.py``)."""
    if args.arch == "sdv2-unet-full":
        from repro_torch.configs.sdv2_unet import factory
    else:
        from repro_torch.configs.smoke import SMOKE_FACTORIES
        factory = SMOKE_FACTORIES[{"uvit": "uvit-h"}.get(args.arch,
                                                         args.arch)]
    return factory(kernels=True)


@dataclasses.dataclass
class Trainer:
    """What a step needs, on either path: ``params`` is the tree AdamW
    updates and checkpoints save (``(stage stacks, edge)`` on the pipeline
    path, the model's own tree without it), ``loss(params, batch, t,
    noise)`` the step's DDPM loss from given draws, ``logical(params)`` the
    model-space tree, ``plan`` the plan's text."""
    params: Any
    opt_state: Any
    loss: Callable
    logical: Callable
    split: Callable                 # model-space tree -> ``params``' form
    loader: Any
    device: Any
    plan: str
    compiled: Any = None            # CompiledPipeline (pipeline path)


def _device(args):
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; "
                           "pass --device cpu to train on the CPU")
    return torch.device(args.device)


def _with_grads(params):
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return params, adamw_init(params)


def build_trainer(args) -> Trainer:
    """The pipeline path's :class:`Trainer` for ``args``."""
    import torch

    from repro_torch.core.hw import H100_SXM
    from repro_torch.data import ShardedLoader, SyntheticLatentDataset
    from repro_torch.models.diffusion import (hunyuan_pipeline_graph,
                                              uvit_pipeline_graph)
    from repro_torch.runtime.adapters import (diffusion_model_fns,
                                              make_diffusion_microbatches)
    from repro_torch.runtime.compile import auto_pipeline

    device = _device(args)
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
        params = compiled.init_pipeline_params(gen, device)
    params, opt_state = _with_grads(params)
    fn = compiled.build()

    def loss(params, batch, t, noise):
        # Hunyuan's temb comes from the current edge params (time_mlp)
        mb, aux = make_diffusion_microbatches(batch, M, cfg, kind, t=t,
                                              noise=noise, params=params[1])
        (enc, dec), edge = params
        return fn(enc, dec, edge, mb, aux)

    text = (dict(text_dim=cfg.ctx_dim, text_len=cfg.ctx_len)
            if kind == "hunyuan" else {})
    ds = SyntheticLatentDataset(img_size=cfg.img_size, channels=cfg.in_ch,
                                n_classes=10, **text)
    return Trainer(params, opt_state, loss,
                   lambda p: compiled.merge_params(*p), compiled.split_params,
                   ShardedLoader(ds, global_batch=args.global_batch), device,
                   compiled.describe(), compiled)


def build_smoke_trainer(args) -> Trainer:
    """The non-pipeline path's :class:`Trainer` (the JAX trainer's
    ``_build_smoke_trainer``): the model's params from seed 0, the
    synthetic dataset at the config's batch shapes."""
    import torch

    from repro_torch.data import ShardedLoader, SyntheticLatentDataset
    from repro_torch.tree import tree_leaves

    device = _device(args)
    loss_fn, init_fn, make_batch, cfg = _smoke_bundle(args)
    # the batch's keys and shapes, read from a prototype batch (a small
    # one), as the JAX trainer reads them
    proto = {k: tuple(v.shape) for k, v in
             make_batch(torch.Generator().manual_seed(0), "cpu").items()}
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        params = init_fn(gen, device)
    params, opt_state = _with_grads(params)
    text = proto.get("text_embeds")
    ds = SyntheticLatentDataset(img_size=proto["latents"][1],
                                channels=proto["latents"][-1], n_classes=10,
                                text_dim=text[-1] if text else 0,
                                text_len=text[1] if text else 77)
    n = sum(x.numel() for x in tree_leaves(params))
    plan = (f"non-pipeline: {cfg.name}, {n} params "
            f"({str(cfg.param_dtype).replace('torch.', '')}), flash "
            f"attention" + (", skip-in kernel" if getattr(
                cfg, "use_skip_kernel", False) else ""))

    def loss(params, batch, t, noise):
        return loss_fn(params, {k: v for k, v in batch.items()
                                if k in proto}, t, noise)

    return Trainer(params, opt_state, loss, lambda p: p, lambda p: p,
                   ShardedLoader(ds, global_batch=args.global_batch), device,
                   plan)


def _resume(args, compiled, state: dict, device) -> tuple[Any, dict]:
    """Restore the newest verified step of ``--ckpt-dir`` into the live
    tensors of ``state``, in place (they stay the leaves AdamW updates);
    ``(None, None)`` when no step verifies.  Returns the RestoreInfo and
    the resume's seconds (verifying, reading and placing, with the
    elastic re-stack; copying into place) and its peak device memory.
    On the non-pipeline path (``compiled`` None) the checkpoint holds the
    model's own tree and restores as it is (``restore_checkpoint``,
    ``strict=False``).

    The JAX trainer asks ``latest_step`` first, which hashes every kept
    step, and then restores, which hashes the chosen one again.  Here the
    restore walks back from the newest step itself, and ``latest_step``
    runs only when it fails, to tell "nothing verifies" (start afresh, as
    the JAX trainer does) from a verified step that does not load (raise):
    the same outcomes, one hash pass fewer."""
    import torch

    from repro_torch.checkpoint import (CheckpointError, latest_step,
                                        restore_checkpoint)
    from repro_torch.runtime.resilience import (RestoreInfo,
                                                restore_training_state)
    from repro_torch.tree import tree_flatten

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        if compiled is not None:
            restored, info = restore_training_state(args.ckpt_dir, compiled,
                                                    state, strict=False)
        else:
            restored, step = restore_checkpoint(args.ckpt_dir, state,
                                                strict=False)
            info = RestoreInfo(step, False, None, None)
    except CheckpointError:
        if latest_step(args.ckpt_dir) is None:
            return None, None
        raise
    new = tree_flatten(restored)[0]
    del restored
    if cuda:
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    with torch.no_grad():
        for i, dst in enumerate(tree_flatten(state)[0]):
            src = new[i]
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"checkpoint leaf {i} is {src.dtype}{list(src.shape)}, "
                    f"the model's {dst.dtype}{list(dst.shape)}")
            dst.copy_(src)
            new[i] = None
    if cuda:
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    return info, {"restore_s": t1 - t0, "copy_s": t2 - t1,
                  "total_s": t2 - t0,
                  "peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else None)}


def run(args, on_restore=None, init_params=None, draw=None) -> TrainResult:
    """Train ``args.steps`` steps (from the restored step with
    ``--resume``).  ``on_restore(state, info)``, when given, is called once
    a resume has restored ``{"params", "opt"}`` in place, before the first
    step.

    ``init_params`` (a model-space tree of numpy arrays, as
    ``jax.device_get`` gives it, in any dict order) replaces the seed-0
    params; ``draw(step)`` returns the step's DDPM ``(t, noise)`` in place
    of the per-step generator's.  With both, another trainer's params and
    draws (the JAX trainer's ``fold_in(PRNGKey(0), step)``) go through this
    one."""
    _refuse_unported(args)
    from repro_torch.runtime.resilience import (EXIT_ESCALATE, FaultPlan,
                                                GradGuard,
                                                GradGuardEscalation,
                                                Heartbeat, all_finite,
                                                write_heartbeat)

    faults = FaultPlan.parse(args.faults)
    if args.simulate_failure:
        faults = faults.with_kill(args.simulate_failure)
    # malformed specs die here, not mid-training
    faults = faults.for_host(args.host_id, args.num_hosts)

    def beat(step, phase, loss=None, gnorm=None, step_s=None):
        if args.heartbeat_dir:
            write_heartbeat(args.heartbeat_dir, Heartbeat(
                args.host_id, step, phase, loss=loss, grad_norm=gnorm,
                step_s=step_s, gen=args.gen))

    beat(-1, "init")
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.diffusion import ddpm_draw
    from repro_torch.optim import (AdamWConfig, adamw_update,
                                   cosine_schedule, global_norm)
    from repro_torch.tree import tree_leaves, tree_map

    tr = (build_trainer if args.pipeline else build_smoke_trainer)(args)
    params, opt_state, compiled, device = (tr.params, tr.opt_state,
                                           tr.compiled, tr.device)
    if init_params is not None:
        from repro_torch.convert import params_from_jax
        src = tr.split(params_from_jax(init_params, device))
        with torch.no_grad():
            tree_map(lambda dst, x: dst.copy_(x), params, src)
        del src
    plan = tr.plan
    print("[train] " + plan.replace("\n", "\n[train] "), flush=True)
    opt_cfg = AdamWConfig(lr=args.lr)
    cuda = device.type == "cuda"
    mgr = CheckpointManager(
        args.ckpt_dir, keep=args.keep,
        plan=compiled.state_spec() if compiled is not None else None,
        io_fault=faults.io_fault) if args.ckpt_dir else None

    start, resumed, restore = 0, None, None
    if args.resume and args.ckpt_dir:
        state = {"params": params, "opt": opt_state}
        resumed, restore = _resume(args, compiled, state, device)
        if resumed is not None:
            start = resumed.step
            print(f"[train] resumed from step {start}"
                  + (" (elastic restore: plan changed)" if resumed.elastic
                     else "")
                  + f" in {restore['total_s']:.2f} s", flush=True)
            if on_restore is not None:
                on_restore(state, resumed)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    guard = GradGuard(budget=args.nan_skip_budget)
    losses: dict[int, float] = {}
    step_s: dict[int, float] = {}
    prof = None

    def finish(loss) -> TrainResult:
        beat(args.steps, "done")
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        final = None if loss is None else float(loss.detach())
        with torch.no_grad():
            logical = tree_map(lambda x: x.detach().cpu(), tr.logical(params))
        res = TrainResult(
            final_loss=final, losses=losses, step_seconds=step_s, plan=plan,
            start=start, resumed=resumed, skipped_steps=guard.skipped_total,
            peak_bytes=peak, compiled=compiled, params=params,
            opt_state=opt_state, logical_params=logical,
            saves=mgr.history if mgr else [], restore=restore)
        if args.out_json:
            with open(args.out_json, "w") as f:
                json.dump({"final_loss": final,
                           "losses": {str(k): v for k, v in losses.items()},
                           "step_seconds": {str(k): v
                                            for k, v in step_s.items()},
                           "start": start,
                           "resumed_step": resumed.step if resumed else None,
                           "elastic": bool(resumed.elastic) if resumed
                           else False,
                           "skipped_steps": res.skipped_steps,
                           "peak_bytes": peak}, f)
        return res

    if start >= args.steps:
        print(f"[train] nothing to do: resumed step {start} >= "
              f"--steps {args.steps}")
        return finish(None)

    loss = None
    stopped = False
    last_save = None
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        if faults.hang_before(step):
            print(f"[train] fault plan: woke from hang at step {step}")
        if args.profile and step == start + 1:
            from torch.profiler import ProfilerActivity, profile
            # device kernels only on a card (host op events would slow
            # the step they measure); host ops on the CPU
            prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                       else ProfilerActivity.CPU])
            prof.__enter__()
        t_step = time.perf_counter()
        raw = tr.loader.get(step)
        batch = faults.poison_batch(
            {k: torch.as_tensor(v, device=device) for k, v in raw.items()},
            step)
        if draw is None:
            t, noise = ddpm_draw(batch["latents"], step)
        else:
            t, noise = (torch.as_tensor(x, device=device) for x in draw(step))
        loss = tr.loss(params, batch, t, noise)
        loss.backward()
        # a leaf the step never reads (the xattn wk/wv cross-attention
        # ignores, and on the pipeline path Hunyuan's time_mlp, whose temb
        # enters as data) has no grad: a zero gradient, as jax.grad gives it
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        finite = bool(all_finite(loss, grads))
        gnorm = float(global_norm(grads)) if args.heartbeat_dir else None
        lr = cosine_schedule(step, base_lr=args.lr, warmup=20,
                             total=args.steps)
        if finite:
            adamw_update(params, grads, opt_state, opt_cfg, lr=lr)
        for p in tree_leaves(params):
            p.grad = None
        del grads
        if cuda:
            torch.cuda.synchronize(device)
        step_s[step] = time.perf_counter() - t_step
        try:
            guard.observe(finite, step)     # skipped above when not finite
        except GradGuardEscalation as e:
            if args.escalation == "rollback":
                print(f"[train] {e}; requesting supervisor rollback",
                      flush=True)
                if mgr:
                    mgr.wait()
                beat(step, "done")
                raise SystemExit(EXIT_ESCALATE) from None
            raise
        losses[step] = float(loss.detach())
        if args.out_json:
            # an atomic per-step dump: a killed run still leaves its losses
            _dump_losses(args.out_json, losses, start)
        slow = faults.slow_factor(step)
        if slow > 1.0:     # straggle: stretch this step by the factor
            time.sleep(min((time.perf_counter() - t_step) * (slow - 1.0),
                           5.0))
        beat(step, "train", loss=losses[step], gnorm=gnorm,
             step_s=step_s[step])
        if step % args.log_every == 0 or step == args.steps - 1:
            sps = ((step - start + 1) * args.global_batch
                   / (time.perf_counter() - t0))
            print(f"[train] step {step:5d} loss {losses[step]:.4f} "
                  f"lr {lr:.2e} step {step_s[step]:.3f}s "
                  f"({sps:.2f} samples/s)", flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            beat(step + 1, "ckpt")
            mgr.save_async(step + 1, {"params": params, "opt": opt_state})
            last_save = step + 1
        if faults.post_step(step + 1, ckpt_dir=args.ckpt_dir,
                            flush=mgr.wait if mgr else None) == "stop":
            print(f"[train] fault plan: abrupt stop after step {step} "
                  "(no final save)", flush=True)
            stopped = True
            break
    if prof is not None:
        prof.__exit__(None, None, None)
        traced = [step_s[s] for s in step_s if s > start]
        with open(args.profile, "w") as f:
            json.dump(_profile_summary(prof, sum(traced), len(traced),
                                       device), f, indent=1)
    if mgr and not stopped:
        if last_save != args.steps:       # the last periodic save may be it
            beat(args.steps, "ckpt")
            mgr.save_async(args.steps, {"params": params, "opt": opt_state})
        mgr.wait()
    res = finish(loss)
    if not stopped:
        print(f"[train] done: final loss {res.final_loss:.4f}"
              + (f", peak device memory {res.peak_bytes / 1e9:.2f} GB"
                 if cuda else ""), flush=True)
    return res


if __name__ == "__main__":
    main()
