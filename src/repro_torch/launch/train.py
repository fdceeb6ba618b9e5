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
cross-attention through the flash kernel and adaLN conditioning; and
``skipvit``, the JAX trainer's SkipViT (d_model 64, 4 heads, 4/2/4
encoder/bottleneck/decoder blocks over one parameter stack, additive skips:
no skip-concat kernel), its real size, since the JAX package has no larger
SkipViT config.

Without ``--pipeline`` (the JAX trainer's ``_build_smoke_trainer``): one
value-and-grad of the whole model's loss per step, the GradGuard's finite
check, the grad norm, AdamW.  Archs: the JAX smoke configs of the three
diffusion models (``uvit-h`` (alias ``uvit``), ``hunyuan-dit``,
``sdv2-unet``: ``configs/smoke.py``) and of the seven decoder LMs
(``smollm-360m``, ``h2o-danube-1.8b``, ``internlm2-20b``, ``granite-34b``,
``internvl2-2b``, ``qwen3-moe-30b-a3b``, ``deepseek-v3-671b``) and of
whisper, xLSTM and Zamba2 (``whisper-base``, ``xlstm-125m``,
``zamba2-2.7b``), so the two trainers can be held to each other, and
``sdv2-unet-full``, the SDv2 UNet at full width (``configs/sdv2_unet.py``,
1.84e9 params) in bf16.  A token model's batch is the JAX trainer's:
``{"tokens"}`` from the same synthetic Markov language
(``SyntheticTokenDataset``, step-indexed) -- internvl2's too, whose
vision prefix the JAX trainer's batch leaves out -- and for whisper
``frames`` beside them, normal, drawn once a run from the trainer's
seed-0 generator after the params (the JAX trainer draws them once from
its init key), the same every step: the loss's draw, which
``run(draw=)`` can replace.

The kernels are always on: the decoder skip-in of UViT and Hunyuan-DiT
goes through the fused skip-concat matmul, every attention through flash
attention and Zamba2's carry across chunks through the gated linear scan
(on the CPU, through the kernels' plain versions), Zamba2's shared
attention included; of the LMs, deepseek's MLA runs the dense attention,
as in JAX (its q/k and v head dims differ).

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

Multi-host worker mode, one process per host (the JAX trainer's contract;
``launch/supervisor.py`` runs hosts of ranks instead, below):

- ``--host-id h --num-hosts H`` makes this process host ``h`` of ``H``: it
  writes ONLY its own checkpoint shard (``shard_{h:05d}.npz``; host 0
  owns the manifest and GC) with a blocking save at each checkpoint step,
  then waits on ``wait_step_complete`` -- the commit barrier that keeps
  any host from racing past a step its peers have not durably finished --
  for at most ``--commit-timeout`` seconds; a barrier that does not close
  degrades to a warning (the supervisor's watchdog owns declaring a peer
  dead).  It prints ``HostTopology(H, devices // H).describe()``, and with
  ``--heartbeat-dir`` meets its peers at the ``FileBarrier``
  ``start.g<gen>`` before the first step.  Host-scoped fault tokens are
  validated against ``H`` before any step runs.
- Every worker of the port is a whole replica: the ``--devices`` pipeline
  devices of the plan run in the one process (``--dp`` stays 1), and every
  host draws the full global batch, as the JAX workers do.

One process per pipeline device (ranks): under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` set) ``--pipeline --dp
G --pp P`` runs as rank ``RANK`` of a world of G x P processes (the rank
grid of ``launch/mesh.py``: pipeline index ``RANK % P``, data index
``RANK // P``; ``--pp`` defaults to ``--devices // --dp``).  Each rank
holds its own stage rows and the edge params, runs its rows of the step
tables, and moves the ring hops over ``--ring``: ``nccl`` (the default on
``cuda``; one card a rank) or ``gloo`` (the default on ``cpu``; on
``cuda`` the one-card ring, its payloads staged through pinned host
memory).  The backward is the rank walk of ``runtime/ring.py``, not
``loss.backward()``.  With ``--dp G > 1`` every rank draws the global
batch and runs its data replica's shard of each microbatch, and the loss
and gradients are averaged over the replicas through the data group's
collectives; ``--zero-stage 1`` keeps a rank's AdamW moments for its
shard of its rows only (the updated shards all-gathered back), ``2`` its
rows too (gathered on use).  The GradGuard's finite flag and the grad
norm (AdamW's clip, each element counted once over the grid) are reduced
over every rank, so the ranks skip and clip alike; rank 0 prints.
``--rank-report DIR`` writes, per rank, the first step's forward+backward
as read before its update (loss, gradient fingerprints, ring and
data-group bytes, launches, peak memory), the data group's bytes of each
training step, its saves and its restore (with a SHA-256 of each block it
held at each save and after the restore, ``held_digests``), and, with one
replica and no resume, one
forward+backward each of the paper's skip-carry baseline and of the
closed-form wave (a folded V = 1 plan with M >= D) from the initial
params after training.  Without torchrun's environment the one-process
executor runs one replica (``--dp > 1`` raises ``ValueError``).

Hosts of ranks (``--num-hosts H --host-id h`` under torchrun, as ``torchrun
--nnodes H --node-rank h`` or ``launch/supervisor.py`` launches them): the
world is H hosts of ``LOCAL_WORLD_SIZE`` ranks each, host ``h`` owning
ranks ``[h x LOCAL_WORLD_SIZE, (h+1) x LOCAL_WORLD_SIZE)``
(``launch.mesh.HostTopology``); a world that disagrees is refused before
any process group exists.  Each host's local rank 0 writes the host's
heartbeats, and every rank runs ``FaultPlan.for_host(h, H)``, so
``hostdown@K:h`` and ``hang@K[:h]`` take all of host h's ranks.  A save is
the commit of the JAX trainer's multi-host save: it returns once every
shard of the step has landed and the ranks agree on it.  A rank whose
collective fails, once its process group exists, because a peer is gone
(gloo's transport errors, a wait past ``RING_TIMEOUT_S``,
``torch.distributed``'s own errors) exits ``EXIT_PEER_LOST`` (44), so
that a supervisor blames the host that died, not the hosts it took down
with it.

Checkpoints over ranks: ``--ckpt-dir`` makes every rank write
``shard_<rank>.npz`` of one checkpoint in the JAX package's format, every
leaf whole as one process of the plan holds it.  At a save every rank
gathers, on its main thread and in one order, the pieces of the leaves it
writes from the ranks holding them (over the whole world: NCCL, or gloo
staged through pinned host memory on one card) into host memory -- the
snapshot -- and writes and hashes them on a background thread; before the
next save or a fault's flush the ranks agree whether every shard landed (a
step whose save degraded on any rank never verifies; every rank warns and
trains on).  ``--resume`` restores the same step on every rank, each
reading only what it holds (``runtime.resilience.restore_rank_state``),
elastically when the plan changed.  ``kill@K``/``stop@K`` fire on every
rank after the flush; ``corrupt@K``/``truncate@K`` on rank 0 alone, after
every shard landed; GC is rank 0's, once the ranks agree a step landed.

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
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch uvit-pp \
        --pipeline --devices 4 --steps 6 --device cpu --ckpt-dir /tmp/ck \
        --ckpt-every 3 --faults stop@3          # then add --resume
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --arch uvit-h \
        --pipeline --devices 4 --microbatches 8 --global-batch 16 \
        --steps 4 --ring gloo --device cuda      # four ranks on one card
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --arch uvit-pp \
        --pipeline --dp 2 --pp 2 --zero-stage 2 --steps 5 --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --arch uvit \
        --pipeline --dp 2 --pp 2 --zero-stage 2 --steps 6 --device cpu \
        --ckpt-dir /tmp/ck --ckpt-every 2 --faults stop@4
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --arch uvit \
        --pipeline --dp 2 --pp 1 --steps 6 --device cpu --ckpt-dir /tmp/ck \
        --resume                                  # elastic: P=2 -> P=1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
from typing import Any, Callable

PIPELINE_ARCHS = ("uvit", "uvit-pp", "uvit-nano", "uvit-h", "hunyuan-pp",
                  "hunyuan-dit", "skipvit")
# the JAX trainer's decoder-LM smoke keys (configs/smoke.py)
LM_ARCHS = ("smollm-360m", "h2o-danube-1.8b", "internlm2-20b", "granite-34b",
            "internvl2-2b", "qwen3-moe-30b-a3b", "deepseek-v3-671b")
# the JAX trainer's whisper, xLSTM and Zamba2 smoke keys
RECURRENT_ARCHS = ("whisper-base", "xlstm-125m", "zamba2-2.7b")
# without --pipeline: the JAX trainer's diffusion smoke keys ("uvit" is its
# alias of "uvit-h"), the UNet at full width and the other smoke keys
SMOKE_ARCHS = ("uvit", "uvit-h", "hunyuan-dit", "sdv2-unet",
               "sdv2-unet-full", *LM_ARCHS, *RECURRENT_ARCHS)
ARCHS = tuple(dict.fromkeys(PIPELINE_ARCHS + SMOKE_ARCHS))


# torchrun's environment: with all of it set, --pipeline runs as one rank
RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")
# seconds a rank waits on a peer before its collective fails: a receive
# posted for a send that never comes ends the run instead of hanging it
RING_TIMEOUT_S = 600.0


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
    ap.add_argument("--layers", type=int, default=None,
                    help="--pipeline: the model cut to this many blocks, "
                         "its widths kept (default: its config's depth)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data replicas of the pipeline (> 1: ranks under "
                         "torchrun, one process per (data, pipeline) index)")
    ap.add_argument("--pp", type=int, default=None,
                    help="pipeline degree (default: --devices // --dp)")
    ap.add_argument("--zero-stage", type=int, default=0, choices=(0, 1, 2),
                    help="ZeRO over the data replicas: 1 shards the AdamW "
                         "moments, 2 the stage rows too (0 with --dp 1)")
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
    ap.add_argument("--host-id", type=int, default=0,
                    help="this process's host rank (multi-host worker "
                         "mode; writes shard_<host-id>.npz only)")
    ap.add_argument("--num-hosts", type=int, default=1,
                    help="total host processes cooperating on the run")
    ap.add_argument("--heartbeat-dir", default=None,
                    help="write a heartbeat per step here")
    ap.add_argument("--gen", type=int, default=0,
                    help="supervisor generation stamped into heartbeats")
    ap.add_argument("--commit-timeout", type=float, default=60.0,
                    help="multi-host barrier timeout (s) of the "
                         "one-process worker mode: the start barrier and "
                         "each checkpoint step's commit (ranks commit over "
                         "their process group)")
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
    ap.add_argument("--ring", default=None, choices=("nccl", "gloo"),
                    help="ranks (under torchrun): the pipeline ring's "
                         "transport; nccl (default on cuda, a card a rank) "
                         "or gloo (default on cpu; on cuda the one-card "
                         "ring, staged through pinned host memory)")
    ap.add_argument("--rank-report", default=None,
                    help="ranks: write DIR/rank<r>.json with the first "
                         "step's forward+backward (read before its update), "
                         "every step's data-group bytes and, with one "
                         "replica, the skip-carry baseline's and the "
                         "closed-form wave's after training")
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


def _dump_losses(path: str, losses: dict, start: int, step_s: dict,
                 beat_t: dict, peak_bytes: int | None) -> None:
    """The atomic per-step dump: losses, step seconds, each train beat's
    wall-clock time, this process's kernel launches so far and its peak
    device memory since the first step (a worker that is killed leaves
    them for its supervisor)."""
    from repro_torch.kernels import launch_counts
    doc = {"losses": {str(k): v for k, v in losses.items()},
           "step_seconds": {str(k): v for k, v in step_s.items()},
           "beat_t": {str(k): v for k, v in beat_t.items()},
           "launches": launch_counts(), "start": start,
           "peak_bytes": peak_bytes, "partial": True}
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def main(argv=None, **run_kw):
    """The command line's :func:`run` (``run_kw`` passed on): over ranks,
    a collective that failed because a peer is gone exits
    ``EXIT_PEER_LOST``.  Only once the process group exists: an error of
    the rank's own rendezvous blames its host."""
    import torch.distributed as dist
    args = _parse_args(argv)
    try:
        return run(args, **run_kw).final_loss
    except Exception as e:
        if not (args.pipeline and rank_env() is not None
                and dist.is_initialized() and _peer_lost(e)):
            raise
        from repro_torch.runtime.resilience import EXIT_PEER_LOST
        print(f"[train] a peer rank is gone ({type(e).__name__}: "
              f"{str(e)[:300]}); exiting {EXIT_PEER_LOST}", flush=True)
        # the process group is broken: no clean shutdown to wait for
        os._exit(EXIT_PEER_LOST)


# gloo's errors when a peer rank is gone: its TCP transport's (a connection
# reset or closed, a read or write error) and a wait past the timeout
_GLOO_PEER_LOST = re.compile(r"gloo/transport/|Connection (reset|closed) by "
                             r"peer|Timed out waiting")


def _peer_lost(e: BaseException) -> bool:
    """Whether ``e`` is a collective that failed because a peer rank is
    gone: ``torch.distributed``'s own errors (its store, network and
    backend errors, NCCL's among them) or gloo's transport errors, which
    it raises as a plain ``RuntimeError``."""
    import torch.distributed as dist
    return isinstance(e, dist.DistError) or (
        isinstance(e, RuntimeError) and bool(_GLOO_PEER_LOST.search(str(e))))


def _refuse_unported(args) -> None:
    if args.pipeline and args.arch not in PIPELINE_ARCHS:
        raise ValueError(f"--arch {args.arch} has no pipeline path; the "
                         "pipeline archs are " + ", ".join(PIPELINE_ARCHS))
    if not args.pipeline and args.arch not in SMOKE_ARCHS:
        raise ValueError(f"--arch {args.arch} trains only with --pipeline")
    if args.layers is not None and (not args.pipeline
                                    or args.arch == "skipvit"):
        raise ValueError(f"--layers cuts the depth of a --pipeline model "
                         f"with n_layers blocks, not of {args.arch}")


def _pipeline_degree(args) -> int:
    """P: ``--pp``, else ``--devices // --dp`` (the JAX trainer's rule)."""
    return args.pp or max(args.devices // args.dp, 1)


def _refuse_one_process_dp(args) -> None:
    """Data replicas run as ranks: one process runs one replica."""
    if args.dp > 1:
        P = _pipeline_degree(args)
        raise ValueError(
            f"--dp {args.dp}: the port runs data replicas as ranks, one "
            "process per (data, pipeline) index; launch the "
            f"{args.dp} x {P} grid with\n  python -m torch.distributed.run "
            f"--standalone --nproc-per-node {args.dp * P} -m "
            f"repro_torch.launch.train --pipeline --dp {args.dp} --pp {P} "
            "...")


def rank_env(environ=None) -> dict | None:
    """``{"rank", "world", "local_rank", "local_world"}`` from torchrun's
    environment, or None when any of :data:`RANK_ENV` is missing (one
    process).  ``local_world`` is ``LOCAL_WORLD_SIZE``, the ranks of this
    rank's host (the whole world when it is not set: one host)."""
    env = os.environ if environ is None else environ
    if not all(k in env for k in RANK_ENV):
        return None
    return {"rank": int(env["RANK"]), "world": int(env["WORLD_SIZE"]),
            "local_rank": int(env["LOCAL_RANK"]),
            "local_world": int(env.get("LOCAL_WORLD_SIZE",
                                       env["WORLD_SIZE"]))}


def _refuse_rank_options(args, env: dict) -> None:
    """A world that disagrees with the plan or with ``--num-hosts`` /
    ``--host-id``, refused before any process group exists."""
    from repro_torch.launch.mesh import HostTopology
    P = _pipeline_degree(args)
    if env["world"] != args.dp * P:
        raise ValueError(f"{env['world']} processes cannot run a "
                         f"{P}-device pipeline with {args.dp} data "
                         f"replicas: the world is --dp x --pp = "
                         f"{args.dp * P}")
    if env["world"] != args.num_hosts * env["local_world"]:
        raise ValueError(f"a world of {env['world']} ranks is not "
                         f"--num-hosts {args.num_hosts} hosts of "
                         f"LOCAL_WORLD_SIZE {env['local_world']} ranks")
    host = HostTopology(args.num_hosts,
                        env["local_world"]).host_of_device(env["rank"])
    if args.host_id != host:
        raise ValueError(f"rank {env['rank']} belongs to host {host} of "
                         f"{args.num_hosts} (LOCAL_WORLD_SIZE "
                         f"{env['local_world']}), not --host-id "
                         f"{args.host_id}")


@dataclasses.dataclass
class Ranks:
    """This process's rank of a pipeline run over ranks: its grid
    (``launch.mesh.RankGrid``), its ring and device, the ring's kind, with
    data replicas its data group (``runtime.ring.DataGroup``), and the
    whole world as a ``runtime.ring.GroupView`` (a checkpoint's gather)."""
    grid: Any
    ring: Any
    device: Any
    kind: str                      # "nccl" | "gloo"
    data: Any = None
    world: Any = None
    # the data group's bytes and calls of each training step, by collective
    step_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def leader(self) -> bool:
        return self.grid.rank == 0

    def describe(self) -> str:
        how = ("a card a rank" if self.kind == "nccl" else
               "staged through pinned host memory" if self.ring.staged
               else "CPU tensors")
        return (f"ranks: rank {self.grid.rank} of {self.grid.world} "
                f"(pipeline index {self.grid.pipe_index}, data index "
                f"{self.grid.data_index}), {self.kind} ring ({how}) on "
                f"{self.device}"
                + (f"; {self.data.describe()}" if self.data else ""))

    def agree(self, obj) -> list:
        """Every rank's ``obj`` (small, picklable), in rank order: a
        collective of the whole world."""
        import torch.distributed as dist
        out = [None] * self.grid.world
        dist.all_gather_object(out, obj)
        return out

    def reduce(self, loss, grads, compiled) -> tuple[bool, Any]:
        """(finite, global norm) of the step's gradient over the grid, each
        element counted once (``runtime.ring.grid_grad_norm``): a stage
        leaf ZeRO shards by its data replicas (``compiled.zero_dims()``;
        its ``.grad`` is the rank's shard, zeros elsewhere at ZeRO-1) on
        every rank, a stage leaf every replica holds whole on data index 0
        only, the edge leaves on rank 0 only."""
        from repro_torch.runtime.ring import grid_grad_norm
        return grid_grad_norm(loss, grads, grads, compiled.zero_dims(),
                              first=self.grid.data_index == 0,
                              leader=self.leader, ring=self.ring,
                              data=self.data)


def _init_ranks(args, env: dict) -> Ranks:
    """Join the process group of torchrun's world, build the rank grid and
    this rank's ring.  No fallback: a missing card or backend raises."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_rank_grid
    from repro_torch.runtime.ring import DataGroup, GroupView, Ring
    kind = args.ring or ("nccl" if args.device == "cuda" else "gloo")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is visible")
        n = torch.cuda.device_count()
        if kind == "nccl" and env["local_rank"] >= n:
            raise RuntimeError(
                f"local rank {env['local_rank']} has no card of its own "
                f"({n} visible): NCCL refuses two ranks on one card; run "
                "one rank a card, or --ring gloo for the one-card ring")
        device = torch.device("cuda", env["local_rank"] % n)
        torch.cuda.set_device(device)
    else:
        if kind == "nccl":
            raise ValueError("--ring nccl needs --device cuda")
        device = torch.device("cpu")
    dist.init_process_group(
        kind, rank=env["rank"], world_size=env["world"],
        timeout=datetime.timedelta(seconds=RING_TIMEOUT_S))
    grid = make_rank_grid(_pipeline_degree(args), dp=args.dp)
    staged = kind == "gloo" and device.type == "cuda"
    ring = Ring(grid.model_group, grid.pipe_index, grid.pp, device,
                staged=staged)
    data = (DataGroup(grid.data_group, grid.data_index, grid.dp, device,
                      staged=staged) if grid.dp > 1 else None)
    world = GroupView(dist.group.WORLD, grid.rank, grid.world, device,
                      staged=staged)
    return Ranks(grid, ring, device, kind, data, world=world)


def _kind(args) -> str:
    if args.arch == "skipvit":
        return "skipvit"
    return "hunyuan" if args.arch.startswith("hunyuan") else "uvit"


def _model_config(args):
    """The pipeline path's model config of ``args``, kernels on."""
    from repro_torch.models.diffusion import (HunyuanDiTConfig, SkipViTConfig,
                                              UViTConfig)
    if args.arch == "skipvit":
        # the JAX trainer's own SkipViT; no skip-concat kernel to switch on
        return SkipViTConfig("skipvit-pp", img_size=8, in_ch=4, patch=2,
                             d_model=64, n_heads=4, d_ff=128, n_classes=10,
                             n_enc=4, n_mid=2, n_dec=4, use_flash=True)
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
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return dataclasses.replace(cfg, use_skip_kernel=True, use_flash=True)


def _smoke_bundle(args):
    """The non-pipeline path's ``(loss_fn, init_fn, make_batch, cfg)`` of
    ``args``, kernels on: a JAX smoke config's (``configs/smoke.py``), or
    the full-width UNet's (``configs/sdv2_unet.py``)."""
    if args.arch == "sdv2-unet-full":
        from repro_torch.configs.sdv2_unet import factory
    else:
        from repro_torch.configs.smoke import (LM_FACTORIES,
                                               RECURRENT_FACTORIES,
                                               SMOKE_FACTORIES)
        factory = {**SMOKE_FACTORIES, **LM_FACTORIES,
                   **RECURRENT_FACTORIES}[
            {"uvit": "uvit-h"}.get(args.arch, args.arch)]
    return factory(kernels=True)


def _ddpm_draws(batch, step: int) -> tuple:
    """A diffusion model's DDPM ``(t, noise)`` of step ``step``, from a
    generator seeded with the step."""
    from repro_torch.models.diffusion import ddpm_draw
    return tuple(ddpm_draw(batch["latents"], step))


def _no_draws(batch, step: int) -> tuple:
    return ()


@dataclasses.dataclass
class Trainer:
    """What a step needs, on either path: ``params`` is the tree AdamW
    updates and checkpoints save (``(stage stacks, edge)`` on the pipeline
    path, the model's own tree without it), ``loss(params, batch,
    *draws)`` the step's loss from the draws ``draws(batch, step)`` gives
    (a diffusion model's DDPM ``(t, noise)``; an LM's none),
    ``logical(params)`` the model-space tree, ``plan`` the plan's text."""
    params: Any
    opt_state: Any
    loss: Callable
    logical: Callable
    split: Callable                 # model-space tree -> ``params``' form
    loader: Any
    device: Any
    plan: str
    compiled: Any = None            # CompiledPipeline (pipeline path)
    ranks: Ranks | None = None      # one process per pipeline device
    draws: Callable = _ddpm_draws   # (batch, step) -> the loss's own draws


def _device(args):
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible; "
                           "pass --device cpu to train on the CPU")
    return torch.device(args.device)


def _with_grads(params, opt_view=lambda p: p):
    """``params`` as autograd leaves, and the AdamW state of
    ``opt_view(params)`` (a ZeRO-1 rank's shard views)."""
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return params, adamw_init(opt_view(params))


def build_trainer(args, compiled=None, ranks: Ranks | None = None
                  ) -> Trainer:
    """The pipeline path's :class:`Trainer` for ``args``.  ``compiled``, a
    :class:`~repro_torch.runtime.compile.CompiledPipeline` of the same
    model (the tuner's plan from ``auto_pipeline(graph, fns, N)``), takes
    the place of the plan pinned by ``--devices``/``--pp``,
    ``--microbatches``, ``--interleave`` and ``--wire-dtype``: its M
    splits the global batch.  With ``ranks`` the trainer is that rank's:
    its params are the rank's rows (at ZeRO-2 its shard of them) and the
    edge params, and its loss fills the gradients itself."""
    import torch

    from repro_torch.core.hw import H100_SXM
    from repro_torch.data import ShardedLoader, SyntheticLatentDataset
    from repro_torch.models.diffusion import (hunyuan_pipeline_graph,
                                              skipvit_pipeline_graph,
                                              uvit_pipeline_graph)
    from repro_torch.runtime.adapters import (make_diffusion_microbatches,
                                              model_fns)
    from repro_torch.runtime.compile import auto_pipeline

    device = ranks.device if ranks is not None else _device(args)
    cfg = _model_config(args)
    M = (args.microbatches if compiled is None
         else compiled.pcfg.num_microbatches)
    if args.global_batch % M:
        raise ValueError(f"--global-batch {args.global_batch} does not split "
                         f"into {M} microbatches")
    kind = _kind(args)
    if compiled is None:
        P = _pipeline_degree(args)
        graph_fn = {"skipvit": skipvit_pipeline_graph,
                    "hunyuan": hunyuan_pipeline_graph}.get(kind,
                                                           uvit_pipeline_graph)
        graph = graph_fn(cfg, batch=args.global_batch // M, hw=H100_SXM)
        compiled = auto_pipeline(graph, model_fns(cfg, kind), P,
                                 hw=H100_SXM, pipeline_devices=P,
                                 microbatches=M, interleave=args.interleave,
                                 wire_dtype=args.wire_dtype,
                                 dp_size=args.dp, zero_stage=args.zero_stage)
    if ranks is not None:
        compiled = compiled.for_rank(ranks.grid.pipe_index,
                                     ranks.grid.data_index)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        params = compiled.init_pipeline_params(gen, device)
    params, opt_state = _with_grads(params, compiled.optimizer_view)
    fn = (compiled.build(ranks.ring, ranks.data) if ranks is not None
          else compiled.build())

    def loss(params, batch, t, noise):
        # Hunyuan's temb comes from the current edge params (time_mlp)
        mb, aux = make_diffusion_microbatches(
            batch, M, cfg, kind, t=t, noise=noise, params=params[1])
        (enc, dec), edge = params
        return fn(enc, dec, edge, mb, aux)

    text = (dict(text_dim=cfg.ctx_dim, text_len=cfg.ctx_len)
            if kind == "hunyuan" else {})
    ds = SyntheticLatentDataset(img_size=cfg.img_size, channels=cfg.in_ch,
                                n_classes=10, **text)
    plan = compiled.describe()
    if ranks is not None:
        plan += "\n  " + ranks.describe()
    return Trainer(params, opt_state, loss,
                   lambda p: compiled.merge_params(*p), compiled.split_params,
                   ShardedLoader(ds, global_batch=args.global_batch), device,
                   plan, compiled, ranks)


def build_smoke_trainer(args) -> Trainer:
    """The non-pipeline path's :class:`Trainer` (the JAX trainer's
    ``_build_smoke_trainer``): the model's params from seed 0, the
    synthetic dataset at the config's batch shapes."""
    import torch

    from repro_torch.data import (ShardedLoader, SyntheticLatentDataset,
                                  SyntheticTokenDataset)
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
    if "tokens" in proto:          # the JAX trainer's batch: tokens alone
        ds = SyntheticTokenDataset(vocab=cfg.vocab,
                                   seq_len=proto["tokens"][1])
        attn = getattr(cfg, "attn", None)
        flash = getattr(cfg, "use_flash", attn is not None and attn.use_flash)
        draws = _no_draws
        if "frames" in proto:      # whisper: its frames, once a run
            frames = torch.randn((args.global_batch, *proto["frames"][1:]),
                                 generator=gen, device=device)

            def draws(batch, step):
                return (frames,)
    else:
        ds = SyntheticLatentDataset(img_size=proto["latents"][1],
                                    channels=proto["latents"][-1],
                                    n_classes=10,
                                    text_dim=text[-1] if text else 0,
                                    text_len=text[1] if text else 77)
        flash = True
        draws = _ddpm_draws
    n = sum(x.numel() for x in tree_leaves(params))
    kernels = [k for k, on in (
        ("flash attention", flash),
        ("skip-in kernel", getattr(cfg, "use_skip_kernel", False)),
        ("gated linear scan", hasattr(cfg, "mamba"))) if on]
    plan = (f"non-pipeline: {cfg.name}, {n} params "
            f"({str(cfg.param_dtype).replace('torch.', '')}); kernels: "
            + (", ".join(kernels) or "none"))

    def loss(params, batch, *draws):
        batch = {k: v for k, v in batch.items() if k in proto}
        if "frames" in proto:
            return loss_fn(params, {**batch, "frames": draws[0]})
        return loss_fn(params, batch, *draws)

    return Trainer(params, opt_state, loss, lambda p: p, lambda p: p,
                   ShardedLoader(ds, global_batch=args.global_batch), device,
                   plan, draws=draws)


def _resume(args, compiled, state: dict, device,
            ranks: Ranks | None = None) -> tuple[Any, dict]:
    """Restore the newest verified step of ``--ckpt-dir`` into the live
    tensors of ``state``, in place (they stay the leaves AdamW updates);
    ``(None, None)`` when no step verifies.  Returns the RestoreInfo and
    the resume's seconds (verifying, reading and placing, the elastic
    re-layout included; copying into place) and its peak device memory.
    A pipeline's state restores through ``restore_rank_state``, each
    device's rows read straight into its tensors: over ranks a rank reads
    only its own share (the ranks split the hashing and agree on every
    verdict), one process every device's rows; the record adds its
    seconds verifying and reading, and the bytes it hashed and read.  On
    the non-pipeline path (``compiled`` None) the checkpoint holds the
    model's own tree and restores as it is (``restore_checkpoint``,
    ``strict=False``).

    The JAX trainer asks ``latest_step`` first, which hashes every kept
    step, and then restores, which hashes the chosen one again.  Here the
    restore walks back from the newest step itself, and on the
    non-pipeline path ``latest_step`` runs only when it fails, to tell
    "nothing verifies" (start afresh, as the JAX trainer does) from a
    verified step that does not load (raise): the same outcomes, one hash
    pass fewer."""
    import torch

    from repro_torch.checkpoint import (CheckpointError, latest_step,
                                        restore_checkpoint)
    from repro_torch.runtime.resilience import (RestoreInfo,
                                                restore_rank_state)
    from repro_torch.tree import tree_flatten

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if compiled is not None:
        world = (dict(index=ranks.grid.rank, size=ranks.grid.world,
                      agree=ranks.agree) if ranks is not None else {})
        try:
            info, stats = restore_rank_state(args.ckpt_dir, compiled, state,
                                             **world)
        except CheckpointError as e:
            if e.reason in ("empty", "unverified"):
                return None, None
            raise
        if cuda:
            torch.cuda.synchronize(device)
        total = time.perf_counter() - t0
        return info, dict(stats, restore_s=total, copy_s=0.0, total_s=total,
                          peak_bytes=(torch.cuda.max_memory_allocated(device)
                                      if cuda else None))
    try:
        restored, step = restore_checkpoint(args.ckpt_dir, state,
                                            strict=False)
    except CheckpointError:
        if latest_step(args.ckpt_dir) is None:
            return None, None
        raise
    info = RestoreInfo(step, False, None, None)
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


def held_digests(compiled, state: dict) -> dict:
    """SHA-256 of what a rank holds, by checkpoint leaf index: an edge
    leaf (and AdamW's step) whole; a stage leaf its stage stack and each
    real block of its rows, ``{"stack": k, "rows": [slot][row]}`` (the
    padding rows past a slot's count left out), and where the rank holds
    its data replica's ZeRO shard of the rows, the block dim cut
    (``dim``) into ``parts`` equal parts and its ``part``.  What a checker
    holds against the same blocks' bytes in a checkpoint's members, cut
    the same way: after a restore, what the rank read; at a save, what
    the gather wrote."""
    import hashlib

    import torch

    from repro_torch.runtime.resilience import rank_leaves
    from repro_torch.tree import tree_flatten

    def sha(x):
        b = x.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        return hashlib.sha256(b.numpy()).hexdigest()

    lay, d = compiled.layout, compiled.rank
    counts = (lay.enc_counts[d], lay.dec_counts[d])
    out = {}
    for i, (x, p) in enumerate(zip(tree_flatten(state)[0],
                                   rank_leaves(compiled, state))):
        if p.stack is None:
            out[str(i)] = sha(x)
            continue
        rec = out[str(i)] = {"stack": p.stack, "rows": [
            [sha(x[v, r]) for r in range(c)]
            for v, c in enumerate(counts[p.stack])]}
        dim = compiled.piece_dim(p.stack, p.path, moments=p.moments)
        if dim >= 0:                      # of the rows [V, pad, ...]
            rec.update(dim=dim - 2, parts=compiled.pcfg.dp_size,
                       part=compiled.data_index)
    return out


FINGERPRINT_PROBES = 8


def grad_fingerprints(grads, *, rank: int | None = None,
                      probes: int = FINGERPRINT_PROBES,
                      whole: Callable | None = None) -> dict:
    """``key -> [norm, dot_1, ..., dot_probes]`` for each leaf of a
    pipeline gradient tree ``(stage stacks, edge)``: every stage leaf per
    pipeline device (``stack[d]`` of a one-process tree, or a rank's own
    rows with ``rank=d``), keyed ``stage<i>/<path>@<d>``, and every edge
    leaf whole (``edge/<path>``).  The dots are with standard normal
    tensors drawn on the gradient's device from a seed of the key, row by
    row, so a rank's leaves and the one-process tree's slices of them
    fingerprint alike; ``sqrt(mean((dot_a - dot_b)^2))`` estimates
    ``||g_a - g_b||``.  ``whole(i, path, x)``, when given, turns stage
    stack ``i``'s leaf into the leaf to fingerprint, one leaf at a time
    (a ZeRO rank's shard into the whole, :func:`_whole_leaf`)."""
    import zlib

    import torch

    from repro_torch.tree import tree_paths
    stacks, edge = grads

    def fp(key, rows):
        g = torch.Generator(device=rows.device).manual_seed(
            zlib.crc32(key.encode()))
        dots = torch.zeros(probes, dtype=torch.float64, device=rows.device)
        for r in rows:
            z = torch.randn((probes, r.numel()), generator=g,
                            dtype=torch.float32, device=rows.device)
            dots += torch.mv(z, r.reshape(-1).float()).double()
            del z
        norm = torch.linalg.vector_norm(rows, dtype=torch.float32)
        return [float(norm)] + dots.tolist()

    out = {}
    for i, st in enumerate(stacks):
        for path, x in tree_paths(st):
            if whole is not None:
                x = whole(i, path, x)
            per = ([(rank, x)] if rank is not None
                   else list(enumerate(x.unbind(0))))
            for d, xd in per:
                key = f"stage{i}/{path}@{d}"
                out[key] = fp(key, xd.reshape(-1, *xd.shape[2:]))
    for path, x in tree_paths(edge):
        key = f"edge/{path}"
        out[key] = fp(key, x.reshape(1, *x.shape))
    return out


def _step_inputs(tr: Trainer, step: int, draw, poison=None) -> tuple:
    """Step ``step``'s batch on the trainer's device (``poison(batch,
    step)`` applied, when given) and the draws its loss takes after the
    batch: ``draw(step)``'s when given, else the trainer's own
    (``tr.draws``)."""
    import torch
    batch = {k: torch.as_tensor(v, device=tr.device)
             for k, v in tr.loader.get(step).items()}
    if poison is not None:
        batch = poison(batch, step)
    if draw is None:
        return batch, tr.draws(batch, step)
    return batch, tuple(torch.as_tensor(x, device=tr.device)
                        for x in draw(step))


def _timed_walk(tr: Trainer, walk: Callable) -> tuple:
    """One rank walk (``walk()`` returns its reduced loss): the loss, and
    a record of it, seconds (device synchronized), ring bytes, the data
    group's bytes, calls and seconds, kernel launches and peak device
    memory."""
    import copy

    import torch

    from repro_torch.kernels import launch_counts
    ring, data = tr.ranks.ring, tr.ranks.data
    cuda = tr.device.type == "cuda"
    ring.reset_bytes()
    if data is not None:
        data.reset_bytes()
    before = launch_counts()
    if cuda:
        torch.cuda.synchronize(tr.device)
        torch.cuda.reset_peak_memory_stats(tr.device)
    t0 = time.perf_counter()
    loss = walk()
    if cuda:
        torch.cuda.synchronize(tr.device)
    secs = time.perf_counter() - t0
    after = launch_counts()
    return loss, dict(loss=float(loss), seconds=secs,
                ring_bytes=copy.deepcopy(ring.bytes),
                data_bytes=dict(data.bytes) if data else None,
                data_calls=dict(data.calls) if data else None,
                data_seconds=dict(data.seconds) if data else None,
                launches={k: v - before.get(k, 0) for k, v in after.items()},
                peak_bytes=(torch.cuda.max_memory_allocated(tr.device)
                            if cuda else None))


def _whole_leaf(tr: Trainer) -> Callable | None:
    """For :func:`grad_fingerprints`' ``whole``: under ZeRO with data
    replicas, a rank's gradient of a whole stage leaf, gathered over the
    data group (at ZeRO-1 the sum of the replicas' ``.grad``, each its
    shard and zeros elsewhere; at ZeRO-2 the all-gather of the shards);
    None without ZeRO."""
    from repro_torch.tree import tree_paths
    dims, data = tr.compiled.zero_dims(), tr.ranks.data
    if dims is None:
        return None
    dim = [dict(tree_paths(ds)) for ds in dims]

    def whole(i, path, g):
        d = dim[i][path]
        if d < 0:
            return g
        if tr.compiled.pcfg.zero_stage == 1:
            g = g.clone()
            data.all_reduce_([g])
            return g
        return data.all_gather([g], [d + 1])[0]

    return whole


def _closed_form_probe(args, tr: Trainer, draw) -> dict | None:
    """One forward+backward of the closed-form wave over the ranks
    (``executor="closed_form"``: the same cuts as the trainer's table
    plan) from the initial (seed-0) params and step 0's batch, with its
    gradient fingerprints; None where the closed form does not apply (a
    linear or interleaved plan, M < D)."""
    import torch

    from repro_torch.runtime.adapters import (make_diffusion_microbatches,
                                              model_fns)
    from repro_torch.tree import tree_leaves, tree_map
    cp, kind = tr.compiled, _kind(args)
    pcfg = cp.pcfg
    if not cp.folded or cp.layout.V > 1 \
            or pcfg.num_microbatches < pcfg.num_devices:
        return None
    cf = dataclasses.replace(cp, executor="closed_form")
    cfg, device = _model_config(args), tr.device
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        params = cf.split_params(model_fns(cfg, kind).init_fn(gen, device))
    for x in tree_leaves(params):
        x.requires_grad_(True)
    stacks, edge = params
    fn = cf.build(tr.ranks.ring)
    batch, (t, noise) = _step_inputs(tr, 0, draw)
    mb, aux = make_diffusion_microbatches(
        batch, pcfg.num_microbatches, cfg, kind, t=t, noise=noise,
        params=edge)
    _, out = _timed_walk(tr, lambda: fn(*stacks, edge, mb, aux))
    out["fingerprints"] = grad_fingerprints(
        tree_map(lambda p: p.grad if p.grad is not None
                 else torch.zeros_like(p), params),
        rank=tr.ranks.ring.index)
    return out


def _rank_report(args, tr: Trainer, res: TrainResult, probe: dict,
                 draw) -> str:
    """After training: one forward+backward each of the paper's skip-carry
    baseline and of the closed-form wave on this rank from the initial
    (seed-0) params and step 0's batch (UViT and Hunyuan-DiT, one data
    replica), then ``--rank-report``'s file for this rank.  Returns its
    path."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.runtime.adapters import (DiffusionPipelineAdapter,
                                              make_diffusion_microbatches,
                                              model_fns)
    from repro_torch.tree import tree_leaves
    ranks, device, kind = tr.ranks, tr.device, _kind(args)
    base = closed = None
    if kind != "skipvit" and ranks.data is None and res.resumed is None:
        cfg, pcfg = _model_config(args), tr.compiled.pcfg
        ad = DiffusionPipelineAdapter(cfg, pcfg, kind)
        gen = torch.Generator(device=device).manual_seed(0)
        with torch.no_grad():
            (enc, dec), edge = ad.split_params_skip_carry(
                model_fns(cfg, kind).init_fn(gen, device), ranks.ring.index)
        for x in tree_leaves(((enc, dec), edge)):
            x.requires_grad_(True)
        fn = ad.build_skip_carry_baseline(ranks.ring)
        batch, (t, noise) = _step_inputs(tr, 0, draw)
        mb, aux = make_diffusion_microbatches(
            batch, pcfg.num_microbatches, cfg, kind, t=t, noise=noise,
            params=edge)
        _, base = _timed_walk(tr, lambda: fn(enc, dec, edge, mb, aux))
        del enc, dec, edge, mb, aux
        closed = _closed_form_probe(args, tr, draw)
    doc = dict(rank=ranks.grid.rank, world=ranks.grid.world, ring=ranks.kind,
               pipe=ranks.grid.pipe_index, data=ranks.grid.data_index,
               dp=ranks.grid.dp, spec=tr.compiled.state_spec(),
               data_group=ranks.data.describe() if ranks.data else None,
               step_data_bytes={str(k): v for k, v in
                                ranks.step_bytes.items()},
               staged=ranks.ring.staged, device=str(device), probe=probe,
               train=dict(losses={str(k): v for k, v in res.losses.items()},
                          step_seconds={str(k): v for k, v in
                                        res.step_seconds.items()},
                          peak_bytes=res.peak_bytes,
                          skipped_steps=res.skipped_steps),
               baseline=base, closed_form=closed, launches=launch_counts(),
               restore=res.restore, saves=res.saves,
               resumed=dataclasses.asdict(res.resumed) if res.resumed
               else None)
    os.makedirs(args.rank_report, exist_ok=True)
    path = os.path.join(args.rank_report, f"rank{ranks.grid.rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".tmp", path)
    return path


def run(args, on_restore=None, init_params=None, draw=None,
        compiled=None, on_grads=None) -> TrainResult:
    """Train ``args.steps`` steps (from the restored step with
    ``--resume``).  ``on_restore(state, info)``, when given, is called once
    a resume has restored ``{"params", "opt"}`` in place, before the first
    step.

    ``init_params`` (a model-space tree of numpy arrays, as
    ``jax.device_get`` gives it, in any dict order) replaces the seed-0
    params; ``draw(step)`` returns the step's DDPM ``(t, noise)`` in place
    of the per-step generator's (an LM's loss takes no draws: ``()``).
    With both, another trainer's params and draws (the JAX trainer's
    ``fold_in(PRNGKey(0), step)``) go through this one.  ``compiled`` trains the pipeline path on a given plan
    (:func:`build_trainer`).  ``on_grads(step, grads)``, when given, sees
    each step's gradient tree before the update.

    Under torchrun's environment (:func:`rank_env`) the pipeline path runs
    as one rank of the world (see the module docstring).
    """
    _refuse_unported(args)
    env = rank_env() if args.pipeline else None
    if env is not None:
        _refuse_rank_options(args, env)
    else:
        _refuse_one_process_dp(args)
    if compiled is not None and not args.pipeline:
        raise ValueError("a compiled pipeline plan needs --pipeline")
    from repro_torch.runtime.resilience import (ENTRY_BEATS, EXIT_ESCALATE,
                                                FaultPlan, GradGuard,
                                                GradGuardEscalation,
                                                Heartbeat, all_finite,
                                                write_heartbeat)

    faults = FaultPlan.parse(args.faults)
    if args.simulate_failure:
        faults = faults.with_kill(args.simulate_failure)
    # malformed specs die here, not mid-training; every rank of a host
    # runs the host's plan
    faults = faults.for_host(args.host_id, args.num_hosts)
    # each host's local rank 0 speaks for the host
    beats = bool(args.heartbeat_dir) and (env is None
                                          or env["local_rank"] == 0)

    def beat(step, phase, loss=None, gnorm=None, step_s=None):
        if beats:
            write_heartbeat(args.heartbeat_dir, Heartbeat(
                args.host_id, step, phase, loss=loss, grad_norm=gnorm,
                step_s=step_s, gen=args.gen))

    def beat_entry(step):
        # lockstep ranks: a host that hangs before step K stalls its peers
        # inside step K, on the same last train beat; the step they
        # entered tells the root from them
        if beats:
            write_heartbeat(os.path.join(args.heartbeat_dir, ENTRY_BEATS),
                            Heartbeat(args.host_id, step, "enter",
                                      gen=args.gen))

    beat(-1, "init")
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import launch_counts
    from repro_torch.optim import (AdamWConfig, adamw_update,
                                   cosine_schedule, global_norm)
    from repro_torch.tree import tree_leaves, tree_map

    ranks = _init_ranks(args, env) if env is not None else None
    # rank 0 speaks for a run over ranks
    say = print if ranks is None or ranks.leader else (lambda *a, **k: None)
    tr = (build_trainer(args, compiled, ranks) if args.pipeline
          else build_smoke_trainer(args))
    params, opt_state, compiled, device = (tr.params, tr.opt_state,
                                           tr.compiled, tr.device)
    if init_params is not None:
        from repro_torch.convert import params_from_jax
        src = tr.split(params_from_jax(init_params, device))
        with torch.no_grad():
            tree_map(lambda dst, x: dst.copy_(x), params, src)
        del src
    plan = tr.plan
    cuda = device.type == "cuda"
    where = (f"cuda:{torch.cuda.current_device()} "
             f"({torch.cuda.get_device_name(device)})" if cuda else "cpu")
    print(f"[train] device: {where}"
          + (f" (rank {ranks.grid.rank})" if ranks else ""), flush=True)
    say("[train] " + plan.replace("\n", "\n[train] "), flush=True)
    opt_cfg = AdamWConfig(lr=args.lr)
    mgr = None
    if args.ckpt_dir and ranks is not None:
        # every rank writes shard_<rank>: its share of the gathered leaves
        from repro_torch.runtime.resilience import RankSaves
        mgr = CheckpointManager(
            args.ckpt_dir, keep=args.keep, host_id=ranks.grid.rank,
            num_hosts=ranks.grid.world, plan=compiled.state_spec(),
            io_fault=faults.io_fault,
            ranks=RankSaves(compiled, ranks.world, ranks.grid.rank_of,
                            ranks.agree))
    elif args.ckpt_dir:
        mgr = CheckpointManager(
            args.ckpt_dir, keep=args.keep, host_id=args.host_id,
            num_hosts=args.num_hosts,
            plan=compiled.state_spec() if compiled is not None else None,
            io_fault=faults.io_fault)

    multi_host = args.num_hosts > 1
    if multi_host and ranks is not None:
        # the process group is the hosts' rendezvous
        from repro_torch.launch.mesh import HostTopology
        topo = HostTopology(args.num_hosts, env["local_world"])
        if env["local_rank"] == 0:
            print("[train] " + topo.describe().replace("\n", "\n[train] "),
                  flush=True)
    elif multi_host:
        from repro_torch.launch.mesh import FileBarrier, HostTopology
        topo = HostTopology(args.num_hosts,
                            max(args.devices // args.num_hosts, 1))
        print("[train] " + topo.describe().replace("\n", "\n[train] "),
              flush=True)
        if args.heartbeat_dir:
            FileBarrier(os.path.join(args.heartbeat_dir, "barrier"),
                        host_id=args.host_id, num_hosts=args.num_hosts
                        ).wait(f"start.g{args.gen}",
                               timeout=args.commit_timeout)

    start, resumed, restore = 0, None, None
    if args.resume and args.ckpt_dir:
        state = {"params": params, "opt": opt_state}
        resumed, restore = _resume(args, compiled, state, device, ranks)
        if resumed is not None:
            start = resumed.step
            if mgr:
                mgr.trust(start)        # verified: GC need not hash it
            say(f"[train] resumed from step {start}"
                + (" (elastic restore: plan changed)" if resumed.elastic
                   else "")
                + f" in {restore['total_s']:.2f} s", flush=True)
            if ranks is not None and args.rank_report:
                restore["digests"] = held_digests(compiled, state)
            if on_restore is not None:
                on_restore(state, resumed)
    # --rank-report's probe is the first step's forward+backward, read
    # before its update; nothing reset the peak since the process began,
    # so here it is the set-up's (the whole model drawn on the card before
    # the rank kept its rows)
    probe = None
    init_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    guard = GradGuard(budget=args.nan_skip_budget)
    losses: dict[int, float] = {}
    step_s: dict[int, float] = {}
    beat_t: dict[int, float] = {}
    prof = None
    out_json = args.out_json
    if ranks is not None and out_json:
        if "{rank}" not in out_json:
            raise ValueError("--out-json over ranks needs a {rank} field: "
                             "each rank writes its own")
        out_json = out_json.format(rank=ranks.grid.rank)

    def finish(loss) -> TrainResult:
        beat(args.steps, "done")
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        final = None if loss is None else float(loss.detach())
        logical = None
        if ranks is None:          # a rank holds only its own stage rows
            with torch.no_grad():
                logical = tree_map(lambda x: x.detach().cpu(),
                                   tr.logical(params))
        res = TrainResult(
            final_loss=final, losses=losses, step_seconds=step_s, plan=plan,
            start=start, resumed=resumed, skipped_steps=guard.skipped_total,
            peak_bytes=peak, compiled=compiled, params=params,
            opt_state=opt_state, logical_params=logical,
            saves=mgr.history if mgr else [], restore=restore)
        if out_json:
            with open(out_json, "w") as f:
                json.dump({"final_loss": final,
                           "losses": {str(k): v for k, v in losses.items()},
                           "step_seconds": {str(k): v
                                            for k, v in step_s.items()},
                           "start": start,
                           "resumed_step": resumed.step if resumed else None,
                           "elastic": bool(resumed.elastic) if resumed
                           else False,
                           "skipped_steps": res.skipped_steps,
                           "peak_bytes": peak,
                           "beat_t": {str(k): v for k, v in beat_t.items()},
                           "launches": launch_counts(),
                           "restore": restore, "saves": res.saves}, f)
        return res

    if start >= args.steps:
        say(f"[train] nothing to do: resumed step {start} >= "
              f"--steps {args.steps}")
        return finish(None)

    def save_at(step_next: int) -> None:
        """Single host and ranks: async save (over ranks the gather, on
        every rank at this point, is the snapshot); over ranks of several
        hosts it then waits for the commit: every shard landed and the
        ranks agree on it.  Multi-host, one process a host: blocking shard
        write, then the rendezvous on step completeness (the commit
        barrier)."""
        from repro_torch.checkpoint import CheckpointError, wait_step_complete
        state = {"params": params, "opt": opt_state}
        # a save is progress: the watchdog must not read a slow commit as a
        # stalled step loop
        beat(step_next, "ckpt")
        if ranks is not None or not multi_host:
            # --rank-report: what the rank holds at the save, before the
            # gather and the step's update
            held = (held_digests(compiled, state) if ranks is not None
                    and args.rank_report else None)
            mgr.save_async(step_next, state)
            if held is not None:
                mgr.history[-1]["digests"] = held
            if multi_host:
                # a host that dies right after may not take the step with
                # it: the JAX trainer's multi-host save is blocking too
                mgr.wait()
            return
        if mgr.save(step_next, state) is None:
            return                  # degraded save: no barrier to meet
        try:
            wait_step_complete(args.ckpt_dir, step_next,
                               timeout=args.commit_timeout)
        except CheckpointError as e:
            # degrade and warn, as a failed single-host save does
            print(f"[train] WARNING: commit barrier at step {step_next} "
                  f"did not close: {e}", flush=True)

    loss = None
    stopped = False
    last_save = None
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        if faults.hang_before(step):
            say(f"[train] fault plan: woke from hang at step {step}")
        beat_entry(step)
        if args.profile and step == start + 1:
            from torch.profiler import ProfilerActivity, profile
            # device kernels only on a card (host op events would slow
            # the step they measure); host ops on the CPU
            prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                       else ProfilerActivity.CPU])
            prof.__enter__()
        t_step = time.perf_counter()
        if ranks is not None and ranks.data is not None:
            ranks.data.reset_bytes()
        batch, draws = _step_inputs(tr, step, draw, faults.poison_batch)
        if ranks is not None and args.rank_report and step == start:
            loss, probe = _timed_walk(
                tr, lambda: tr.loss(params, batch, *draws))
            probe["init_peak_bytes"] = init_peak
        else:
            loss = tr.loss(params, batch, *draws)
        if ranks is None:
            loss.backward()     # a rank's loss has filled its grads itself
        # a leaf the step never reads (the xattn wk/wv cross-attention
        # ignores, and on the pipeline path Hunyuan's time_mlp, whose temb
        # enters as data) has no grad: a zero gradient, as jax.grad gives it
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        if on_grads is not None:
            on_grads(step, grads)
        norm = None
        if ranks is None:
            finite = bool(all_finite(loss, grads))
            gnorm = float(global_norm(grads)) if args.heartbeat_dir else None
        else:
            # the ranks must agree on skipping and clipping, or their
            # params part
            finite, norm = ranks.reduce(loss, grads, compiled)
            gnorm = float(norm)
        lr = cosine_schedule(step, base_lr=args.lr, warmup=20,
                             total=args.steps)
        if finite:
            if ranks is None:
                adamw_update(params, grads, opt_state, opt_cfg, lr=lr)
            else:
                # ZeRO-1: the rank's shard is updated, then gathered back
                adamw_update(compiled.optimizer_view(params),
                             compiled.optimizer_view(grads), opt_state,
                             opt_cfg, lr=lr, norm=norm)
                compiled.gather_params_(params, ranks.data)
        for p in tree_leaves(params):
            p.grad = None
        if cuda:
            torch.cuda.synchronize(device)
        step_s[step] = time.perf_counter() - t_step
        if ranks is not None and ranks.data is not None:
            ranks.step_bytes[step] = dict(
                bytes=dict(ranks.data.bytes), calls=dict(ranks.data.calls),
                seconds=dict(ranks.data.seconds))
        if ranks is not None and args.rank_report and step == start:
            # after the step's record: gathering the whole rows is no part
            # of the step
            probe["fingerprints"] = grad_fingerprints(
                grads, rank=ranks.ring.index, whole=_whole_leaf(tr))
        del grads
        try:
            guard.observe(finite, step)     # skipped above when not finite
        except GradGuardEscalation as e:
            if args.escalation == "rollback":
                say(f"[train] {e}; requesting supervisor rollback",
                      flush=True)
                if mgr:
                    mgr.wait()
                beat(step, "done")
                raise SystemExit(EXIT_ESCALATE) from None
            raise
        losses[step] = float(loss.detach())
        slow = faults.slow_factor(step)
        if slow > 1.0:     # straggle: stretch this step by the factor
            time.sleep(min((time.perf_counter() - t_step) * (slow - 1.0),
                           5.0))
        beat_t[step] = time.time()
        beat(step, "train", loss=losses[step], gnorm=gnorm,
             step_s=step_s[step])
        if out_json:
            # an atomic per-step dump: a killed run still leaves its losses
            _dump_losses(out_json, losses, start, step_s, beat_t,
                         torch.cuda.max_memory_allocated(device) if cuda
                         else None)
        if step % args.log_every == 0 or step == args.steps - 1:
            sps = ((step - start + 1) * args.global_batch
                   / (time.perf_counter() - t0))
            say(f"[train] step {step:5d} loss {losses[step]:.4f} "
                  f"lr {lr:.2e} step {step_s[step]:.3f}s "
                  f"({sps:.2f} samples/s)", flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            save_at(step + 1)
            last_save = step + 1
        # every rank flushes (a collective); rank 0 alone damages a shard,
        # after every rank's shard has landed
        if faults.post_step(step + 1, ckpt_dir=args.ckpt_dir if ranks is None
                            or ranks.leader else None,
                            flush=mgr.wait if mgr else None) == "stop":
            say(f"[train] fault plan: abrupt stop after step {step} "
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
            save_at(args.steps)
        mgr.wait()
    res = finish(loss)
    if ranks is not None and args.rank_report:
        # the baseline draws the whole model again: the optimizer state
        # goes first
        res.opt_state = tr.opt_state = None
        del opt_state
        _rank_report(args, tr, res, probe, draw)
    if ranks is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    if not stopped:
        say(f"[train] done: final loss {res.final_loss:.4f}"
              + (f", peak device memory {res.peak_bytes / 1e9:.2f} GB"
                 if cuda else ""), flush=True)
    return res


if __name__ == "__main__":
    main()
