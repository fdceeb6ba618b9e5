"""Hybrid ZeRO x pipeline parallelism through the compile path, on the
PyTorch/CUDA port (the counterpart of ``examples/hybrid_zero_pipeline.py``).

Plans an LM pipeline as two data replicas of a two-device pipeline
(N = 4: P = 2 x dp = 2) with ZeRO-2 over the data replicas: a rank's
stage rows rest sharded, each slot's rows are all-gathered on use inside
the steps that run them, and their gradients come back reduce-scattered.
Prints the plan and its certificate, then trains a few AdamW steps over
four rank processes, one per (data, pipeline) index -- NCCL where the
ranks have a card each, gloo on one card (payloads staged through pinned
host memory), gloo on the CPU with ``--device cpu`` -- and shows the
tuner unlocking a faster granite-34b plan on 16 H100s with ZeRO than any
replicated one.

    PYTHONPATH=src python examples/torch_hybrid_zero_pipeline.py \
        [--device cpu] [--steps 10]
"""
import argparse
import datetime
import os
import socket
import subprocess
import sys

import torch

from repro_torch.analysis import certify_plan
from repro_torch.models.layers import AttnConfig
from repro_torch.models.lm import LMConfig, lm_pipeline_graph
from repro_torch.runtime.adapters import lm_model_fns
from repro_torch.runtime.compile import auto_pipeline
from repro_torch.tree import tree_leaves, tree_map

DP, PP = 2, 2
B, S, M = 8, 16, 4
CFG = LMConfig(name="demo", vocab=64, d_model=32, n_layers=8,
               attn=AttnConfig(32, 4, 2, 8), d_ff=64, tied_embeddings=True)


def plan():
    """The N = 4 plan: P = 2 pipeline devices x dp = 2 ZeRO-2 replicas."""
    graph = lm_pipeline_graph(CFG, fwd_times=[4, 1, 1, 1, 1, 1, 1, 4])
    return auto_pipeline(graph, lm_model_fns(CFG), DP * PP,
                         pipeline_devices=PP, dp_size=DP, microbatches=M,
                         lam=0.0, zero_stage=2)


def backend(device: str) -> tuple[str, bool]:
    """The ring's backend and whether its payloads are staged: NCCL with
    a card a rank, gloo staged through host memory on one card, gloo on
    the CPU.  Nothing falls back: a missing card raises."""
    if device == "cpu":
        return "gloo", False
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu")
    return ("nccl", False) if torch.cuda.device_count() >= DP * PP \
        else ("gloo", True)


def worker(rank: int, port: int, device: str, steps: int) -> None:
    """One rank of the (data=2, model=2) grid: its rows of the plan, its
    ring and data group, ``steps`` AdamW steps (the norm over the whole
    grid, the update of the rank's shard)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_rank_grid
    from repro_torch.launch.train import Ranks
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.runtime.ring import DataGroup, Ring

    kind, staged = backend(device)
    if kind == "nccl":
        torch.cuda.set_device(rank)
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    dist.init_process_group(kind, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=DP * PP,
                            timeout=datetime.timedelta(seconds=300))
    grid = make_rank_grid(PP, dp=DP)
    ring = Ring(grid.model_group, grid.pipe_index, PP, dev, staged=staged)
    data = DataGroup(grid.data_group, grid.data_index, DP, dev,
                     staged=staged)
    cp = plan().for_rank(grid.pipe_index, grid.data_index)
    # every rank draws the same seed-0 model and keeps its shard of its rows
    params = cp.init_pipeline_params(
        torch.Generator(device=dev).manual_seed(0), dev)
    for x in tree_leaves(params):
        x.requires_grad_(True)
    stacks, edge = params
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, CFG.vocab, (B, S), generator=gen).to(dev)
    mbs = {"tokens": tokens.reshape(M, B // M, S)}
    fn = cp.build(ring, data)
    ranks = Ranks(grid, ring, dev, kind, data)
    opt_cfg = AdamWConfig(lr=1e-2)
    opt_state = adamw_init(cp.optimizer_view(params))
    if rank == 0:
        print(f"[rank 0] {ranks.describe()}", flush=True)
    for step in range(steps):
        ring.reset_bytes()
        data.reset_bytes()
        loss = (fn(*stacks, edge, mbs, {}) if cp.folded
                else fn(stacks[0], edge, mbs))
        grads = tree_map(lambda p: p.grad, params)
        finite, norm = ranks.reduce(loss, grads, cp)
        if not finite:
            raise RuntimeError(f"step {step}: non-finite gradients")
        with torch.no_grad():
            adamw_update(cp.optimizer_view(params), cp.optimizer_view(grads),
                         opt_state, opt_cfg, norm=norm)
        cp.gather_params_(params, data)
        for x in tree_leaves(params):
            x.grad = None
        if rank == 0 and (step % 3 == 0 or step == steps - 1):
            print(f"step {step:2d}  loss {float(loss):.4f}", flush=True)
    if rank == 0:
        print(f"[rank 0] data group moved {dict(data.bytes)} bytes in the "
              f"last step's collectives; ring {ring.bytes}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def train_over_ranks(device: str, steps: int) -> None:
    """Start the four rank processes and wait for them; rank 0 prints."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), "--port", str(port),
         "--device", device, "--steps", str(steps)], env=env)
        for r in range(DP * PP)]
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(f"rank exit codes {codes}")


def tuner_table() -> None:
    """The tuner's ZeRO axes on granite-34b over 16 H100s (80 GB each):
    every replicated plan needs a deep pipeline to fit, and ZeRO-2 admits
    a shallower, faster one."""
    from repro_torch.configs import granite_34b
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.tuner import tune

    g34 = lm_pipeline_graph(granite_34b.CFG)
    drops: list = []
    best = tune(g34, 16, hw=H100_SXM, drops=drops)[0]
    best0 = tune(g34, 16, hw=H100_SXM, zero_stages=(0,))[0]
    print(f"\ngranite-34b on 16x {H100_SXM.name}, "
          f"{H100_SXM.mem_limit / 1e9:.0f} GB each:")
    print(f"  replicated best: P={best0.P} dp={best0.dp} zero=0  "
          f"t/sample={best0.t_sample * 1e3:.1f} ms  "
          f"peak={best0.peak_mem / 1e9:.1f} GB")
    print(f"  hybrid best:     P={best.P} dp={best.dp} "
          f"zero={best.zero_stage}  t/sample={best.t_sample * 1e3:.1f} ms  "
          f"peak={best.peak_mem / 1e9:.1f} GB")
    print("  dropped along the way:")
    for d in drops[:4]:
        print(f"    {d}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.port, args.device, args.steps)
        return
    backend(args.device)             # refuse a missing card up front

    # 1. the hybrid plan: N=4 devices = P=2 pipeline x dp=2 ZeRO-2
    cp = plan()
    print(cp.describe())
    print(certify_plan(cp, name="hybrid-demo").summary())
    n_sharded = sum(d >= 0 for ds in cp.zero_dims()
                    for d in tree_leaves(ds))
    print(f"ZeRO-2 rest layout: {n_sharded} stack leaves sharded over the "
          "data replicas (gathered on use inside each step)\n")

    # 2. train over four ranks: gradients reduce-scatter over the data
    # group; each rank's AdamW moments cover its shard
    kind, staged = backend(args.device)
    print(f"training {args.steps} AdamW steps over {DP * PP} rank processes "
          f"({kind}{', staged' if staged else ''}, {args.device}):")
    train_over_ranks(args.device, args.steps)

    # 3. the tuner's ZeRO axes for the port's hardware preset
    tuner_table()


if __name__ == "__main__":
    main()
