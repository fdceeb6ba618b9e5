#!/usr/bin/env python3
"""How fast gloo moves a byte through each collective the data group
could use: all-reduce (fp32, bf16, uint8), gloo's own all-gather and
reduce-scatter (fp32), and the point-to-point exchange ``DataGroup`` runs
both of them as over gloo (``p2p halves``: each rank sends one half and
receives the other: a reduce-scatter of the bytes it hands, or an
all-gather of as many output bytes), between the two ranks of each of
``--groups`` pairs running at once (the hybrid plan's data groups), on CPU
tensors over localhost TCP.

    python3 tools/time_gloo.py [--mb 680] [--groups 2] [--repeats 3]

Prints one line per collective: the bytes each rank hands it (the
all-reduced tensor, the all-gather's output, the reduce-scatter's input),
the best of ``--repeats`` timed calls after a warm-up (host clock, rank 0,
after a barrier) and the rate.  These are host numbers: the staged data
group's CUDA tensors go through pinned host memory and then through the
same gloo calls.  Needs no card; all processes are joined before it exits.
"""
import argparse
import socket
import sys
import time

COLLECTIVES = ("all_reduce fp32", "all_reduce bf16", "all_reduce uint8",
               "all_gather uint8", "reduce_scatter fp32",
               "p2p halves")


def _rank(rank: int, world: int, port: int, nbytes: int, repeats: int,
          q) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    groups = [dist.new_group(list(range(j, world, world // 2)))
              for j in range(world // 2)]
    group = groups[rank % (world // 2)]
    u8 = torch.zeros(nbytes, dtype=torch.uint8)
    f32 = torch.zeros(nbytes // 4)
    bf16 = torch.zeros(nbytes // 2, dtype=torch.bfloat16)
    parts = [torch.empty(nbytes // 2, dtype=torch.uint8) for _ in range(2)]
    shard = torch.empty(nbytes // 8)
    peers = dist.get_process_group_ranks(group)
    peer = peers[1 - peers.index(rank)]
    got = torch.empty(nbytes // 2, dtype=torch.uint8)

    def p2p():      # the other rank's half out, this rank's half in
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, u8[nbytes // 2:], peer, group),
                dist.P2POp(dist.irecv, got, peer, group)]):
            w.wait()

    calls = {
        "all_reduce fp32": lambda: dist.all_reduce(f32, group=group),
        "all_reduce bf16": lambda: dist.all_reduce(bf16, group=group),
        "all_reduce uint8": lambda: dist.all_reduce(u8, group=group),
        "all_gather uint8": lambda: dist.all_gather(
            parts, u8[:nbytes // 2], group=group),
        "reduce_scatter fp32": lambda: dist.reduce_scatter_tensor(
            shard, f32, group=group),
        "p2p halves": p2p,
    }
    for name in COLLECTIVES:
        calls[name]()
        best = None
        for _ in range(repeats):
            dist.barrier()
            t0 = time.perf_counter()
            calls[name]()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        if rank == 0:
            q.put((name, best))
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    import multiprocessing as mp
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=680,
                    help="MiB each rank hands each collective")
    ap.add_argument("--groups", type=int, default=2,
                    help="two-rank groups running at once")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    nbytes = args.mb * 2 ** 20
    world = 2 * args.groups
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, world, port, nbytes,
                                             args.repeats, q))
             for r in range(world)]
    for p in procs:
        p.start()
    rows = [q.get(timeout=600) for _ in COLLECTIVES]
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
            p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    print(f"gloo, {world} processes in {args.groups} two-rank groups, "
          f"{nbytes} bytes a rank a call, best of {args.repeats}:")
    for name, dt in rows:
        print(f"  {name}: {dt:.4f} s, {nbytes / dt / 1e9:.3f} GB/s")
    if bad:
        sys.exit(f"ranks exited {bad}")


if __name__ == "__main__":
    main()
