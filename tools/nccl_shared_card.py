#!/usr/bin/env python3
"""Does NCCL accept two ranks on one card?  Starts two processes that join
one NCCL process group on ``cuda:0`` (a localhost TCP store) and all-reduce
one tensor; prints what each rank saw, NCCL's error message if it refused,
and ``nccl two ranks on one card: refused|accepted`` as the last line.

    python3 tools/nccl_shared_card.py      # on a machine with one card

Exits 0 either way (the answer is the last line), 1 when there is no card.
Both processes are joined (and killed after 120 s) before it exits.
"""
import socket
import sys


def _rank(rank: int, port: int, q) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=2, timeout=datetime.timedelta(seconds=60))
        x = torch.ones(4, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        q.put((rank, "ok", f"all_reduce gave {x.tolist()}"))
    except Exception as e:                    # the answer this script reports
        q.put((rank, "error", f"{type(e).__name__}: {e}"))
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:
                pass


def main() -> None:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    print(f"card: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}); torch {torch.__version__}, "
          f"NCCL {torch.cuda.nccl.version()}", flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    while not q.empty():
        results.append(q.get())
    for rank, kind, msg in sorted(results):
        print(f"rank {rank}: {kind}: {msg}", flush=True)
    ok = len(results) == 2 and all(k == "ok" for _, k, _ in results)
    print(f"nccl two ranks on one card: {'accepted' if ok else 'refused'}",
          flush=True)


if __name__ == "__main__":
    main()
