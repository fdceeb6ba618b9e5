"""Multi-scenario fault-tolerance drill over the PyTorch/CUDA port's
trainer (the counterpart of ``examples/fault_tolerance.py``).

Each scenario launches ``repro_torch.launch.train`` -- one process, or a
world of rank processes under ``torchrun`` -- and injects faults through
the ``--faults`` plan (``runtime.resilience.FaultPlan``):

- ``kill-resume`` (also ``--fast``): a hard kill (``os._exit(42)``) at
  step K, a relaunch with ``--resume``; the stateless data pipeline
  regenerates the exact step stream.
- ``shrink-restore``: a P=2 x dp=2 ZeRO-2 pipeline over four ranks is
  hard-killed mid-run and resumed onto a *different* plan (P=1 x dp=2,
  ZeRO-0, two ranks); the resumed losses must match an uninterrupted
  reference run at rtol 1e-4 (fp32 wire).
- ``corrupt-shard``: a checkpoint shard is byte-flipped (by the fault
  plan) before the kill; the resume detects the bad SHA-256, falls back
  to the previous complete step, and still completes.
- ``io-backoff``: transient save failures are retried with exponential
  backoff; an exhausted retry budget degrades to keep-training-and-warn
  (the step loop never crashes on storage trouble).
- ``nan-guard``: a poisoned batch gives non-finite gradients; the guard
  skips the update and training recovers -- unless the consecutive-skip
  budget is exceeded, which aborts.

Runs on the card (the ranks of one card over the gloo ring, staged
through pinned host memory; NCCL where each rank has a card) unless
given ``--device cpu``.

    PYTHONPATH=src python examples/torch_fault_tolerance.py          # all
    PYTHONPATH=src python examples/torch_fault_tolerance.py --fast   # CI
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
    [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
             if p]))
DEVICE = "cuda"

PIPE = ["--pipeline", "--arch", "uvit", "--dp", "2", "--pp", "2",
        "--zero-stage", "2", "--microbatches", "2", "--global-batch", "4",
        "--steps", "12", "--ckpt-every", "4", "--log-every", "4",
        "--wire-dtype", "float32", "--lr", "1e-3"]


def _ring(nproc: int) -> list:
    """One card a rank takes NCCL; ranks that share a card or the CPU take
    the gloo ring."""
    if DEVICE == "cpu" or nproc == 1:
        return []
    import torch
    return ["--ring", "nccl" if torch.cuda.device_count() >= nproc
            else "gloo"]


def train(args, expect_rc=0, nproc=1):
    """Run the trainer (``nproc`` ranks under torchrun when more than
    one) and return its output.  A rank's exit code reaches torchrun's
    report, not its own: ``expect_rc`` then means torchrun failed with
    that rank exit code in its report."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train"]
    if nproc > 1:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(nproc), "-m",
               "repro_torch.launch.train"]
    r = subprocess.run(cmd + args + ["--device", DEVICE] + _ring(nproc),
                       env=ENV, capture_output=True, text=True)
    out = r.stdout + r.stderr
    ok = (r.returncode == expect_rc if nproc == 1 or expect_rc == 0 else
          r.returncode != 0 and f"exitcode  : {expect_rc}" in out)
    assert ok, (f"expected rc={expect_rc}, got {r.returncode}\n"
                f"STDOUT:\n{r.stdout[-3000:]}\nSTDERR:\n{r.stderr[-2000:]}")
    return out


def losses_of(path):
    with open(path) as f:
        doc = json.load(f)
    return {int(k): v for k, v in doc["losses"].items()}, doc


def check_traj(ref, got, what):
    assert got, f"{what}: no steps ran"
    for s, b in got.items():
        a = ref[s]
        assert abs(a - b) <= 1e-4 * abs(a) + 1e-6, \
            f"{what}: step {s} loss {b} != reference {a}"


def scenario_kill_resume(tmp):
    print("=== kill-resume: killed at step 60 (checkpoints every 25)")
    d = os.path.join(tmp, "kill")
    base = ["--arch", "uvit-h", "--steps", "100", "--ckpt-dir", d,
            "--ckpt-every", "25", "--global-batch", "8"]
    train(base + ["--faults", "kill@60"], expect_rc=42)
    print("=== node died (rc=42). relaunching with --resume")
    out = train(base + ["--resume"])
    assert "resumed from step 50" in out, out[-1500:]
    print("=== recovered and completed 100 steps.")


def scenario_shrink_restore(tmp):
    print("=== shrink-restore: P=2 dp=2 ZeRO-2 killed at step 10, "
          "resumed as P=1 dp=2 zero=0")
    ref_json = os.path.join(tmp, "ref{rank}.json")
    train(PIPE + ["--out-json", ref_json], nproc=4)
    ref, _ = losses_of(ref_json.format(rank=0))
    d = os.path.join(tmp, "shrink")
    train(PIPE + ["--ckpt-dir", d, "--faults", "kill@10"], expect_rc=42,
          nproc=4)
    out_json = os.path.join(tmp, "shrink{rank}.json")
    out = train(PIPE + ["--pp", "1", "--zero-stage", "0", "--ckpt-dir", d,
                        "--resume", "--out-json", out_json], nproc=2)
    got, doc = losses_of(out_json.format(rank=0))
    assert doc["resumed_step"] == 8 and doc["elastic"], doc
    assert "elastic restore: plan changed" in out
    check_traj(ref, got, "shrink-restore")
    print("=== elastic shrink reproduced the reference trajectory.")


def scenario_corrupt_shard(tmp):
    print("=== corrupt-shard: newest checkpoint byte-flipped before the "
          "kill; resume must fall back to the previous verified step")
    d = os.path.join(tmp, "corrupt")
    base = PIPE + ["--ckpt-dir", d, "--ckpt-every", "2"]
    train(base + ["--faults", "corrupt@5:shard_00000,kill@5"],
          expect_rc=42, nproc=4)
    out_json = os.path.join(tmp, "corrupt{rank}.json")
    out = train(base + ["--resume", "--out-json", out_json], nproc=4)
    _, doc = losses_of(out_json.format(rank=0))
    assert doc["resumed_step"] == 2, doc       # step 4 was corrupted
    assert "failed verification" in out and "fell back to step 2" in out
    print("=== checksum caught the corruption; fell back and completed.")


def scenario_io_backoff(tmp):
    print("=== io-backoff: transient save failures retry; exhausted "
          "retries degrade to keep-training-and-warn")
    sys.path.insert(0, SRC)
    from repro_torch.checkpoint import complete_steps

    d = os.path.join(tmp, "io1")
    out = train(PIPE + ["--ckpt-dir", d, "--faults", "iofail@4:2"], nproc=4)
    assert "retry" in out, out[-1500:]
    assert complete_steps(d)[-1] == 12
    d = os.path.join(tmp, "io2")
    out = train(PIPE + ["--ckpt-dir", d, "--faults", "iofail@8:4"], nproc=4)
    assert "training continues WITHOUT" in out, out[-1500:]
    assert complete_steps(d) == [4, 12], complete_steps(d)
    print("=== storage trouble never crashed the step loop.")


def scenario_nan_guard(tmp):
    print("=== nan-guard: poisoned batch skipped within budget; "
          "persistent NaNs abort")
    out_json = os.path.join(tmp, "nan{rank}.json")
    out = train(PIPE + ["--faults", "nan@6", "--out-json", out_json],
                nproc=4)
    assert "update skipped" in out, out[-1500:]
    _, doc = losses_of(out_json.format(rank=0))
    assert doc["skipped_steps"] == 1 and doc["final_loss"] is not None
    out = train(PIPE + ["--faults", "nan@2,nan@3,nan@4",
                        "--nan-skip-budget", "2"], expect_rc=1, nproc=4)
    assert "exceed the skip budget" in out, out[-1500:]
    print("=== guard skipped one bad step and aborted a divergence.")


SCENARIOS = {
    "kill-resume": scenario_kill_resume,
    "shrink-restore": scenario_shrink_restore,
    "corrupt-shard": scenario_corrupt_shard,
    "io-backoff": scenario_io_backoff,
    "nan-guard": scenario_nan_guard,
}

FAST = ("kill-resume",)


def main():
    global DEVICE
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="CI subset: kill/resume only")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("scenarios", nargs="*", metavar="scenario",
                    help=f"subset to run (default: all): {list(SCENARIOS)}")
    args = ap.parse_args()
    unknown = [s for s in args.scenarios if s not in SCENARIOS]
    if unknown:
        ap.error(f"unknown scenario(s) {unknown}; choose from "
                 f"{list(SCENARIOS)}")
    DEVICE = args.device
    names = args.scenarios or (FAST if args.fast else list(SCENARIOS))
    tmp = tempfile.mkdtemp(prefix="repro_torch_ft_")
    try:
        for name in names:
            SCENARIOS[name](tmp)
        print(f"FAULT TOLERANCE DRILL: {len(names)} scenario(s) OK")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
