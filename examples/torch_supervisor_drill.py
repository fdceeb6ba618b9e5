"""Training-supervisor drill matrix on the PyTorch/CUDA port: detect ->
decide -> recover (the counterpart of ``examples/supervisor_drill.py``).

Each scenario runs a real supervised cluster -- ``launch/supervisor.py``
launching, for every simulated host, the ranks of its devices as
``repro_torch.launch.train`` processes -- and exercises one arm of the
escalation matrix:

- ``hostdown`` (``--fast``): host 1 hard-exits mid-run; the supervisor
  sees the exit code, rolls back to the last verified checkpoint and
  relaunches shrunk (dp=2 x P=2 -> dp=1 x P=2 on the survivor).
- ``hang`` (``--fast``): host 0 stalls with its process alive (a stuck
  collective); the progress watchdog flags the ROOT hung host within
  ``stall_timeout * miss_budget`` and recovery proceeds as above.
- ``straggler``: host 1 runs 3x slow from step 4; the detector flags it
  from per-step timing medians -- report-only, the run completes with no
  restart.
- ``gradguard-escalate``: a persistent NaN stream exhausts the workers'
  skip budget; they exit ``EXIT_ESCALATE`` (43) and the supervisor rolls
  back to last-good WITHOUT shrinking (the hosts are healthy -- the
  *state* was poisoned), relaunching on the same plan.
- ``iofail-rollback``: transient save failures are injected into the
  post-rollback generation; the checkpoint manager's retry/backoff
  absorbs them and recovery still completes.

Every scenario leaves a structured ``events.jsonl`` and per-rank logs
under its run dir and prints the ``--status`` rendering.  The ranks run on
the card (several ranks of one card over the staged gloo ring) unless
given ``--device cpu``.

    PYTHONPATH=src python examples/torch_supervisor_drill.py          # all
    PYTHONPATH=src python examples/torch_supervisor_drill.py --fast   # CI
"""
import argparse
import glob
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

STEPS = 12
DEVICE = "cuda"


def _cfg(run_dir, **kw):
    from repro_torch.launch.supervisor import SupervisorConfig
    base = dict(run_dir=run_dir, num_hosts=2, devices_per_host=2,
                steps=STEPS, global_batch=8, arch="uvit-nano", dp=2,
                pp=2, microbatches=4, wire_dtype="float32", lr=1e-3,
                ckpt_every=4, stall_timeout=12.0, miss_budget=2, poll=0.2,
                backoff_base=0.2, log_every=4, device=DEVICE,
                worker_env={"OMP_NUM_THREADS": "1"})
    base.update(kw)
    return SupervisorConfig(**base)


def _run(cfg):
    from repro_torch.launch.supervisor import (Supervisor, format_status,
                                               read_events)
    res = Supervisor(cfg).run()
    print(format_status(cfg.run_dir))
    return res, [e["kind"] for e in read_events(res.events_path)]


def _expect(cond, msg):
    assert cond, msg


def scenario_hostdown(tmp):
    print("=== hostdown: host 1 exits after the step-8 commit")
    res, kinds = _run(_cfg(os.path.join(tmp, "hostdown"),
                           faults="hostdown@8:1"))
    _expect(res.ok and res.restarts == 1, f"{res.outcome}/{res.restarts}")
    _expect(res.final_hosts == 1 and res.final_plan == (1, 2, 0),
            f"{res.final_plan} on {res.final_hosts}")
    for k in ("hostdown", "rollback", "shrink", "restart", "done"):
        _expect(k in kinds, f"missing {k} in {kinds}")
    print("=== detected by exit code; rolled back + shrunk + finished.\n")


def scenario_hang(tmp):
    print("=== hang: host 0 freezes before step 6 (process stays alive)")
    res, kinds = _run(_cfg(os.path.join(tmp, "hang"), faults="hang@6"))
    _expect(res.ok and res.restarts == 1, f"{res.outcome}/{res.restarts}")
    _expect(res.final_hosts == 1, f"{res.final_hosts} hosts")
    _expect("hang" in kinds and "shrink" in kinds, kinds)
    print("=== watchdog flagged the frozen host; recovered shrunk.\n")


def scenario_straggler(tmp):
    print("=== straggler: host 1 runs 3x slow from step 4 (report-only)")
    res, kinds = _run(_cfg(os.path.join(tmp, "straggler"),
                           faults="slow@4:3.0:1", steps=16,
                           straggler_factor=1.8, straggler_patience=3,
                           # the healthy host legitimately waits on the
                           # straggler in every step's collectives -- keep
                           # the hang threshold above that lag
                           stall_timeout=15.0))
    _expect(res.ok and res.restarts == 0,
            f"straggler must not trigger recovery: {res.outcome}/"
            f"{res.restarts} restarts")
    _expect("straggler" in kinds, f"no straggler event in {kinds}")
    _expect("shrink" not in kinds, "straggler wrongly shrank the cluster")
    print("=== flagged from timing medians; run completed untouched.\n")


def scenario_gradguard_escalate(tmp):
    print("=== gradguard-escalate: NaN stream blows the skip budget; "
          "workers exit 43; rollback WITHOUT shrink")
    res, kinds = _run(_cfg(os.path.join(tmp, "escalate"),
                           faults="nan@6,nan@7,nan@8,nan@9",
                           nan_skip_budget=2))
    _expect(res.ok and res.restarts == 1, f"{res.outcome}/{res.restarts}")
    _expect(res.final_hosts == 2 and res.final_plan == (2, 2, 0),
            f"escalation must keep the plan: {res.final_plan} on "
            f"{res.final_hosts}")
    _expect("escalate" in kinds and "rollback" in kinds, kinds)
    _expect("shrink" not in kinds, "escalation wrongly shrank the cluster")
    # the monitor sees a non-finite loss only where a poll lands on a
    # skipped step's heartbeat: the escalating step's last beat is "done"
    print("=== non-finite loss " + ("flagged (anomaly event)" if "anomaly"
                                     in kinds else "not polled: no anomaly "
                                     "event"))
    print("=== poisoned state discarded; same plan relaunched clean.\n")


def scenario_iofail_rollback(tmp):
    print("=== iofail-rollback: transient save failures injected into "
          "the post-rollback generation")
    d = os.path.join(tmp, "iofail")
    res, kinds = _run(_cfg(d, faults="hostdown@8:1",
                           relaunch_faults="iofail@0:2"))
    _expect(res.ok and res.restarts == 1, f"{res.outcome}/{res.restarts}")
    _expect("hostdown" in kinds and "done" in kinds, kinds)
    text = ""
    for log in sorted(glob.glob(os.path.join(d, "logs",
                                             "worker_h0.r*.g1.log"))):
        with open(log) as f:
            text += f.read()
    _expect("retry" in text,
            f"no retry/backoff in the relaunched ranks: {text[-1500:]}")
    print("=== rollback survived flaky storage via retry/backoff.\n")


SCENARIOS = {
    "hostdown": scenario_hostdown,
    "hang": scenario_hang,
    "straggler": scenario_straggler,
    "gradguard-escalate": scenario_gradguard_escalate,
    "iofail-rollback": scenario_iofail_rollback,
}

FAST = ("hostdown", "hang")


def main():
    global DEVICE
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="CI subset: hostdown + hang")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--keep-run-dirs", action="store_true",
                    help="keep run dirs (events.jsonl, rank logs)")
    ap.add_argument("scenarios", nargs="*", metavar="scenario",
                    help=f"subset to run (default: all): {list(SCENARIOS)}")
    args = ap.parse_args()
    unknown = [s for s in args.scenarios if s not in SCENARIOS]
    if unknown:
        ap.error(f"unknown scenario(s) {unknown}; choose from "
                 f"{list(SCENARIOS)}")
    DEVICE = args.device
    names = args.scenarios or (FAST if args.fast else list(SCENARIOS))
    tmp = (os.environ.get("SUPERVISOR_DRILL_DIR")
           or tempfile.mkdtemp(prefix="repro_torch_supx_"))
    os.makedirs(tmp, exist_ok=True)
    try:
        for name in names:
            SCENARIOS[name](tmp)
        print(f"SUPERVISOR DRILL: {len(names)} scenario(s) OK")
    finally:
        if not args.keep_run_dirs and "SUPERVISOR_DRILL_DIR" not in \
                os.environ:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
