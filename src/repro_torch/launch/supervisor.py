"""Multi-host training supervisor: the detect -> decide -> recover loop (the
port of ``repro.launch.supervisor``).

Spawns one worker subprocess per host over ``repro_torch.launch.train``,
then closes the loop the single-process trainer cannot: it *watches* the
workers (file-based heartbeats + process exit codes), *decides* what a
signal means (missed heartbeat -> suspect; persistent stall -> hung;
nonzero exit -> host down; exit code ``EXIT_ESCALATE`` -> the GradGuard
asked for a rollback), and *recovers* (coordinated teardown, roll back to
the last verified-complete checkpoint, re-plan on the surviving device
count via ``core.tuner.shrink_plan``, relaunch on the shrunk plan) --
under an exponential-backoff restart budget so a persistent failure
aborts instead of crash-looping.

Escalation matrix (what each signal triggers):

    NaN batch             -> GradGuard skips the update (worker-local)
    skip budget blown     -> worker exits 43 -> rollback, same plan
    missed heartbeat      -> 'heartbeat-miss' event, host marked suspect
    persistent stall      -> host hung: killed -> rollback + shrink
    worker exit != 0      -> host down:        rollback + shrink
    straggler (slow host) -> 'straggler' event (report, no action)
    restart budget blown  -> abort

Every decision lands in ``<run-dir>/events.jsonl`` (one JSON object per
line: launch, gen-live, heartbeat-miss, hang, hostdown, escalate, anomaly,
straggler, rollback, shrink, restart, done, abort); ``--status`` renders
the log + live heartbeats without touching the training processes.

Where it differs from the JAX supervisor (its decisions do not):

- workers run ``repro_torch.launch.train``; the port's ``src`` goes on
  their ``PYTHONPATH`` and no ``XLA_FLAGS`` are set (a port worker runs
  all of its plan's pipeline devices in its one process);
- ``device`` (``--device``, default ``cuda``) is passed to every worker:
  workers run on the card unless the caller asks for the CPU;
- the port's workers run ``dp = 1`` without ZeRO, so a plan with
  ``dp > 1`` or ``zero_stage > 0`` raises ``NotImplementedError`` naming
  it, before any worker is launched and again on a shrink; the defaults
  are ``dp = 1, pp = 4`` (the JAX package's are ``dp = 2, pp = 2``: with
  either, ``dp x pp`` = hosts x devices per host), so losing one of two
  hosts folds the pipeline, ``shrink_plan(2, dp=1, pp=4) = (1, 2, 0)``.

This module is the control plane: it never calls into CUDA (its imports
load torch for the checkpoint reader but create no CUDA context), so it
still runs when the accelerator runtime is wedged.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.supervisor \
        --run-dir /tmp/sup --hosts 2 --steps 40 --faults hostdown@20:1
    PYTHONPATH=src python -m repro_torch.launch.supervisor \
        --run-dir /tmp/sup --hosts 2 --steps 12 --device cpu \
        --faults hang@6 --stall-timeout 4 --miss-budget 2
    PYTHONPATH=src python -m repro_torch.launch.supervisor \
        --run-dir /tmp/sup --status
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

from repro_torch.checkpoint.store import latest_step
from repro_torch.core.tuner import shrink_plan
from repro_torch.runtime.resilience import (EXIT_ESCALATE, StragglerDetector,
                                            Watchdog, read_heartbeats)

EVENTS_FILE = "events.jsonl"


# ---------------------------------------------------------------------------
# Structured event log
# ---------------------------------------------------------------------------

class EventLog:
    """Append-only JSONL event stream (one self-contained object per
    line; a torn tail line -- crashed writer -- is skipped on read)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def emit(self, kind: str, **fields) -> dict:
        doc = {"t": time.time(), "kind": kind, **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(doc) + "\n")
        detail = ", ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[supervisor] {kind}" + (f" ({detail})" if detail else ""))
        sys.stdout.flush()
        return doc


def read_events(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


# ---------------------------------------------------------------------------
# Config / result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SupervisorConfig:
    run_dir: str                    # events.jsonl, heartbeats, logs, results
    num_hosts: int = 2
    devices_per_host: int = 2
    steps: int = 40
    global_batch: int = 8
    arch: str = "uvit-nano"
    dp: int = 1
    pp: int = 4
    zero_stage: int = 0
    microbatches: int = 4
    wire_dtype: str = "float32"
    lr: float = 3e-4
    ckpt_dir: str | None = None     # default: <run_dir>/ckpt
    ckpt_every: int = 10
    keep: int = 3
    faults: str | None = None       # injected into generation 0 only
    relaunch_faults: str | None = None   # injected into every relaunch
    nan_skip_budget: int = 3
    escalation: str = "rollback"
    # watchdog / detection knobs
    poll: float = 0.2               # monitor poll interval (s)
    stall_timeout: float = 10.0     # s without step progress -> suspect
    startup_timeout: float = 300.0  # pre-first-train-step allowance
    miss_budget: int = 3            # suspect -> hung multiplier
    straggler_factor: float = 2.0
    straggler_patience: int = 3
    # recovery policy
    max_restarts: int = 3
    backoff_base: float = 1.0       # restart n sleeps base * 2**(n-1)
    commit_timeout: float = 60.0    # worker-side checkpoint barrier
    worker_env: dict = dataclasses.field(default_factory=dict)
    log_every: int = 10
    device: str = "cuda"            # every worker's --device


@dataclasses.dataclass
class SupervisorResult:
    ok: bool
    outcome: str                    # done | abort
    generations: int                # launches performed (>= 1)
    restarts: int
    final_hosts: int
    final_plan: tuple               # (dp, pp, zero_stage)
    events_path: str
    losses: dict                    # merged step -> loss across generations


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------

class _Worker:
    def __init__(self, host_id: int, proc: subprocess.Popen, log: str,
                 out_json: str):
        self.host_id = host_id
        self.proc = proc
        self.log = log
        self.out_json = out_json


def _check_plan(plan) -> None:
    dp, pp, zero = plan
    if dp > 1 or zero > 0:
        raise NotImplementedError(
            f"the plan dp={dp} pp={pp} zero_stage={zero}: data parallelism "
            "and ZeRO are not yet ported to repro_torch (its workers run "
            "dp=1, zero_stage=0)")


class Supervisor:
    def __init__(self, cfg: SupervisorConfig):
        self.cfg = cfg
        os.makedirs(cfg.run_dir, exist_ok=True)
        self.ckpt_dir = cfg.ckpt_dir or os.path.join(cfg.run_dir, "ckpt")
        self.hb_dir = os.path.join(cfg.run_dir, "hb")
        self.log_dir = os.path.join(cfg.run_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self.events = EventLog(os.path.join(cfg.run_dir, EVENTS_FILE))

    # ---- launch ------------------------------------------------------

    def _worker_cmd(self, host_id: int, num_hosts: int, plan, gen: int,
                    faults: str | None, out_json: str) -> list[str]:
        dp, pp, zero = plan
        cmd = [sys.executable, "-m", "repro_torch.launch.train",
               "--arch", self.cfg.arch, "--pipeline",
               "--steps", str(self.cfg.steps),
               "--global-batch", str(self.cfg.global_batch),
               "--lr", str(self.cfg.lr),
               "--devices", str(dp * pp), "--dp", str(dp), "--pp", str(pp),
               "--zero-stage", str(zero),
               "--microbatches", str(self.cfg.microbatches),
               "--wire-dtype", self.cfg.wire_dtype,
               "--ckpt-dir", self.ckpt_dir,
               "--ckpt-every", str(self.cfg.ckpt_every),
               "--keep", str(self.cfg.keep), "--resume",
               "--host-id", str(host_id), "--num-hosts", str(num_hosts),
               "--heartbeat-dir", self.hb_dir, "--gen", str(gen),
               "--commit-timeout", str(self.cfg.commit_timeout),
               "--nan-skip-budget", str(self.cfg.nan_skip_budget),
               "--escalation", self.cfg.escalation,
               "--log-every", str(self.cfg.log_every),
               "--device", self.cfg.device,
               "--out-json", out_json]
        if faults:
            cmd += ["--faults", faults]
        return cmd

    def _worker_env(self) -> dict:
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = src + os.pathsep * bool(env.get("PYTHONPATH")) \
            + env.get("PYTHONPATH", "")
        env.pop("REPRO_FAULTS", None)   # faults go through the CLI only
        env.update(self.cfg.worker_env)
        return env

    def _launch(self, num_hosts: int, plan, gen: int,
                faults: str | None) -> list[_Worker]:
        workers = []
        for h in range(num_hosts):
            log = os.path.join(self.log_dir, f"worker_h{h}.g{gen}.log")
            out = os.path.join(self.log_dir, f"result_h{h}.g{gen}.json")
            cmd = self._worker_cmd(h, num_hosts, plan, gen, faults, out)
            with open(log, "w") as lf:
                proc = subprocess.Popen(cmd, env=self._worker_env(),
                                        stdout=lf, stderr=subprocess.STDOUT)
            workers.append(_Worker(h, proc, log, out))
        self.events.emit("launch", gen=gen, hosts=num_hosts,
                         plan={"dp": plan[0], "pp": plan[1],
                               "zero_stage": plan[2]},
                         faults=faults or "")
        return workers

    def _teardown(self, workers: list[_Worker]) -> None:
        for w in workers:
            if w.proc.poll() is None:
                w.proc.terminate()
        deadline = time.time() + 5.0
        for w in workers:
            if w.proc.poll() is None:
                try:
                    w.proc.wait(timeout=max(deadline - time.time(), 0.1))
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait()

    # ---- monitor -----------------------------------------------------

    def _monitor(self, workers: list[_Worker], gen: int
                 ) -> tuple[str, list[int]]:
        """Watch one generation until it finishes or fails.

        Returns ``(outcome, hosts)``: ``("done", [])``, ``("escalate",
        [h])`` (rollback, same plan), or ``("hostdown", dead_hosts)``
        (rollback + shrink; includes hung hosts the supervisor killed).
        """
        cfg = self.cfg
        hosts = [w.host_id for w in workers]
        dog = Watchdog(hosts, stall_timeout=cfg.stall_timeout,
                       startup_timeout=cfg.startup_timeout,
                       miss_budget=cfg.miss_budget)
        straggle = StragglerDetector(factor=cfg.straggler_factor,
                                     patience=cfg.straggler_patience)
        verdicts = {h: "ok" for h in hosts}
        flagged: set[int] = set()
        anomalous: set[tuple[int, int]] = set()
        live = True
        while True:
            time.sleep(cfg.poll)
            beats = read_heartbeats(self.hb_dir, gen=gen)
            dog.observe(beats)
            straggle.observe(beats)

            if live and beats and all(
                    beats[h].phase in ("train", "ckpt", "done")
                    for h in hosts if h in beats) \
                    and all(h in beats for h in hosts):
                self.events.emit("gen-live", gen=gen, hosts=len(hosts))
                live = False

            for h, hb in beats.items():
                key = (h, hb.step)
                bad_loss = hb.loss is not None and not _finite(hb.loss)
                bad_norm = (hb.grad_norm is not None
                            and not _finite(hb.grad_norm))
                if (bad_loss or bad_norm) and key not in anomalous:
                    anomalous.add(key)
                    self.events.emit("anomaly", gen=gen, host=h,
                                     step=hb.step, loss=hb.loss,
                                     grad_norm=hb.grad_norm)

            # process exits take precedence over heartbeat inference
            dead, escalated, running = [], [], []
            for w in workers:
                rc = w.proc.poll()
                if rc is None:
                    running.append(w)
                elif rc == EXIT_ESCALATE:
                    escalated.append(w.host_id)
                elif rc != 0:
                    dead.append(w.host_id)
            if escalated:
                self.events.emit("escalate", gen=gen, hosts=escalated)
                return "escalate", escalated
            if dead:
                for h in dead:
                    self.events.emit("hostdown", gen=gen, host=h,
                                     rc=next(w.proc.returncode
                                             for w in workers
                                             if w.host_id == h))
                return "hostdown", dead
            if not running:
                return "done", []

            checks = dog.check()
            hung = []
            for h in hosts:
                v = checks[h]
                if v != verdicts[h]:
                    if v == "suspect":
                        self.events.emit("heartbeat-miss", gen=gen, host=h,
                                         age=round(dog.age(h), 2))
                    verdicts[h] = v
                if v == "hung" and any(w.host_id == h
                                       and w.proc.poll() is None
                                       for w in workers):
                    hung.append(h)
            if hung:
                # one hung host wedges its peers (stuck collectives, the
                # checkpoint commit barrier), so several hosts stall at
                # once: attribute the hang to the ROOT cause -- the hung
                # host(s) with the least step progress -- and count the
                # rest as survivors for the shrink
                low = min(dog.progress(h)[1] for h in hung)
                roots = [h for h in hung if dog.progress(h)[1] == low]
                for h in roots:
                    self.events.emit("hang", gen=gen, host=h,
                                     age=round(dog.age(h), 2),
                                     step=dog.progress(h)[1])
                return "hostdown", roots

            for h, ratio in straggle.stragglers().items():
                if h not in flagged:
                    flagged.add(h)
                    self.events.emit("straggler", gen=gen, host=h,
                                     ratio=round(ratio, 2))

    # ---- recover -----------------------------------------------------

    def run(self) -> SupervisorResult:
        cfg = self.cfg
        num_hosts = cfg.num_hosts
        plan = (cfg.dp, cfg.pp, cfg.zero_stage)
        _check_plan(plan)
        losses: dict[int, float] = {}
        gen, restarts = 0, 0
        faults = cfg.faults
        while True:
            workers = self._launch(num_hosts, plan, gen, faults)
            outcome, bad = self._monitor(workers, gen)
            self._teardown(workers)
            self._collect_losses(workers, losses)
            if outcome == "done":
                self.events.emit("done", gen=gen,
                                 steps=cfg.steps, hosts=num_hosts)
                return SupervisorResult(
                    True, "done", gen + 1, restarts, num_hosts, plan,
                    self.events.path, losses)

            restarts += 1
            if restarts > cfg.max_restarts:
                self.events.emit("abort", gen=gen, restarts=restarts - 1,
                                 reason="restart budget exhausted")
                return SupervisorResult(
                    False, "abort", gen + 1, restarts - 1, num_hosts, plan,
                    self.events.path, losses)

            step = latest_step(self.ckpt_dir)
            self.events.emit("rollback", gen=gen, step=step,
                             reason=outcome)
            if outcome == "hostdown":
                survivors = num_hosts - len(bad)
                if survivors < 1:
                    self.events.emit("abort", gen=gen, restarts=restarts,
                                     reason="no surviving hosts")
                    return SupervisorResult(
                        False, "abort", gen + 1, restarts, 0, plan,
                        self.events.path, losses)
                new_plan = shrink_plan(
                    survivors * cfg.devices_per_host, dp=plan[0],
                    pp=plan[1], zero_stage=plan[2])
                _check_plan(new_plan)
                self.events.emit(
                    "shrink", gen=gen, hosts=survivors, lost=bad,
                    plan={"dp": new_plan[0], "pp": new_plan[1],
                          "zero_stage": new_plan[2]})
                num_hosts, plan = survivors, new_plan

            delay = cfg.backoff_base * (2 ** (restarts - 1))
            self.events.emit("restart", gen=gen + 1, attempt=restarts,
                             budget=cfg.max_restarts,
                             backoff_s=round(delay, 2))
            time.sleep(delay)
            gen += 1
            faults = cfg.relaunch_faults

    def _collect_losses(self, workers: list[_Worker],
                        losses: dict[int, float]) -> None:
        """Merge a generation's step->loss map (workers are replicas of the
        same computation, so any one host's trajectory is THE trajectory;
        post-rollback steps overwrite their first attempt)."""
        for w in workers:
            try:
                with open(w.out_json) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            for k, v in doc.get("losses", {}).items():
                losses[int(k)] = v


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


# ---------------------------------------------------------------------------
# Status reader
# ---------------------------------------------------------------------------

def format_status(run_dir: str, *, tail: int = 12) -> str:
    """Render a run's event log + live heartbeats (read-only)."""
    events = read_events(os.path.join(run_dir, EVENTS_FILE))
    lines = [f"supervisor run: {run_dir}"]
    if not events:
        return lines[0] + "\n  (no events yet)"
    t0 = events[0]["t"]
    counts: dict[str, int] = {}
    for e in events:
        counts[e["kind"]] = counts.get(e["kind"], 0) + 1
    lines.append("  events: " + ", ".join(
        f"{k} x{n}" for k, n in sorted(counts.items())))
    for e in events[-tail:]:
        extra = {k: v for k, v in e.items() if k not in ("t", "kind")}
        detail = ", ".join(f"{k}={v}" for k, v in extra.items())
        lines.append(f"  +{e['t'] - t0:8.2f}s  {e['kind']:<15}"
                     + (f" {detail}" if detail else ""))
    beats = read_heartbeats(os.path.join(run_dir, "hb"))
    if beats:
        now = time.time()
        lines.append("  heartbeats:")
        for h in sorted(beats):
            hb = beats[h]
            loss = f" loss={hb.loss:.4f}" if hb.loss is not None else ""
            lines.append(
                f"    host {h}: gen {hb.gen} {hb.phase} step {hb.step}"
                f"{loss} ({now - hb.t:.1f}s ago, pid {hb.pid})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", required=True,
                    help="supervisor state root (events.jsonl, heartbeats, "
                         "worker logs, checkpoints)")
    ap.add_argument("--status", action="store_true",
                    help="print the run's event log + heartbeats and exit")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--devices-per-host", type=int, default=2)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--arch", default="uvit-nano")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree (only 1 is ported)")
    ap.add_argument("--pp", type=int, default=4)
    ap.add_argument("--zero-stage", type=int, default=0, choices=(0, 1, 2))
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--wire-dtype", default="float32")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--faults", default=None,
                    help="fault plan injected into generation 0 (e.g. "
                         "'hostdown@20:1' or 'hang@15')")
    ap.add_argument("--relaunch-faults", default=None,
                    help="fault plan injected into every relaunch "
                         "(e.g. 'iofail@0:2' to stress rollback)")
    ap.add_argument("--escalation", default="rollback",
                    choices=("abort", "rollback"))
    ap.add_argument("--nan-skip-budget", type=int, default=3)
    ap.add_argument("--stall-timeout", type=float, default=10.0)
    ap.add_argument("--startup-timeout", type=float, default=300.0)
    ap.add_argument("--miss-budget", type=int, default=3)
    ap.add_argument("--poll", type=float, default=0.2)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--backoff-base", type=float, default=1.0)
    ap.add_argument("--straggler-factor", type=float, default=2.0)
    ap.add_argument("--straggler-patience", type=int, default=3)
    ap.add_argument("--commit-timeout", type=float, default=60.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every worker runs its model")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.status:
        print(format_status(args.run_dir))
        return 0
    cfg = SupervisorConfig(
        run_dir=args.run_dir, num_hosts=args.hosts,
        devices_per_host=args.devices_per_host, steps=args.steps,
        global_batch=args.global_batch, arch=args.arch, dp=args.dp,
        pp=args.pp, zero_stage=args.zero_stage,
        microbatches=args.microbatches, wire_dtype=args.wire_dtype,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        faults=args.faults, relaunch_faults=args.relaunch_faults,
        escalation=args.escalation, nan_skip_budget=args.nan_skip_budget,
        stall_timeout=args.stall_timeout,
        startup_timeout=args.startup_timeout, miss_budget=args.miss_budget,
        poll=args.poll, max_restarts=args.max_restarts,
        backoff_base=args.backoff_base,
        straggler_factor=args.straggler_factor,
        straggler_patience=args.straggler_patience,
        commit_timeout=args.commit_timeout, device=args.device)
    res = Supervisor(cfg).run()
    print(f"[supervisor] {res.outcome}: {res.generations} generation(s), "
          f"{res.restarts} restart(s), final plan dp={res.final_plan[0]} "
          f"pp={res.final_plan[1]} zero={res.final_plan[2]} on "
          f"{res.final_hosts} host(s)")
    return 0 if res.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
