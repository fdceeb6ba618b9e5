"""Multi-host training supervisor: the detect -> decide -> recover loop (the
port of ``repro.launch.supervisor``).

Runs every generation as one world of rank processes of
``repro_torch.launch.train``, grouped by host: host ``h`` of ``H`` owns ranks
``[h x devices_per_host, (h+1) x devices_per_host)`` (``launch.mesh.
HostTopology``), and ``dp x pp = H x devices_per_host``.  Then it closes the
loop the trainer cannot: it *watches* the hosts (file-based heartbeats + the
ranks' exit codes), *decides* what a signal means (missed heartbeat ->
suspect; persistent stall -> hung; a rank's nonzero exit -> host down; exit
code ``EXIT_ESCALATE`` -> the GradGuard asked for a rollback), and
*recovers* (teardown of the whole world, roll back to the last
verified-complete checkpoint, re-plan on the surviving device count via
``core.tuner.shrink_plan``, relaunch a smaller world on the survivors,
whose ranks restore the checkpoint on their plan) -- under an
exponential-backoff restart budget so a persistent failure aborts instead
of crash-looping.

Escalation matrix (what each signal triggers):

    NaN batch             -> GradGuard skips the update (every rank)
    skip budget blown     -> ranks exit 43 -> rollback, same plan
    missed heartbeat      -> 'heartbeat-miss' event, host marked suspect
    persistent stall      -> host hung: killed -> rollback + shrink
    a rank exits != 0, 44 -> host down:        rollback + shrink
    ranks exit 44 only    -> peer lost, nobody to blame: rollback, same plan
    straggler (slow host) -> 'straggler' event (report, no action)
    restart budget blown  -> abort

Every decision lands in ``<run-dir>/events.jsonl`` (one JSON object per
line: launch, gen-live, heartbeat-miss, hang, hostdown, escalate,
peer-lost, anomaly, straggler, rollback, shrink, restart, done, abort);
``--status`` renders the log + live heartbeats without touching the
training processes.

Where it differs from the JAX supervisor (its decisions do not):

- a JAX worker is a host process running its host's devices; here a host
  is a group of rank processes, one per device, each spawned by the
  supervisor with the environment ``torchrun`` would give it (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``) in a session of its own; as torchrun's
  agent does, the supervisor hosts each generation's rendezvous store, on
  a port the OS picks when it binds it (``TORCHELASTIC_USE_AGENT_STORE``:
  every rank is a client), so no rank can lose its port to another
  process; teardown signals each rank's process group (terminate, kill
  after 5 s).  No ``torchrun`` agent runs a host: it exits 1 for any failed
  child, which would lose 42 (host down) against 43 (escalate).  The
  port's ``src`` goes on their ``PYTHONPATH``; no ``XLA_FLAGS`` are set;
- a host's verdict comes from its ranks' exit codes: any 43 ->
  ``escalate``; any other nonzero code but ``EXIT_PEER_LOST`` (44, a rank
  whose collective failed because a peer is gone) -> ``hostdown``; a host
  whose ranks exited 44 is not counted as down.  Ranks fail together, so
  once one has exited 43 or a code that blames its host, the verdict
  waits up to ``SETTLE_S`` for the rest of the world to exit too.  A
  generation that ends with peer-lost exits and no host to blame
  (``peer-lost``) rolls back on the same plan, as an escalation does;
- ranks run in lockstep, so a host that hangs before step K stalls its
  peers inside step K, on the same last ``train`` beat: the hang's root is
  chosen among every stalled host (hung or suspect) by the later of its
  last heartbeat's step and the step its ranks last entered (the
  ``enter`` beats, ``runtime.resilience.ENTRY_BEATS``);
- ``device`` (``--device``, default ``cuda``) is passed to every rank:
  ranks run on the card unless the caller asks for the CPU.  With at least
  one card a rank visible, each host sees only its own cards
  (``CUDA_VISIBLE_DEVICES``, the cards as ``nvidia-smi`` lists them) and
  the ranks keep the trainer's NCCL ring; with fewer, the ranks share the
  cards over ``--ring gloo`` (NCCL refuses two ranks on one card).
- the trainer's one-process ``--host-id/--num-hosts`` worker mode (a
  FileBarrier start, one shard a host, the commit barrier) is not launched
  here: it runs as the JAX trainer's hosts do, a process a host started by
  hand, and this supervisor has one launch path, ranks.

This module is the control plane: it never calls into CUDA (its imports
load torch for the checkpoint reader but create no CUDA context), so it
still runs when the accelerator runtime is wedged.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.supervisor \
        --run-dir /tmp/sup --hosts 2 --dp 2 --pp 2 --steps 40 \
        --faults hostdown@20:1                    # four ranks on one card
    PYTHONPATH=src python -m repro_torch.launch.supervisor \
        --run-dir /tmp/sup --hosts 2 --dp 2 --pp 2 --steps 12 \
        --device cpu --faults hang@6 --stall-timeout 8 --miss-budget 2
    PYTHONPATH=src python -m repro_torch.launch.supervisor \
        --run-dir /tmp/sup --status
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

from repro_torch.checkpoint.store import latest_step
from repro_torch.core.tuner import shrink_plan
from repro_torch.launch.mesh import HostTopology
from repro_torch.runtime.resilience import (ENTRY_BEATS, EXIT_ESCALATE,
                                            EXIT_PEER_LOST,
                                            StragglerDetector, Watchdog,
                                            read_heartbeats)

EVENTS_FILE = "events.jsonl"
# seconds the verdict waits, once a rank has escalated or gone down, for
# the rest of the world to exit too (ranks in lockstep fail within a moment
# of each other: every host that escalated or went down with it counts)
SETTLE_S = 2.0


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
    layers: int | None = None       # every rank's --layers (None: full)
    dp: int = 2
    pp: int = 2
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
    worker_env: dict = dataclasses.field(default_factory=dict)
    log_every: int = 10
    device: str = "cuda"            # every rank's --device


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

class _Rank:
    """One rank process of a generation: its host, its rank, its log and
    its result file."""

    def __init__(self, host_id: int, rank: int, proc: subprocess.Popen,
                 log: str, out_json: str):
        self.host_id = host_id
        self.rank = rank
        self.proc = proc
        self.log = log
        self.out_json = out_json


def _rendezvous_store():
    """A generation's rendezvous store, served by the supervisor as
    torchrun's agent serves it, on a port the OS picks as it binds it: a
    fresh one for each generation (a torn-down generation's port may linger
    in TIME_WAIT), and no rank's bind can race another process for it."""
    from torch.distributed import TCPStore
    return TCPStore("127.0.0.1", 0, is_master=True)


def _signal_group(proc: subprocess.Popen, sig: int) -> None:
    """``sig`` to the process group a rank leads (its session's), which
    reaches whatever the rank started too."""
    try:
        os.killpg(proc.pid, sig)
    except ProcessLookupError:
        pass


class Supervisor:
    def __init__(self, cfg: SupervisorConfig):
        self.cfg = cfg
        os.makedirs(cfg.run_dir, exist_ok=True)
        self.ckpt_dir = cfg.ckpt_dir or os.path.join(cfg.run_dir, "ckpt")
        self.hb_dir = os.path.join(cfg.run_dir, "hb")
        self.log_dir = os.path.join(cfg.run_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self.events = EventLog(os.path.join(cfg.run_dir, EVENTS_FILE))
        self.cards = self._cards()
        self.store = None               # the live generation's rendezvous

    # ---- launch ------------------------------------------------------

    def _worker_cmd(self, host_id: int, num_hosts: int, plan, gen: int,
                    faults: str | None, out_json: str) -> list[str]:
        """Every rank of host ``host_id``'s command (``out_json`` holds the
        ``{rank}`` field the trainer fills in); the rank is in its
        environment (:meth:`_rank_env`).  Ranks that share cards (fewer
        than a rank each) move their hops over the staged gloo ring."""
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
               "--nan-skip-budget", str(self.cfg.nan_skip_budget),
               "--escalation", self.cfg.escalation,
               "--log-every", str(self.cfg.log_every),
               "--device", self.cfg.device,
               "--out-json", out_json]
        if self.cfg.layers is not None:
            cmd += ["--layers", str(self.cfg.layers)]
        if self.cfg.device == "cuda" and len(self.cards) < dp * pp:
            cmd += ["--ring", "gloo"]
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

    def _cards(self) -> list[str]:
        """The cards the ranks may use: ``CUDA_VISIBLE_DEVICES`` of the
        ranks' environment when it is set, else every card ``nvidia-smi``
        lists, by UUID; none on the CPU or without ``nvidia-smi``."""
        if self.cfg.device != "cuda":
            return []
        vis = self._worker_env().get("CUDA_VISIBLE_DEVICES")
        if vis is not None:
            return [c.strip() for c in vis.split(",") if c.strip()]
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                                  "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            return []
        return smi.stdout.split() if smi.returncode == 0 else []

    def _rank_env(self, topo: HostTopology, rank: int, port: int) -> dict:
        """Rank ``rank``'s environment: torchrun's, with host ``h``'s
        ``devices_per_host`` ranks as its local world, and with at least
        one card a rank, host ``h``'s cards alone visible.  ``port`` is the
        generation's store's, which the ranks join as clients."""
        env = self._worker_env()
        h = topo.host_of_device(rank)
        mine = topo.host_devices(h)
        env.update(RANK=str(rank), WORLD_SIZE=str(topo.num_devices),
                   LOCAL_RANK=str(rank - mine.start),
                   LOCAL_WORLD_SIZE=str(topo.devices_per_host),
                   GROUP_RANK=str(h), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), TORCHELASTIC_USE_AGENT_STORE="True")
        if len(self.cards) >= topo.num_devices:
            env["CUDA_VISIBLE_DEVICES"] = ",".join(self.cards[i]
                                                   for i in mine)
        return env

    def _launch(self, num_hosts: int, plan, gen: int,
                faults: str | None) -> list[_Rank]:
        topo = HostTopology(num_hosts, self.cfg.devices_per_host)
        dp, pp, zero = plan
        if dp * pp != topo.num_devices:
            raise ValueError(f"the plan dp={dp} x pp={pp} needs {dp * pp} "
                             f"ranks; {num_hosts} hosts x "
                             f"{self.cfg.devices_per_host} devices hold "
                             f"{topo.num_devices}")
        self.store = _rendezvous_store()
        ranks = []
        for r in range(topo.num_devices):
            h = topo.host_of_device(r)
            log = os.path.join(self.log_dir, f"worker_h{h}.r{r}.g{gen}.log")
            out = os.path.join(self.log_dir,
                               f"result_h{h}.r{{rank}}.g{gen}.json")
            cmd = self._worker_cmd(h, num_hosts, plan, gen, faults, out)
            with open(log, "w") as lf:
                proc = subprocess.Popen(
                    cmd, env=self._rank_env(topo, r, self.store.port),
                    stdout=lf,
                    stderr=subprocess.STDOUT, start_new_session=True)
            ranks.append(_Rank(h, r, proc, log, out.format(rank=r)))
        self.events.emit("launch", gen=gen, hosts=num_hosts,
                         plan={"dp": dp, "pp": pp, "zero_stage": zero},
                         faults=faults or "", ranks=topo.num_devices)
        return ranks

    def _teardown(self, ranks: list[_Rank]) -> None:
        """End every rank of a generation and whatever it started: SIGTERM
        to each rank's process group, SIGKILL to every group still there
        5 s later; then close the generation's store."""
        for r in ranks:
            _signal_group(r.proc, signal.SIGTERM)
        deadline = time.time() + 5.0
        for r in ranks:
            try:
                r.proc.wait(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                pass
        for r in ranks:
            _signal_group(r.proc, signal.SIGKILL)
            r.proc.wait()
        self.store = None

    # ---- monitor -----------------------------------------------------

    def _monitor(self, ranks: list[_Rank], gen: int
                 ) -> tuple[str, list[int]]:
        """Watch one generation until it finishes or fails.

        Returns ``(outcome, hosts)``: ``("done", [])``, ``("escalate",
        [h])`` (rollback, same plan), ``("peer-lost", [])`` (rollback, same
        plan: ranks lost a peer and no host is to blame), or
        ``("hostdown", dead_hosts)`` (rollback + shrink; includes hung
        hosts the supervisor killed).
        """
        cfg = self.cfg
        hosts = sorted({r.host_id for r in ranks})
        of_host = {h: [r for r in ranks if r.host_id == h] for h in hosts}
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
            # the hosts' ranks run in lockstep: a straggler shows in when
            # its ranks enter each step, not in the step times
            straggle.observe_entries(read_heartbeats(
                os.path.join(self.hb_dir, ENTRY_BEATS), gen=gen))

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

            # process exits take precedence over heartbeat inference; a
            # host's verdict is its ranks' exit codes, read once the world
            # has settled
            dead, escalated, running, lost = _exits(of_host)
            if (dead or escalated) and running:
                settle = time.time() + SETTLE_S
                while running and time.time() < settle:
                    time.sleep(0.05)
                    dead, escalated, running, lost = _exits(of_host)
            if escalated:
                self.events.emit("escalate", gen=gen, hosts=escalated)
                return "escalate", escalated
            if dead:
                for h, rc in dead.items():
                    self.events.emit("hostdown", gen=gen, host=h, rc=rc)
                return "hostdown", list(dead)
            if not running:
                if lost:
                    self.events.emit("peer-lost", gen=gen, hosts=lost)
                    return "peer-lost", []
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
                if v == "hung" and h in running:
                    hung.append(h)
            if hung:
                # one hung host wedges its peers (stuck collectives, the
                # checkpoint commit barrier), so several hosts stall at
                # once: attribute the hang to the ROOT cause -- the host(s)
                # with the least step progress -- and count the rest as
                # survivors for the shrink.  Ranks stall in lockstep, on
                # the same last train beat and within a poll of each
                # other: every stalled host is a candidate, and the step
                # its ranks entered counts as progress
                entered = read_heartbeats(os.path.join(self.hb_dir,
                                                       ENTRY_BEATS), gen=gen)

                def reach(h):
                    return max(dog.progress(h)[1],
                               entered[h].step if h in entered else -2)

                stalled = [h for h in hosts if h in running
                           and verdicts[h] in ("hung", "suspect")]
                low = min(reach(h) for h in stalled)
                roots = [h for h in stalled if reach(h) == low]
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
        losses: dict[int, float] = {}
        gen, restarts = 0, 0
        faults = cfg.faults
        while True:
            ranks = self._launch(num_hosts, plan, gen, faults)
            outcome, bad = self._monitor(ranks, gen)
            self._teardown(ranks)
            self._collect_losses(ranks, losses)
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

    def _collect_losses(self, ranks: list[_Rank],
                        losses: dict[int, float]) -> None:
        """Merge a generation's step->loss map (every rank records the
        step's reduced loss, so any one rank's trajectory is THE
        trajectory; post-rollback steps overwrite their first attempt)."""
        for r in ranks:
            try:
                with open(r.out_json) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            for k, v in doc.get("losses", {}).items():
                losses[int(k)] = v


def _exits(of_host: dict) -> tuple:
    """``(dead, escalated, running, lost)`` from each host's ranks' exit
    codes: host -> the first code that blames it (nonzero, not
    ``EXIT_PEER_LOST``), the hosts with a rank that exited
    ``EXIT_ESCALATE`` (not counted dead), those with a rank still running,
    and those with a rank that exited ``EXIT_PEER_LOST``."""
    dead, escalated, running, lost = {}, [], set(), []
    for h, ranks in of_host.items():
        codes = [r.proc.poll() for r in ranks]
        blame = [c for c in codes if c not in (None, 0, EXIT_PEER_LOST)]
        if EXIT_ESCALATE in codes:
            escalated.append(h)
        elif blame:
            dead[h] = blame[0]
        if None in codes:
            running.add(h)
        if EXIT_PEER_LOST in codes:
            lost.append(h)
    return dead, escalated, running, lost


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
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--pp", type=int, default=2)
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
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every rank runs its model (ranks that "
                         "share cards use the gloo ring)")
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
        device=args.device)
    res = Supervisor(cfg).run()
    print(f"[supervisor] {res.outcome}: {res.generations} generation(s), "
          f"{res.restarts} restart(s), final plan dp={res.final_plan[0]} "
          f"pp={res.final_plan[1]} zero={res.final_plan[2]} on "
          f"{res.final_hosts} host(s)")
    return 0 if res.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
