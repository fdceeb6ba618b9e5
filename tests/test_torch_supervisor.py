"""The port's supervisor control plane held to the JAX package's, without a
model.

- ``Watchdog`` verdicts, ages and progress points, and
  ``StragglerDetector`` flags and ratios, over the same scripted heartbeat
  sequences (explicit ``now``) as ``tests/test_supervisor.py`` and a grid
  around them: exactly equal;
- ``HostTopology`` over a grid of (hosts, devices per host) and stage
  placements, ``FileBarrier`` with a port barrier and a JAX barrier
  meeting in one directory, ``BarrierTimeout``'s fields, ``EventLog`` and
  ``read_events`` with a torn tail, and ``format_status`` with its
  "s ago" ages masked: exactly equal;
- both ``Supervisor`` classes over scripted workers (a stdlib script that
  writes heartbeats in the shared file format and exits with a scripted
  code; ``_worker_cmd`` patched on both: the JAX supervisor runs it once a
  host, the port's once a rank, two ranks a host, each rank writing its
  host's heartbeats and its own result file) and one checkpoint directory
  written by the port's ``save_checkpoint``, in seven scenarios (all ok,
  hostdown, a hang with two hosts stalled and the root attributed, an
  escalation, the restart budget spent, no surviving host, a straggler):
  event sequences equal in ``kind``, ``gen``, ``host``, ``step``,
  ``plan``, ``reason``, ``hosts`` and ``lost``, results equal but for
  ``events_path``;
- the CLI's defaults are the JAX supervisor's, and a rank's command and
  environment are what the trainer over ranks reads.

Timing of the scripted scenarios: the monitor polls every second and every
worker writes what it will write within a fraction of a second of its
launch (a straggler at half-second offsets between polls), so both
supervisors observe the same states at the same polls.  A poll comes at
least a second after the last, so a host frozen since the previous poll is
already past the watchdog's 0.75 s deadline (a heartbeat-miss) and a late
poll only moves the hang (at 4 x 0.75 s) to a later one, which the
compared fields do not see.
"""
import json
import os
import re
import sys
import threading
import time

import pytest
import torch

from repro.launch import mesh as jax_mesh
from repro.launch import supervisor as jax_sup
from repro.runtime import resilience as jax_res
from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import supervisor as port_sup
from repro_torch.runtime import resilience as port_res


# ---------------------------------------------------------------------------
# Watchdog and StragglerDetector, the same inputs through both classes
# ---------------------------------------------------------------------------

def _beats(mod, host, step, phase="train", t=0.0, step_s=None):
    return {host: mod.Heartbeat(host, step, phase, t=t, step_s=step_s)}


# each script: (constructor kwargs, [(now, host, step, phase) | ("check",
# now)]); every check compares verdicts, ages and progress points
WATCHDOG_SCRIPTS = {
    "progress-not-writes": (
        dict(hosts=[0], stall_timeout=10, miss_budget=3),
        [(0.0, 0, 0, "train"), (0.0, 0, 1, "train")]
        + [(float(t), 0, 1, "train") for t in range(1, 35)]
        + [("check", 11.0), ("check", 31.0), (31.0, 0, 2, "train"),
           ("check", 32.0)]),
    "startup-vs-stall": (
        dict(hosts=[0, 1], stall_timeout=5, startup_timeout=100,
             miss_budget=2),
        [(0.0, 0, -1, "init"), (0.0, 1, 0, "train"), (0.0, 1, 1, "train"),
         ("check", 20.0), ("check", 99.0), ("check", 101.0),
         ("check", 201.0)]),
    "unseen-host": (
        dict(hosts=[7], startup_timeout=100),
        [("check", 50.0), ("check", 101.0), ("check", 301.0)]),
    "first-train-lenient": (
        dict(hosts=[0], stall_timeout=5, startup_timeout=100, miss_budget=2),
        [(0.0, 0, 4, "train"), ("check", 20.0), ("check", 101.0),
         (101.0, 0, 5, "train"), ("check", 107.0), ("check", 112.0)]),
    "ckpt-and-done": (
        dict(hosts=[0], stall_timeout=5, miss_budget=2),
        [(0.0, 0, 3, "ckpt"), ("check", 6.0), ("check", 11.0),
         (6.0, 0, 9, "done"), ("check", 1000.0)]),
    "stranger-ignored": (
        dict(hosts=[0, 1], stall_timeout=2, startup_timeout=4,
             miss_budget=3),
        [(0.0, 5, 3, "train"), (1.0, 0, 0, "train"), (2.0, 0, 1, "train"),
         (3.0, 1, 0, "train"), ("check", 5.0), ("check", 9.0),
         ("check", 13.5)]),
}


def _run_watchdog(mod, kwargs, script):
    kw = dict(kwargs)
    dog = mod.Watchdog(kw.pop("hosts"), now=0.0, **kw)
    out = []
    for ev in script:
        if ev[0] == "check":
            now = ev[1]
            out.append((dog.check(now=now),
                        {h: dog.age(h, now=now) for h in dog.hosts},
                        {h: dog.progress(h) for h in dog.hosts}))
        else:
            now, h, step, phase = ev
            dog.observe(_beats(mod, h, step, phase), now=now)
    return out


@pytest.mark.parametrize("name", sorted(WATCHDOG_SCRIPTS))
def test_watchdog_matches_jax(name):
    kwargs, script = WATCHDOG_SCRIPTS[name]
    got = _run_watchdog(port_res, kwargs, script)
    assert got == _run_watchdog(jax_res, kwargs, script)
    assert any(v == "hung" for c, _, _ in got for v in c.values()) or \
        name in ("stranger-ignored",)


def test_watchdog_default_clock_matches_jax():
    """Without ``now`` both read the wall clock: a fresh watchdog is ok."""
    for mod in (port_res, jax_res):
        dog = mod.Watchdog([0, 1], stall_timeout=5)
        dog.observe(_beats(mod, 0, 0))
        assert dog.check() == {0: "ok", 1: "ok"}
        assert 0.0 <= dog.age(0) < 5.0


def _feed(mod, det, host, steps, dt, t0=0.0, step_s=None, every=1):
    t = t0
    for s in range(steps):
        if s % every == 0:
            det.observe(_beats(mod, host, s, t=t, step_s=step_s))
        t += dt


STRAGGLER_SCRIPTS = {
    # (kwargs, [(host, steps, dt, t0, step_s, every)])
    "slow-host": (dict(factor=2.0, patience=3),
                  [(0, 10, 1.0, 0.0, None, 1), (1, 10, 1.0, 0.0, None, 1),
                   (2, 10, 3.0, 0.0, None, 1)]),
    "needs-patience": (dict(factor=2.0, patience=5),
                       [(0, 4, 1.0, 0.0, None, 1),
                        (1, 4, 9.0, 0.0, None, 1)]),
    "no-peers": (dict(), [(0, 10, 9.0, 0.0, None, 1)]),
    "sparse-polling": (dict(factor=2.0, patience=3),
                       [(0, 13, 1.0, 100.0, 1.0, 4),
                        (1, 13, 3.0, 100.0, 3.0, 4)]),
    "recovers": (dict(factor=2.0, patience=2, window=4),
                 [(0, 12, 1.0, 0.0, None, 1), (1, 6, 5.0, 0.0, None, 1),
                  (1, 6, 1.0, 100.0, None, 1)]),
    "mixed-step-s": (dict(factor=1.5, patience=2, window=3),
                     [(0, 9, 1.0, 0.0, 1.0, 2), (1, 9, 2.0, 0.0, None, 1),
                      (2, 9, 1.2, 0.0, 1.7, 3)]),
}


def _run_straggler(mod, kwargs, feeds):
    det = mod.StragglerDetector(**kwargs)
    trail = []
    for host, steps, dt, t0, step_s, every in feeds:
        _feed(mod, det, host, steps, dt, t0, step_s, every)
        trail.append(det.stragglers())
    return trail


@pytest.mark.parametrize("name", sorted(STRAGGLER_SCRIPTS))
def test_straggler_detector_matches_jax(name):
    kwargs, feeds = STRAGGLER_SCRIPTS[name]
    got = _run_straggler(port_res, kwargs, feeds)
    assert got == _run_straggler(jax_res, kwargs, feeds)
    if name in ("slow-host", "sparse-polling"):
        assert set(got[-1]) == {2 if name == "slow-host" else 1}


# ---------------------------------------------------------------------------
# HostTopology, FileBarrier, BarrierTimeout
# ---------------------------------------------------------------------------

def _topology(mod, H, P):
    topo = mod.HostTopology(H, P)
    n = topo.num_devices
    placements = [list(range(n)), list(range(n))[::-1],
                  [d for pair in zip(range(0, n, 2), range(1, n, 2))
                   for d in pair[::-1]],
                  [(3 * d) % n for d in range(n)], [0]]
    return dict(
        n=n, host_of=[topo.host_of_device(d) for d in range(n)],
        devices=[list(topo.host_devices(h)) for h in range(H)],
        ring=[topo.ring_neighbors(h) for h in range(H)],
        edges=[topo.cross_host_edges(p) for p in placements],
        describe=[topo.describe(), *(topo.describe(p) for p in placements)])


@pytest.mark.parametrize("H,P", [(1, 1), (1, 4), (2, 2), (2, 4), (3, 4),
                                 (4, 1), (4, 2), (5, 3)])
def test_host_topology_matches_jax(H, P):
    assert _topology(port_mesh, H, P) == _topology(jax_mesh, H, P)


@pytest.mark.parametrize("args", [(0, 2), (2, 0), (-1, 1)])
def test_host_topology_rejects_what_jax_rejects(args):
    msgs = []
    for mod in (port_mesh, jax_mesh):
        with pytest.raises(ValueError, match="num_hosts >= 1") as ei:
            mod.HostTopology(*args)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_host_topology_range_errors_match_jax():
    for call in (lambda t: t.host_of_device(4), lambda t: t.host_devices(2),
                 lambda t: t.ring_neighbors(-1)):
        msgs = []
        for mod in (port_mesh, jax_mesh):
            with pytest.raises(ValueError) as ei:
                call(mod.HostTopology(2, 2))
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_file_barrier_port_meets_jax(tmp_path):
    d = str(tmp_path)
    a = port_mesh.FileBarrier(d, host_id=0, num_hosts=2)
    b = jax_mesh.FileBarrier(d, host_id=1, num_hosts=2)
    done = []
    t = threading.Thread(target=lambda: (a.wait("s", timeout=10),
                                         done.append(0)))
    t.start()
    time.sleep(0.1)
    assert not done                              # host 1 not there yet
    b.wait("s", timeout=10)
    t.join(timeout=10)
    assert done == [0]
    assert sorted(os.listdir(d)) == ["s.h00000", "s.h00001"]
    # the other way round, and a JAX reset clears a port marker
    c = jax_mesh.FileBarrier(d, host_id=0, num_hosts=2)
    e = port_mesh.FileBarrier(d, host_id=1, num_hosts=2)
    t = threading.Thread(target=lambda: c.wait("u", timeout=10))
    t.start()
    e.wait("u", timeout=10)
    t.join(timeout=10)
    jax_mesh.FileBarrier(d, host_id=0, num_hosts=2).reset("u")
    assert not any(n.startswith("u.") for n in os.listdir(d))


def test_barrier_timeout_fields_match_jax(tmp_path):
    errs = []
    for mod, sub in ((port_mesh, "p"), (jax_mesh, "j")):
        bar = mod.FileBarrier(str(tmp_path / sub), host_id=1, num_hosts=3)
        with pytest.raises(mod.BarrierTimeout) as ei:
            bar.wait("t2", timeout=0.2, poll=0.02)
        assert isinstance(ei.value, TimeoutError)
        errs.append((ei.value.name, ei.value.missing, str(ei.value)))
        bar.reset("t2")
        assert os.listdir(tmp_path / sub) == []
    assert errs[0] == errs[1] == (
        "t2", [0, 2], "barrier 't2': host(s) [0, 2] did not arrive within "
        "0.2s")


# ---------------------------------------------------------------------------
# EventLog, read_events, format_status
# ---------------------------------------------------------------------------

def _strip_t(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


def test_event_log_and_read_events_match_jax(tmp_path):
    out = []
    for mod, sub in ((port_sup, "p"), (jax_sup, "j")):
        path = str(tmp_path / sub / "events.jsonl")
        log = mod.EventLog(path)
        docs = [log.emit("launch", gen=0, hosts=2,
                         plan={"dp": 1, "pp": 4, "zero_stage": 0}),
                log.emit("hostdown", gen=0, host=1, rc=42), log.emit("done")]
        with open(path, "a") as f:
            f.write('{"t": 1, "kind": "tor')      # a crashed writer
        events = mod.read_events(path)
        assert events == docs
        out.append(_strip_t(events))
        assert mod.read_events(str(tmp_path / sub / "missing.jsonl")) == []
    assert out[0] == out[1]
    # each package reads the other's log
    assert _strip_t(port_sup.read_events(str(tmp_path / "j" /
                                             "events.jsonl"))) == out[0]


def _mask(status: str) -> str:
    return re.sub(r"\d+\.\ds ago", "?s ago", status)


def test_format_status_matches_jax(tmp_path):
    run_dir = str(tmp_path)
    assert port_sup.format_status(run_dir) == jax_sup.format_status(run_dir)
    log = port_sup.EventLog(os.path.join(run_dir, "events.jsonl"))
    for kind, kw in (("launch", dict(gen=0, hosts=2)),
                     ("heartbeat-miss", dict(gen=0, host=0, age=4.01)),
                     ("rollback", dict(gen=0, step=8, reason="hostdown")),
                     ("shrink", dict(gen=0, hosts=1, lost=[1])),
                     ("done", dict(gen=1, steps=12, hosts=1))):
        log.emit(kind, **kw)
    hb = os.path.join(run_dir, "hb")
    port_res.write_heartbeat(hb, port_res.Heartbeat(0, 7, "train",
                                                    loss=2.5))
    jax_res.write_heartbeat(hb, jax_res.Heartbeat(1, 3, "ckpt", gen=1))
    got = port_sup.format_status(run_dir)
    assert _mask(got) == _mask(jax_sup.format_status(run_dir))
    assert "rollback" in got and "step=8" in got and "loss=2.5000" in got
    assert _mask(port_sup.format_status(run_dir, tail=2)) == \
        _mask(jax_sup.format_status(run_dir, tail=2))


# ---------------------------------------------------------------------------
# the two supervisors over scripted workers
# ---------------------------------------------------------------------------

WORKER = r'''
import json, os, sys, time
spec = json.loads(sys.argv[1])
host, gen, hb_dir = spec["host"], spec["gen"], spec["hb_dir"]

def beat(step, phase, step_s=None, loss=None):
    os.makedirs(hb_dir, exist_ok=True)
    doc = {"host_id": host, "step": step, "phase": phase, "t": time.time(),
           "loss": loss, "grad_norm": None, "step_s": step_s,
           "pid": os.getpid(), "gen": gen}
    tmp = os.path.join(hb_dir, ".hb_h%05d.tmp%d" % (host, os.getpid()))
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, os.path.join(hb_dir, "hb_h%05d.json" % host))

losses = {}
# a port rank fills in its result file's {rank} field, as the trainer does
out = spec["out"].replace("{rank}", os.environ.get("RANK", ""))

def dump():
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"losses": losses}, f)
    os.replace(tmp, out)

beat(-1, "init")
for at, act in spec["script"]:
    delay = spec["t0"] + at - time.time()
    if delay > 0:
        time.sleep(delay)
    if act[0] == "steps":
        for s in range(act[1], act[2]):
            losses[str(s)] = 2.0 - 0.01 * s
            beat(s, "train", step_s=act[3], loss=losses[str(s)])
        dump()
    elif act[0] == "done":
        beat(spec["steps"], "done")
        sys.exit(0)
    elif act[0] == "exit":
        if act[1] == 43:                 # the trainer's escalation beat
            beat(act[2], "done")
        sys.exit(act[1])
    elif act[0] == "sleep":              # hung, or blocked on a peer
        time.sleep(3600)
'''

STEPS = 12


def _run_to(start, stop, then, step_s=0.1):
    return [(0.0, ["steps", start, stop, step_s]), (0.0, then)]


def _all_ok(gen, host, num_hosts, start):
    return _run_to(start, STEPS, ["done"])


def _hostdown(gen, host, num_hosts, start):
    if gen == 0:     # host 1 dies after step 7; host 0 waits on its commit
        return _run_to(0, 8, ["exit", 42] if host == 1 else ["sleep"])
    return _all_ok(gen, host, num_hosts, start)


def _hang(gen, host, num_hosts, start):
    if gen == 0:     # host 0 freezes before step 6, host 1 at the barrier
        return _run_to(0, 6 if host == 0 else 8, ["sleep"])
    return _all_ok(gen, host, num_hosts, start)


def _escalate(gen, host, num_hosts, start):
    if gen == 0:
        return _run_to(0, 6, ["exit", 43, 5] if host == 0 else ["sleep"])
    return _all_ok(gen, host, num_hosts, start)


def _budget(gen, host, num_hosts, start):
    return _run_to(start, start + 2,
                   ["exit", 43, start + 1] if host == 0 else ["sleep"])


def _no_survivors(gen, host, num_hosts, start):
    return _run_to(0, 3 + host, ["exit", 42 if host == 0 else 1])


def _straggler(gen, host, num_hosts, start):
    s = 0.5 if host == 1 else 0.1
    return [(0.0, ["steps", 0, 3, s]), (1.5, ["steps", 3, 6, s]),
            (2.5, ["steps", 6, 9, s]), (2.5, ["steps", 9, STEPS, s]),
            (3.5, ["done"])]


# name -> (script, checkpoint steps, config overrides, expected kinds)
SCENARIOS = {
    "all-ok": (_all_ok, "4,8", {}, ["launch", "gen-live", "done"]),
    "hostdown": (_hostdown, "4,8", {}, [
        "launch", "gen-live", "hostdown", "rollback", "shrink", "restart",
        "launch", "gen-live", "done"]),
    "hang-root": (_hang, "4", {}, [
        "launch", "gen-live", "heartbeat-miss", "heartbeat-miss", "hang",
        "rollback", "shrink", "restart", "launch", "gen-live", "done"]),
    "escalate": (_escalate, "4,8", {}, [
        "launch", "gen-live", "escalate", "rollback", "restart", "launch",
        "gen-live", "done"]),
    "budget": (_budget, "4,8", {"max_restarts": 1}, [
        "launch", "gen-live", "escalate", "rollback", "restart", "launch",
        "gen-live", "escalate", "abort"]),
    "no-survivors": (_no_survivors, "4,8", {}, [
        "launch", "gen-live", "hostdown", "hostdown", "rollback", "abort"]),
    "straggler": (_straggler, "4,8", {}, [
        "launch", "gen-live", "straggler", "done"]),
}
COMPARED = ("kind", "gen", "host", "step", "plan", "reason", "hosts", "lost")


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """One checkpoint directory per step set, written by the port: the
    listed steps complete on two hosts; "4" also holds host 1's half of
    step 8 (the hang's parked shard), which no reader may count."""
    tree = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(5)}
    out = {}
    for key in ("4,8", "4"):
        d = str(tmp_path_factory.mktemp("ckpt"))
        for s in map(int, key.split(",")):
            for h in (0, 1):
                save_checkpoint(d, s, tree, host_id=h, num_hosts=2)
        if key == "4":
            save_checkpoint(d, 8, tree, host_id=1, num_hosts=2)
        out[key] = d
    return out


def _supervise(mod, run_dir, ckpt_dir, script_path, scenario, over):
    cfg = mod.SupervisorConfig(
        run_dir=run_dir, num_hosts=2, devices_per_host=2, steps=STEPS,
        dp=1, pp=4, ckpt_dir=ckpt_dir, ckpt_every=4, poll=1.0,
        stall_timeout=0.75, startup_timeout=0.75, miss_budget=4,
        backoff_base=0.05, straggler_patience=3, **over)
    sup = mod.Supervisor(cfg)

    def worker_cmd(host_id, num_hosts, plan, gen, faults, out_json):
        start = mod.latest_step(sup.ckpt_dir) if gen else 0
        spec = dict(host=host_id, gen=gen, hb_dir=sup.hb_dir, out=out_json,
                    steps=STEPS, t0=time.time(),
                    script=scenario(gen, host_id, num_hosts, start or 0))
        return [sys.executable, script_path, json.dumps(spec)]

    sup._worker_cmd = worker_cmd
    return sup.run()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_supervisor_decisions_match_jax(name, tmp_path, ckpt_dirs):
    scenario, steps, over, kinds = SCENARIOS[name]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    results = {}

    def go(label, mod):
        results[label] = _supervise(mod, str(tmp_path / label),
                                    ckpt_dirs[steps], str(script), scenario,
                                    over)

    # both at once: same load, half the wall time
    threads = [threading.Thread(target=go, args=a)
               for a in (("port", port_sup), ("jax", jax_sup))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    port, jax_r = results["port"], results["jax"]
    ev_p = port_sup.read_events(port.events_path)
    ev_j = jax_sup.read_events(jax_r.events_path)
    assert [e["kind"] for e in ev_p] == kinds, ev_p
    assert [{k: e.get(k) for k in COMPARED} for e in ev_p] == \
        [{k: e.get(k) for k in COMPARED} for e in ev_j]
    fields = ("ok", "outcome", "generations", "restarts", "final_hosts",
              "final_plan", "losses")
    assert {f: getattr(port, f) for f in fields} == \
        {f: getattr(jax_r, f) for f in fields}
    if name == "hang-root":
        hang = next(e for e in ev_p if e["kind"] == "hang")
        assert (hang["host"], hang["step"]) == (0, 5)   # the root, not 1
        assert next(e for e in ev_p if e["kind"] == "rollback")["step"] == 4
    if name in ("hostdown", "hang-root"):
        assert port.final_plan == (1, 2, 0) and port.final_hosts == 1
        assert sorted(port.losses) == list(range(STEPS))
    if name == "straggler":
        assert next(e for e in ev_p if e["kind"] == "straggler")["host"] == 1


def test_checkpoint_dirs_read_alike(ckpt_dirs):
    from repro.checkpoint import latest_step as jax_latest
    for d in ckpt_dirs.values():
        assert latest_step(d) == jax_latest(d)
    assert latest_step(ckpt_dirs["4"]) == 4


def test_supervisor_cli_defaults_fold_the_pipeline():
    """The JAX supervisor's defaults: dp=2 pp=2 on 2 hosts x 2 devices;
    losing a host keeps the pipeline and drops a replica."""
    from repro.core.tuner import shrink_plan as jax_shrink
    from repro_torch.core.tuner import shrink_plan
    args = port_sup._parse_args(["--run-dir", "x"])
    jargs = jax_sup._parse_args(["--run-dir", "x"])
    assert (args.dp, args.pp, args.hosts, args.devices_per_host) == \
        (jargs.dp, jargs.pp, jargs.hosts, jargs.devices_per_host) == \
        (2, 2, 2, 2)
    assert args.device == "cuda" and not hasattr(args, "ring")
    assert args.dp * args.pp == args.hosts * args.devices_per_host
    assert shrink_plan(2, dp=2, pp=2) == jax_shrink(2, dp=2, pp=2) == \
        (1, 2, 0)
    cfg = port_sup.SupervisorConfig(run_dir="x")
    jcfg = jax_sup.SupervisorConfig(run_dir="x")
    assert (cfg.dp, cfg.pp, cfg.zero_stage) == \
        (jcfg.dp, jcfg.pp, jcfg.zero_stage) == (2, 2, 0)
    assert cfg.device == "cuda" and not hasattr(cfg, "ring")


def test_worker_command_and_env(tmp_path):
    """A rank's command and environment: the trainer parses every flag,
    ``rank_env`` reads torchrun's variables, and the world agrees with
    ``--num-hosts``/``--host-id``; with a card a rank visible, each host
    sees its own and the ranks keep the trainer's ring; ranks that share
    cards get the gloo ring."""
    from repro_torch.launch import train
    cfg = port_sup.SupervisorConfig(run_dir=str(tmp_path), device="cpu",
                                    zero_stage=2,
                                    worker_env={"OMP_NUM_THREADS": "1"})
    sup = port_sup.Supervisor(cfg)
    cmd = sup._worker_cmd(1, 2, (2, 2, 2), 3, "hang@6", "o.r{rank}.json")
    assert cmd[1:3] == ["-m", "repro_torch.launch.train"]
    i = cmd.index("--device")
    assert cmd[i + 1] == "cpu" and cmd[-2:] == ["--faults", "hang@6"]
    assert cmd[cmd.index("--host-id") + 1] == "1"
    args = train._parse_args(cmd[3:])
    assert (args.host_id, args.num_hosts, args.gen, args.devices, args.dp,
            args.pp, args.zero_stage, args.ring, args.out_json) == (
        1, 2, 3, 4, 2, 2, 2, None, "o.r{rank}.json")
    topo = port_mesh.HostTopology(2, 2)
    env = sup._rank_env(topo, 3, 29512)
    assert {k: env[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                "LOCAL_WORLD_SIZE", "GROUP_RANK",
                                "MASTER_ADDR", "MASTER_PORT")} == dict(
        RANK="3", WORLD_SIZE="4", LOCAL_RANK="1", LOCAL_WORLD_SIZE="2",
        GROUP_RANK="1", MASTER_ADDR="127.0.0.1", MASTER_PORT="29512")
    assert env["TORCHELASTIC_USE_AGENT_STORE"] == "True"   # a client each
    renv = train.rank_env(env)
    assert renv == {"rank": 3, "world": 4, "local_rank": 1,
                    "local_world": 2}
    train._refuse_rank_options(args, renv)
    assert env.get("XLA_FLAGS") == os.environ.get("XLA_FLAGS")  # not set
    assert env.get("CUDA_VISIBLE_DEVICES") == \
        os.environ.get("CUDA_VISIBLE_DEVICES")        # the CPU: untouched
    src = env["PYTHONPATH"].split(os.pathsep)[0]
    assert os.path.isdir(os.path.join(src, "repro_torch"))
    assert env["OMP_NUM_THREADS"] == "1"
    # on cards: one a rank visible -> each host its own, the trainer's
    # ring; fewer -> shared, over gloo
    for cards, want, ring in (("a,b,c,d", "c,d", None),
                              ("a,b", "a,b", "gloo")):
        card_sup = port_sup.Supervisor(port_sup.SupervisorConfig(
            run_dir=str(tmp_path / cards), worker_env={
                "CUDA_VISIBLE_DEVICES": cards}))
        assert card_sup._rank_env(topo, 2, 1)["CUDA_VISIBLE_DEVICES"] == \
            want
        card_cmd = card_sup._worker_cmd(1, 2, (2, 2, 0), 0, None, "o.json")
        assert train._parse_args(card_cmd[3:]).ring == ring


def test_worker_command_passes_layers(tmp_path):
    """``layers`` reaches every rank as the trainer's ``--layers``; left
    unset, the ranks train the config's full depth."""
    from repro_torch.launch import train
    for layers in (None, 16):
        sup = port_sup.Supervisor(port_sup.SupervisorConfig(
            run_dir=str(tmp_path / str(layers)), arch="uvit-h",
            layers=layers, device="cpu"))
        cmd = sup._worker_cmd(0, 2, (2, 2, 0), 0, None, "o.json")
        assert train._parse_args(cmd[3:]).layers == layers


def test_supervisor_module_makes_no_cuda_call():
    import inspect
    src = inspect.getsource(port_sup)
    assert "torch.cuda" not in src and "import torch" not in src
