"""The port's supervisor over ranks: every generation a world of gloo rank
processes of the port's trainer, grouped by host, held to the JAX
supervisor's drill (``tests/helpers/supervisor_drill.py``) at its own plan
and knobs.

One module fixture runs, at once:

- one JAX subprocess on four forced host devices: the JAX trainer's
  uninterrupted run of the drill's plan (uvit-nano, ``--dp 2 --pp 2``, M=4,
  global batch 8, 12 steps, lr 1e-3, fp32 wire), its 12 losses;
- beside it, three supervised runs of 2 hosts x 2 ranks (``--device cpu``,
  one torch thread a rank), whose ranks start from the JAX trainer's
  initial params and take its DDPM draws (``python
  tests/test_torch_rank_supervisor.py rank INPUTS ARGV``): ``hostdown@8:1``
  with generation 0 at ZeRO-2, ``hang@6`` at ZeRO-0 (the JAX drill's
  ``stall_timeout`` 8 and ``miss_budget`` 2), and ``nan@1`` with
  ``--nan-skip-budget 0`` over 3 steps.

Held: the hostdown and hang drills end ``done`` on ``(1, 2, 0)`` on one
host after a rollback to 8 and to 4, the hang attributed to the root host
0 within ``stall_timeout x miss_budget`` plus five polls, and the merged
12-step trajectory equals the JAX trainer's at rtol 1e-4; the NaN run
escalates, rolls back on the same plan (no shrink) and finishes.  Then:
real ranks whose peer host died exit ``EXIT_PEER_LOST`` and the host is
not counted down; a host's verdict from scripted exit codes, also when
host 1's ranks exit 43 after the monitor saw host 0's; teardown leaves no
rank (nor a rank's child) alive, a rank that ignores SIGTERM included; an
error of a rank's own rendezvous is not a lost peer; the trainer refuses
a world that disagrees with ``--num-hosts`` before any process group
exists.

The ranks run this file: JAX and the JAX package are imported where they
are used, in this process and in the JAX subprocess, never in a rank.
"""
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.launch import supervisor as sup_mod
from repro_torch.launch import train
from repro_torch.launch.mesh import HostTopology
from repro_torch.runtime.resilience import EXIT_PEER_LOST

REPO = pathlib.Path(__file__).resolve().parents[1]
STEPS, BATCH = 12, 8
RTOL, ATOL = 1e-4, 1e-6            # the JAX drill's
# the JAX drill's PLAN
PLAN = ["--arch", "uvit-nano", "--pipeline", "--devices", "4", "--dp", "2",
        "--pp", "2", "--microbatches", "4", "--global-batch", str(BATCH),
        "--steps", str(STEPS), "--lr", "1e-3", "--wire-dtype", "float32",
        "--log-every", "4"]
NANO = dict(img_size=8, in_ch=4, patch=4, d_model=32, n_layers=8, n_heads=2,
            d_ff=64, n_classes=10)
# (faults, ZeRO stage of generation 0, rollback step, detecting event)
DRILLS = {"hostdown": ("hostdown@8:1", 2, 8, "hostdown"),
          "hang": ("hang@6", 0, 4, "hang")}
NAN_STEPS = 3
TIMEOUT = 400


def _flatten(tree, prefix=""):
    """Nested dicts / tuples of arrays -> {"a/b/c": numpy array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat):
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------

def _inputs(path):
    """The JAX trainer's initial uvit-nano params and each step's DDPM
    draws (``fold_in(PRNGKey(0), step)``: a uniform t and a normal noise
    over the global batch)."""
    import jax
    import jax.numpy as jnp

    from repro.models import diffusion as jdm
    key = jax.random.PRNGKey(0)
    params = jax.device_get(jdm.init_uvit(key, jdm.UViTConfig("uvit-nano",
                                                              **NANO)))
    out = {f"p|{k}": v for k, v in _flatten(params).items()}
    for step in range(STEPS):
        rt, rn = jax.random.split(jax.random.fold_in(key, step))
        out[f"t|{step}"] = np.asarray(jax.random.uniform(rt, (BATCH,)))
        out[f"noise|{step}"] = np.asarray(
            jax.random.normal(rn, (BATCH, 8, 8, 4), jnp.float32))
    np.savez(path, **out)


def _jax_main(out):
    """The JAX trainer's uninterrupted run of the drill's plan."""
    from repro.launch.train import _parse_args, run
    res = run(_parse_args(PLAN))
    np.save(out, np.array([res.losses[s] for s in range(STEPS)]))


def _rank_main(inputs, argv):
    """One rank of a supervised world: the trainer's command line, from the
    JAX params, with the JAX draws."""
    torch.set_num_threads(1)
    with np.load(inputs) as z:
        res = {k: z[k] for k in z.files}
    params = _unflatten({k[2:]: v for k, v in res.items()
                         if k.startswith("p|")})
    train.main(argv, init_params=params,
               draw=lambda s: (res[f"t|{s}"], res[f"noise|{s}"]))


def _config(run_dir, **over):
    """The JAX drill's ``SupervisorConfig``, on the CPU."""
    kw = dict(run_dir=str(run_dir), num_hosts=2, devices_per_host=2,
              steps=STEPS, global_batch=BATCH, arch="uvit-nano", dp=2, pp=2,
              microbatches=4, wire_dtype="float32", lr=1e-3, ckpt_every=4,
              stall_timeout=8.0, miss_budget=2, poll=0.2, backoff_base=0.2,
              log_every=4, device="cpu",
              worker_env={"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""})
    kw.update(over)
    return sup_mod.SupervisorConfig(**kw)


def _from_jax(sup, inputs):
    """Every rank ``sup`` launches runs :func:`_rank_main` on its trainer
    argv."""
    cmd_of = sup._worker_cmd

    def cmd(*a):
        return [sys.executable, __file__, "rank", str(inputs),
                *cmd_of(*a)[3:]]

    sup._worker_cmd = cmd
    return sup


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("rank_supervisor")
    inputs = base / "inputs.npz"
    _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_out = base / "jax_losses.npy"
    jax_proc = subprocess.Popen(
        [sys.executable, __file__, "jax", str(jax_out)], env=env,
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    cfgs = {name: _config(base / name, faults=faults, zero_stage=zero)
            for name, (faults, zero, _, _) in DRILLS.items()}
    cfgs["nan"] = _config(base / "nan", faults="nan@1", nan_skip_budget=0,
                          steps=NAN_STEPS)
    got = {}

    def one(name):
        got[name] = _from_jax(sup_mod.Supervisor(cfgs[name]), inputs).run()

    threads = [threading.Thread(target=one, args=(n,)) for n in cfgs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    out, _ = jax_proc.communicate(timeout=TIMEOUT)
    assert jax_proc.returncode == 0, out[-3000:]
    return dict(base=base, cfg=cfgs, res=got, jax=np.load(jax_out))


def _events(res):
    return sup_mod.read_events(res.events_path)


def _logs(run_dir):
    d = pathlib.Path(run_dir) / "logs"
    return {p.name: p.read_text() for p in sorted(d.glob("*.log"))}


# ---------------------------------------------------------------------------
# the JAX drills over ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DRILLS))
def test_jax_drill_over_ranks(runs, name):
    faults, zero, rollback, detect = DRILLS[name]
    cfg, res = runs["cfg"][name], runs["res"][name]
    events = _events(res)
    kinds = [e["kind"] for e in events]
    assert res.ok and res.outcome == "done", kinds
    assert (res.generations, res.restarts) == (2, 1)
    assert (res.final_hosts, res.final_plan) == (1, (1, 2, 0))
    for k in (detect, "rollback", "shrink", "restart", "gen-live", "done"):
        assert k in kinds, kinds
    launches = [e for e in events if e["kind"] == "launch"]
    assert [(e["hosts"], e["ranks"], e["plan"]) for e in launches] == [
        (2, 4, {"dp": 2, "pp": 2, "zero_stage": zero}),
        (1, 2, {"dp": 1, "pp": 2, "zero_stage": 0})]
    assert next(e for e in events if e["kind"] == "rollback")["step"] == \
        rollback
    shrink = next(e for e in events if e["kind"] == "shrink")
    assert shrink["plan"] == {"dp": 1, "pp": 2, "zero_stage": 0}
    hit = [e for e in events if e["kind"] == detect]
    assert [e["host"] for e in hit] == [1 if detect == "hostdown" else 0]
    if detect == "hang":
        assert hit[0]["age"] <= cfg.stall_timeout * cfg.miss_budget \
            + 5 * cfg.poll
        assert hit[0]["step"] == 5
    assert sorted(res.losses) == list(range(STEPS))
    np.testing.assert_allclose([res.losses[s] for s in range(STEPS)],
                               runs["jax"], rtol=RTOL, atol=ATOL)
    logs = _logs(cfg.run_dir)
    assert sorted(logs) == sorted(
        [f"worker_h{r // 2}.r{r}.g0.log" for r in range(4)]
        + ["worker_h0.r0.g1.log", "worker_h0.r1.g1.log"])
    for n, text in logs.items():
        assert "[train] device: cpu (rank" in text, (n, text[-2000:])
    # generation 1 restored the rollback step on its own plan: the same
    # pipeline, one replica
    assert f"resumed from step {rollback}" in logs["worker_h0.r0.g1.log"]
    status = sup_mod.format_status(cfg.run_dir)
    assert detect in status and "rollback" in status


def test_escalation_rolls_back_on_the_same_plan(runs):
    res = runs["res"]["nan"]
    events = _events(res)
    kinds = [e["kind"] for e in events]
    assert kinds == ["launch", "gen-live", "escalate", "rollback", "restart",
                     "launch", "gen-live", "done"], kinds
    esc = next(e for e in events if e["kind"] == "escalate")
    assert esc["hosts"] == [0, 1]           # every rank skipped alike
    assert next(e for e in events if e["kind"] == "rollback")["reason"] == \
        "escalate"
    launches = [e for e in events if e["kind"] == "launch"]
    assert launches[0]["plan"] == launches[1]["plan"] == {
        "dp": 2, "pp": 2, "zero_stage": 0}
    assert [e["hosts"] for e in launches] == [2, 2]
    assert res.ok and (res.final_hosts, res.final_plan) == (2, (2, 2, 0))
    assert sorted(res.losses) == list(range(NAN_STEPS))
    np.testing.assert_allclose([res.losses[s] for s in range(NAN_STEPS)],
                               runs["jax"][:NAN_STEPS], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# exit codes, verdicts, teardown
# ---------------------------------------------------------------------------

def test_peer_lost_ranks_are_not_counted_down(tmp_path):
    """Host 1's ranks die after step 0; host 0's ranks, waiting on them in
    step 1, exit ``EXIT_PEER_LOST``; every rank is waited for before the
    monitor's first poll, which blames host 1 alone."""
    cfg = _config(tmp_path, steps=3, ckpt_every=100, faults="hostdown@1:1")
    sup = sup_mod.Supervisor(cfg)
    ranks = sup._launch(2, (2, 2, 0), 0, cfg.faults)
    try:
        codes = [r.proc.wait(timeout=TIMEOUT) for r in ranks]
        assert codes == [EXIT_PEER_LOST] * 2 + [42] * 2, codes
        assert sup._monitor(ranks, 0) == ("hostdown", [1])
    finally:
        sup._teardown(ranks)
    for r in ranks[:2]:
        assert "a peer rank is gone" in pathlib.Path(r.log).read_text()


RANK_SCRIPT = r'''
import os, signal, subprocess, sys, time
spec = sys.argv[1].split(",")
code = spec[int(os.environ["RANK"])]
if code == "ignore-term":                # ignores SIGTERM, starts a child
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(600)"])
    with open(os.environ["PID_FILE"] + os.environ["RANK"], "w") as f:
        f.write(str(child.pid))
    time.sleep(600)
elif code == "sleep":
    time.sleep(600)
elif code.startswith("late"):            # late<code>: exits a moment later
    time.sleep(0.5)
    code = code[4:]
sys.exit(int(code))
'''

# exit codes by rank (2 hosts x 2 ranks) -> the monitor's verdict
VERDICTS = {
    "all-done": ("0,0,0,0", ("done", [])),
    "host1-down": ("44,44,42,44", ("hostdown", [1])),
    "host0-crash": ("1,44,44,44", ("hostdown", [0])),
    "escalate-wins": ("43,44,42,0", ("escalate", [0])),
    "nobody-to-blame": ("44,44,44,0", ("peer-lost", [])),
}


def _scripted(tmp_path, spec):
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    cfg = _config(tmp_path, startup_timeout=600.0, poll=0.05,
                  worker_env={"PID_FILE": str(tmp_path / "pid")})
    sup = sup_mod.Supervisor(cfg)
    sup._worker_cmd = lambda *a: [sys.executable, str(script), spec]
    return sup


@pytest.mark.parametrize("name", list(VERDICTS))
def test_host_verdict_from_rank_exit_codes(tmp_path, name):
    spec, want = VERDICTS[name]
    sup = _scripted(tmp_path, spec)
    ranks = sup._launch(2, (2, 2, 0), 0, None)
    for r in ranks:
        r.proc.wait(timeout=60)
    assert sup._monitor(ranks, 0) == want
    sup._teardown(ranks)
    kinds = [e["kind"] for e in sup_mod.read_events(sup.events.path)]
    assert kinds[-1] == {"done": "launch", "hostdown": "hostdown",
                         "escalate": "escalate",
                         "peer-lost": "peer-lost"}[want[0]]


def test_verdict_waits_for_the_world_to_settle(tmp_path):
    """Ranks in lockstep fail within a moment of each other: the monitor
    that sees host 0's ranks exit 43 first still counts host 1, whose ranks
    exit 43 half a second later."""
    sup = _scripted(tmp_path, "43,43,late43,late43")
    ranks = sup._launch(2, (2, 2, 0), 0, None)
    try:
        ranks[0].proc.wait(timeout=60)
        assert sup._monitor(ranks, 0) == ("escalate", [0, 1])
    finally:
        sup._teardown(ranks)


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie waiting for its reaper does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_teardown_leaves_no_rank_alive(tmp_path):
    sup = _scripted(tmp_path, "ignore-term,sleep,sleep,0")
    ranks = sup._launch(2, (2, 2, 0), 0, None)
    pid_file = tmp_path / "pid0"
    deadline = time.time() + 60
    while not pid_file.exists():
        assert time.time() < deadline
        time.sleep(0.05)
    child = int(pid_file.read_text())
    assert ranks[3].proc.wait(timeout=60) == 0
    assert all(r.proc.poll() is None for r in ranks[:3])
    t0 = time.time()
    sup._teardown(ranks)
    assert 4.0 <= time.time() - t0 < 30.0      # the SIGTERM grace, then KILL
    assert [r.proc.returncode for r in ranks] == [
        -signal.SIGKILL, -signal.SIGTERM, -signal.SIGTERM, 0]
    for pid in [r.proc.pid for r in ranks] + [child]:
        deadline = time.time() + 10
        while _alive(pid):
            assert time.time() < deadline, f"pid {pid} outlived teardown"
            time.sleep(0.05)


# ---------------------------------------------------------------------------
# the trainer's host checks
# ---------------------------------------------------------------------------

def test_rendezvous_error_blames_the_rank_itself(monkeypatch):
    """A ``torch.distributed`` error raised before the process group exists
    (the rank's own rendezvous) is not a lost peer: ``main`` raises it, and
    the rank's exit code blames its host."""
    import torch.distributed as dist

    def rendezvous_fails(args, **kw):
        raise dist.DistNetworkError("the store's port is taken")

    for k, v in dict(RANK="1", WORLD_SIZE="4", LOCAL_RANK="1",
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(train, "run", rendezvous_fails)
    assert not dist.is_initialized()
    with pytest.raises(dist.DistNetworkError):
        train.main(PLAN + ["--device", "cpu"])

@pytest.mark.parametrize("env, host, match", [
    (dict(RANK="2", WORLD_SIZE="4", LOCAL_WORLD_SIZE="2"), 1, None),
    (dict(RANK="1", WORLD_SIZE="4", LOCAL_WORLD_SIZE="4"), 0,
     "not --num-hosts 2 hosts of LOCAL_WORLD_SIZE 4"),
    (dict(RANK="1", WORLD_SIZE="4"), 0,
     "not --num-hosts 2 hosts of LOCAL_WORLD_SIZE 4"),
    (dict(RANK="3", WORLD_SIZE="4", LOCAL_WORLD_SIZE="2"), 0,
     "rank 3 belongs to host 1"),
])
def test_trainer_refuses_a_world_that_disagrees_with_its_hosts(
        monkeypatch, env, host, match):
    """Checked before any process group exists: ``run`` raises with no
    ``MASTER_PORT`` to meet at."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    for k, v in dict(env, LOCAL_RANK="0", MASTER_ADDR="127.0.0.1").items():
        monkeypatch.setenv(k, v)
    args = train._parse_args(PLAN + ["--device", "cpu", "--num-hosts", "2",
                                     "--host-id", str(host)])
    renv = train.rank_env()
    if match is None:
        train._refuse_rank_options(args, renv)
        assert HostTopology(2, renv["local_world"]).host_of_device(
            renv["rank"]) == host
        return
    with pytest.raises(ValueError, match=match):
        train.run(args)
    import torch.distributed as dist
    assert not dist.is_initialized()


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    _jax_main(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["rank"]:
    _rank_main(sys.argv[2], sys.argv[3:])
