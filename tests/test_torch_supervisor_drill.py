"""Multi-host workers of the port's trainer and supervised recovery drills,
on the CPU.

- a worker run as ``--host-id 1 --num-hosts 2`` passes its start barrier,
  writes only ``shard_00001`` of its checkpoint step and waits at the
  commit barrier until host 0's worker lands its half; the two-host
  checkpoint then restores bitwise in the JAX reader and in the port, and
  a two-host checkpoint the JAX writer made restores in the port;
- two OS processes commit the shards of one step, host 1 late, while host
  0's GC runs retention the whole time (the scenario of
  ``tests/helpers/concurrent_ckpt.py`` through the port's store): the
  half-written step is never reported complete and never collected;
- the port's supervisor over ranks (``--device cpu``, one torch thread a
  rank) at a plan that folds the pipeline when a host goes: 2 hosts x 2
  ranks, ``dp=1 pp=4``, M=4, global batch 8, 12 steps, fp32 wire, a
  checkpoint every 4 steps.  ``hostdown@8:1`` and ``hang@6`` each end
  ``done`` on ``(1, 2, 0)`` on one host of two ranks after a rollback to
  step 8 and step 4 (an elastic restore, P=4 -> P=2), the hang attributed
  to host 0 within ``stall_timeout x miss_budget`` plus five polls, and the
  merged 12-step trajectory equals the port's uninterrupted one-process
  run at rtol 1e-4 (what ``tests/helpers/supervisor_drill.py`` checks of
  the JAX drill; ``tests/test_torch_rank_supervisor.py`` runs the JAX
  drill's own plan, dp=2 pp=2, against the JAX trainer).
"""
import functools
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro_torch.checkpoint import (CheckpointManager, complete_steps,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint, verify_step,
                                    wait_step_complete)
from repro_torch.launch import supervisor as sup_mod
from repro_torch.launch import train
from repro_torch.tree import tree_flatten, tree_map

REPO = pathlib.Path(__file__).resolve().parents[1]
STEPS = 12
PLAN = ["--arch", "uvit-nano", "--pipeline", "--devices", "4", "--pp", "4",
        "--microbatches", "4", "--global-batch", "8", "--steps", str(STEPS),
        "--lr", "1e-3", "--wire-dtype", "float32", "--log-every", "4",
        "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"),
                OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")


# ---------------------------------------------------------------------------
# worker mode: one shard per host, the commit barrier
# ---------------------------------------------------------------------------

WORKER_ARGV = ["--arch", "uvit-nano", "--pipeline", "--devices", "2",
               "--microbatches", "4", "--global-batch", "8", "--steps", "2",
               "--ckpt-every", "2", "--wire-dtype", "float32", "--log-every",
               "1", "--device", "cpu", "--num-hosts", "2",
               "--commit-timeout", "60"]


def _worker(tmp_path, host):
    out, log = tmp_path / f"h{host}.json", tmp_path / f"h{host}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *WORKER_ARGV,
             "--host-id", str(host), "--ckpt-dir", str(tmp_path / "ckpt"),
             "--heartbeat-dir", str(tmp_path / "hb"), "--out-json",
             str(out)], cwd=REPO, env=_env(), stdout=f,
            stderr=subprocess.STDOUT)
    return proc, out, log


@pytest.fixture(scope="module")
def two_host_ckpt(tmp_path_factory):
    """Host 1's worker alone first (host 0's start marker planted by hand),
    then host 0's: returns the directory, what host 1 left before host 0
    started, and both workers' results and logs."""
    tmp = tmp_path_factory.mktemp("workers")
    barrier = tmp / "hb" / "barrier"
    barrier.mkdir(parents=True)
    (barrier / "start.g0.h00000").write_text("planted")
    p1, out1, log1 = _worker(tmp, 1)
    p0 = None
    try:
        step_dir = tmp / "ckpt" / "step_000000002"
        deadline = time.time() + 240
        while not (step_dir / "shard_00001.json").exists():
            assert p1.poll() is None, log1.read_text()
            assert time.time() < deadline, log1.read_text()
            time.sleep(0.05)
        time.sleep(0.5)             # host 1 now waits at the commit barrier
        alone = sorted(os.listdir(step_dir))
        waiting = p1.poll() is None
        p0, out0, log0 = _worker(tmp, 0)
        assert p0.wait(timeout=300) == 0, log0.read_text()
        assert p1.wait(timeout=300) == 0, log1.read_text()
    finally:
        for p in (p0, p1):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    return dict(dir=str(tmp / "ckpt"), alone=alone, waiting=waiting,
                out=[json.loads(o.read_text()) for o in (out0, out1)],
                log=[x.read_text() for x in (log0, log1)])


def test_worker_writes_only_its_shard_and_meets_the_barrier(two_host_ckpt):
    w = two_host_ckpt
    assert w["alone"] == ["shard_00001.json", "shard_00001.npz"]
    assert w["waiting"]                      # blocked on host 0's half
    assert complete_steps(w["dir"]) == [2]
    man = verify_step(w["dir"], 2)
    assert man["num_hosts"] == 2
    assert man["shards"] == ["shard_00000.npz", "shard_00001.npz"]
    for log in w["log"]:
        assert "did not close" not in log
        assert "[train] device: cpu" in log
        assert "[train] hosts: 2 x 1 devices = 2" in log
    # replicas: the same losses on both hosts
    assert w["out"][0]["losses"] == w["out"][1]["losses"]
    assert sorted(w["out"][0]["losses"]) == ["0", "1"]


def test_no_build_refuses_to_compile_a_missing_kernel(tmp_path,
                                                     monkeypatch):
    """``REPRO_TORCH_NO_BUILD=1`` (what a supervisor's workers on the card
    run under): a kernel library missing from the build directory raises
    before any compiler is looked for; one that is there is loaded as is."""
    from repro_torch.kernels import build

    def no_compiler():
        raise AssertionError("a worker looked for nvcc")

    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_NO_BUILD", "1")
    monkeypatch.setattr(build, "nvcc_path", no_compiler)
    with pytest.raises(RuntimeError, match="REPRO_TORCH_NO_BUILD=1 forbids"):
        build.build(("skip_matmul", "flash_attention"))
    with pytest.raises(RuntimeError, match="REPRO_TORCH_NO_BUILD=1 forbids"):
        build.load("skip_matmul")
    build.lib_path("skip_matmul").touch()
    assert build.build(("skip_matmul",)) == {}
    assert sorted(os.listdir(tmp_path)) == [build.lib_path("skip_matmul").name]


def test_two_host_port_checkpoint_restores_in_jax_and_port(two_host_ckpt):
    args = train._parse_args(WORKER_ARGV[:-4])
    tr = train.build_trainer(args)
    like = {"params": tr.params, "opt": tr.opt_state}
    got, step = restore_checkpoint(two_host_ckpt["dir"],
                                   tree_map(torch.zeros_like, like))
    assert step == 2
    jlike = tree_map(lambda x: jnp.zeros(
        tuple(x.shape), jnp.int32 if x.dtype == torch.int32 else jnp.float32),
        like)
    jgot, jstep = jax_restore(two_host_ckpt["dir"], jlike)
    assert jstep == 2
    port = tree_flatten(got)[0]
    jleaves = jax.tree_util.tree_flatten(jgot)[0]
    assert len(port) == len(jleaves) > 10
    for a, b in zip(port, jleaves):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # not the initial params: two AdamW steps went in
    assert not all(torch.equal(a, b.detach()) for a, b in
                   zip(tree_flatten(got["params"])[0],
                       tree_flatten(tr.params)[0]))


def test_two_host_jax_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32),
                  rng.standard_normal((2, 2)).astype(np.float32)],
            "step": np.int32(7)}
    for h in (1, 0):
        jax_save(str(tmp_path), 6, tree, host_id=h, num_hosts=2)
    like = {"w": torch.zeros(3, 4), "b": [torch.zeros(5), torch.zeros(2, 2)],
            "step": torch.zeros((), dtype=torch.int32)}
    got, step = restore_checkpoint(str(tmp_path), like)
    assert step == 6
    for a, b in zip(tree_flatten(got)[0], jax.tree_util.tree_flatten(tree)[0]):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# concurrent multi-host commits while host 0's GC runs
# ---------------------------------------------------------------------------

WRITER = r'''
import sys, time
import torch
from repro_torch.checkpoint.store import save_checkpoint
directory, host, delay = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
time.sleep(delay)
save_checkpoint(directory, 4, {"w": torch.arange(12.0).reshape(3, 4),
                               "b": torch.ones(5),
                               "k": torch.full((2, 2), 7.0)},
                host_id=host, num_hosts=2)
'''


def test_concurrent_writers_gc_never_collects_inflight_step(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(5),
            "k": torch.full((2, 2), 7.0)}
    for s in (1, 2, 3):                  # history: complete 2-host steps
        for h in (0, 1):
            save_checkpoint(d, s, tree, host_id=h, num_hosts=2)
    assert complete_steps(d) == [1, 2, 3]
    script = tmp_path / "writer.py"
    script.write_text(WRITER)
    procs = [subprocess.Popen([sys.executable, str(script), d, str(h),
                               str(delay)], env=_env())
             for h, delay in ((0, 0.0), (1, 3.0))]
    mgr = CheckpointManager(d, keep=2, host_id=0, num_hosts=2)
    step_dir = os.path.join(d, "step_000000004")
    raced = 0
    deadline = time.time() + 120.0
    while True:                          # GC races the in-flight commit
        mgr._gc()
        newest = latest_step(d)
        assert newest in (3, 4), f"half-complete step surfaced: {newest}"
        if newest == 3 and os.path.isdir(step_dir) and \
                os.path.exists(os.path.join(step_dir, "manifest.json")):
            # host 0's half (shard + manifest) is down, host 1's is not
            with pytest.raises(ValueError):
                verify_step(d, 4)
            raced += 1
        if newest == 4:
            break
        assert time.time() < deadline, "step 4 never completed"
        time.sleep(0.05)
    for p in procs:
        assert p.wait(timeout=120) == 0
    assert raced > 0, "the race window was never observed"
    wait_step_complete(d, 4, timeout=5.0)
    mgr._gc()                            # ordinary retention now applies
    assert complete_steps(d) == [3, 4]
    assert sorted(n for n in os.listdir(d) if n.startswith("step_")) == \
        ["step_000000003", "step_000000004"]


# ---------------------------------------------------------------------------
# supervised drills: detect -> roll back -> shrink -> resume
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    """The port's uninterrupted run on generation 0's plan."""
    res = train.run(train._parse_args(PLAN))
    assert sorted(res.losses) == list(range(STEPS))
    return dict(res.losses)


def _drill(tmp_path, faults):
    cfg = sup_mod.SupervisorConfig(
        run_dir=str(tmp_path), num_hosts=2, devices_per_host=2, steps=STEPS,
        global_batch=8, arch="uvit-nano", dp=1, pp=4, microbatches=4,
        wire_dtype="float32", lr=1e-3, ckpt_every=4, faults=faults,
        stall_timeout=4.0, miss_budget=2, poll=0.2, backoff_base=0.2,
        log_every=4, device="cpu",
        worker_env={"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""})
    res = sup_mod.Supervisor(cfg).run()
    return cfg, res, sup_mod.read_events(res.events_path)


@pytest.mark.parametrize("faults,rollback,detect", [
    ("hostdown@8:1", 8, "hostdown"), ("hang@6", 4, "hang")])
def test_supervised_drill_on_cpu(tmp_path, faults, rollback, detect):
    cfg, res, events = _drill(tmp_path, faults)
    assert res.ok and res.outcome == "done", events
    assert (res.generations, res.restarts) == (2, 1)
    assert (res.final_hosts, res.final_plan) == (1, (1, 2, 0))
    kinds = [e["kind"] for e in events]
    for k in (detect, "rollback", "shrink", "restart", "gen-live", "done"):
        assert k in kinds, kinds
    assert next(e for e in events if e["kind"] == "rollback")["step"] == \
        rollback
    shrink = next(e for e in events if e["kind"] == "shrink")
    assert shrink["plan"] == {"dp": 1, "pp": 2, "zero_stage": 0}
    hit = next(e for e in events if e["kind"] == detect)
    assert hit["host"] == (1 if detect == "hostdown" else 0)
    if detect == "hang":
        assert hit["age"] <= cfg.stall_timeout * cfg.miss_budget \
            + 5 * cfg.poll
    ref = _reference()
    assert sorted(res.losses) == list(range(STEPS))
    for s in range(STEPS):
        np.testing.assert_allclose(res.losses[s], ref[s], rtol=1e-4,
                                   err_msg=f"step {s}")
    logs = os.listdir(os.path.join(str(tmp_path), "logs"))
    assert sorted(n for n in logs if n.endswith(".log")) == sorted(
        [f"worker_h{r // 2}.r{r}.g0.log" for r in range(4)]
        + ["worker_h0.r0.g1.log", "worker_h0.r1.g1.log"])
    for n in logs:
        if n.endswith(".log"):
            text = open(os.path.join(str(tmp_path), "logs", n)).read()
            assert "[train] device: cpu (rank" in text, text
    gen1 = open(os.path.join(str(tmp_path), "logs",
                             "worker_h0.r0.g1.log")).read()
    assert f"resumed from step {rollback} (elastic restore" in gen1, gen1
    status = sup_mod.format_status(str(tmp_path))
    assert detect in status and "rollback" in status
