"""The port's fault plan, GradGuard and heartbeats held to the JAX
package's, and the trainer's checkpoint and fault drills on the CPU.

``FaultPlan.parse`` must give the same actions and the same errors as
JAX's over a list of specs, ``GradGuard`` the same verdicts and
escalation.  The drills run ``repro_torch.launch.train`` (``uvit-pp``,
fp32 wire, ``--device cpu``) against one uninterrupted 6-step run:

- same plan: ``stop@3`` then ``--resume`` gives steps 3-5 at rtol 1e-6;
- elastic: the same checkpoint resumed at D=2 gives them at rtol 1e-4;
- ``kill@2`` in a subprocess exits 42 and the resume continues exactly;
- ``nan@1`` is skipped and counted (no AdamW step);
- ``corrupt@4``/``truncate@4`` make the resume fall back to step 2;
- ``iofail`` retries, or degrades to a warned, missing save;
- an exhausted skip budget aborts, or exits 43 with ``--escalation
  rollback``.
"""
import dataclasses
import functools
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import resilience as jres
from repro_torch.checkpoint import latest_step
from repro_torch.launch import train
from repro_torch.runtime import resilience as tres
from repro_torch.tree import tree_leaves

REPO = pathlib.Path(__file__).resolve().parents[1]
BASE = ["--arch", "uvit-pp", "--pipeline", "--devices", "4", "--steps",
        "6", "--global-batch", "8", "--microbatches", "4", "--device", "cpu",
        "--wire-dtype", "float32", "--log-every", "100"]

SPECS = [
    "kill@60,stop@4,nan@10,corrupt@80:shard_00001,truncate@9,iofail@20:3",
    "hostdown@30:1,hang@40,slow@50:2.5:1,hang@41:1", "iofail@2", "",
    " nan@1 , stop@2 ", "explode@3", "garbage", "kill@-1", "nan@2,nan@2",
    "kill@3:x", "iofail@2:0", "iofail@2:x", "hostdown@3", "hostdown@3:x",
    "slow@5", "slow@5:0.5", "slow@5:x", "hang@3:x", "corrupt@2:shard_0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from more threads, and tier-1 runs six
    test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(mod, fn):
    """The actions a parse gives, or its error's type name, reason, token."""
    try:
        plan = fn(mod)
    except ValueError as e:
        return ("error", type(e).__name__, getattr(e, "reason", None),
                getattr(e, "token", None))
    return [dataclasses.astuple(a) for a in plan.actions]


@pytest.mark.parametrize("spec", SPECS)
def test_faultplan_parse_matches_jax(spec):
    parse = lambda m: m.FaultPlan.parse(spec)
    assert _outcome(tres, parse) == _outcome(jres, parse)
    for host, n in ((0, 1), (1, 2), (0, 2)):
        split = lambda m: m.FaultPlan.parse(spec).for_host(host, n)
        assert _outcome(tres, split) == _outcome(jres, split), (host, n)


def test_faultplan_hooks_match_jax(monkeypatch):
    spec = "nan@2,stop@3,iofail@5:2,slow@4:2.5,slow@6:3,hang@7,kill@9"
    t, j = tres.FaultPlan.parse(spec), jres.FaultPlan.parse(spec)
    for step in range(10):
        assert t.wants_nan(step) == j.wants_nan(step)
        assert t.slow_factor(step) == j.slow_factor(step)
        slept = []
        assert t.hang_before(step, sleep=slept.append, seconds=1.0) == \
            j.hang_before(step, sleep=lambda s: None, seconds=1.0)
        assert slept == ([1.0] if step == 7 else [])
        if step < 9:
            assert t.post_step(step) == j.post_step(step)
    for step in (3, 5, 5, 5, 6):
        got = want = None
        try:
            t.io_fault(step)
        except OSError:
            got = "fail"
        try:
            j.io_fault(step)
        except OSError:
            want = "fail"
        assert got == want, step
    monkeypatch.setenv("REPRO_FAULTS", "nan@7")
    assert tres.FaultPlan.parse(None).wants_nan(7)
    assert tres.FaultPlan.parse("").with_kill(4).actions == \
        (tres.FaultAction("kill", 4),)
    assert (tres.EXIT_KILLED, tres.EXIT_ESCALATE) == \
        (jres.EXIT_KILLED, jres.EXIT_ESCALATE)


def test_poison_batch_and_all_finite_match_jax():
    batch = {"latents": np.ones((2, 3), np.float32),
             "labels": np.arange(2, dtype=np.int32)}
    fp_t, fp_j = tres.FaultPlan.parse("nan@1"), jres.FaultPlan.parse("nan@1")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    assert fp_t.poison_batch(tb, 0) is tb
    got = fp_t.poison_batch(tb, 1)
    want = fp_j.poison_batch({k: jnp.asarray(v) for k, v in batch.items()}, 1)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].dtype == tb[k].dtype
    for vals in ([1.0, 2.0], [1.0, float("nan")], [float("inf"), 0.0]):
        tree = {"g": vals, "n": 3}
        t = {"g": torch.tensor(vals), "n": torch.tensor(3)}
        j = {"g": jnp.asarray(vals), "n": jnp.asarray(3)}
        assert bool(tres.all_finite(t, torch.tensor(0.5))) == \
            bool(jres.all_finite(j, jnp.asarray(0.5))), tree
    assert bool(tres.all_finite({"i": torch.arange(3)}))


def _guard_trace(mod, budget, flags):
    g, out = mod.GradGuard(budget=budget), []
    for step, ok in enumerate(flags):
        try:
            out.append(g.observe(ok, step))
        except mod.GradGuardEscalation as e:
            out.append(("escalate", e.step, e.consecutive, e.budget,
                        isinstance(e, RuntimeError)))
            break
    return out, g.skipped_total, g.consecutive


@pytest.mark.parametrize("budget,flags", [
    (2, [True, False, False, False]), (1, [False, True, False, True]),
    (0, [True, False]), (3, [False] * 3 + [True] + [False] * 4)])
def test_gradguard_matches_jax(budget, flags):
    assert _guard_trace(tres, budget, flags) == \
        _guard_trace(jres, budget, flags)


def test_heartbeats_cross_read(tmp_path):
    tres.write_heartbeat(str(tmp_path), tres.Heartbeat(0, 5, "train",
                                                       loss=1.5, gen=2))
    jres.write_heartbeat(str(tmp_path), jres.Heartbeat(1, 3, "ckpt", gen=2))
    (tmp_path / "hb_h00007.json").write_text("{torn")
    for mod in (tres, jres):
        got = mod.read_heartbeats(str(tmp_path), gen=2)
        assert sorted(got) == [0, 1]
        assert (got[0].step, got[0].phase, got[0].loss) == (5, "train", 1.5)
        assert got[1].phase == "ckpt" and got[1].pid == os.getpid()
        assert mod.read_heartbeats(str(tmp_path), gen=1) == {}


# ---------------------------------------------------------------------------
# trainer drills
# ---------------------------------------------------------------------------

def _run(extra=(), on_restore=None):
    return train.run(train._parse_args(BASE + list(extra)),
                     on_restore=on_restore)


@functools.lru_cache(maxsize=None)
def _baseline():
    res = _run()
    return res.losses


@pytest.fixture(scope="module")
def stopped(tmp_path_factory):
    """A run stopped after step 2 with a checkpoint of step 3."""
    d = tmp_path_factory.mktemp("stop3")
    res = _run(["--ckpt-dir", str(d), "--ckpt-every", "3", "--faults",
                "stop@3"])
    return d, res


def _close(got, want, rtol):
    for s, v in want.items():
        assert math.isclose(got[s], v, rel_tol=rtol, abs_tol=0.0), \
            (s, got[s], v)


def test_drill_stop_then_exact_resume(stopped, tmp_path):
    d, res = stopped
    base = _baseline()
    assert sorted(res.losses) == [0, 1, 2] and res.start == 0
    assert [r["step"] for r in res.saves] == [3] and res.saves[0]["path"]
    _close(res.losses, {s: base[s] for s in (0, 1, 2)}, 1e-6)
    ck = tmp_path / "ck"
    shutil.copytree(d, ck)
    seen = []
    out = tmp_path / "run.json"
    got = _run(["--ckpt-dir", str(ck), "--resume", "--out-json", str(out)],
               on_restore=lambda st, info: seen.append(
                   (int(st["opt"]["step"]), info.step, info.elastic)))
    assert seen == [(3, 3, False)]
    assert got.start == 3 and sorted(got.losses) == [3, 4, 5]
    assert not got.resumed.elastic
    _close(got.losses, {s: base[s] for s in (3, 4, 5)}, 1e-6)
    doc = json.loads(out.read_text())
    assert (doc["start"], doc["resumed_step"], doc["elastic"],
            doc["skipped_steps"]) == (3, 3, False, 0)
    # the final save of step 6, and the model-space params
    assert [r["step"] for r in got.saves] == [6]
    merged = tree_leaves(got.compiled.merge_params(*got.params))
    logical = tree_leaves(got.logical_params)
    assert len(logical) == len(merged)
    for a, b in zip(logical, merged):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_drill_elastic_resume_onto_two_devices(stopped, tmp_path):
    d, res = stopped
    ck = tmp_path / "ck"
    shutil.copytree(d, ck)
    got = _run(["--ckpt-dir", str(ck), "--resume", "--devices", "2"])
    assert got.resumed.elastic and got.start == 3
    assert "D=2 devices" in got.plan
    _close(got.losses, {s: _baseline()[s] for s in (3, 4, 5)}, 1e-4)


def test_drill_kill_in_a_subprocess_then_resume(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"] + BASE
        + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
           "--simulate-failure", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == tres.EXIT_KILLED, proc.stdout + proc.stderr
    assert "hard node failure after step 2" in proc.stdout
    got = _run(["--ckpt-dir", str(tmp_path), "--resume"])
    assert got.start == 2 and sorted(got.losses) == [2, 3, 4, 5]
    _close(got.losses, {s: _baseline()[s] for s in (2, 3, 4, 5)}, 1e-6)


def test_drill_resume_without_a_verified_step_starts_afresh(tmp_path):
    (tmp_path / "step_000000004").mkdir()           # no manifest
    res = _run(["--steps", "1", "--ckpt-dir", str(tmp_path), "--resume"])
    assert res.start == 0 and res.resumed is None and res.restore is None
    _close(res.losses, {0: _baseline()[0]}, 1e-6)


def test_drill_nan_step_is_skipped_and_counted():
    res = _run(["--steps", "3", "--faults", "nan@1"])
    assert res.skipped_steps == 1
    assert math.isnan(res.losses[1])
    assert all(math.isfinite(res.losses[s]) for s in (0, 2))
    assert int(res.opt_state["step"]) == 2          # no AdamW step at 1


@pytest.mark.parametrize("verb", ["corrupt", "truncate"])
def test_drill_damaged_checkpoint_falls_back(tmp_path, verb):
    res = _run(["--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                "--faults", f"{verb}@4,stop@4"])
    assert [r["step"] for r in res.saves] == [2, 4]
    got = _run(["--ckpt-dir", str(tmp_path), "--resume", "--steps", "3"])
    assert got.start == 2 and got.resumed.step == 2
    assert sorted(got.losses) == [2]


def test_drill_iofail_retries_or_degrades(tmp_path):
    res = _run(["--steps", "2", "--ckpt-dir", str(tmp_path / "a"),
                "--ckpt-every", "2", "--faults", "iofail@2:2"])
    (rec,) = res.saves
    assert rec["path"] and rec["attempts"] == 3
    with pytest.warns(RuntimeWarning, match="training continues"):
        res = _run(["--steps", "2", "--ckpt-dir", str(tmp_path / "b"),
                    "--ckpt-every", "2", "--faults", "iofail@2:9"])
    (rec,) = res.saves
    assert rec["path"] is None and rec["attempts"] == 4
    assert latest_step(str(tmp_path / "b")) is None


@pytest.mark.parametrize("policy", ["abort", "rollback"])
def test_drill_exhausted_budget_escalates(policy):
    extra = ["--steps", "3", "--faults", "nan@1", "--nan-skip-budget", "0",
             "--escalation", policy]
    if policy == "rollback":
        with pytest.raises(SystemExit) as ei:
            _run(extra)
        assert ei.value.code == tres.EXIT_ESCALATE == 43
    else:
        with pytest.raises(tres.GradGuardEscalation) as ei:
            _run(extra)
        assert (ei.value.step, ei.value.consecutive, ei.value.budget) == \
            (1, 1, 0)


def test_drill_heartbeats(tmp_path):
    _run(["--steps", "2", "--heartbeat-dir", str(tmp_path), "--gen", "3"])
    (hb,) = jres.read_heartbeats(str(tmp_path), gen=3).values()
    assert (hb.host_id, hb.step, hb.phase) == (0, 2, "done")
