"""The port's two drill CLIs at their ``--fast`` subsets on the CPU:
``examples/torch_fault_tolerance.py`` (kill at step 60, resume from the
step-50 checkpoint) and ``examples/torch_supervisor_drill.py`` (host 1 down
after the step-8 commit, then host 0 hung before step 6; each recovered
shrunk), over the port's trainer and supervisor."""
from test_torch_examples import run_example


def test_fault_tolerance_fast():
    proc = run_example("torch_fault_tolerance.py", "--fast", "--device",
                       "cpu")
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    for line in ("=== kill-resume: killed at step 60",
                 "=== node died (rc=42). relaunching with --resume",
                 "=== recovered and completed 100 steps.",
                 "FAULT TOLERANCE DRILL: 1 scenario(s) OK"):
        assert line in out, line
    assert "shrink-restore" not in out


def test_supervisor_drill_fast():
    proc = run_example("torch_supervisor_drill.py", "--fast", "--device",
                       "cpu", timeout=600)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    for line in ("=== detected by exit code; rolled back + shrunk + "
                 "finished.", "=== watchdog flagged the frozen host; "
                 "recovered shrunk.", "SUPERVISOR DRILL: 2 scenario(s) OK"):
        assert line in out, line
    assert "=== straggler" not in out


def _lockstep(detector, steps, late):
    """Feed ``detector`` a two-host lockstep world of ``steps`` steps:
    host 1 enters each step ``late[s]`` seconds after host 0, both hosts'
    ``step_s`` the whole step (each waits for the other inside it), one
    poll a step entry."""
    from repro_torch.runtime.resilience import Heartbeat
    t = 100.0
    for s in range(steps):
        period = 1.0 + late[s]
        detector.observe({h: Heartbeat(h, s - 1, "train", t=t, step_s=period)
                          for h in (0, 1)})
        detector.observe_entries({0: Heartbeat(0, s, "enter", t=t),
                                  1: Heartbeat(1, s, "enter",
                                               t=t + late[s])})
        t += period


def test_straggler_detector_reads_lockstep_entries():
    """Ranks of one world run in lockstep: every host's step time is the
    slowest's, so the step times cannot tell a straggler.  Host 1 entering
    each step 2 s late (its own 3 s against host 0's 1 s) is flagged from
    the step-entry beats after ``patience`` steps; a world whose hosts
    enter together flags nobody."""
    from repro_torch.runtime.resilience import StragglerDetector
    det = StragglerDetector(factor=1.8, patience=3)
    _lockstep(det, 10, [0.0] * 4 + [2.0] * 6)
    assert set(det.stragglers()) == {1}
    assert det.stragglers()[1] > 2.5
    det = StragglerDetector(factor=1.8, patience=3)
    _lockstep(det, 10, [0.01] * 10)
    assert det.stragglers() == {}
    # the step times alone, equal on both hosts, flag nobody
    from repro_torch.runtime.resilience import Heartbeat
    det = StragglerDetector(factor=1.8, patience=3)
    for s in range(10):
        det.observe({h: Heartbeat(h, s, "train", t=100.0 + 3 * s, step_s=3.0)
                     for h in (0, 1)})
    assert det.stragglers() == {}


def test_supervisor_drill_flags_a_straggler_over_ranks():
    """The drill's ``straggler`` scenario over the port's ranks: host 1
    runs 3x slow from step 4 and is flagged, with no restart."""
    proc = run_example("torch_supervisor_drill.py", "straggler", "--device",
                       "cpu", timeout=600)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert "straggler (gen=0, host=1" in out, out[-3000:]
    assert "SUPERVISOR DRILL: 1 scenario(s) OK" in out
