"""Static plan verification: prove a lowered plan safe before it runs.

The port's copy of ``repro.analysis``: the dataflow proof and the plan
certificate, which import neither JAX nor torch; the offline certifying
CLI (``python -m repro_torch.analysis.verify``); the launch constraints
of the port's CUDA kernels in plain arithmetic
(:mod:`repro_torch.analysis.kernel_check`, whose verdicts the kernel
wrappers raise); and the AST policy linter (``python -m
repro_torch.analysis.lint``: the port's import boundary, a lazy torch in
``core/``, guarded extrema in the scheduler).

The compile path validates *schedules* (``core.schedule.validate_schedule``,
constraint families 6-11) and the lowering rejects shapes the executors
cannot realize (``runtime.schedule_exec.PlanError``) — but until now
nothing certified the *lowered step tables themselves*: the rotating-buffer
slot assignments, channel-activity masks, and double-buffered hop ordering
the scan bodies actually execute.  This package closes that gap with pure
host-side analyses (no framework import, no execution):

- :mod:`repro_torch.analysis.dataflow` — abstractly interprets a lowered
  :class:`~repro_torch.runtime.schedule_exec.StepTables` device program
  over the rotating ``W_down``/``W_up``/``W_turn``/``W_skip`` buffers and
  proves it race-free (no store clobbers a live slot), initialization-sound (every
  read sees exactly one matching store), deadlock-free (ring sends and
  receives pair one hop apart every step, in both the synchronous and the
  overlapped double-buffered lowering) and wire-dtype consistent.
- :mod:`repro_torch.analysis.certificate` — bundles the proof into a
  machine-readable :class:`PlanCertificate` (JSON), attached to
  ``CompiledPipeline.certify()`` and verifiable offline.
"""
from repro_torch.analysis.dataflow import (CHECKS, DataflowReport,
                                           Violation, interpret_tables)
from repro_torch.analysis.certificate import (PlanCertificate, certify_plan,
                                              certify_schedule,
                                              certify_tables, export_plan,
                                              load_plan)

__all__ = [
    "CHECKS",
    "DataflowReport",
    "Violation",
    "interpret_tables",
    "PlanCertificate",
    "certify_plan",
    "certify_schedule",
    "certify_tables",
    "export_plan",
    "load_plan",
]
