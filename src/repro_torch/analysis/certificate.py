"""Machine-readable plan certificates + offline plan snapshots.

A copy of ``repro.analysis.certificate``: the port imports nothing of the JAX
package, so it keeps its own copy of this framework-neutral module.  The
schemas keep the reference's names, so a certificate or a saved plan reads
the same in both packages.

A :class:`PlanCertificate` packages one :func:`~repro_torch.analysis.dataflow.
interpret_tables` run — checks run, violations found, the replayed
buffer-occupancy proofs behind the declared liveness windows, and the
exposed/hidden hop accounting — as a JSON document that CI (or an
operator) can archive next to a deployed plan and re-verify offline.

``export_plan`` / ``load_plan`` snapshot the lowered step tables
themselves (plus the skip-consumer map and pipeline config the proof is
conditional on) to a JSON file, so a plan can be re-certified
(``load_plan(path).certify()``) with no model code, no framework, and no
scheduler in the loop.  Everything in this module is numpy-only.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

from repro_torch.analysis.dataflow import (CHECKS, DataflowReport, Violation,
                                     interpret_tables)

CERTIFICATE_SCHEMA = "repro.plan-certificate/v1"
PLAN_SCHEMA = "repro.saved-plan/v1"

# Mirrors runtime.pipeline.WIRE_DTYPES (asserted equal in the test
# suite); duplicated so certification never imports the torch-backed
# runtime modules.
WIRE_DTYPES = ("bfloat16", "float32")

_TABLE_FIELDS = (
    "D", "M", "V", "rings", "forward_steps", "sel", "slot", "mb",
    "down_mb", "down_valid", "up_mb", "up_valid", "loss", "embed",
    "turn_rd", "turn_wr", "down_send", "up_send", "down_slot", "up_slot",
    "rx_slot", "turn_wr_slot", "turn_rd_slot", "skip_wr", "skip_wr_slot",
    "skip_rd_slot", "W_down", "W_up", "W_turn", "W_skip", "exposed_down",
    "exposed_up", "embed_device", "turn_device")
_INT_FIELDS = ("D", "M", "V", "rings", "W_down", "W_up", "W_turn",
               "W_skip", "exposed_down", "exposed_up", "embed_device",
               "turn_device")
_BOOL_TABLES = ("down_valid", "up_valid", "loss", "embed", "turn_rd",
                "turn_wr", "down_send", "up_send", "skip_wr")


@dataclasses.dataclass(frozen=True)
class PlanCertificate:
    """The static proof for one lowered plan, serializable to JSON.

    ``ok`` is the verdict; everything else is the evidence: which checks
    ran, what failed, the replayed per-channel peak occupancies vs the
    windows the lowering declared, and the hop-overlap accounting.
    """

    ok: bool
    checks: tuple[str, ...]
    failed_checks: tuple[str, ...]
    violations: tuple[str, ...]
    plan: dict[str, Any]          # D, M, V, rings, steps, overlap, wire
    windows: dict[str, dict[str, int]]   # chan -> {declared, peak}
    hops: dict[str, int]
    name: str | None = None

    def to_dict(self) -> dict[str, Any]:
        return {"schema": CERTIFICATE_SCHEMA,
                "name": self.name,
                "ok": self.ok,
                "checks": list(self.checks),
                "failed_checks": list(self.failed_checks),
                "violations": list(self.violations),
                "plan": dict(self.plan),
                "windows": {k: dict(v) for k, v in self.windows.items()},
                "hops": dict(self.hops)}

    def to_json(self, *, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, doc: dict[str, Any]) -> "PlanCertificate":
        if doc.get("schema") != CERTIFICATE_SCHEMA:
            raise ValueError(
                f"not a plan certificate (schema={doc.get('schema')!r}, "
                f"expected {CERTIFICATE_SCHEMA!r})")
        return cls(ok=bool(doc["ok"]),
                   checks=tuple(doc["checks"]),
                   failed_checks=tuple(doc["failed_checks"]),
                   violations=tuple(doc["violations"]),
                   plan=dict(doc["plan"]),
                   windows={k: dict(v)
                            for k, v in doc["windows"].items()},
                   hops=dict(doc["hops"]),
                   name=doc.get("name"))

    @classmethod
    def from_json(cls, text: str) -> "PlanCertificate":
        return cls.from_dict(json.loads(text))

    def summary(self) -> str:
        p = self.plan
        dp, zs = p.get("dp", 1), p.get("zero_stage", 0)
        hybrid = f" dp={dp} zero={zs}" if dp > 1 or zs > 0 else ""
        head = (f"{self.name or 'plan'}: D={p['D']} M={p['M']} "
                f"V={p['V']} rings={p['rings']} steps={p['num_steps']}"
                f"{hybrid} wire={p['wire_dtype']} "
                f"{'overlap' if p['overlap'] else 'sync'}")
        win = " ".join(f"{c}={w['peak']}/{w['declared']}"
                       for c, w in self.windows.items())
        hop = (f"hops live={self.hops['live_down']}+{self.hops['live_up']} "
               f"exposed={self.hops['exposed']} "
               f"hidden={self.hops['hidden']}")
        if self.ok:
            return f"OK   {head} | peaks {win} | {hop}"
        lines = [f"FAIL {head} | checks failed: "
                 f"{', '.join(self.failed_checks)}"]
        lines += [f"  - {v}" for v in self.violations[:20]]
        if len(self.violations) > 20:
            lines.append(f"  ... and {len(self.violations) - 20} more")
        return "\n".join(lines)


def _certificate_from_report(tabs, report: DataflowReport, *,
                             overlap: bool, wire_dtype: str,
                             dp: int = 1, zero_stage: int = 0,
                             fingerprint: str | None = None,
                             name: str | None) -> PlanCertificate:
    violations = list(report.violations)
    if wire_dtype not in WIRE_DTYPES:
        violations.append(Violation(
            "wire-dtype-flow",
            f"unknown wire_dtype {wire_dtype!r}; expected one of "
            f"{WIRE_DTYPES}"))
    live_down, live_up = (int(x) for x in tabs.live_hops)
    failed = tuple(sorted({v.check for v in violations},
                          key=CHECKS.index))
    return PlanCertificate(
        ok=not violations,
        checks=CHECKS,
        failed_checks=failed,
        violations=tuple(str(v) for v in violations),
        plan={"D": int(tabs.D), "M": int(tabs.M), "V": int(tabs.V),
              "rings": int(tabs.rings),
              "num_steps": int(tabs.num_steps),
              "dp": int(dp), "zero_stage": int(zero_stage),
              "overlap": bool(overlap), "wire_dtype": wire_dtype,
              # the state-layout digest restore checks against (None for
              # bare-table certifications with no CompiledPipeline)
              "fingerprint": fingerprint},
        windows={"down": {"declared": int(tabs.W_down),
                          "peak": report.peak_down},
                 "up": {"declared": int(tabs.W_up),
                        "peak": report.peak_up},
                 "turn": {"declared": int(tabs.W_turn),
                          "peak": report.peak_turn},
                 "skip": {"declared": int(tabs.W_skip),
                          "peak": report.peak_skip}},
        hops={"live_down": live_down, "live_up": live_up,
              "exposed": report.exposed_down + report.exposed_up,
              "hidden": live_down + live_up
              - report.exposed_down - report.exposed_up,
              "dense": int(tabs.rings) * int(tabs.D)
              * int(tabs.num_steps)},
        name=name)


def certify_tables(tabs, *, skip_consumers=None, overlap: bool = True,
                   wire_dtype: str = "bfloat16",
                   dp: int = 1, zero_stage: int = 0,
                   fingerprint: str | None = None,
                   name: str | None = None) -> PlanCertificate:
    """Certify lowered step tables directly (numpy-only, no framework).

    ``skip_consumers`` must be the same consumer map the lowering was
    given (``StageLayout.skip_consumers()``) — folded V > 1 plans elide
    dead stash stores, so the conservative read-every-slot default would
    reject valid plans.  ``dp``/``zero_stage`` record the hybrid plan
    dimensions (DP replica count over the data axes and ZeRO sharding
    stage) the executor was configured with — the dataflow proof itself
    is per-replica, so they are certificate metadata, not checked state.
    """
    report = interpret_tables(tabs, overlap=overlap,
                              skip_consumers=skip_consumers)
    return _certificate_from_report(tabs, report, overlap=overlap,
                                    wire_dtype=wire_dtype, dp=dp,
                                    zero_stage=zero_stage,
                                    fingerprint=fingerprint, name=name)


def certify_plan(plan, *, name: str | None = None) -> PlanCertificate:
    """Certify a :class:`~repro_torch.runtime.compile.CompiledPipeline`.

    Pulls the memoized lowering, consumer map, and pipeline config off
    the plan so the certificate describes exactly what ``build()`` would
    execute.  Only meaningful for the table executors — the closed-form
    differential references don't lower to step tables (their certificate
    covers what ``executor="table"`` would run for the same schedule).
    """
    tabs = plan.step_tables()
    consumers = plan.layout.skip_consumers() if plan.folded else None
    fp = plan.fingerprint() if hasattr(plan, "fingerprint") else None
    # the port's one-process executor has no overlap switch: its plans
    # certify as the JAX package's default, overlapped lowering
    return certify_tables(
        tabs, skip_consumers=consumers,
        overlap=True,
        wire_dtype=plan.pcfg.wire_dtype,
        dp=getattr(plan.pcfg, "dp_size", 1),
        zero_stage=getattr(plan.pcfg, "zero_stage", 0),
        fingerprint=fp, name=name)


def certify_schedule(sched, *, folded: bool, devices=None,
                     skip_consumers=None, overlap: bool = True,
                     wire_dtype: str = "bfloat16",
                     dp: int = 1, zero_stage: int = 0,
                     name: str | None = None) -> PlanCertificate:
    """Lower a validated schedule and certify the result.

    Imports the (torch-backed) lowering lazily — the rest of this package
    stays importable without torch.
    """
    from repro_torch.runtime.schedule_exec import StepTables
    tabs = StepTables.from_schedule(sched, folded=folded, devices=devices,
                                    skip_consumers=skip_consumers)
    return certify_tables(tabs, skip_consumers=skip_consumers,
                          overlap=overlap, wire_dtype=wire_dtype,
                          dp=dp, zero_stage=zero_stage, name=name)


# ===========================================================================
# Offline plan snapshots
# ===========================================================================

@dataclasses.dataclass
class SavedPlan:
    """A lowered plan snapshot: duck-typed step tables + the config the
    dataflow proof is conditional on."""

    tables: Any                   # StepTables-shaped namespace
    skip_consumers: tuple | None
    overlap: bool
    wire_dtype: str
    dp: int = 1
    zero_stage: int = 0
    name: str | None = None

    def certify(self) -> PlanCertificate:
        return certify_tables(
            self.tables, skip_consumers=self.skip_consumers,
            overlap=self.overlap, wire_dtype=self.wire_dtype,
            dp=self.dp, zero_stage=self.zero_stage,
            name=self.name)


class _Tables:
    """Plain attribute bag quacking like StepTables for the interpreter."""

    @property
    def num_steps(self) -> int:
        return self.sel.shape[1]

    @property
    def live_hops(self) -> tuple[int, int]:
        return int(self.down_send.sum()), int(self.up_send.sum())


def export_plan(tabs, path, *, skip_consumers=None, overlap: bool = True,
                wire_dtype: str = "bfloat16",
                dp: int = 1, zero_stage: int = 0,
                name: str | None = None) -> None:
    """Snapshot lowered step tables (+ proof context) to a JSON file."""
    doc: dict[str, Any] = {"schema": PLAN_SCHEMA, "name": name,
                           "overlap": bool(overlap),
                           "wire_dtype": wire_dtype,
                           "dp": int(dp), "zero_stage": int(zero_stage),
                           "skip_consumers": skip_consumers,
                           "tables": {}}
    for field in _TABLE_FIELDS:
        val = getattr(tabs, field)
        doc["tables"][field] = (np.asarray(val).tolist()
                                if isinstance(val, np.ndarray)
                                else (list(val) if isinstance(val, tuple)
                                      else int(val)))
    with open(path, "w") as fh:
        json.dump(doc, fh, sort_keys=True)


def load_plan(path) -> SavedPlan:
    """Rehydrate an :func:`export_plan` snapshot for re-certification."""
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("schema") != PLAN_SCHEMA:
        raise ValueError(
            f"not a saved plan (schema={doc.get('schema')!r}, expected "
            f"{PLAN_SCHEMA!r})")
    tabs = _Tables()
    for field in _TABLE_FIELDS:
        val = doc["tables"][field]
        if field in _INT_FIELDS:
            setattr(tabs, field, int(val))
        elif field == "forward_steps":
            setattr(tabs, field, tuple(int(x) for x in val))
        else:
            dtype = bool if field in _BOOL_TABLES else np.int32
            setattr(tabs, field, np.asarray(val, dtype=dtype))
    sc = doc.get("skip_consumers")
    consumers = (tuple(tuple(tuple(int(e) for e in slot) for slot in dev)
                       for dev in sc) if sc is not None else None)
    return SavedPlan(tables=tabs, skip_consumers=consumers,
                     overlap=bool(doc["overlap"]),
                     wire_dtype=str(doc["wire_dtype"]),
                     dp=int(doc.get("dp", 1)),
                     zero_stage=int(doc.get("zero_stage", 0)),
                     name=doc.get("name"))
