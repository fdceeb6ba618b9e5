"""``python -m repro_torch.analysis.verify`` -- certify plans offline (the
port of ``repro.analysis.verify``).

Re-synthesizes the tier-1 example plans (or loads saved plan snapshots)
and runs the full static dataflow proof on each lowering, printing one
summary line per certificate and exiting non-zero if any plan fails:

    python -m repro_torch.analysis.verify                    # all tier-1
    python -m repro_torch.analysis.verify hunyuan32          # one config
    python -m repro_torch.analysis.verify --plan plan.json   # a snapshot
    python -m repro_torch.analysis.verify --use-ilp          # + ILP plans

Per config the matrix covers every synthesis path ``auto_pipeline`` can
ship -- the unit-slot greedy, the duration-aware timed greedy in every
priority orientation, and the portfolio pick -- for V in {1, 2, 4}
(infeasible interleave degrees are skipped) and both hop lowerings
(``overlap`` on/off).  ``--use-ilp`` adds the exact ILP synthesis at
V = 1, where HiGHS stays tractable.

Plans are built through the port's planner (``core/``), its lowering
(``runtime/schedule_exec.py``, which imports torch) and its certificates
(``analysis/certificate.py``); those imports are deferred, so
re-certifying a ``--plan`` snapshot -- the port's or one the JAX package
exported: the format is shared -- stays numpy-only end to end.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.certificate import (PlanCertificate,
                                              certify_tables, export_plan,
                                              load_plan)

TIER1_CONFIGS = ("sdv2unet29", "skipvit26", "hunyuan32")
INTERLEAVE_DEGREES = (1, 2, 4)


def tier1_graph(name: str):
    """(BlockGraph, pipeline device count) for a tier-1 config name, the
    JAX package's three: the SDv2 UNet's 29 blocks, a 26-block SkipViT
    with seeded block times and Hunyuan-DiT's 32 blocks (the UNet's and
    Hunyuan's costs from the port's hardware preset, ``H100_SXM``)."""
    if name == "sdv2unet29":
        from repro_torch.configs import sdv2_unet
        from repro_torch.models.diffusion import unet_block_graph
        return unet_block_graph(sdv2_unet.CFG, batch=1), 4
    if name == "skipvit26":
        import random

        from repro_torch.models.diffusion import (SkipViTConfig,
                                                  skipvit_pipeline_graph)
        rnd = random.Random(0)
        cfg = SkipViTConfig("b", n_enc=12, n_mid=2, n_dec=12)
        return skipvit_pipeline_graph(
            cfg, fwd_times=[rnd.uniform(0.5, 3.0) for _ in range(26)]), 4
    if name == "hunyuan32":
        from repro_torch.configs import hunyuan_dit
        return hunyuan_dit.pipeline_graph(), 4
    raise ValueError(
        f"unknown config {name!r}; expected one of {TIER1_CONFIGS} "
        "(or pass --plan for a saved snapshot)")


def _synthesize(part, M: int, *, use_ilp: bool, time_limit: float):
    """name -> validated Schedule, every synthesis path the port ships."""
    from repro_torch.core.schedule import (TIMED_PRIORITIES, greedy_schedule,
                                           greedy_schedule_timed,
                                           schedule_for_partition,
                                           validate_schedule)
    S, D = part.num_stages, part.num_devices
    times = getattr(part, "stage_costs", None) or (1.0,) * S
    scheds = {"greedy": greedy_schedule(S, M, part.device_of_stage, D)}
    for prio in TIMED_PRIORITIES:
        scheds[f"timed-{prio}"] = greedy_schedule_timed(
            S, M, part.device_of_stage, D, times, priority=prio)
    scheds["portfolio"] = schedule_for_partition(part, M)
    if use_ilp and S <= 2 * D:      # V = 1: where HiGHS stays tractable
        scheds["ilp"] = schedule_for_partition(part, M, use_ilp=True,
                                               time_limit=time_limit)
    for name, sched in scheds.items():
        errors = validate_schedule(sched, part.device_of_stage,
                                   collocated=part.collocated_pairs(),
                                   folded=getattr(part, "folded", False))
        if errors:
            raise ValueError(f"{name} synthesis produced an invalid "
                             f"schedule: {errors[:3]}")
    return scheds


def certify_config(name: str, *, use_ilp: bool = False,
                   time_limit: float = 120.0, export_dir=None,
                   zero: bool = False) -> list[PlanCertificate]:
    """Certify every (synthesis, V, overlap) plan for one tier-1 config.

    Every run also certifies one hybrid (dp=2) plan per graph -- the
    per-replica dataflow proof is unchanged, but the certificate records
    the (dp, zero_stage) dimensions the rank executors would run with.
    ``zero`` adds the ZeRO-2 rest-sharded variant.
    """
    from repro_torch.core.partition import partition
    from repro_torch.runtime.compile import StageLayout
    from repro_torch.runtime.schedule_exec import StepTables
    graph, D = tier1_graph(name)
    M = 2 * D
    certs: list[PlanCertificate] = []
    for V in INTERLEAVE_DEGREES:
        try:
            part = partition(graph, D, lam=0.0, interleave=V)
        except ValueError as e:
            print(f"skip {name} V={V}: {e}", file=sys.stderr)
            continue
        consumers = (StageLayout.from_partition(part, graph)
                     .skip_consumers() if part.folded else None)
        for synth, sched in _synthesize(part, M, use_ilp=use_ilp,
                                        time_limit=time_limit).items():
            tabs = StepTables.from_schedule(
                sched, folded=part.folded, devices=part.devices,
                skip_consumers=consumers)
            for overlap in (True, False):
                tag = (f"{name}/v{V}/{synth}/"
                       f"{'overlap' if overlap else 'sync'}")
                certs.append(certify_tables(
                    tabs, skip_consumers=consumers, overlap=overlap,
                    name=tag))
            if synth == "portfolio" and V == 1:
                for z in ((1, 2) if zero else (1,)):
                    certs.append(certify_tables(
                        tabs, skip_consumers=consumers, overlap=True,
                        dp=2, zero_stage=z,
                        name=f"{name}/v1/portfolio/dp2-zero{z}"))
                if export_dir is not None:
                    export_plan(tabs,
                                export_dir / f"{name}_v1_portfolio_dp2.json",
                                skip_consumers=consumers, dp=2,
                                zero_stage=2 if zero else 1,
                                name=f"{name}/v1/portfolio/dp2")
            if export_dir is not None:
                path = export_dir / f"{name}_v{V}_{synth}.json"
                export_plan(tabs, path, skip_consumers=consumers,
                            name=f"{name}/v{V}/{synth}")
    return certs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.verify",
        description="statically certify lowered pipeline plans")
    ap.add_argument("configs", nargs="*",
                    help=f"tier-1 config names (default: all of "
                         f"{', '.join(TIER1_CONFIGS)})")
    ap.add_argument("--plan", action="append", default=[],
                    metavar="FILE",
                    help="certify a saved plan snapshot (export_plan "
                         "JSON) instead of re-synthesizing")
    ap.add_argument("--use-ilp", action="store_true",
                    help="additionally certify exact-ILP plans (V=1)")
    ap.add_argument("--zero", action="store_true",
                    help="additionally certify ZeRO-2 hybrid (dp=2) "
                         "plan variants")
    ap.add_argument("--time-limit", type=float, default=120.0,
                    help="ILP solver time limit in seconds")
    ap.add_argument("--export-dir", metavar="DIR",
                    help="also snapshot each lowered plan to DIR")
    ap.add_argument("--json", metavar="FILE", dest="json_out",
                    help="write all certificates to FILE as JSON")
    args = ap.parse_args(argv)

    export_dir = None
    if args.export_dir:
        import pathlib
        export_dir = pathlib.Path(args.export_dir)
        export_dir.mkdir(parents=True, exist_ok=True)

    certs: list[PlanCertificate] = []
    for path in args.plan:
        cert = load_plan(path).certify()
        certs.append(cert if cert.name else
                     PlanCertificate(**{**cert.__dict__, "name": path}))
    if not args.plan or args.configs:
        for name in (args.configs or TIER1_CONFIGS):
            certs.extend(certify_config(
                name, use_ilp=args.use_ilp, time_limit=args.time_limit,
                export_dir=export_dir, zero=args.zero))

    for cert in certs:
        print(cert.summary())
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump([c.to_dict() for c in certs], fh, indent=2,
                      sort_keys=True)
    bad = [c for c in certs if not c.ok]
    print(f"{len(certs) - len(bad)}/{len(certs)} plans certified clean")
    return 1 if bad or not certs else 0


if __name__ == "__main__":
    sys.exit(main())
