"""Hardware models used by the partitioner and the roofline analysis.

The ``Hardware`` record of ``repro.core.hw`` and the one preset the port
plans for, ``H100_SXM``.  (The JAX package's presets describe other
machines; a test that needs one builds a ``Hardware`` from it.)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per-chip peak (bf16/fp16) FLOP/s
    hbm_bw: float              # per-chip HBM bytes/s
    intra_bw: float            # effective intra-node / intra-pod link bytes/s
    inter_bw: float            # effective inter-node / inter-pod bytes/s
    mem_limit: float           # per-device memory budget (bytes)
    t_lat: float = 5e-6        # static latency of a communication kernel (s)


# NVIDIA H100 SXM (data sheet, dense rates, 700 W): 989 TFLOP/s bf16,
# 3.35 TB/s HBM3, 80 GB; NVLink 4 gives 900 GB/s per card, 450 GB/s each
# way, all to all within a host.
H100_SXM = Hardware(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    intra_bw=450e9,
    inter_bw=450e9,
    mem_limit=80e9,
)


PRESETS = {h.name: h for h in (H100_SXM,)}
