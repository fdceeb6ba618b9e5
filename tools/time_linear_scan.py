#!/usr/bin/env python3
"""Time the gated linear scan of the ``repro_torch`` on ``PYTHONPATH``.

    PYTHONPATH=<checkout>/src python3 tools/time_linear_scan.py

It exists to compare the scan with a checkout whose ``chip_smoke.py`` times
neither its backward nor the wide shape: run it once a checkout, in turns,
in one call on one card.  It times what every version of
``repro_torch.kernels.linear_scan`` has: the forward kernel
``gated_linear_scan_cuda(a, x)``, and the op's backward, the node that
``gated_linear_scan`` records called as autograd calls it
(``h.grad_fn.apply(g)``: on a card one kernel launch or, in the first
version of the port, the forward kernel on the time-reversed scan between
concatenations, flips and casts).  Inputs are ``chip_smoke.scan_inputs``'
at the decay near 1; each is timed with ``chip_smoke.time_ms``: ``ms`` as
CUDA events around 20 calls as issued, ``device_ms`` as the replay of the
same 20 calls from one CUDA graph, at ``chip_smoke.SCAN_SHAPES``, in bf16
and fp32.  Kernels build into the checkout's ``build/``.  Prints one JSON
line per row, then the card's name and power limit as ``nvidia-smi`` gives
them.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_linear_scan: no CUDA device")
    from chip_smoke import SCAN_DECAYS, SCAN_SHAPES, scan_inputs, time_ms
    from repro_torch.kernels.linear_scan import ops
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for shape, (R, T, C) in SCAN_SHAPES.items():
            a, x, g = scan_inputs(torch, gen, R, T, C, dt, dt,
                                  SCAN_DECAYS[-1])
            h = ops.gated_linear_scan(a.requires_grad_(True), x)
            for direction, fn in (
                    ("forward", lambda: ops.gated_linear_scan_cuda(a, x)),
                    ("backward", lambda: h.grad_fn.apply(g))):
                print(json.dumps(dict(
                    package=os.path.dirname(ops.__file__), shape=shape,
                    direction=direction, dtype=dtype, R=R, T=T, C=C,
                    ms=time_ms(torch, fn),
                    device_ms=time_ms(torch, fn, graph=True))), flush=True)
            del a, x, g, h
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
