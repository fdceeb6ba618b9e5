#!/usr/bin/env python3
"""Time the bf16 flash-attention forward of the ``repro_torch`` on
``PYTHONPATH`` at the train steps' shapes.

    PYTHONPATH=<checkout>/src python3 tools/time_flash.py

It exists to compare two checkouts' flash kernels on one card: run it once
a checkout, in turns (parent, change, change, parent), in one call.  It
times what every version of ``repro_torch.kernels.flash_attention`` has,
``flash_attention_cuda(q, k, v, causal, window)``, and beside it the
yardstick ``scaled_dot_product_attention`` on the same inputs, at the
SDv2 UNet's six shapes (B=16, 8 heads of 112 and 224) and at UViT-H's and
Hunyuan-DiT's self-attention (D=128).  Each is timed with
``chip_smoke.time_ms``: ``ms`` as CUDA events around 20 calls as issued,
``device_ms`` as the replay of the same 20 calls from one CUDA graph.
Before timing, each kernel output is held to the plain version at rtol =
atol = 2e-2 (the script exits 1 if it disagrees).  Kernels build into the
checkout's ``build/``.  Prints one JSON line per shape, then the card's
name and power limit as ``nvidia-smi`` gives them.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHAPES = [  # name, B, S, T, H, D
    ("sdv2-unet L1 self", 16, 256, 256, 8, 112),
    ("sdv2-unet L1 cross", 16, 256, 77, 8, 112),
    ("sdv2-unet L2 self", 16, 64, 64, 8, 224),
    ("sdv2-unet L2 cross", 16, 64, 77, 8, 224),
    ("sdv2-unet L3+mid self", 16, 16, 16, 8, 224),
    ("sdv2-unet L3+mid cross", 16, 16, 77, 8, 224),
    ("uvit-h", 2, 258, 258, 20, 128),
    ("hunyuan-dit", 2, 1024, 1024, 16, 128),
]


def main() -> None:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("time_flash: no CUDA device")
    from chip_smoke import bound, time_ms
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, B, S, T, H, D in SHAPES:
        q = torch.randn(B, S, H, D, device="cuda", generator=gen).bfloat16()
        k, v = (torch.randn(B, T, H, D, device="cuda", generator=gen)
                .bfloat16() for _ in range(2))
        got = ops.flash_attention_cuda(q, k, v, False, None)
        want = ops.attention_plain(q, k, v, False, None)
        err = float((got.float() - want.float()).abs().max())
        try:
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)
        except AssertionError as e:
            sys.exit(f"time_flash: {name}: kernel disagrees with the plain "
                     f"version:\n{e}")
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))

        def kernel():
            return ops.flash_attention_cuda(q, k, v, False, None)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh)

        b_ms, b_by = bound(4.0 * B * H * S * T * D,
                           2 * (2 * B * S * H * D + 2 * B * T * H * D),
                           "bfloat16")
        print(json.dumps(dict(
            package=os.path.dirname(ops.__file__), shape=name, B=B, S=S,
            T=T, H=H, D=D, max_abs_err=err, ms=time_ms(torch, kernel),
            device_ms=time_ms(torch, kernel, graph=True),
            library_ms=time_ms(torch, sdpa),
            library_device_ms=time_ms(torch, sdpa, graph=True),
            bound_ms=b_ms, bound_by=b_by)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
