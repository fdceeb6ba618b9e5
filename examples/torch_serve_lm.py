"""Batched LM serving demo (prefill + greedy decode) across families, on
the PyTorch/CUDA port (the counterpart of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import sys

from repro_torch.launch.serve import main as serve_main

device = sys.argv[sys.argv.index("--device") + 1] \
    if "--device" in sys.argv else "cuda"
for arch in ("smollm-360m", "xlstm-125m", "zamba2-2.7b"):
    serve_main(["--arch", arch, "--batch", "4", "--prompt-len", "8",
                "--gen", "16", "--device", device])
