"""PULSE's wave pipeline over ranks on the PyTorch/CUDA port (the
counterpart of ``examples/pipeline_wave_demo.py``): trains a UViT with the
folded-stage executor as 4 pipeline stages x 2 data replicas, one process
per (data, pipeline) index under ``torchrun``, and prints the plan, the
live loss and the step times.

On the card the eight ranks share it over the gloo ring (payloads staged
through pinned host memory); with ``--device cpu`` they run on the CPU.

    PYTHONPATH=src python examples/torch_pipeline_wave_demo.py \
        [--device cpu] [--steps 30]
"""
import argparse
import os
import subprocess
import sys

DP, PP = 2, 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    print(f"wave pipeline over {DP * PP} ranks ({PP} stages x DP {DP}) on "
          f"{args.device}:", flush=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(DP * PP), "-m",
           "repro_torch.launch.train", "--arch", "uvit", "--pipeline",
           "--dp", str(DP), "--pp", str(PP), "--steps", str(args.steps),
           "--global-batch", "16", "--microbatches", "4", "--lr", "2e-3",
           "--log-every", "5", "--device", args.device, "--ring", "gloo"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
