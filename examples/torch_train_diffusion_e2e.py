"""End-to-end training on the PyTorch/CUDA port (the counterpart of
``examples/train_diffusion_e2e.py``): train a UViT diffusion model on
synthetic latents with checkpointing, then resume once from the last
checkpoint and train on to the end.  The model is the trainer's small
``uvit-h`` smoke config; the same loop drives the full-width configs.

    PYTHONPATH=src python examples/torch_train_diffusion_e2e.py \
        [--device cpu] [--fast]

``--fast`` trains 12 steps, checkpoints every 4, and resumes to 20 (the
default: 120 steps, every 40, resumed to 200).
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import main as train_main


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fast", action="store_true",
                    help="12 steps, a checkpoint every 4, resumed to 20")
    args = ap.parse_args()
    first, every, last = (12, 4, 20) if args.fast else (120, 40, 200)
    ckpt = tempfile.mkdtemp(prefix="repro_torch_uvit_")
    common = ["--arch", "uvit-h", "--ckpt-dir", ckpt, "--ckpt-every",
              str(every), "--global-batch", "16", "--lr", "2e-3",
              "--log-every", str(every), "--device", args.device]
    try:
        print(f"=== phase 1: train {first} steps (checkpoint every {every})",
              flush=True)
        train_main(["--steps", str(first), *common])
        print(f"=== phase 2: resume to {last} steps", flush=True)
        loss = train_main(["--steps", str(last), "--resume", *common])
        print(f"final loss {loss:.4f}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
