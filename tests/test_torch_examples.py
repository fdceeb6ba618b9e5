"""The port's examples (``examples/torch_*.py``) at their smallest settings
on the CPU: each exits 0 and prints its key lines.  None imports JAX or
the JAX package, and each runs on the card unless given ``--device cpu``:
without it, on a machine with no card, it fails instead of falling back.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
NAMES = ("torch_quickstart.py", "torch_hybrid_zero_pipeline.py",
         "torch_pipeline_wave_demo.py", "torch_train_diffusion_e2e.py",
         "torch_fault_tolerance.py", "torch_supervisor_drill.py",
         "torch_serve_lm.py")


def run_example(name, *args, timeout=300, cuda=False):
    """Run ``examples/<name>`` from the repo root, on one torch thread and,
    unless ``cuda``, with no card visible; returns the process."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    if not cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(EXAMPLES / name), *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _ok(proc, *lines):
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    for line in lines:
        assert line in out, (line, out[-4000:])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_nothing_of_jax(name):
    tree = ast.parse((EXAMPLES / name).read_text())
    for node in ast.walk(tree):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module] if isinstance(node, ast.ImportFrom)
                and node.module else [])
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), (name,
                                                                       m)


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n != "torch_serve_lm.py"])
def test_example_defaults_to_the_card(name):
    """``--device`` takes cuda or cpu and defaults to cuda."""
    tree = ast.parse((EXAMPLES / name).read_text())
    found = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "add_argument"
             and n.args and getattr(n.args[0], "value", None) == "--device"]
    assert len(found) == 1, name
    kw = {k.arg: ast.literal_eval(k.value) for k in found[0].keywords}
    assert kw["default"] == "cuda" and set(kw["choices"]) == {"cuda", "cpu"}


@pytest.mark.parametrize("name,args", [
    ("torch_train_diffusion_e2e.py", ["--fast"]),
    ("torch_hybrid_zero_pipeline.py", ["--steps", "1"])])
def test_example_without_a_card_fails_rather_than_falls_back(name, args):
    proc = run_example(name, *args)
    assert proc.returncode != 0
    assert "loss" not in proc.stdout


def test_quickstart():
    _ok(run_example("torch_quickstart.py", "--device", "cpu"),
        "UViT graph: 18 blocks", "PULSE partition over 4 devices",
        "comm/microbatch: PULSE", "PULSE wave schedule",
        "hybrid tuner on h100-sxm (16 devices)",
        "auto_pipeline: S=8 stages over D=4 devices (folded wave)",
        "OK   quickstart:", "one forward+backward on cpu: loss",
        "step tables (forward slots only")


def test_hybrid_zero_pipeline():
    out = _ok(run_example("torch_hybrid_zero_pipeline.py", "--device", "cpu",
                          "--steps", "2"),
              "hybrid: dp=2 over ('data',), zero_stage=2", "OK   hybrid-demo",
              "stack leaves sharded over the data replicas",
              "over 4 rank processes (gloo, cpu)", "step  0  loss",
              "step  1  loss", "granite-34b on 16x h100-sxm",
              "hybrid best:     P=2 dp=8 zero=2")
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and losses[1] < losses[0]


def test_pipeline_wave_demo():
    out = _ok(run_example("torch_pipeline_wave_demo.py", "--device", "cpu",
                          "--steps", "2"),
              "wave pipeline over 8 ranks (4 stages x DP 2) on cpu",
              "(folded wave)", "data replica 0 of 2",
              "[train] step     0 loss", "[train] done: final loss")
    assert out.count("[train] device: cpu (rank") == 8


def test_train_diffusion_e2e():
    _ok(run_example("torch_train_diffusion_e2e.py", "--device", "cpu",
                    "--fast"),
        "=== phase 1: train 12 steps (checkpoint every 4)",
        "=== phase 2: resume to 20 steps", "resumed from step 12",
        "final loss")
