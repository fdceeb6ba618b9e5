"""Quickstart on the PyTorch/CUDA port: the PULSE planning stack, then the
compile path (the counterpart of ``examples/quickstart.py``).

Builds the paper's UViT model graph, runs the skip-aware partitioner, the
communication model, the schedule templates and the hybrid tuner (for the
port's hardware preset, ``H100_SXM``), printing each artefact; then plans
a small UViT through ``auto_pipeline``, certifies the lowered plan and
runs one forward+backward of it on the device.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core.comm_model import (naive_pp_volume,
                                         partition_comm_volume, pulse_volume)
from repro_torch.core.hw import H100_SXM
from repro_torch.core.partition import blockwise_partition, partition
from repro_torch.core.schedule import template_1f1b, template_wave
from repro_torch.core.tuner import tune
from repro_torch.models.diffusion import (UViTConfig, ddpm_draw,
                                          uvit_block_graph,
                                          uvit_pipeline_graph)
from repro_torch.runtime.adapters import (diffusion_model_fns,
                                          make_diffusion_microbatches)
from repro_torch.runtime.compile import auto_pipeline
from repro_torch.runtime.schedule_exec import StepTables
from repro_torch.tree import tree_leaves

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                help="where the compiled pipeline runs (default: the card)")
args = ap.parse_args()
device = torch.device(args.device)

# 1. model -> block graph with skip edges -------------------------------
cfg = UViTConfig("uvit", img_size=32, d_model=1024, n_layers=16,
                 n_heads=16, d_ff=4096)
g = uvit_block_graph(cfg, batch=32)
print(f"UViT graph: {g.n} blocks, {len(g.skips)} skip edges "
      f"(nested={g.is_nested()})")

# 2. skip-aware partitioning (Alg. 1) -----------------------------------
D = 4
part = partition(g, D)
print(f"\nPULSE partition over {D} devices (S={part.num_stages} folded):")
for s in range(part.num_stages):
    lo, hi = part.stage_range(s)
    names = ",".join(b.name for b in g.blocks[lo:hi])
    print(f"  stage {s} -> device {part.device_of_stage(s)}: [{names}]")
assert part.validate_collocation(g)

# 3. communication volumes (paper §II-C vs §V-B) ------------------------
a = g.blocks[1].act_bytes
v_pulse = partition_comm_volume(g, part)
v_base = partition_comm_volume(g, blockwise_partition(g, D))
print(f"\ncomm/microbatch: PULSE {v_pulse.fwd_total / 1e6:.1f} MB "
      f"(skip bytes: {v_pulse.skip_bytes / 1e6:.1f}) vs sequential "
      f"{v_base.fwd_total / 1e6:.1f} MB "
      f"-> {100 * (1 - v_pulse.fwd_total / v_base.fwd_total):.0f}% "
      "reduction")
print(f"closed forms: naive {naive_pp_volume(g.n - 2, D, a) / 1e6:.1f} MB, "
      f"pulse {pulse_volume(D, a) / 1e6:.1f} MB")

# 4. schedules (paper Figs. 8/9) ----------------------------------------
print("\n1F1B schedule (S=D):")
print(template_1f1b(D, 4).to_ascii())
print("\nPULSE wave schedule (S=2D, folded):")
print(template_wave(D, 4).to_ascii())

# 5. hybrid tuner (paper §VI), for the port's one hardware preset -------
print(f"\nhybrid tuner on {H100_SXM.name} (16 devices):")
for c in tune(g, 16, hw=H100_SXM)[:3]:
    print(f"  P={c.P:2d} G={c.G:2d} b={c.b:3d}  "
          f"t/sample={c.t_sample * 1e3:.2f} ms  "
          f"peak={c.peak_mem / 2 ** 30:.1f} GiB  wave={c.wave}")

# 6. the auto-pipeline compile path (graph -> partition -> schedule ->
#    executor; runtime/compile.py), certified, then run once -------------
small = UViTConfig("uvit-s", img_size=8, in_ch=4, patch=2, d_model=64,
                   n_layers=8, n_heads=4, d_ff=128, n_classes=10)
fns = diffusion_model_fns(small, "uvit")
compiled = auto_pipeline(uvit_pipeline_graph(small), fns, 4,
                         pipeline_devices=4, microbatches=8)
print("\ncompile path (the plan's four pipeline devices share one process "
      "here; ranks run one a process, see launch/train.py --pipeline):")
print(compiled.describe())
print(compiled.schedule.to_ascii())
print(compiled.certify(name="quickstart").summary())

gen = torch.Generator(device=device).manual_seed(0)
stacks, edge = compiled.init_pipeline_params(gen, device)
batch = {"latents": torch.randn((16, 8, 8, 4), generator=gen, device=device),
         "labels": torch.randint(0, 10, (16,), generator=gen, device=device)}
t, noise = ddpm_draw(batch["latents"], 0)     # step 0's draws
mb, aux = make_diffusion_microbatches(batch, 8, small, "uvit", t=t,
                                      noise=noise)
for x in tree_leaves((stacks, edge)):
    x.requires_grad_(True)
loss = compiled.build()(*stacks, edge, mb, aux)
loss.backward()
loss = float(loss.detach())
print(f"one forward+backward on {device}: loss {loss:.4f}, "
      f"patch_embed grad norm {float(edge['patch_embed'].grad.norm()):.4f}")

# 7. the lowered step programs: the same grid as dense arrays, and the
#    executor-facing step tables the walk reads --------------------------
progs = compiled.schedule.device_programs()
print(f"\ndevice_programs: virtual[D, T] over {progs.num_devices} devices x "
      f"{progs.num_steps} steps (-1 = idle):")
print(progs.virtual)
tabs = StepTables.from_schedule(compiled.schedule, folded=compiled.folded)
print(f"step tables (forward slots only, {tabs.num_steps} steps; "
      "0=idle 1=enc 2=dec):")
print(tabs.sel)
