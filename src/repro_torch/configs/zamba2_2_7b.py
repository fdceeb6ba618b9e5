"""zamba2-2.7b [hybrid]: 54 Mamba2 blocks d=2560 (ssm_state=64) + 2 shared
full-attention blocks (32H, d_ff=10240) applied every 6 layers (the widths
of the JAX package's ``configs/zamba2_2_7b.py``).

The shared block's parameter reuse sites are long-range graph edges (the
PULSE collocation case).  Every Mamba2 block's carry across chunks runs
the gated linear scan kernel.  The shared attention's head dim, 80, is
not one the flash kernel builds (``flash_attention.ops.HEAD_DIMS``), so it
runs the dense ``attention`` (``use_flash`` off), as the JAX config does
and as danube's does: a choice of the config, not a fallback.
"""
import torch

from repro_torch.models.layers import AttnConfig
from repro_torch.models.mamba import Mamba2Config, Zamba2Config

CFG = Zamba2Config(
    name="zamba2-2.7b", vocab=32000, d_model=2560, n_layers=54,
    mamba=Mamba2Config(d_model=2560, d_state=64, head_dim=64, expand=2,
                       chunk=128),
    shared_attn=AttnConfig(d_model=2560, n_heads=32, n_kv_heads=32,
                           head_dim=80),
    shared_d_ff=10240, shared_every=6, n_shared_blocks=2,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16)
