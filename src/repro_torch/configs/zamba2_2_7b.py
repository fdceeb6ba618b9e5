"""zamba2-2.7b [hybrid]: 54 Mamba2 blocks d=2560 (ssm_state=64) + 2 shared
full-attention blocks (32H, d_ff=10240) applied every 6 layers (the widths
of the JAX package's ``configs/zamba2_2_7b.py``).

The shared block's parameter reuse sites are long-range graph edges (the
PULSE collocation case).  Every Mamba2 block's carry across chunks runs
the gated linear scan kernel.  The shared attention (32 heads of 80) runs
the flash kernel (``use_flash``; bf16 at head dim 80 takes the
tensor-core route, the head padded to 128 columns in shared memory), in
training and over each site's KV cache when serving.
"""
import torch

from repro_torch.models.layers import AttnConfig
from repro_torch.models.mamba import Mamba2Config, Zamba2Config

CFG = Zamba2Config(
    name="zamba2-2.7b", vocab=32000, d_model=2560, n_layers=54,
    mamba=Mamba2Config(d_model=2560, d_state=64, head_dim=64, expand=2,
                       chunk=128),
    shared_attn=AttnConfig(d_model=2560, n_heads=32, n_kv_heads=32,
                           head_dim=80, use_flash=True),
    shared_d_ff=10240, shared_every=6, n_shared_blocks=2,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16)
