"""h2o-danube-1.8b [dense]: 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.

llama+mistral mix with sliding-window attention (window 4096), the widths
of the JAX package's ``configs/h2o_danube_1_8b.py``.  Its attention runs
the flash kernel with its window (``use_flash``; bf16 at head dim 80 takes
the tensor-core route, the head padded to 128 columns in shared memory),
as does the smoke config (head dim 16).
"""
import torch

from repro_torch.models.layers import AttnConfig
from repro_torch.models.lm import LMConfig

CFG = LMConfig(
    name="h2o-danube-1.8b", vocab=32000, d_model=2560, n_layers=24,
    attn=AttnConfig(d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
                    window=4096, use_flash=True),
    d_ff=6912, dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)
