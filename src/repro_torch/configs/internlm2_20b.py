"""internlm2-20b [dense]: 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92544
(the widths of the JAX package's ``configs/internlm2_20b.py``); flash
attention at head dim 128.
"""
import torch

from repro_torch.models.layers import AttnConfig
from repro_torch.models.lm import LMConfig

CFG = LMConfig(
    name="internlm2-20b", vocab=92544, d_model=6144, n_layers=48,
    attn=AttnConfig(d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
                    use_flash=True),
    d_ff=16384, dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)
