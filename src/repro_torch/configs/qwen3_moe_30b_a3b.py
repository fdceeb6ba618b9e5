"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4, head_dim=128,
qk-norm) expert d_ff=768, 128 experts top-8, vocab=151936, sort-based
("scatter") dispatch (the widths of the JAX package's
``configs/qwen3_moe_30b_a3b.py``); flash attention at head dim 128.
"""
import torch

from repro_torch.models.layers import AttnConfig, MoEConfig
from repro_torch.models.lm import LMConfig

CFG = LMConfig(
    name="qwen3-moe-30b-a3b", vocab=151936, d_model=2048, n_layers=48,
    attn=AttnConfig(d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
                    qk_norm=True, use_flash=True),
    moe=MoEConfig(d_model=2048, d_ff=768, n_experts=128, top_k=8,
                  capacity_factor=1.25),
    moe_dispatch="scatter",
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)
