"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA, MoE d_ff=2048 256 experts
top-8 + 1 shared, first 3 layers dense (d_ff=18432), vocab=129280, MTP
(the widths of the JAX package's ``configs/deepseek_v3_671b.py``).

MLA's q/k heads are 192 wide (128 nope + 64 rope) and its v heads 128, so
its attention is the dense ``attention``, as in JAX (the flash kernel
takes one head dim; queued in ROADMAP).  The JAX config's int8 AdamW
moments are not ported.
"""
import torch

from repro_torch.models.layers import MLAConfig, MoEConfig
from repro_torch.models.lm import LMConfig

CFG = LMConfig(
    name="deepseek-v3-671b", vocab=129280, d_model=7168, n_layers=61,
    mla=MLAConfig(d_model=7168, n_heads=128, q_lora_rank=1536,
                  kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    d_ff=18432, n_dense_layers=3,
    moe=MoEConfig(d_model=7168, d_ff=2048, n_experts=256, top_k=8,
                  n_shared=1, shared_d_ff=2048, capacity_factor=1.25),
    moe_dispatch="scatter", mtp=True,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)
