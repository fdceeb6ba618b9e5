"""internvl2-2b [vlm]: 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.

The widths of the JAX package's ``configs/internvl2_2b.py``.  The InternViT
frontend is a stub there too: a batch carries ``N_PATCHES`` pre-projected
patch embeddings ``(B, 256, d_model)``, prepended to the text tokens; the
loss drops their rows before the readout.  Flash attention at head dim
128.
"""
import torch

from repro_torch.models.layers import AttnConfig
from repro_torch.models.lm import LMConfig

N_PATCHES = 256

CFG = LMConfig(
    name="internvl2-2b", vocab=92553, d_model=2048, n_layers=24,
    attn=AttnConfig(d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
                    use_flash=True),
    d_ff=8192, vision_prefix=N_PATCHES,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)
