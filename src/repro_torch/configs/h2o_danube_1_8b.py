"""h2o-danube-1.8b [dense]: 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.

llama+mistral mix with sliding-window attention (window 4096), the widths
of the JAX package's ``configs/h2o_danube_1_8b.py``.  Its head dim, 80, is
not one the flash kernel builds (``flash_attention.ops.HEAD_DIMS``), so
this config runs the dense ``attention`` (``use_flash`` off): a choice of
the config, not a fallback.  Flash at head dim 80 is queued (ROADMAP).
The smoke config (head dim 16) runs flash with its window.
"""
import torch

from repro_torch.models.layers import AttnConfig
from repro_torch.models.lm import LMConfig

CFG = LMConfig(
    name="h2o-danube-1.8b", vocab=32000, d_model=2560, n_layers=24,
    attn=AttnConfig(d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
                    window=4096),
    d_ff=6912, dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)
