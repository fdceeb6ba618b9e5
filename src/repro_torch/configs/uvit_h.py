"""UViT-2.7B, the paper's own model (§VII-B): 32 blocks (16 enc + 16 dec
with long skips), d=2560, 20 heads (head_dim 128), d_ff=10240, latent
32x32x4 (258 tokens), class-conditional; bf16 params and activations.

About 2.73e9 parameters: bf16 params and grads take 5.5 GB each and the
fp32 AdamW moments 21.8 GB, so the model trains at full width and depth on
one 80 GB card, with the pipeline's D devices sharing it.  The trainer
(``launch/train.py --arch uvit-h``) takes it through ``auto_pipeline``.
"""
from __future__ import annotations

import torch

from repro_torch.models.diffusion import UViTConfig

CFG = UViTConfig(
    name="uvit-h", img_size=32, in_ch=4, patch=2, d_model=2560,
    n_layers=32, n_heads=20, d_ff=10240, n_classes=1001,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16)
