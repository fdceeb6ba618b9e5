"""Hunyuan-DiT-3B, the paper's own model, scaled: 32 DiT blocks (16 enc +
16 dec with long skips), d=2048, 16 heads (head_dim 128), d_ff=8192, adaLN
time conditioning, cross-attention over 77 text tokens of width 1024
(CLIP+T5 stub embeddings), latent 64x64x4 with patch 2 (1024 tokens); bf16
params and activations.

``CFG.param_count()`` gives 3,221,225,472 parameters (the edge params bring
the model to about 3.26e9): bf16 params and grads take 6.5 GB each and the
fp32 AdamW moments 26 GB, so the model trains at full width and depth on
one 80 GB card, with the pipeline's D devices sharing it.  The trainer
(``launch/train.py --arch hunyuan-dit``) takes it through
``auto_pipeline``.
"""
from __future__ import annotations

import torch

from repro_torch.models.diffusion import HunyuanDiTConfig

CFG = HunyuanDiTConfig(
    name="hunyuan-dit", img_size=64, in_ch=4, patch=2, d_model=2048,
    n_layers=32, n_heads=16, d_ff=8192, ctx_dim=1024, ctx_len=77,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16)
