"""internvl2-2b [vlm]: 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.

The widths of the JAX package's ``configs/internvl2_2b.py``.  The InternViT
frontend is a stub there too: a batch carries ``N_PATCHES`` pre-projected
patch embeddings ``(B, 256, d_model)``, prepended to the text tokens; the
loss drops their rows before the readout.  Flash attention at head dim
128.
"""
import torch

from repro_torch.configs.base import meta
from repro_torch.configs.lm_common import lm_bundle
from repro_torch.models.layers import AttnConfig
from repro_torch.models.lm import LMConfig
from repro_torch.train.steps import ParallelPlan

N_PATCHES = 256

CFG = LMConfig(
    name="internvl2-2b", vocab=92553, d_model=2048, n_layers=24,
    attn=AttnConfig(d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
                    use_flash=True),
    d_ff=8192, vision_prefix=N_PATCHES,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)

_KV_REP = {"wk": (None, None), "wv": (None, None)}
PLANS = {
    "train_4k": ParallelPlan(tp_axis="model", fsdp_axes=("data",),
                             custom_rules=_KV_REP),
    "prefill_32k": ParallelPlan(tp_axis="model", custom_rules=_KV_REP),
    "decode_32k": ParallelPlan(tp_axis="model", custom_rules=_KV_REP),
    "long_500k": ParallelPlan(),
}


def _prefix_struct(shape, mb):
    """The stub frontend's patch embeddings, ``(B, 256, d)`` or
    ``(M, B/M, 256, d)``, bf16 on the meta device."""
    B = shape.global_batch
    if mb:
        return meta((mb, B // mb, N_PATCHES, CFG.d_model), torch.bfloat16)
    return meta((B, N_PATCHES, CFG.d_model), torch.bfloat16)


def get_bundle():
    return lm_bundle("internvl2-2b", CFG, PLANS,
                     vision_prefix_struct=_prefix_struct,
                     notes="ViT frontend stubbed (patch embeddings input)")
