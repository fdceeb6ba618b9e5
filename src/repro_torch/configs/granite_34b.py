"""granite-34b [dense]: 88L d=6144 48H (MQA kv=1) d_ff=24576 vocab=49152,
gpt_bigcode-style 2-matrix GELU MLP (the widths of the JAX package's
``configs/granite_34b.py``); flash attention at head dim 128.
"""
import torch

from repro_torch.configs.lm_common import lm_bundle
from repro_torch.models.layers import AttnConfig
from repro_torch.models.lm import LMConfig
from repro_torch.train.steps import ParallelPlan

CFG = LMConfig(
    name="granite-34b", vocab=49152, d_model=6144, n_layers=88,
    attn=AttnConfig(d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
                    use_flash=True),
    d_ff=24576, mlp_gelu=True,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)

_KV_REP = {"wk": (None, None), "wv": (None, None)}
PLANS = {
    "train_4k": ParallelPlan(tp_axis="model", fsdp_axes=("data",),
                             custom_rules=_KV_REP),
    "prefill_32k": ParallelPlan(tp_axis="model", custom_rules=_KV_REP),
    "decode_32k": ParallelPlan(tp_axis="model", custom_rules=_KV_REP),
    "long_500k": ParallelPlan(),
}


def get_bundle():
    return lm_bundle("granite-34b", CFG, PLANS)
