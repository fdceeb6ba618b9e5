"""internlm2-20b [dense]: 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92544
(the widths of the JAX package's ``configs/internlm2_20b.py``); flash
attention at head dim 128.
"""
import torch

from repro_torch.configs.lm_common import lm_bundle
from repro_torch.models.layers import AttnConfig
from repro_torch.models.lm import LMConfig
from repro_torch.train.steps import ParallelPlan

CFG = LMConfig(
    name="internlm2-20b", vocab=92544, d_model=6144, n_layers=48,
    attn=AttnConfig(d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
                    use_flash=True),
    d_ff=16384, dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)

_KV_REP = {"wk": (None, None), "wv": (None, None)}
PLANS = {
    "train_4k": ParallelPlan(strategy="pp_1f1b", pp_degree=16,
                             microbatches=16, batch_axes=("pod", "data"),
                             fsdp_axes=("data",),
                             notes="1F1B S=D=16, 3 layers/stage, ZeRO-1"),
    "prefill_32k": ParallelPlan(tp_axis="model", custom_rules=_KV_REP),
    "decode_32k": ParallelPlan(tp_axis="model", custom_rules=_KV_REP),
    "long_500k": ParallelPlan(),
}


def get_bundle():
    return lm_bundle("internlm2-20b", CFG, PLANS)
