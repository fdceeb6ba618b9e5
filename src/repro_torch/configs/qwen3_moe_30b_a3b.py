"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4, head_dim=128,
qk-norm) expert d_ff=768, 128 experts top-8, vocab=151936, sort-based
("scatter") dispatch (the widths of the JAX package's
``configs/qwen3_moe_30b_a3b.py``); flash attention at head dim 128.
"""
import torch

from repro_torch.configs.lm_common import lm_bundle
from repro_torch.models.layers import AttnConfig, MoEConfig
from repro_torch.models.lm import LMConfig
from repro_torch.train.steps import ParallelPlan

CFG = LMConfig(
    name="qwen3-moe-30b-a3b", vocab=151936, d_model=2048, n_layers=48,
    attn=AttnConfig(d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
                    qk_norm=True, use_flash=True),
    moe=MoEConfig(d_model=2048, d_ff=768, n_experts=128, top_k=8,
                  capacity_factor=1.25),
    moe_dispatch="scatter",
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)

_KV_REP = {"wk": (None, None), "wv": (None, None)}
PLANS = {
    "train_4k": ParallelPlan(tp_axis="model", ep=True, fsdp_axes=("data",),
                             custom_rules=_KV_REP,
                             notes="EP-16 (8 experts/chip) + ZeRO over data"),
    "prefill_32k": ParallelPlan(tp_axis="model", ep=True,
                                custom_rules=_KV_REP),
    "decode_32k": ParallelPlan(tp_axis="model", ep=True,
                               custom_rules=_KV_REP),
    "long_500k": ParallelPlan(),
}


def get_bundle():
    return lm_bundle("qwen3-moe-30b-a3b", CFG, PLANS,
                     notes="128-expert MoE, scatter dispatch, EP-16")
