"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA, MoE d_ff=2048 256 experts
top-8 + 1 shared, first 3 layers dense (d_ff=18432), vocab=129280, MTP
(the widths of the JAX package's ``configs/deepseek_v3_671b.py``).

MLA's q/k heads are 192 wide (128 nope + 64 rope) and its v heads 128, so
its attention is the dense ``attention``, as in JAX (the flash kernel
takes one head dim; queued in ROADMAP).  Its ``train_4k`` plan keeps the
AdamW moments in int8 (``optim.int8_adamw_update``, about 2 bytes a param
against fp32's 8).  One MoE layer's experts alone hold 256 x 3 x 7168 x
2048 = 1.13e10 params, so the model does not fit one 80 GB card at full
width even at one layer.
"""
import torch

from repro_torch.configs.lm_common import lm_bundle
from repro_torch.models.layers import MLAConfig, MoEConfig
from repro_torch.models.lm import LMConfig
from repro_torch.train.steps import ParallelPlan

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

PLANS = {
    "train_4k": ParallelPlan(tp_axis="model", ep=True,
                             fsdp_axes=("pod", "data"),
                             int8_optimizer=True,
                             notes="EP/TP-16 x FSDP, int8 Adam moments"),
    "prefill_32k": ParallelPlan(tp_axis="model", ep=True,
                                fsdp_axes=("pod", "data")),
    "decode_32k": ParallelPlan(tp_axis="model", ep=True,
                               fsdp_axes=("pod", "data"),
                               seq_shard_axis="model",
                               notes="MLA latent cache seq-sharded over TP"),
    "long_500k": ParallelPlan(),
}


def get_bundle():
    return lm_bundle("deepseek-v3-671b", CFG, PLANS,
                     notes="MLA + 256-expert MoE + MTP")
