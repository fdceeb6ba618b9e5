"""h2o-danube-1.8b [dense]: 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.

llama+mistral mix with sliding-window attention (window 4096), the widths
of the JAX package's ``configs/h2o_danube_1_8b.py``.  Its attention runs
the flash kernel with its window (``use_flash``; bf16 at head dim 80 takes
the tensor-core route, the head padded to 128 columns in shared memory),
as does the smoke config (head dim 16).
"""
import torch

from repro_torch.configs.lm_common import lm_bundle
from repro_torch.models.layers import AttnConfig
from repro_torch.models.lm import LMConfig
from repro_torch.train.steps import ParallelPlan

CFG = LMConfig(
    name="h2o-danube-1.8b", vocab=32000, d_model=2560, n_layers=24,
    attn=AttnConfig(d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
                    window=4096, use_flash=True),
    d_ff=6912, dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)

_KV_REP = {"wk": (None, None), "wv": (None, None)}   # kv=8 < tp=16
PLANS = {
    "train_4k": ParallelPlan(tp_axis="model", fsdp_axes=("data",),
                             custom_rules=_KV_REP),
    "prefill_32k": ParallelPlan(tp_axis="model", custom_rules=_KV_REP),
    "decode_32k": ParallelPlan(tp_axis="model", custom_rules=_KV_REP),
    "long_500k": ParallelPlan(tp_axis="model", custom_rules=_KV_REP,
                              batch_axes=(), seq_shard_axis="data",
                              notes="window cache seq-sharded over data"),
}


def get_bundle():
    return lm_bundle("h2o-danube-1.8b", CFG, PLANS, long_ok=True,
                     notes="SWA window=4096")
