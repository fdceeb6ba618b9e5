"""smollm-360m [dense]: 32L d=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

llama-arch small model with tied embeddings (the widths of the JAX
package's ``configs/smollm_360m.py``).  PULSE-relevant: the folded wave
collocates stage 0 (embedding) with the last stage (tied readout) on
device 0, so the tied matrix needs no cross-stage gradient exchange.
Head dim 64 is a tensor-core head dim of the flash kernel: ``use_flash``.
About 3.62e8 params (``CFG.param_count()``).
"""
import torch

from repro_torch.configs.lm_common import lm_bundle
from repro_torch.models.layers import AttnConfig
from repro_torch.models.lm import LMConfig
from repro_torch.train.steps import ParallelPlan

CFG = LMConfig(
    name="smollm-360m", vocab=49152, d_model=960, n_layers=32,
    attn=AttnConfig(d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
                    use_flash=True),
    d_ff=2560, tied_embeddings=True,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)

PLANS = {
    "train_4k": ParallelPlan(strategy="pp_wave", pp_degree=16,
                             microbatches=16, batch_axes=("pod", "data"),
                             fsdp_axes=("data",),
                             notes="PULSE wave S=32: tied embed/head fold"),
    "prefill_32k": ParallelPlan(tp_axis="model",
                                custom_rules={"wk": (None, None),
                                              "wv": (None, None)}),
    "decode_32k": ParallelPlan(tp_axis="model",
                               custom_rules={"wk": (None, None),
                                             "wv": (None, None)}),
    "long_500k": ParallelPlan(),
}


def get_bundle():
    return lm_bundle("smollm-360m", CFG, PLANS,
                     notes="wave-fold demo for tied embeddings")
