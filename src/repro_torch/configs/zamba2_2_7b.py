"""zamba2-2.7b [hybrid]: 54 Mamba2 blocks d=2560 (ssm_state=64) + 2 shared
full-attention blocks (32H, d_ff=10240) applied every 6 layers (the widths
of the JAX package's ``configs/zamba2_2_7b.py``).

The shared block's parameter reuse sites are long-range graph edges (the
PULSE collocation case).  Every Mamba2 block's carry across chunks runs
the gated linear scan kernel.  The shared attention (32 heads of 80) runs
the flash kernel (``use_flash``; bf16 at head dim 80 takes the
tensor-core route, the head padded to 128 columns in shared memory), in
training and over each site's KV cache when serving.
"""
import torch

from repro_torch.configs.base import ArchBundle, ShapeSpec, token_batch_struct
from repro_torch.models import mamba as zm
from repro_torch.models.layers import AttnConfig
from repro_torch.models.mamba import Mamba2Config, Zamba2Config
from repro_torch.train.steps import ParallelPlan

CFG = Zamba2Config(
    name="zamba2-2.7b", vocab=32000, d_model=2560, n_layers=54,
    mamba=Mamba2Config(d_model=2560, d_state=64, head_dim=64, expand=2,
                       chunk=128),
    shared_attn=AttnConfig(d_model=2560, n_heads=32, n_kv_heads=32,
                           head_dim=80, use_flash=True),
    shared_d_ff=10240, shared_every=6, n_shared_blocks=2,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16)

PLANS = {
    "train_4k": ParallelPlan(tp_axis=None, fsdp_axes=("model",),
                             batch_axes=("pod", "data")),
    "prefill_32k": ParallelPlan(tp_axis=None, fsdp_axes=("model",),
                                batch_axes=("pod", "data")),
    "decode_32k": ParallelPlan(tp_axis=None, fsdp_axes=("model",),
                               batch_axes=("pod", "data")),
    "long_500k": ParallelPlan(tp_axis=None, fsdp_axes=("model",),
                              batch_axes=(), seq_shard_axis="data",
                              notes="shared-attn caches seq-sharded"),
}
SUPPORT = {s: "ok" for s in
           ("train_4k", "prefill_32k", "decode_32k", "long_500k")}


def batch_struct(shape: ShapeSpec, plan=None):
    return token_batch_struct(shape, CFG.vocab)


def loss_fn(params, batch, rng=None):
    return zm.zamba2_loss(params, batch, CFG)


def cache_struct(shape: ShapeSpec):
    """Each Mamba2 block's state and each shared site's KV cache of
    ``seq_len`` rows, on the meta device."""
    return zm.init_states(CFG, shape.global_batch, shape.seq_len,
                          device="meta")


def make_decode_fn(shape: ShapeSpec):
    def decode(params, token, states):
        return zm.decode_step(params, token, states, CFG)
    return decode


def get_bundle():
    return ArchBundle(
        name="zamba2-2.7b", family="hybrid", cfg=CFG,
        init_fn=lambda gen, device="cuda": zm.init_zamba2(gen, CFG, device),
        loss_fn=loss_fn, batch_struct=batch_struct, plans=PLANS,
        shape_support=dict(SUPPORT),
        param_count=CFG.param_count(), active_param_count=CFG.param_count(),
        make_decode_fn=make_decode_fn, cache_struct=cache_struct,
        notes="Mamba2 + shared attention blocks (PULSE collocation case)")
