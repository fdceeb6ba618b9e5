"""xlstm-125m [ssm]: 12L d=768 4H vocab=50304 — sLSTM + mLSTM blocks
(xLSTM[7:1]-style: sLSTM at every 6th layer), the widths of the JAX
package's ``configs/xlstm_125m.py``.

The recurrent state is O(1) in sequence length; training runs the mLSTM
parallel form (fp32 (B, S, S, H) tensors) and the sLSTM loop over time.
No attention, so no kernel on this path.
"""
import torch

from repro_torch.configs.base import ArchBundle, ShapeSpec, token_batch_struct
from repro_torch.models import xlstm as xm
from repro_torch.models.xlstm import XLSTMConfig
from repro_torch.train.steps import ParallelPlan

CFG = XLSTMConfig(
    name="xlstm-125m", vocab=50304, d_model=768, n_layers=12, n_heads=4,
    slstm_every=6, dtype=torch.bfloat16, param_dtype=torch.bfloat16)

PLANS = {
    "train_4k": ParallelPlan(tp_axis=None, fsdp_axes=("model",),
                             batch_axes=("pod", "data")),
    "prefill_32k": ParallelPlan(tp_axis=None, fsdp_axes=("model",),
                                batch_axes=("pod", "data")),
    "decode_32k": ParallelPlan(tp_axis=None, fsdp_axes=("model",),
                               batch_axes=("pod", "data")),
    "long_500k": ParallelPlan(tp_axis=None, fsdp_axes=("model",),
                              batch_axes=("data",),
                              notes="state is O(1); context length free"),
}
SUPPORT = {s: "ok" for s in
           ("train_4k", "prefill_32k", "decode_32k", "long_500k")}


def batch_struct(shape: ShapeSpec, plan=None):
    return token_batch_struct(shape, CFG.vocab)


def loss_fn(params, batch, rng=None):
    return xm.xlstm_loss(params, batch, CFG)


def cache_struct(shape: ShapeSpec):
    """Each block's decode state, on the meta device."""
    return xm.init_states(CFG, shape.global_batch, device="meta")


def make_decode_fn(shape: ShapeSpec):
    def decode(params, token, states):
        return xm.decode_step(params, token, states, CFG)
    return decode


def get_bundle():
    return ArchBundle(
        name="xlstm-125m", family="ssm", cfg=CFG,
        init_fn=lambda gen, device="cuda": xm.init_xlstm(gen, CFG, device),
        loss_fn=loss_fn, batch_struct=batch_struct, plans=PLANS,
        shape_support=dict(SUPPORT),
        param_count=CFG.param_count(), active_param_count=CFG.param_count(),
        make_decode_fn=make_decode_fn, cache_struct=cache_struct,
        notes="recurrent state O(1); long_500k trivially supported")
