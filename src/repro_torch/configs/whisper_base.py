"""whisper-base [audio]: 6L enc + 6L dec, d=512 8H d_ff=2048 vocab=51865
(the widths of the JAX package's ``configs/whisper_base.py``).

Conv frontend is a STUB (precomputed frame embeddings are the input).
seq_len applies to the audio-frame axis; decoder targets are <= 448 tokens
(whisper's max, ``MAX_TGT``).  Encoder is full attention.  Head dim
512 / 8 = 64 is a tensor-core head dim of the flash kernel: ``use_flash``
on every attention (encoder self, decoder causal self, cross).
70,658,560 params (``init_whisper``; ``CFG.param_count()``, 70,595,072,
leaves out the biases and norms).
"""
import torch

from repro_torch.configs.base import ArchBundle, ShapeSpec, meta
from repro_torch.models import whisper as wh
from repro_torch.models.whisper import WhisperConfig
from repro_torch.train.steps import ParallelPlan

CFG = WhisperConfig(
    name="whisper-base", vocab=51865, d_model=512, n_enc_layers=6,
    n_dec_layers=6, n_heads=8, d_ff=2048,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, use_flash=True)

MAX_TGT = 448

PLANS = {
    "train_4k": ParallelPlan(tp_axis=None, fsdp_axes=("model",),
                             batch_axes=("pod", "data")),
    "prefill_32k": ParallelPlan(tp_axis=None, fsdp_axes=("model",),
                                batch_axes=("pod", "data")),
    "decode_32k": ParallelPlan(tp_axis=None, fsdp_axes=("model",),
                               batch_axes=("pod", "data")),
    "long_500k": ParallelPlan(),
}

SUPPORT = {
    "train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
    "long_500k": "skipped: full-attention audio encoder (1500-frame native "
                 "context); no sub-quadratic path",
}


def batch_struct(shape: ShapeSpec, plan=None):
    B = shape.global_batch
    return {
        "frames": meta((B, shape.seq_len, CFG.d_model), torch.bfloat16),
        "tokens": meta((B, MAX_TGT), torch.int32),
    }


def loss_fn(params, batch, rng=None):
    return wh.whisper_loss(params, batch, CFG)


def cache_struct(shape: ShapeSpec):
    """The encoded frames and the decoder's KV caches of ``MAX_TGT`` rows,
    on the meta device."""
    B = shape.global_batch
    return {
        "enc_out": meta((B, shape.seq_len, CFG.d_model), torch.bfloat16),
        "dec": wh.init_dec_caches(CFG, B, MAX_TGT, device="meta"),
    }


def make_decode_fn(shape: ShapeSpec):
    def decode(params, token, cache):
        logits, dec = wh.decode_step(params, token, cache["enc_out"],
                                     cache["dec"], CFG)
        return logits, {"enc_out": cache["enc_out"], "dec": dec}
    return decode


def get_bundle():
    return ArchBundle(
        name="whisper-base", family="audio", cfg=CFG,
        init_fn=lambda gen, device="cuda": wh.init_whisper(gen, CFG, device),
        loss_fn=loss_fn, batch_struct=batch_struct, plans=PLANS,
        shape_support=SUPPORT, param_count=CFG.param_count(),
        active_param_count=CFG.param_count(),
        make_decode_fn=make_decode_fn, cache_struct=cache_struct,
        notes="enc-dec; audio frontend stubbed; decode = cross-attend to "
              "seq_len encoded frames")
