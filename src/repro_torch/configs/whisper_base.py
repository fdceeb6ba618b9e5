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

from repro_torch.models.whisper import WhisperConfig

CFG = WhisperConfig(
    name="whisper-base", vocab=51865, d_model=512, n_enc_layers=6,
    n_dec_layers=6, n_heads=8, d_ff=2048,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, use_flash=True)

MAX_TGT = 448
