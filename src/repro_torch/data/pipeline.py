"""Data pipeline: deterministic synthetic datasets + sharded host loader.

A copy of ``repro.data.pipeline``: the port imports nothing of the JAX package, so it
keeps its own copy of this framework-neutral module.

Synthetic-but-learnable data (per paper §VII, preprocessing — VAE latents /
text embeddings — is outside the measured loop, so training inputs are
precomputed tensors; we synthesize them deterministically from the step
index so any host can (re)generate its shard independently):

- fault tolerance: a restarted/replaced host resumes from (step, host_id)
  alone — no data-state checkpoint needed;
- elasticity: re-sharding to a different host count only changes the
  host_id -> slice mapping, not the global stream;
- straggler tolerance: no inter-host coordination in the input pipeline.

``SyntheticTokenDataset`` draws from a fixed Markov chain so LM losses
actually decrease; ``SyntheticLatentDataset`` mixes class/text-conditioned
Gaussian modes so diffusion losses decrease.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticTokenDataset:
    vocab: int
    seq_len: int
    seed: int = 0
    order: int = 2          # Markov order of the synthetic language

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse transition table: each context prefers ~8 next tokens
        self.k = 8
        self.table = rng.integers(0, self.vocab,
                                  size=(self.vocab, self.k)).astype(np.int32)

    def batch(self, step: int, host_id: int, batch: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + host_id)
        toks = np.empty((batch, self.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        choices = rng.integers(0, self.k, size=(batch, self.seq_len))
        for t in range(1, self.seq_len):
            toks[:, t] = self.table[toks[:, t - 1], choices[:, t]]
        return {"tokens": toks}


@dataclasses.dataclass
class SyntheticLatentDataset:
    img_size: int
    channels: int
    n_classes: int = 10
    text_dim: int = 0
    text_len: int = 77
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.modes = rng.normal(
            0, 1, size=(self.n_classes, self.img_size, self.img_size,
                        self.channels)).astype(np.float32)
        if self.text_dim:
            self.text_bank = rng.normal(
                0, 1, size=(self.n_classes, self.text_len, self.text_dim)
            ).astype(np.float32)

    def batch(self, step: int, host_id: int, batch: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_539 + host_id)
        labels = rng.integers(0, self.n_classes, size=batch).astype(np.int32)
        lat = (self.modes[labels]
               + 0.3 * rng.normal(0, 1, size=(batch, self.img_size,
                                              self.img_size, self.channels))
               ).astype(np.float32)
        out = {"latents": lat, "labels": labels}
        if self.text_dim:
            out["text_embeds"] = self.text_bank[labels]
        return out


@dataclasses.dataclass
class ShardedLoader:
    """Host-sharded loader with simple double-buffer prefetch."""

    dataset: object
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        assert self.global_batch % self.num_hosts == 0
        self.local_batch = self.global_batch // self.num_hosts
        self._next = None
        self._next_step = None

    def get(self, step: int) -> dict:
        if self._next_step == step and self._next is not None:
            out = self._next
        else:
            out = self.dataset.batch(step, self.host_id, self.local_batch)
        # prefetch (synchronously built here; on a real host this is a
        # background thread — numpy generation is cheap and overlap-safe)
        self._next = self.dataset.batch(step + 1, self.host_id,
                                        self.local_batch)
        self._next_step = step + 1
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.get(step)
            step += 1
