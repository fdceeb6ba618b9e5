"""ArchBundle: everything the launcher, the step builders and the tests
need of an architecture (the port of ``repro.configs.base``).

Struct functions give tensors on the meta device, with the JAX package's
shapes and dtypes (its ``ShapeDtypeStruct``s): nothing is allocated.
``init_fn(gen, device)`` draws params from a ``torch.Generator``;
``loss_fn(params, batch, rng=None, **draws)`` takes a generator where the
JAX function takes a key, and the diffusion bundles take the step's DDPM
draws ``t=`` and ``noise=`` instead, as ``make_diffusion_microbatches``
does.  ``make_adapter(plan, mesh)`` takes the mesh's axis sizes (a dict
such as ``{"data": 1, "model": 4}``, everything in this process) or a
``RankGrid``, whose rank's adapter it builds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.runtime.pipeline import PipelineConfig
from repro_torch.train.steps import (ParallelPlan, check_one_process,
                                     check_ranks, rank_grid)

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass
class ArchBundle:
    name: str
    family: str
    cfg: Any
    init_fn: Callable                      # (gen, device) -> params
    loss_fn: Callable                      # (params, batch, rng, **draws)
    # batch structs for a shape (train/prefill), on the meta device
    batch_struct: Callable                 # (ShapeSpec, ParallelPlan) -> tree
    plans: dict[str, ParallelPlan]         # per shape name
    shape_support: dict[str, str]          # shape -> "ok" | skip reason
    param_count: int = 0
    active_param_count: int = 0
    # serving (decode shapes): both optional for train-only archs
    make_decode_fn: Callable | None = None  # (ShapeSpec)->(params,tok,c)->(l,c)
    cache_struct: Callable | None = None    # (ShapeSpec) -> cache tree, meta
    # PULSE pipeline (pp_* strategies)
    make_adapter: Callable | None = None    # (plan, mesh axis sizes) -> adapter
    make_microbatches: Callable | None = None
    # reduced-depth variant for roofline probe extrapolation
    scaled_cfg: Callable | None = None      # (n_layers: int) -> cfg
    # reduced smoke config for CPU tests
    smoke: Callable | None = None
    notes: str = ""

    def supported(self, shape: str) -> bool:
        return self.shape_support.get(shape) == "ok"


def meta(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the meta device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def token_batch_struct(shape: ShapeSpec, vocab: int,
                       microbatched: int | None = None) -> Pytree:
    B, S = shape.global_batch, shape.seq_len
    if microbatched:
        M = microbatched
        return {"tokens": meta((M, B // M, S), torch.int32)}
    return {"tokens": meta((B, S), torch.int32)}


def pipeline_config(plan: ParallelPlan, mesh) -> PipelineConfig:
    """The ``PipelineConfig`` of a ``pp_*`` plan on ``mesh``: D = its
    ``"model"`` axis, dp = the product of the plan's batch axes, the plan's
    microbatches, stage remat.  Data replicas run as ranks: on a
    ``RankGrid`` the config is a rank's (its adapter builds with the
    rank's ring and data group); in one process a batch axis larger than
    1 is refused (``check_one_process``)."""
    grid = rank_grid(mesh)
    sizes = (check_one_process(mesh, plan, pipeline_axis="model")
             if grid is None else
             check_ranks(grid, plan, pipeline_axis="model"))
    dp = math.prod(sizes[a] for a in plan.batch_axes if a in sizes)
    return PipelineConfig(num_devices=sizes["model"],
                          num_microbatches=plan.microbatches, dp_size=dp,
                          remat=True)


def ddpm_draws(latents: torch.Tensor, rng: torch.Generator | None,
               t: torch.Tensor | None, noise: torch.Tensor | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """A step's DDPM draws: ``t`` and ``noise`` as given, else drawn from
    ``rng`` (a generator on the latents' device) as the JAX loss draws
    them from its key: t uniform (B,), noise standard normal like the
    latents."""
    if t is None:
        t = torch.rand((latents.shape[0],), generator=rng,
                       device=latents.device)
    if noise is None:
        noise = torch.randn(latents.shape, generator=rng,
                            device=latents.device, dtype=latents.dtype)
    return t, noise


def flatten_microbatches(batch: dict) -> dict:
    """``[M, b, ...]`` leaves -> ``[M * b, ...]``."""
    return {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in
            batch.items()}
