"""Published model configurations, and the architecture registry (the
port of ``repro.configs``): ``get_arch(name)`` -> ``ArchBundle``.

Assigned architectures (10) plus the paper's own diffusion backbones (3).
"""
from __future__ import annotations

import importlib

ASSIGNED = [
    "smollm-360m", "h2o-danube-1.8b", "internlm2-20b", "granite-34b",
    "whisper-base", "xlstm-125m", "internvl2-2b", "qwen3-moe-30b-a3b",
    "deepseek-v3-671b", "zamba2-2.7b",
]
PAPER_ARCHS = ["uvit-h", "sdv2-unet", "hunyuan-dit"]
ALL_ARCHS = ASSIGNED + PAPER_ARCHS

_MODULES = {
    "smollm-360m": "smollm_360m",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "internlm2-20b": "internlm2_20b",
    "granite-34b": "granite_34b",
    "whisper-base": "whisper_base",
    "xlstm-125m": "xlstm_125m",
    "internvl2-2b": "internvl2_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "zamba2-2.7b": "zamba2_2_7b",
    "uvit-h": "uvit_h",
    "sdv2-unet": "sdv2_unet",
    "hunyuan-dit": "hunyuan_dit",
}

_cache: dict = {}


def get_arch(name: str):
    if name not in _cache:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
        _cache[name] = mod.get_bundle()
    return _cache[name]


def list_archs() -> list[str]:
    return list(ALL_ARCHS)
