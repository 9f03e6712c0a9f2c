"""Architecture registry: maps ``--arch`` ids to ModelConfig factories."""
from __future__ import annotations

import importlib
from typing import Callable, Dict

from .base import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}

# Modules under repro_torch.configs that register an architecture.
_CONFIG_MODULES = ["mixtral_8x7b", "phi35_moe", "qwen3_moe_30b_a3b",
                   "mamba2_370m", "smollm_360m", "mistral_nemo_12b",
                   "qwen2_72b", "jamba_v0_1_52b",
                   "llama4_maverick_400b_a17b", "gemma3_4b", "qwen2_vl_7b",
                   "seamless_m4t_large_v2"]


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def _ensure_loaded() -> None:
    for mod in _CONFIG_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()

