"""Architecture registry: one module per assigned architecture.

A copy of the JAX package's ``configs`` (data only), so the port imports
nothing of it."""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_MODULES = [
    "qwen2_vl_72b",
    "qwen3_4b",
    "nemotron_4_340b",
    "gemma2_9b",
    "qwen2_0_5b",
    "whisper_base",
    "falcon_mamba_7b",
    "qwen2_moe_a2_7b",
    "deepseek_moe_16b",
    "recurrentgemma_9b",
]


def _load() -> Dict[str, ModelConfig]:
    out = {}
    for m in ARCH_MODULES:
        mod = importlib.import_module(f".{m}", __package__)
        cfg = mod.CONFIG
        out[cfg.name] = cfg
    return out


_REGISTRY: Dict[str, ModelConfig] = {}


def get_config(name: str) -> ModelConfig:
    global _REGISTRY
    if not _REGISTRY:
        _REGISTRY = _load()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    global _REGISTRY
    if not _REGISTRY:
        _REGISTRY = _load()
    return sorted(_REGISTRY)
