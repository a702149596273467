"""Uniform model facade: build an assigned architecture by config.

The JAX package's ``models/api.py`` for the families the port runs:
``dense`` and ``moe`` (`TransformerLM`) and ``hybrid`` (`GriffinLM`).  The
other families raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..device import resolve_device
from . import griffin, transformer
from .common import LanguageModel, dtype_of, init_params
from .config import ModelConfig

__all__ = ["build_model", "model_parts"]

# family -> (parameter table, model class)
_FAMILIES = {
    "dense": (transformer.defs, transformer.TransformerLM),
    "moe": (transformer.defs, transformer.TransformerLM),
    "hybrid": (griffin.defs, griffin.GriffinLM),
}

_WAITING = {
    "ssm": "models/mamba (ROADMAP Queue 1, item 10)",
    "encdec": "models/whisper (ROADMAP Queue 1, item 10)",
}


def model_parts(cfg: ModelConfig):
    """(defs, model class) of `cfg`'s family; NotImplementedError for a
    family not ported yet."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_WAITING.get(cfg.family, 'unknown family')}")
    return _FAMILIES[cfg.family]


def build_model(cfg: ModelConfig,
                device: Union[str, torch.device, None] = "cuda",
                dtype: Optional[torch.dtype] = None,
                seed: int = 0) -> LanguageModel:
    """`cfg`'s model on `device` with random parameters from `seed` (a
    truncated normal per `common.init_params`, drawn on the device), in
    `dtype` (default: the config's)."""
    table, cls = model_parts(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(table(cfg), gen, dtype or dtype_of(cfg.dtype), dev)
    return cls(cfg, params)
