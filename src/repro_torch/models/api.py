"""Uniform model facade: build an assigned architecture by config.

The JAX package's ``models/api.py`` for the families the port runs: only
``dense`` so far.  The other families raise NotImplementedError naming
their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..device import resolve_device
from .common import dtype_of, init_params
from .config import ModelConfig
from .transformer import TransformerLM, defs

__all__ = ["build_model"]

_WAITING = {
    "moe": "MoE blocks (ROADMAP Queue 1, item 10: models/mlp MoE)",
    "ssm": "models/mamba (ROADMAP Queue 1, item 10)",
    "hybrid": "models/griffin (ROADMAP Queue 1, item 10)",
    "encdec": "models/whisper (ROADMAP Queue 1, item 10)",
}


def build_model(cfg: ModelConfig,
                device: Union[str, torch.device, None] = "cuda",
                dtype: Optional[torch.dtype] = None,
                seed: int = 0) -> TransformerLM:
    """`cfg`'s model on `device` with random parameters from `seed` (a
    truncated normal per `common.init_params`, drawn on the device), in
    `dtype` (default: the config's)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_WAITING.get(cfg.family, 'unknown family')}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(defs(cfg), gen, dtype or dtype_of(cfg.dtype), dev)
    return TransformerLM(cfg, params)
