"""Uniform model facade: build an assigned architecture by config.

The JAX package's ``models/api.py``: ``dense`` and ``moe``
(`TransformerLM`), ``ssm`` (`MambaLM`), ``hybrid`` (`GriffinLM`) and
``encdec`` (`WhisperModel`).  An unknown family raises ValueError.
`build_model` takes the reference's ``mesh`` / ``sp`` / ``rules`` as
keywords after the port's own parameters.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..device import resolve_device
from ..parallel.sharding import AxisRules
from . import griffin, mamba, transformer, whisper
from .common import LanguageModel, dtype_of, init_params
from .config import ModelConfig

__all__ = ["build_model", "model_parts"]

# family -> (parameter table, model class)
_FAMILIES = {
    "dense": (transformer.defs, transformer.TransformerLM),
    "moe": (transformer.defs, transformer.TransformerLM),
    "ssm": (mamba.defs, mamba.MambaLM),
    "hybrid": (griffin.defs, griffin.GriffinLM),
    "encdec": (whisper.defs, whisper.WhisperModel),
}


def model_parts(cfg: ModelConfig):
    """(defs, model class) of `cfg`'s family; ValueError for an unknown
    family."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.name})")
    return _FAMILIES[cfg.family]


def build_model(cfg: ModelConfig,
                device: Union[str, torch.device, None] = "cuda",
                dtype: Optional[torch.dtype] = None,
                seed: int = 0, remat: str = "full", *, mesh=None,
                sp: bool = False,
                rules: Optional[AxisRules] = None) -> LanguageModel:
    """`cfg`'s model on `device` with random parameters from `seed` (a
    truncated normal per `common.init_params`, drawn on the device), in
    `dtype` (default: the config's).  ``remat`` is the reference's:
    "full" (its default) recomputes each layer in the backward of a train
    step, "none" keeps the activations; inference does neither.  With a
    `mesh` (a ``DeviceMesh`` whose device type is `device`'s) every rank
    draws the same parameters and keeps its shard of each
    (`LanguageModel`), `sp` and `rules` as the reference's."""
    table, cls = model_parts(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(table(cfg), gen, dtype or dtype_of(cfg.dtype), dev)
    return cls(cfg, params, remat=remat, mesh=mesh, sp=sp, rules=rules)
