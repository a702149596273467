"""Feed-forward blocks: the dense FFN (SwiGLU / GeGLU / squared-ReLU / GELU).

The JAX package's ``models/mlp.py`` dense half.  Its MoE blocks
(``moe_defs``, ``moe_apply``) wait for their slice (ROADMAP Queue 1,
item 10).  ``jax.nn.gelu`` is the tanh approximation by default, so the
GELUs here pass ``approximate="tanh"`` (PyTorch's default is erf).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .common import ParamDef
from .config import ModelConfig

__all__ = ["mlp_defs", "mlp_apply"]


def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    defs = {"wu": ParamDef((d, f), ("embed", "ff")),
            "wd": ParamDef((f, d), ("ff", "embed"))}
    if cfg.mlp in ("swiglu", "geglu"):
        defs["wg"] = ParamDef((d, f), ("embed", "ff"))
    return defs


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
    elif cfg.mlp == "geglu":  # gemma / recurrentgemma gated GeLU
        h = F.gelu(x @ p["wg"].to(dt), approximate="tanh") \
            * (x @ p["wu"].to(dt))
    elif cfg.mlp == "relu2":  # nemotron squared ReLU
        h = torch.square(F.relu(x @ p["wu"].to(dt)))
    elif cfg.mlp == "gelu":
        h = F.gelu(x @ p["wu"].to(dt), approximate="tanh")
    else:
        raise ValueError(cfg.mlp)
    return h @ p["wd"].to(dt)
