"""Int8 gradient compression with error feedback.

The JAX package's ``train/compress.py``: gradients are quantized to int8
with a per-tensor scale and dequantized, and the quantization residual is
carried to the next step (error feedback; Karimireddy et al., "Error
Feedback Fixes SignSGD", 2019).  On a mesh the pair runs on the
gradients as the step lays them out (DTensors), after their reduction,
as the reference's runs after GSPMD's: in both it changes the update,
not the bytes a collective moves.  Off by default; enabled with
``--compress int8``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..models.common import tree_map

__all__ = ["compress_decompress"]


def _quant_dequant(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, gf - deq


def compress_decompress(grads: Any, ef_state: Optional[Any]):
    """Returns (dequantized grads incl. error feedback, new residuals),
    both float32 trees of `grads`' structure."""
    if ef_state is None:
        ef_state = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                            grads)
    out = tree_map(lambda g, e: _quant_dequant(g.float() + e), grads,
                   ef_state)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)
