"""Rotary position embeddings: standard RoPE and qwen2-vl M-RoPE.

The JAX package's ``models/rope.py`` in PyTorch: angles in float32, a
split-half rotation in float32, the result cast back to x's dtype.  On a
mesh (x a DTensor) the positions are the global ones and the angles
replicated DTensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel.sharding import replicate_like

__all__ = ["apply_rope", "apply_mrope", "default_positions",
           "mrope_positions"]


def _freq(half: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [..., S] -> cos/sin [..., S, head_dim/2] (float32)."""
    ang = positions[..., None].float() * _freq(head_dim // 2, theta,
                                               positions.device)
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., S, D]; cos/sin broadcastable [..., S, D/2]. Split-half rotation."""
    half = x.shape[-1] // 2
    cos, sin = replicate_like(cos, x), replicate_like(sin, x)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def default_positions(batch: int, seq: int, offset: int = 0, *,
                      device) -> torch.Tensor:
    """[B, S] int32 positions offset .. offset + S - 1 on `device`."""
    p = torch.arange(seq, dtype=torch.int32, device=device) + offset
    return p[None, :].expand(batch, seq)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x [B, H, S, D], positions [B, S]."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)  # [B, S, D/2]
    return _rotate(x, cos[:, None], sin[:, None])


def mrope_positions(batch: int, seq: int, offset: int = 0, *,
                    device) -> torch.Tensor:
    """Text-only default: all 3 sections share sequential positions [3, B, S]
    on `device`."""
    p = default_positions(batch, seq, offset, device=device)
    return torch.stack([p, p, p], dim=0)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, ...], theta: float = 1e4) -> torch.Tensor:
    """qwen2-vl multimodal RoPE.

    x [B, H, S, D]; positions3 [3, B, S] (temporal, height, width ids).
    `sections` split D/2 frequency slots among the 3 position streams
    (e.g. (16, 24, 24) for D = 128)."""
    half = x.shape[-1] // 2
    if sum(sections) != half or len(sections) != 3:
        raise ValueError(f"sections {sections} must be 3 parts summing to "
                         f"head_dim / 2 = {half}")
    freq = _freq(half, theta, x.device)
    cos_parts, sin_parts, lo = [], [], 0
    for i, sec in enumerate(sections):
        ang = positions3[i][..., None].float() * freq[lo:lo + sec]
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        lo += sec
    cos = torch.cat(cos_parts, dim=-1)  # [B, S, D/2]
    sin = torch.cat(sin_parts, dim=-1)
    return _rotate(x, cos[:, None], sin[:, None])
