"""Plain PyTorch GQA attention with softcap / sliding window / causal mask.

The CPU path of `ops.attention` and the oracle of the CUDA kernels
(`csrc/flash_attention.cu`, `csrc/flash_attention_sm90.cu`); autograd
through `attention_ref` (`attention_backward_ref`) is the oracle of the
backward kernel (`csrc/flash_attention_bwd.cu`), as XLA autodiff through
the JAX package's ``attention_ref`` is its train path's gradient.  Same arithmetic as the JAX package's
``kernels/flash_attention/ref.py``: q cast to float32 and scaled, logits
in float32, masked entries set to the finite ``NEG_INF`` (not ``-inf``),
softmax over the full key range, output in q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["NEG_INF", "attention_ref", "attention_chunked",
           "attention_backward_ref"]

NEG_INF = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """[len(qpos), len(kpos)] bool: which (query, key) pairs attend.

    window = w keeps keys with  pos_q - w < pos_k <= pos_q  (gemma2 local
    layers, recurrentgemma)."""
    mask = torch.ones((len(qpos), len(kpos)), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _softmax_rows(logits: torch.Tensor) -> torch.Tensor:
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, softcap: Optional[float] = None,
                  window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D]; Hq % Hkv == 0."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    logits = logits.masked_fill(~_mask(pos, pos, causal, window), NEG_INF)
    out = torch.einsum("bhqk,bhkd->bhqd", _softmax_rows(logits), vf)
    return out.to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, softcap: Optional[float] = None,
                      window: Optional[int] = None,
                      scale: Optional[float] = None,
                      block_q: int = 512) -> torch.Tensor:
    """`attention_ref` one block of `block_q` queries at a time, so the
    logits working set is [B, Hkv, g, block_q, S] instead of
    [B, Hq, S, S].  Exact (each block's softmax runs over the full key
    range); grouped heads without repeating K/V.  Falls back to
    `attention_ref` when `block_q` does not divide S, as the reference
    does."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    if s % block_q != 0:
        return attention_ref(q, k, v, causal, softcap, window, scale)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(s, device=q.device)
    out = torch.empty((b, hkv, g, s, d), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, s, block_q):
        qi = (q[:, :, q0:q0 + block_q].float() * scale).reshape(
            b, hkv, g, block_q, d)
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qi, kf)
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        mask = _mask(kpos[q0:q0 + block_q], kpos, causal, window)
        logits = logits.masked_fill(~mask, NEG_INF)
        out[:, :, :, q0:q0 + block_q] = torch.einsum(
            "bhgqk,bhkd->bhgqd", _softmax_rows(logits), vf)
    return out.reshape(b, hq, s, d).to(q.dtype)


def attention_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           do: torch.Tensor, causal: bool = True,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None,
                           scale: Optional[float] = None):
    """(dq, dk, dv) of `attention_ref` at (q, k, v) for the output gradient
    `do`, in q's, k's and v's dtypes: ``torch.autograd.grad`` through the
    plain version (masked pairs get no gradient, softcapped logits the
    ``1 - tanh^2`` factor, grouped heads the sum over their group)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, softcap=softcap,
                            window=window, scale=scale)
        return torch.autograd.grad(out, leaves, do)
