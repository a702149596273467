"""Attention block: GQA/MQA/MHA with RoPE/M-RoPE, qk-norm, softcap, sliding
window, optional bias, and a decode path over (optionally rolling) KV caches.

The JAX package's ``models/attention.py``.  Full-sequence attention
(`attn_apply`, the prefill) goes through `kernels.flash_attention.ops.
attention`: the CUDA kernel on the card, the plain version on the CPU.
On a mesh (DTensor activations) that call runs under ``local_map`` on
each rank's shard: q, k, v laid out per `qkv_specs` (batch over the dp
axes, heads over ``model`` where both q's and k/v's head counts divide,
else replicated; `project_heads` makes them so), the kernel on the local
tensors, the output with q's layout; a DTensor itself never reaches the
kernel.  One-token
decode (`attn_decode`) is plain PyTorch, as the reference's is plain jnp.

Cache layouts (per layer):
  global layers : k/v [B, Hkv, S_max, D]
  local layers  : rolling buffer [B, Hkv, W, D] with slot = pos mod W, plus
                  a [W] slot->absolute-position array (-1: empty); memory
                  O(window) instead of O(seq).
`attn_decode` writes the new key and value into the cache in place (the
reference returns a new cache; at full width a copy per step would double
the cache's memory traffic) and returns the same dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention.ops import attention as attention_op
from ..parallel.sharding import (DEFAULT_RULES, AxisRules, P, constrain,
                                 is_dtensor, placements, replicate_like,
                                 spec_for)
from .common import ParamDef, rms_norm
from .config import ModelConfig
from .rope import apply_mrope, apply_rope

__all__ = ["attn_defs", "attn_apply", "init_cache", "attn_decode",
           "cache_logical_axes", "qkv_specs", "project_heads", "NEG_INF"]

NEG_INF = -1e30


def attn_defs(cfg: ModelConfig, cross: bool = False) -> Dict[str, ParamDef]:
    """The attention block's parameter table.  ``cross`` is the
    reference's parameter, accepted and unused there too."""
    d = cfg.d_model
    defs = {
        "wq": ParamDef((d, cfg.num_heads, cfg.head_dim), ("embed", "qheads", "head_dim")),
        "wk": ParamDef((d, cfg.num_kv_heads, cfg.head_dim), ("embed", "kvheads", "head_dim")),
        "wv": ParamDef((d, cfg.num_kv_heads, cfg.head_dim), ("embed", "kvheads", "head_dim")),
        "wo": ParamDef((cfg.num_heads, cfg.head_dim, d), ("qheads", "head_dim", "embed"),
                       fan_dims=(0, 1)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((cfg.num_heads, cfg.head_dim), ("qheads", "head_dim"), "zeros")
        defs["bk"] = ParamDef((cfg.num_kv_heads, cfg.head_dim), ("kvheads", "head_dim"), "zeros")
        defs["bv"] = ParamDef((cfg.num_kv_heads, cfg.head_dim), ("kvheads", "head_dim"), "zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((cfg.head_dim,), ("head_dim",), "zeros")
        defs["k_norm"] = ParamDef((cfg.head_dim,), ("head_dim",), "zeros")
    return defs


def qkv_specs(b: int, s: int, hq: int, hkv: int, head_dim: int, mesh,
              rules: Optional[AxisRules] = None):
    """(q's spec, k/v's spec) on `mesh`: batch over the dp axes, and the
    heads over the axes `spec_for` gives both q's `hq` and k/v's `hkv`
    heads, else replicated in both (a rank's q heads must meet their kv
    group: qwen2-0.5b's 14/2 heads shard at model = 2, not at 4)."""
    rules = rules or DEFAULT_RULES
    sq = spec_for((b, hq, s, head_dim), ("batch", "qheads", "seq",
                                         "head_dim"), mesh, rules)
    sk = spec_for((b, hkv, s, head_dim), ("batch", "kvheads", "seq",
                                          "head_dim"), mesh, rules)
    heads = sq[1] if sq[1] == sk[1] else None
    return P(sq[0], heads, *sq[2:]), P(sk[0], heads, *sk[2:])


def project_heads(x: torch.Tensor, w: torch.Tensor,
                  spec) -> torch.Tensor:
    """``einsum("bsd,dhk->bhsk", x, w)`` for a DTensor x [B, S, d]: the
    product over the flattened (h, k) is laid out per `spec`'s batch and
    heads entries before it splits into heads, and the flattened weight's
    gradient as the flattened weight, before it splits back (left alone,
    DTensor may shard a flattened dim where h does not divide the mesh
    axis, and then refuse the split).  The same bmm as the meshless
    einsum's, so on a mesh of one the same bits."""
    b, s, d = x.shape
    _, h, k = w.shape
    mesh = x.device_mesh
    w2 = replicate_like(w, x).reshape(d, h * k)
    w2 = w2.redistribute(mesh, w2.placements)  # (a no-op but for the grad)
    y = constrain(torch.einsum("bsd,dn->bsn", x, w2), mesh,
                  P(spec[0], spec[2], spec[1]))
    return y.view(b, s, h, k).permute(0, 2, 1, 3)


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions,
                 rules: Optional[AxisRules] = None):
    """x [B,S,d] -> q [B,Hq,S,D], k/v [B,Hkv,S,D] (rope applied); on a
    mesh laid out per `qkv_specs` under `rules`.

    The einsums return permuted views; `attention_op` makes them
    contiguous."""
    dt = x.dtype
    if is_dtensor(x):
        sq, sk = qkv_specs(x.shape[0], x.shape[1], cfg.num_heads,
                           cfg.num_kv_heads, cfg.head_dim, x.device_mesh,
                           rules)
        q = project_heads(x, p["wq"].to(dt), sq)
        k = project_heads(x, p["wk"].to(dt), sk)
        v = project_heads(x, p["wv"].to(dt), sk)
    else:
        q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(dt))
        k = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)[None, :, None, :]
        k = k + p["bk"].to(dt)[None, :, None, :]
        v = v + p["bv"].to(dt)[None, :, None, :]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention_on_mesh(q, k, v, rules: Optional[AxisRules], **kw):
    """`attention_op` on each rank's shard of DTensors q [B,Hq,S,D] and
    k/v [B,Hkv,S,D], laid out per `qkv_specs`."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    b, hq, s, d = q.shape
    sq, sk = qkv_specs(b, s, hq, k.shape[1], d, mesh, rules)
    pq, pk = placements(sq, mesh), placements(sk, mesh)
    fn = local_map(lambda a, b, c: attention_op(a, b, c, **kw),
                   out_placements=list(pq), in_placements=(pq, pk, pk),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


def attn_apply(p, x: torch.Tensor, cfg: ModelConfig, positions, *,
               local: bool = False, causal: bool = True,
               rules: Optional[AxisRules] = None) -> torch.Tensor:
    """Full-sequence (prefill) attention; on a mesh (x a DTensor) per
    rank under `rules` (`_attention_on_mesh`)."""
    q, k, v = _project_qkv(p, x, cfg, positions, rules)
    kw = dict(causal=causal, softcap=cfg.attn_softcap,
              window=cfg.local_window if local else None)
    o = _attention_on_mesh(q, k, v, rules, **kw) if is_dtensor(q) \
        else attention_op(q, k, v, **kw)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(x.dtype))


def cache_logical_axes() -> Dict[str, Tuple]:
    """Logical axes of one layer's cache leaves (`init_cache`)."""
    return {"k": ("batch", "kvheads", "kv_seq", "head_dim"),
            "v": ("batch", "kvheads", "kv_seq", "head_dim"),
            "slot_pos": (None,)}


# ----------------------------------------------------------------------------
# decode path
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, local: bool,
               dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    length = min(cfg.local_window, max_seq) if (local and cfg.local_window) \
        else max_seq
    shape = (batch, cfg.num_kv_heads, length, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((length,), -1, dtype=torch.int32,
                               device=device),
    }


def attn_decode(p, x: torch.Tensor, cfg: ModelConfig, cache, pos: int, *,
                local: bool = False):
    """One-token decode.  x [B,1,d]; pos an int (the same for the whole
    batch).  Returns (out [B,1,d], cache), the cache updated in place."""
    b = x.shape[0]
    pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    positions = torch.stack([pos_b] * 3, dim=0) \
        if cfg.mrope_sections is not None else pos_b
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)

    # rolling slot: pos mod buffer length (== pos for full-length caches)
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    slot = pos % k.shape[2]
    k[:, :, slot] = k_new[:, :, 0].to(k.dtype)
    v[:, :, slot] = v_new[:, :, 0].to(v.dtype)
    slot_pos[slot] = pos

    # grouped heads without repeating K/V.  The reference keeps bf16
    # operands with float32 accumulation (preferred_element_type); bf16
    # values are exact in float32, so float32 operands give that product
    gq = cfg.num_heads // cfg.num_kv_heads
    qf = (q * torch.tensor(cfg.head_dim ** -0.5, dtype=q.dtype)).reshape(
        b, cfg.num_kv_heads, gq, cfg.head_dim)  # S == 1 squeezed into g
    logits = torch.einsum("bhgk,bhsk->bhgs", qf.float(),
                          k.to(qf.dtype).float())  # [B,Hkv,g,L]
    if cfg.attn_softcap is not None:
        logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if local and cfg.local_window:
        valid &= slot_pos > pos - cfg.local_window
    logits = logits.masked_fill(~valid[None, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhgs,bhsk->bhgk", w.float(),
                     v.to(x.dtype).float()).to(x.dtype)
    o = o.reshape(b, cfg.num_heads, 1, cfg.head_dim)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache
