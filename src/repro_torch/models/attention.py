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
decode (`attn_decode`) is plain PyTorch, as the reference's is plain jnp;
on a mesh its cache leaves are DTensors laid out per the model's
``cache_pspecs`` (the sequence over ``model`` where the kv heads leave it
free) and the new key and value go into the shard that holds their slot
(`common.write_slot`).

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
from .common import ParamDef, rms_norm, write_slot
from .config import ModelConfig
from .rope import apply_mrope, apply_rope

__all__ = ["attn_defs", "attn_apply", "init_cache", "attn_decode",
           "cache_logical_axes", "qkv_specs", "project_heads", "merge_heads",
           "NEG_INF"]

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


def merge_heads(o: torch.Tensor, w: torch.Tensor,
                spec=None) -> torch.Tensor:
    """``einsum("bhsk,hkd->bsd", o, w)``, the output projection.  For a
    DTensor o [B, H, S, K] (laid out per `spec`, q's spec from
    `qkv_specs`) `project_heads`' inverse: the heads merge into one
    (h, k) dim laid out as `spec`'s heads entry, and the gradients of that
    product and of the flattened weight keep their forward layouts before
    they split back into heads (left alone, DTensor may shard the
    flattened dim where h does not divide the mesh axis, e.g. qwen2-0.5b's
    14 heads at model = 16, and then refuse the split).  On a plain
    tensor the einsum itself."""
    if not is_dtensor(o):
        return torch.einsum("bhsk,hkd->bsd", o, w)
    b, h, s, k = o.shape
    mesh = o.device_mesh
    y = constrain(o, mesh, spec).permute(0, 2, 1, 3).reshape(b, s, h * k)
    y = y.redistribute(mesh, y.placements)  # (a no-op but for the grad)
    w2 = replicate_like(w, y).reshape(h * k, w.shape[-1])
    w2 = w2.redistribute(mesh, w2.placements)
    return torch.einsum("bsn,nd->bsd", y, w2)


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
    from ..parallel.compat import local_map

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
    if not is_dtensor(q):
        o = attention_op(q, k, v, **kw)
        return torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(x.dtype))
    o = _attention_on_mesh(q, k, v, rules, **kw)
    sq, _ = qkv_specs(q.shape[0], q.shape[2], q.shape[1], k.shape[1],
                      q.shape[3], q.device_mesh, rules)
    return merge_heads(o, p["wo"].to(x.dtype), sq)


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
                local: bool = False, rules: Optional[AxisRules] = None):
    """One-token decode.  x [B,1,d]; pos an int (the same for the whole
    batch).  Returns (out [B,1,d], cache), the cache updated in place; on
    a mesh (x a DTensor) the projections laid out per `qkv_specs` under
    `rules`."""
    b = x.shape[0]
    pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    positions = torch.stack([pos_b] * 3, dim=0) \
        if cfg.mrope_sections is not None else pos_b
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, rules)

    # rolling slot: pos mod buffer length (== pos for full-length caches)
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    slot = pos % k.shape[2]
    write_slot(k, 2, slot, k_new.to(k.dtype))
    write_slot(v, 2, slot, v_new.to(v.dtype))
    write_slot(slot_pos, 0, slot, torch.full((1,), pos, dtype=torch.int32,
                                             device=x.device))

    spec = qkv_specs(b, 1, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     q.device_mesh, rules)[0] if is_dtensor(q) else None
    o = _decode_attention(q, k, v, slot_pos, cfg, pos, local, x.dtype, spec)
    return merge_heads(o, p["wo"].to(x.dtype), spec), cache


def _decode_logits(q, k, slot_pos, cfg: ModelConfig, pos: int,
                   local: bool):
    """(float32 logits [B, Hkv, g, L], valid [L]) of one decode step on
    plain tensors: q [B, Hq, 1, D] against the cache's k [B, Hkv, L, D],
    grouped heads without repeating K/V.  The reference keeps bf16
    operands with float32 accumulation (preferred_element_type); bf16
    values are exact in float32, so float32 operands give that
    product."""
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    qf = (q * torch.tensor(cfg.head_dim ** -0.5, dtype=q.dtype)).reshape(
        b, hkv, hq // hkv, d)  # S == 1 squeezed into g
    logits = torch.einsum("bhgk,bhsk->bhgs", qf.float(),
                          k.to(qf.dtype).float())  # [B,Hkv,g,L]
    if cfg.attn_softcap is not None:
        logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if local and cfg.local_window:
        valid &= slot_pos > pos - cfg.local_window
    return logits, valid


def _decode_core(q, k, v, slot_pos, cfg: ModelConfig, pos: int,
                 local: bool, dtype: torch.dtype) -> torch.Tensor:
    """Softmax attention of one decode step on plain tensors -> [B, Hq,
    1, D] in `dtype` (the weights rounded to `dtype` before the product,
    as the reference's)."""
    logits, valid = _decode_logits(q, k, slot_pos, cfg, pos, local)
    logits = logits.masked_fill(~valid[None, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1).to(dtype)
    o = torch.einsum("bhgs,bhsk->bhgk", w.float(),
                     v.to(dtype).float()).to(dtype)
    return o.reshape(q.shape[0], q.shape[1], 1, q.shape[3])


def _decode_attention(q, k, v, slot_pos, cfg: ModelConfig, pos: int,
                      local: bool, dtype: torch.dtype,
                      spec=None) -> torch.Tensor:
    """`_decode_core`; on a mesh under ``local_map`` on each rank's shards
    (q laid out per `spec`, its `qkv_specs` spec, whatever layout the
    projections left it in -- a bias sharded over heads can shard q's
    heads where the kv heads stay whole; k/v as the cache is).  Where no mesh dim
    shards the cache's sequence, each rank runs `_decode_core` on its
    batch and heads: on a mesh of one, the meshless bits.  Where one
    does (a single kv head leaves ``model`` to the sequence), the softmax
    spans the ranks as GSPMD partitions the reference's: the row max
    (reduced by max), the sum of ``exp(x - max)`` (reduced by sum), then
    each rank's share of the weighted values (reduced by sum).  DTensor
    is not left to run these products itself: torch 2.11's refuses to
    flatten the batched product's (batch, heads) dims when both are
    sharded, as on a (2, 2) mesh (on a (1, 1) mesh both stay replicated,
    `parallel.sharding.placements`)."""
    if not is_dtensor(q):
        return _decode_core(q, k, v, slot_pos, cfg, pos, local, dtype)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from ..parallel.compat import local_map

    mesh = q.device_mesh
    seq = [isinstance(pl, Shard) and pl.dim == 2 for pl in k.placements]
    qp, kp = placements(spec, mesh), k.placements
    if not any(seq):
        return local_map(
            lambda a, b, c, d: _decode_core(a, b, c, d, cfg, pos, local,
                                            dtype),
            out_placements=list(qp),
            in_placements=(qp, kp, v.placements, slot_pos.placements),
            device_mesh=mesh, redistribute_inputs=True)(q, k, v, slot_pos)
    sp = [Shard(0) if s else Replicate() for s in seq]
    rep = [Replicate() if s else pl for s, pl in zip(seq, qp)]

    def partial(op):  # the rows' placements, partial over the sequence
        return [Partial(op) if s else pl for s, pl in zip(seq, qp)]

    def masked(a, b, d):
        logits, valid = _decode_logits(a, b, d, cfg, pos, local)
        return logits, valid[None, None, None, :]

    def row_max(a, b, d):
        logits, valid = masked(a, b, d)
        return logits.masked_fill(~valid, NEG_INF).amax(-1, keepdim=True)

    def row_sum(a, b, d, m):
        logits, valid = masked(a, b, d)
        return ((logits - m).exp() * valid).sum(-1, keepdim=True)

    def values(a, b, c, d, m, s):
        logits, valid = masked(a, b, d)
        w = ((logits - m).exp() * valid / s).to(dtype)
        return torch.einsum("bhgs,bhsk->bhgk", w.float(),
                            c.to(dtype).float())

    m = local_map(row_max, out_placements=partial("max"),
                  in_placements=(qp, kp, sp), device_mesh=mesh,
                  redistribute_inputs=True)(q, k, slot_pos)
    m = m.redistribute(mesh, rep)
    s = local_map(row_sum, out_placements=partial("sum"),
                  in_placements=(qp, kp, sp, rep), device_mesh=mesh,
                  redistribute_inputs=True)(q, k, slot_pos, m)
    s = s.redistribute(mesh, rep)
    o = local_map(values, out_placements=partial("sum"),
                  in_placements=(qp, kp, v.placements, sp, rep, rep),
                  device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, slot_pos, m, s)
    b, hq, _, d = q.shape
    return o.redistribute(mesh, rep).to(dtype).reshape(b, hq, 1, d)
