"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The JAX package's ``models/whisper.py`` as an ``nn.Module``.  The encoder
consumes precomputed frame embeddings [B, F, d] (the conv frontend is a
stub, as in the reference) and runs bidirectional self-attention; the
decoder runs causal self-attention and cross-attention over the encoder's
memory.  Both add the float32 sinusoid table cast to their input's dtype,
and their self-attention applies RoPE too, as the reference's
``attn_apply`` / ``attn_decode`` do.  Self-attention goes through the
flash-attention kernel (``causal=False`` in the encoder); cross-attention
is the reference's float32 einsum softmax, and decode re-projects the
memory's keys and values at every step, as the reference does.

The parameters keep the reference's tree (``embedding``, ``enc_norm``,
``dec_norm``, ``encoder`` and ``decoder`` stacked over their layers), so
`convert.params_from_reference` is a name-for-name copy.  The model
computes in the dtype of what it is given, as JAX's promotion does: the
encoder in the frames' dtype, the decoder in the embedding's, and the
cross keys and values in the wider of the memory's and the decoder's.
The stacked leaves are taken apart once a call (`common.unstack`).
``remat="full"`` recomputes each encoder and decoder layer in the
backward; "2level" recomputes none, as the reference, whose encoder and
decoder check for "full" alone.  On
a ``mesh`` the parameters are DTensors placed per `param_pspecs`, the
frames (the global batch's) and the sinusoid tables join the activations
as DTensors, and the blocks carry the reference's anchors
(`sp_boundary` around attention, cross-attention and the MLPs,
`sp_constrain` after each decoder layer); `init_cache` lays the decode
cache out per `cache_specs` (the encoder's memory too) and `decode_step`
runs on the mesh too.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..obs.profiler import named_scope
from ..parallel.sharding import (DEFAULT_RULES, AxisRules, is_dtensor,
                                 placements, replicate_like, spec_for)
from . import attention as attn
from . import mlp as ffn
from .common import (LanguageModel, ParamDef, embed_lookup, mesh_forward,
                     mesh_inference, rms_norm, sp_constrain, stack_defs,
                     tree_map, unstack)
from .config import ModelConfig
from .rope import default_positions

__all__ = ["WhisperModel", "defs", "cache_specs"]


def _sinusoid(seq: int, dim: int, dtype: torch.dtype, device,
              start: int = 0) -> torch.Tensor:
    """Rows start .. start + seq - 1 of the reference's sinusoid table:
    sin at the even columns, cos at the odd ones, in float32, cast to
    `dtype`."""
    pos = torch.arange(start, start + seq, dtype=torch.float32,
                       device=device)[:, None]
    div = torch.exp(-math.log(10000.0)
                    * torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=device) / dim)
    ang = pos * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        seq, dim).to(dtype)


def _cross_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg: ModelConfig, dt: torch.dtype) -> torch.Tensor:
    """Cross-attention's float32 einsum softmax on plain tensors (the
    reference's): q [B, H, S, K], k/v [B, H, F, K] -> [B, H, S, K] in
    `dt`."""
    logits = torch.einsum("bhsk,bhfk->bhsf",
                          q.float() * cfg.head_dim ** -0.5, k.float())
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhsf,bhfk->bhsk", w, v.float()).to(dt)


def _cross_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    return {
        "wq": ParamDef((d, cfg.num_heads, cfg.head_dim), ("embed", "qheads", "head_dim")),
        "wk": ParamDef((d, cfg.num_kv_heads, cfg.head_dim), ("embed", "kvheads", "head_dim")),
        "wv": ParamDef((d, cfg.num_kv_heads, cfg.head_dim), ("embed", "kvheads", "head_dim")),
        "wo": ParamDef((cfg.num_heads, cfg.head_dim, d), ("qheads", "head_dim", "embed"),
                       fan_dims=(0, 1)),
    }


def _enc_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": ParamDef((d,), ("embed",), "zeros"),
            "attn": attn.attn_defs(cfg),
            "ln2": ParamDef((d,), ("embed",), "zeros"),
            "mlp": ffn.mlp_defs(cfg)}


def _dec_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": ParamDef((d,), ("embed",), "zeros"),
            "attn": attn.attn_defs(cfg),
            "lnx": ParamDef((d,), ("embed",), "zeros"),
            "cross": _cross_defs(cfg),
            "ln2": ParamDef((d,), ("embed",), "zeros"),
            "mlp": ffn.mlp_defs(cfg)}


def defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter table of `cfg` (the reference's
    ``WhisperModel.defs``), allocating nothing."""
    return {
        "embedding": ParamDef((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed_table"), "fan_in", fan_dims=(1,)),
        "enc_norm": ParamDef((cfg.d_model,), ("embed",), "zeros"),
        "dec_norm": ParamDef((cfg.d_model,), ("embed",), "zeros"),
        "encoder": stack_defs(_enc_block_defs(cfg), cfg.encoder_layers),
        "decoder": stack_defs(_dec_block_defs(cfg), cfg.num_layers),
    }


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                rules: Optional[AxisRules] = None) -> Dict[str, Any]:
    """Specs of `WhisperModel.init_cache`'s tree (the reference's
    ``cache_pspecs``), allocating nothing."""
    rules = rules or DEFAULT_RULES
    L = cfg.num_layers
    la = attn.cache_logical_axes()
    shapes = {"k": (L, batch, cfg.num_kv_heads, max_seq, cfg.head_dim),
              "v": (L, batch, cfg.num_kv_heads, max_seq, cfg.head_dim),
              "slot_pos": (L, max_seq)}
    return {"self": {k: spec_for(shapes[k], ("layers",) + la[k], mesh, rules)
                     for k in shapes},
            "memory": spec_for((batch, cfg.encoder_frames, cfg.d_model),
                               ("batch", None, "embed"), mesh, rules)}


class WhisperModel(LanguageModel):
    """The encoder-decoder with `params`, a tree of `defs(cfg)`'s shapes
    (from `common.init_params` or `convert.params_from_reference`)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 remat: str = "full", *, mesh=None, sp: bool = False,
                 rules: Optional[AxisRules] = None):
        super().__init__(cfg, params, defs(cfg), remat, mesh=mesh, sp=sp,
                         rules=rules)

    def cache_pspecs(self, mesh, batch: int, max_seq: int,
                     rules: Optional[AxisRules] = None) -> Dict[str, Any]:
        return cache_specs(self.cfg, mesh, batch, max_seq, rules)

    # -- encoder ---------------------------------------------------------
    def _encode(self, p, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, f, _ = frames.shape
        with named_scope("whisper.encode"):
            if self.mesh is not None:
                frames = replicate_like(frames, p["embedding"])
            x = frames + replicate_like(_sinusoid(f, cfg.d_model, frames.dtype,
                                                  frames.device)[None], frames)
            positions = default_positions(b, f, device=frames.device)
            for lp in unstack(p["encoder"]):
                x = self._layer_call(self._enc_block, lp, x, positions)
            return rms_norm(x, p["enc_norm"], cfg.norm_eps)

    def _enc_block(self, lp, x: torch.Tensor, positions) -> torch.Tensor:
        cfg = self.cfg
        h = self._boundary(rms_norm(x, lp["ln1"], cfg.norm_eps))
        x = x + self._boundary(attn.attn_apply(lp["attn"], h, cfg, positions,
                                               causal=False, rules=self.rules))
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + self._boundary(ffn.mlp_apply(lp["mlp"], h, cfg))

    @mesh_forward
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, F, d] (precomputed conv-frontend embeddings) ->
        memory [B, F, d] in the frames' dtype (under the caller's grad
        mode)."""
        return self._encode(self.params.tree(), frames)

    # -- cross attention -------------------------------------------------
    def _cross_apply(self, p, x: torch.Tensor,
                     memory: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = x.dtype
        mt = torch.promote_types(memory.dtype, dt)
        with named_scope("whisper.cross"):
            if is_dtensor(x):
                sq, sk = attn.qkv_specs(x.shape[0], x.shape[1], cfg.num_heads,
                                        cfg.num_kv_heads, cfg.head_dim,
                                        x.device_mesh, self.rules)
                q = attn.project_heads(x, p["wq"].to(dt), sq)
                k = attn.project_heads(memory.to(mt), p["wk"].to(dt).to(mt),
                                       sk)
                v = attn.project_heads(memory.to(mt), p["wv"].to(dt).to(mt),
                                       sk)
                # each rank's batch and heads (torch 2.11's DTensor
                # refuses the products' flattening of two sharded dims)
                from ..parallel.compat import local_map

                mesh = x.device_mesh
                pq, pk = placements(sq, mesh), placements(sk, mesh)
                o = local_map(lambda a, b, c: _cross_core(a, b, c, cfg, dt),
                              out_placements=list(pq),
                              in_placements=(pq, pk, pk), device_mesh=mesh,
                              redistribute_inputs=True)(q, k, v)
                return attn.merge_heads(o, p["wo"].to(dt), sq)
            q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(dt))
            k = torch.einsum("bfd,dhk->bhfk", memory.to(mt),
                             p["wk"].to(dt).to(mt))
            v = torch.einsum("bfd,dhk->bhfk", memory.to(mt),
                             p["wv"].to(dt).to(mt))
            o = _cross_core(q, k, v, cfg, dt)
            return torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(dt))

    def _dec_block(self, p, x: torch.Tensor, memory: torch.Tensor, positions,
                   cache=None, pos: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cache is None:
            a = attn.attn_apply(p["attn"], self._boundary(h), cfg, positions,
                                rules=self.rules)
        else:
            a, _ = attn.attn_decode(p["attn"], h, cfg, cache, pos,
                                    rules=self.rules)
        x = x + self._boundary(a)
        c = self._cross_apply(p["cross"], rms_norm(x, p["lnx"], cfg.norm_eps),
                              memory)
        x = x + self._boundary(c)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + self._boundary(ffn.mlp_apply(p["mlp"], h, cfg))

    def _logits(self, p, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, p["dec_norm"], self.cfg.norm_eps)
        return self._unembed(p, x, tied=True)

    # -- decoder forward (teacher forcing) -------------------------------
    @mesh_forward
    def forward(self, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S], frames [B, F, d] -> float32 logits [B, S, V]: the
        encoder over `frames`, then the decoder over `tokens` (under the
        caller's grad mode)."""
        if frames is None:
            raise ValueError("whisper needs encoder frames")
        p = self.params.tree()
        memory = self._encode(p, frames)
        b, s = tokens.shape
        if positions is None:
            positions = default_positions(b, s, device=tokens.device)
        x = embed_lookup(p["embedding"], tokens, self.mesh, self.rules)
        x = x + replicate_like(_sinusoid(s, self.cfg.d_model, x.dtype,
                                         x.device)[None], x)
        for lp in unstack(p["decoder"]):
            x = self._layer_call(self._dec_block, lp, x, memory, positions)
            x = sp_constrain(x, self.mesh, self.sp, self.rules)
        return self._logits(p, x)

    # -- decode ----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None,
                   frames: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """The reference's cache: ``self`` (k/v [L, B, Hkv, max_seq, D] in
        `dtype`, ``slot_pos`` [L, max_seq]) and ``memory`` [B, F, d], the
        encoder run over `frames` when they are given, else zeros in
        `dtype`; on a mesh laid out per `cache_pspecs`."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        L, dev = cfg.num_layers, self._cache_device()
        one = attn.init_cache(cfg, batch, max_seq, False, dtype, dev)
        self_c = tree_map(lambda a: a.expand((L,) + a.shape).clone(), one)
        if frames is not None:
            memory = self.encode(frames)
        else:
            memory = torch.zeros((batch, cfg.encoder_frames, cfg.d_model),
                                 dtype=dtype, device=dev)
        return self._place_cache({"self": self_c, "memory": memory}, batch,
                                 max_seq)

    @mesh_inference
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor,
                    pos: int):
        """tokens [B, 1], pos an int -> (float32 logits [B, 1, V], cache);
        the self-attention cache is updated in place and returned."""
        p = self.params.tree()
        x = embed_lookup(p["embedding"], tokens, self.mesh, self.rules)
        x = x + replicate_like(_sinusoid(1, self.cfg.d_model, x.dtype,
                                         x.device, start=pos)[None], x)
        memory = cache["memory"]
        for i, lp in enumerate(unstack(p["decoder"])):
            x = self._dec_block(lp, x, memory, None,
                                cache=_layer(cache["self"], i), pos=pos)
        return self._logits(p, x), cache
