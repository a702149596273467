"""Decoder-only transformer LM covering the dense & MoE architectures.

The JAX package's ``models/transformer.py`` as an ``nn.Module``.  Features
by config: GQA/MQA, QKV bias, qk-norm, RoPE / M-RoPE, logit softcaps,
alternating local/global attention (gemma2), squared-ReLU / SwiGLU /
GeGLU MLPs, MoE blocks with shared experts and a first dense layer
(deepseek), tied embeddings, gemma-style pre+post block norms and
embedding scaling.

The parameters keep the JAX tree's layout: ``embedding``, ``final_norm``,
optional ``lm_head``, optional ``layer0`` (deepseek's dense first block),
and ``layers`` with every leaf stacked over the other layers (`defs`), so
carrying the reference's weights over is a name-for-name copy
(`convert.params_from_reference`).  The reference's ``lax.scan`` over
groups of ``len(layer_pattern)`` layers is a Python loop over the stacked
layers here; stacked layer ``i`` is of kind
``layer_pattern[i % len(layer_pattern)]``, and ``layer0`` is global.
The stacked leaves are taken apart once a call (`common.unstack`), so
the backward writes each stacked gradient once.  ``remat="full"``
recomputes each block in the backward (`LanguageModel._layer_call`);
``remat="2level"`` is the reference's sqrt-checkpointing over the scanned
groups (`LanguageModel._two_level`: 6 outer groups of 4 for qwen2-0.5b's
24, 12 of 8 for nemotron-4-340b's 96), with ``layer0`` recomputed alone
as under "full".  On a ``mesh`` the parameters are DTensors placed per
`param_pspecs`, the blocks carry the reference's anchors (`sp_boundary`
around attention and the FFN, `sp_constrain` after each pattern group,
the one-hot embedding and `logits_constrain`) and the MoE blocks run
expert parallelism (`mlp.moe_apply`); `init_cache` lays the decode cache
out per `cache_specs` and `decode_step` runs on the mesh too.  The MoE
blocks route dropless in decode, as the reference's do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import attention as attn
from . import mlp as ffn
from ..parallel.sharding import DEFAULT_RULES, AxisRules, spec_for
from .common import (LanguageModel, ParamDef, mesh_forward, mesh_inference,
                     rms_norm, sp_constrain, stack_defs, tree_map, unstack)
from .config import ModelConfig
from .rope import default_positions, mrope_positions

__all__ = ["TransformerLM", "defs", "cache_specs"]


def _ffn_defs(cfg: ModelConfig, kind: str) -> Dict[str, ParamDef]:
    if kind == "moe":
        return ffn.moe_defs(cfg)
    if kind == "dense0":  # deepseek first dense layer
        return ffn.mlp_defs(cfg, cfg.first_dense_d_ff)
    return ffn.mlp_defs(cfg)


def _block_defs(cfg: ModelConfig, ffn_kind: str) -> Dict[str, Any]:
    d = cfg.d_model
    out = {
        "ln1": ParamDef((d,), ("embed",), "zeros"),
        "attn": attn.attn_defs(cfg),
        "ln2": ParamDef((d,), ("embed",), "zeros"),
        "ffn": _ffn_defs(cfg, ffn_kind),
    }
    if cfg.attn_softcap is not None:  # gemma2 also uses post-norms
        out["ln1_post"] = ParamDef((d,), ("embed",), "zeros")
        out["ln2_post"] = ParamDef((d,), ("embed",), "zeros")
    return out


def _scanned_layers(cfg: ModelConfig) -> int:
    """Layers stacked in ``layers``: all but deepseek's ``layer0``."""
    return cfg.num_layers - (1 if cfg.first_dense_d_ff else 0)


def defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter table of `cfg` (the reference's ``TransformerLM.defs``),
    allocating nothing."""
    out: Dict[str, Any] = {
        "embedding": ParamDef((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed_table"), "fan_in", fan_dims=(1,)),
        "final_norm": ParamDef((cfg.d_model,), ("embed",), "zeros"),
        "layers": stack_defs(_block_defs(cfg, "moe" if cfg.num_experts
                                         else "dense"),
                             _scanned_layers(cfg)),
    }
    if cfg.first_dense_d_ff:
        out["layer0"] = _block_defs(cfg, "dense0")
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                  ("embed_table", "vocab"))
    return out


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                rules: Optional[AxisRules] = None) -> Dict[str, Any]:
    """Specs of `TransformerLM.init_cache`'s tree (the reference's
    ``cache_pspecs``), allocating nothing."""
    rules = rules or DEFAULT_RULES
    pattern = cfg.layer_pattern
    groups = _scanned_layers(cfg) // len(pattern)
    logical = attn.cache_logical_axes()

    def shapes(length):
        return {"k": (batch, cfg.num_kv_heads, length, cfg.head_dim),
                "v": (batch, cfg.num_kv_heads, length, cfg.head_dim),
                "slot_pos": (length,)}

    def one(local):
        length = (min(cfg.local_window, max_seq)
                  if (local and cfg.local_window) else max_seq)
        return {k: spec_for((groups,) + sh, ("layers",) + logical[k], mesh,
                            rules) for k, sh in shapes(length).items()}

    out = {f"p{i}": one(kind == "local") for i, kind in enumerate(pattern)}
    if cfg.first_dense_d_ff:
        out["layer0"] = {k: spec_for(sh, logical[k], mesh, rules)
                         for k, sh in shapes(max_seq).items()}
    return out


class TransformerLM(LanguageModel):
    """The dense or MoE LM with `params`, a tree of `defs(cfg)`'s shapes (from
    `common.init_params` or `convert.params_from_reference`)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 remat: str = "full", *, mesh=None, sp: bool = False,
                 rules: Optional[AxisRules] = None):
        super().__init__(cfg, params, defs(cfg), remat, mesh=mesh, sp=sp,
                         rules=rules)

    def cache_pspecs(self, mesh, batch: int, max_seq: int,
                     rules: Optional[AxisRules] = None) -> Dict[str, Any]:
        return cache_specs(self.cfg, mesh, batch, max_seq, rules)

    def _layers(self, p):
        """[(kind, parameters of stacked layer i)] for every stacked layer,
        the parameters taken apart once (`unstack`; ``layer0`` is not among
        them)."""
        pattern = self.cfg.layer_pattern
        return [(pattern[i % len(pattern)], lp)
                for i, lp in enumerate(unstack(p["layers"]))]

    # -- forward ---------------------------------------------------------
    def _block(self, p, x, kind: str, positions, cache=None, pos=None):
        cfg = self.cfg
        local = kind == "local"
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cache is None:
            a = attn.attn_apply(p["attn"], self._boundary(h), cfg, positions,
                                local=local, rules=self.rules)
        else:
            a, cache = attn.attn_decode(p["attn"], h, cfg, cache, pos,
                                        local=local, rules=self.rules)
        if "ln1_post" in p:
            a = rms_norm(a, p["ln1_post"], cfg.norm_eps)
        x = x + self._boundary(a)
        h = self._boundary(rms_norm(x, p["ln2"], cfg.norm_eps))
        if "router" in p["ffn"]:
            f = ffn.moe_apply(p["ffn"], h, cfg, mesh=self.mesh,
                              dropless=cache is not None)
        else:
            f = ffn.mlp_apply(p["ffn"], h, cfg)
        if "ln2_post" in p:
            f = rms_norm(f, p["ln2_post"], cfg.norm_eps)
        return x + self._boundary(f)

    def _positions(self, tokens, positions):
        if positions is not None:
            return positions
        b, s = tokens.shape
        if self.cfg.mrope_sections is not None:
            return mrope_positions(b, s, device=tokens.device)
        return default_positions(b, s, device=tokens.device)

    @mesh_forward
    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] -> float32 logits [B, S, V] (the fused prefill, or
        the train step's forward: it runs under the caller's grad mode)."""
        p = self.params.tree()
        positions = self._positions(tokens, positions)
        x = self._embed(p, tokens)
        if "layer0" in p:
            x = self._remat_call(self.remat != "none", self._block,
                                 p["layer0"], x, "global", positions)
        gsize = len(self.cfg.layer_pattern)
        layers = self._layers(p)
        groups = [layers[i:i + gsize] for i in range(0, len(layers), gsize)]

        def group(gp, x):  # one scanned group, anchored at its end
            for kind, pi in gp:
                x = self._layer_call(self._block, pi, x, kind, positions)
            return sp_constrain(x, self.mesh, self.sp, self.rules)

        if self.remat == "2level":
            x = self._two_level(group, groups, x)
        else:
            for gp in groups:
                x = group(gp, x)
        x = rms_norm(x, p["final_norm"], self.cfg.norm_eps)
        return self._unembed(p, x)

    # -- decode ----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The reference's cache tree: ``p{i}`` for pattern position i, each
        leaf stacked over the groups of ``len(layer_pattern)`` stacked
        layers, and ``layer0``'s (global) cache where the model has one;
        on a mesh laid out per `cache_pspecs`."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        dev = self._cache_device()
        pattern = cfg.layer_pattern
        n = _scanned_layers(cfg)
        if n % len(pattern):
            raise ValueError(f"{n} stacked layers do not divide into "
                             f"groups of {pattern}")
        groups = n // len(pattern)

        def one(local):
            c = attn.init_cache(cfg, batch, max_seq, local, dtype, dev)
            return tree_map(lambda a: a.expand((groups,) + a.shape).clone(),
                            c)

        cache = {f"p{i}": one(kind == "local")
                 for i, kind in enumerate(pattern)}
        if cfg.first_dense_d_ff:
            cache["layer0"] = attn.init_cache(cfg, batch, max_seq, False,
                                              dtype, dev)
        return self._place_cache(cache, batch, max_seq)

    @mesh_inference
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor,
                    pos: int):
        """tokens [B, 1], pos an int -> (float32 logits [B, 1, V], cache);
        the cache is updated in place and returned."""
        p = self.params.tree()
        gsize = len(self.cfg.layer_pattern)
        x = self._embed(p, tokens)
        if "layer0" in p:
            x = self._block(p["layer0"], x, "global", None,
                            cache=cache["layer0"], pos=pos)
        for i, (kind, pi) in enumerate(self._layers(p)):
            c = tree_map(lambda a: a[i // gsize], cache[f"p{i % gsize}"])
            x = self._block(pi, x, kind, None, cache=c, pos=pos)
        x = rms_norm(x, p["final_norm"], self.cfg.norm_eps)
        return self._unembed(p, x), cache
