"""Decoder-only transformer LM: the dense architectures.

The JAX package's ``models/transformer.py`` as an ``nn.Module``.  Features
by config: GQA/MQA, QKV bias, qk-norm, RoPE / M-RoPE, logit softcaps,
alternating local/global attention (gemma2), squared-ReLU / SwiGLU /
GeGLU MLPs, tied embeddings, gemma-style pre+post block norms and
embedding scaling.

The parameters keep the JAX tree's layout: ``embedding``, ``final_norm``,
optional ``lm_head``, and ``layers`` with every leaf stacked
``[num_layers, ...]`` (`defs`), so carrying the reference's weights over
is a name-for-name copy (`convert.params_from_reference`).  The
reference's ``lax.scan`` over groups of ``len(layer_pattern)`` layers is a
Python loop over the layers here; layer ``i`` is of kind
``layer_pattern[i % len(layer_pattern)]``.  ``remat``, ``mesh``, ``sp``
and ``rules`` are not carried over: inference has no use for them.  MoE
blocks and deepseek's dense ``layer0`` raise NotImplementedError (ROADMAP
Queue 1, item 10).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from . import attention as attn
from . import mlp as ffn
from .common import ParamDef, embed_lookup, rms_norm, stack_defs, tree_map
from .config import ModelConfig
from .rope import default_positions, mrope_positions

__all__ = ["TransformerLM", "defs"]

_NOT_PORTED = ("MoE blocks and deepseek's dense layer0 are not ported yet "
               "(ROADMAP Queue 1, item 10: models/mlp MoE)")


def _block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    out = {
        "ln1": ParamDef((d,), ("embed",), "zeros"),
        "attn": attn.attn_defs(cfg),
        "ln2": ParamDef((d,), ("embed",), "zeros"),
        "ffn": ffn.mlp_defs(cfg),
    }
    if cfg.attn_softcap is not None:  # gemma2 also uses post-norms
        out["ln1_post"] = ParamDef((d,), ("embed",), "zeros")
        out["ln2_post"] = ParamDef((d,), ("embed",), "zeros")
    return out


def defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter table of `cfg` (the reference's ``TransformerLM.defs``),
    allocating nothing."""
    if cfg.num_experts or cfg.first_dense_d_ff:
        raise NotImplementedError(_NOT_PORTED)
    out: Dict[str, Any] = {
        "embedding": ParamDef((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed_table"), "fan_in", fan_dims=(1,)),
        "final_norm": ParamDef((cfg.d_model,), ("embed",), "zeros"),
        "layers": stack_defs(_block_defs(cfg), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                  ("embed_table", "vocab"))
    return out


class _Tree(nn.Module):
    """A nested dict of tensors as registered, frozen parameters, so that
    ``state_dict`` names follow the JAX tree ("layers.attn.wq")."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _Tree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        out = {n: m.tree() for n, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


class TransformerLM(nn.Module):
    """The dense LM with `params`, a tree of `defs(cfg)`'s shapes (from
    `common.init_params` or `convert.params_from_reference`)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        want = tree_map(lambda d: tuple(d.shape), defs(cfg))
        got = tree_map(lambda t: tuple(t.shape), params)
        if want != got:
            raise ValueError(f"params do not match {cfg.name}'s table: "
                             f"expected {want}, got {got}")
        self.cfg = cfg
        self.params = _Tree(params)

    @property
    def device(self) -> torch.device:
        return self.params.embedding.device

    @property
    def dtype(self) -> torch.dtype:
        return self.params.embedding.dtype

    def _layers(self, p):
        """(kind, parameters of layer i) for every layer, as views."""
        pattern = self.cfg.layer_pattern
        for i in range(self.cfg.num_layers):
            yield pattern[i % len(pattern)], tree_map(lambda a: a[i],
                                                      p["layers"])

    # -- forward ---------------------------------------------------------
    def _embed(self, p, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_lookup(p["embedding"], tokens)
        if self.cfg.emb_scale_by_sqrt_dim:  # the scale rounded to x's dtype
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _unembed(self, p, x: torch.Tensor) -> torch.Tensor:
        w = p["embedding"].T if self.cfg.tie_embeddings else p["lm_head"]
        logits = (x @ w.to(x.dtype)).float()
        cap = self.cfg.final_softcap
        if cap is not None:  # in place: [B, S, V] float32 is large
            logits.div_(cap).tanh_().mul_(cap)
        return logits

    def _block(self, p, x, kind: str, positions, cache=None, pos=None):
        cfg = self.cfg
        local = kind == "local"
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cache is None:
            a = attn.attn_apply(p["attn"], h, cfg, positions, local=local)
        else:
            a, cache = attn.attn_decode(p["attn"], h, cfg, cache, pos,
                                        local=local)
        if "ln1_post" in p:
            a = rms_norm(a, p["ln1_post"], cfg.norm_eps)
        x = x + a
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        f = ffn.mlp_apply(p["ffn"], h, cfg)
        if "ln2_post" in p:
            f = rms_norm(f, p["ln2_post"], cfg.norm_eps)
        return x + f

    def _positions(self, tokens, positions):
        if positions is not None:
            return positions
        b, s = tokens.shape
        if self.cfg.mrope_sections is not None:
            return mrope_positions(b, s, device=tokens.device)
        return default_positions(b, s, device=tokens.device)

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] -> float32 logits [B, S, V] (the fused prefill)."""
        p = self.params.tree()
        positions = self._positions(tokens, positions)
        x = self._embed(p, tokens)
        for kind, pi in self._layers(p):
            x = self._block(pi, x, kind, positions)
        x = rms_norm(x, p["final_norm"], self.cfg.norm_eps)
        return self._unembed(p, x)

    # -- decode ----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The reference's cache tree: ``p{i}`` for pattern position i, each
        leaf stacked over the ``num_layers / len(layer_pattern)`` groups."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        pattern = cfg.layer_pattern
        if cfg.num_layers % len(pattern):
            raise ValueError(f"{cfg.num_layers} layers do not divide into "
                             f"groups of {pattern}")
        groups = cfg.num_layers // len(pattern)

        def one(local):
            c = attn.init_cache(cfg, batch, max_seq, local, dtype, self.device)
            return tree_map(lambda a: a.expand((groups,) + a.shape).clone(),
                            c)

        return {f"p{i}": one(kind == "local")
                for i, kind in enumerate(pattern)}

    @torch.inference_mode()
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor,
                    pos: int):
        """tokens [B, 1], pos an int -> (float32 logits [B, 1, V], cache);
        the cache is updated in place and returned."""
        p = self.params.tree()
        gsize = len(self.cfg.layer_pattern)
        x = self._embed(p, tokens)
        for i, (kind, pi) in enumerate(self._layers(p)):
            c = tree_map(lambda a: a[i // gsize], cache[f"p{i % gsize}"])
            x = self._block(pi, x, kind, None, cache=c, pos=pos)
        x = rms_norm(x, p["final_norm"], self.cfg.norm_eps)
        return self._unembed(p, x), cache
