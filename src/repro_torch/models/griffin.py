"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local MQA
attention in a 2:1 pattern (rec, rec, attn).

RG-LRU:  r_t = sigmoid(blockdiag(W_a) x_t),  i_t = sigmoid(blockdiag(W_x) x_t)
         a_t = exp(-c softplus(L) * r_t),    c = 8
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

The JAX package's ``models/griffin.py`` as an ``nn.Module``.  The
parameters keep the reference's tree: ``rec`` stacked over the
``2 * groups`` recurrent layers of the (rec, rec, attn) groups (layer
``(g, j)`` is row ``2 g + j``), ``att`` over the ``groups`` attention
layers, and ``tail`` over the ``num_layers - 3 * groups`` recurrent layers
after them, so `convert.params_from_reference` is a name-for-name copy.

Prefill runs the recurrence as a log-depth scan in float32 (`lru_scan`,
in place of the reference's ``lax.associative_scan``); decode carries
(conv_state, h) per recurrent layer and a ``local_window``-slot rolling
cache per attention layer, both updated in place.  Attention is always
local (windowed MQA) and goes through the flash-attention kernel in the
prefill.  The embeddings are tied and scaled by sqrt(d_model); there is no
final softcap, as in the reference.  The stacked leaves are taken apart
once a call (`common.unstack`).  ``remat="full"`` recomputes each block
in the backward; "2level" recomputes none, as the reference, whose
``forward`` checks for "full" alone.  On a ``mesh`` the parameters are
DTensors placed per `param_pspecs` and the blocks carry the reference's
anchors (`sp_boundary` around the mixers and MLPs, `sp_constrain` after
each group); `init_cache` lays the decode cache out per `cache_specs` and
`decode_step` runs on the mesh too.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..obs.profiler import named_scope
from ..parallel.sharding import DEFAULT_RULES, AxisRules, spec_for
from . import attention as attn
from . import mlp as ffn
from .common import (LanguageModel, ParamDef, mesh_forward, mesh_inference,
                     records_grad, rms_norm, sp_constrain, stack_defs,
                     tree_map, unstack, write_into)
from .config import ModelConfig
from .rope import default_positions

__all__ = ["GriffinLM", "defs", "cache_specs", "lru_scan"]

_NBLOCKS = 16
_C = 8.0
_CONV = 4  # causal depthwise conv width


def _groups(cfg: ModelConfig) -> int:
    return cfg.num_layers // 3


def _tail(cfg: ModelConfig) -> int:
    return cfg.num_layers - 3 * _groups(cfg)  # extra rec layers


def _rec_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, w = cfg.d_model, cfg.lru_width
    c = w // _NBLOCKS
    return {
        "ln": ParamDef((d,), ("embed",), "zeros"),
        "w_gate": ParamDef((d, w), ("embed", "lru")),
        "w_x": ParamDef((d, w), ("embed", "lru")),
        "conv_w": ParamDef((_CONV, w), (None, "lru"), scale=0.5),
        "conv_b": ParamDef((w,), ("lru",), "zeros"),
        "gate_a": ParamDef((_NBLOCKS, c, c), (None, "lru", None), fan_dims=(1,)),
        "gate_x": ParamDef((_NBLOCKS, c, c), (None, "lru", None), fan_dims=(1,)),
        "lambda_": ParamDef((w,), ("lru",), "normal", scale=1.0),
        "w_out": ParamDef((w, d), ("lru", "embed")),
        "mlp_ln": ParamDef((d,), ("embed",), "zeros"),
        "mlp": ffn.mlp_defs(cfg),
    }


def _attn_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln": ParamDef((cfg.d_model,), ("embed",), "zeros"),
        "attn": attn.attn_defs(cfg),
        "mlp_ln": ParamDef((cfg.d_model,), ("embed",), "zeros"),
        "mlp": ffn.mlp_defs(cfg),
    }


def defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter table of `cfg` (the reference's ``GriffinLM.defs``),
    allocating nothing."""
    out = {
        "embedding": ParamDef((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed_table"), "fan_in", fan_dims=(1,)),
        "final_norm": ParamDef((cfg.d_model,), ("embed",), "zeros"),
        "rec": stack_defs(_rec_defs(cfg), 2 * _groups(cfg)),
        "att": stack_defs(_attn_defs(cfg), _groups(cfg)),
    }
    if _tail(cfg):
        out["tail"] = stack_defs(_rec_defs(cfg), _tail(cfg))
    return out


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                rules: Optional[AxisRules] = None) -> Dict[str, Any]:
    """Specs of `GriffinLM.init_cache`'s tree (the reference's
    ``cache_pspecs``), allocating nothing."""
    rules = rules or DEFAULT_RULES
    g, w = _groups(cfg), cfg.lru_width
    length = min(cfg.local_window or max_seq, max_seq)
    rc = {"conv": spec_for((g, 2, batch, 3, w),
                           ("layers", None, "batch", None, "lru"), mesh,
                           rules),
          "h": spec_for((g, 2, batch, w), ("layers", None, "batch", "lru"),
                        mesh, rules)}
    la = attn.cache_logical_axes()
    shapes = {"k": (g, batch, cfg.num_kv_heads, length, cfg.head_dim),
              "v": (g, batch, cfg.num_kv_heads, length, cfg.head_dim),
              "slot_pos": (g, length)}
    out = {"rec": rc,
           "att": {k: spec_for(shapes[k], ("layers",) + la[k], mesh, rules)
                   for k in shapes}}
    if _tail(cfg):
        t = _tail(cfg)
        out["tail"] = {
            "conv": spec_for((t, batch, 3, w),
                             ("layers", "batch", None, "lru"), mesh, rules),
            "h": spec_for((t, batch, w), ("layers", "batch", "lru"), mesh,
                          rules)}
    return out


def _blockdiag_apply(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w [NB, c, c]; x [..., NB*c] -> [..., NB*c], in x's dtype."""
    nb, c, _ = w.shape
    xs = x.reshape(x.shape[:-1] + (nb, c))
    return torch.einsum("...nc,ncd->...nd", xs, w.to(x.dtype)).reshape(x.shape)


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1, from h_0 = 0: the reference's
    ``lax.associative_scan`` of ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 +
    b2)``, as a Hillis-Steele scan (ceil(log2 S) passes over the whole
    sequence, each combining element t with element t - 2^j).  The sums
    run in another order than the reference's odd/even recursion, so the
    two agree to float32 rounding, not bit for bit.

    Where autograd records (a train step), each pass concatenates its two
    halves instead of writing them through ``out=``, which autograd
    refuses; the same products, so the same bits."""
    s = a.shape[1]
    grad = records_grad(a, b)
    off = 1
    while off < s:
        last = 2 * off >= s  # the last pass needs no new a
        if grad:
            nb = torch.cat([b[:, :off], torch.addcmul(b[:, off:], a[:, off:],
                                                      b[:, :-off])], dim=1)
            if not last:
                a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        else:
            nb = torch.empty_like(b)
            nb[:, :off] = b[:, :off]
            torch.addcmul(b[:, off:], a[:, off:], b[:, :-off],
                          out=nb[:, off:])
            if not last:
                na = torch.empty_like(a)
                na[:, :off] = a[:, :off]
                torch.mul(a[:, off:], a[:, :-off], out=na[:, off:])
                a = na
        b = nb
        off *= 2
    return b


class GriffinLM(LanguageModel):
    """The hybrid LM with `params`, a tree of `defs(cfg)`'s shapes (from
    `common.init_params` or `convert.params_from_reference`)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 remat: str = "full", *, mesh=None, sp: bool = False,
                 rules: Optional[AxisRules] = None):
        super().__init__(cfg, params, defs(cfg), remat, mesh=mesh, sp=sp,
                         rules=rules)

    def cache_pspecs(self, mesh, batch: int, max_seq: int,
                     rules: Optional[AxisRules] = None) -> Dict[str, Any]:
        return cache_specs(self.cfg, mesh, batch, max_seq, rules)

    # -- RG-LRU mixer ----------------------------------------------------
    def _rec_mixer(self, p, h: torch.Tensor, cache=None) -> torch.Tensor:
        dt = h.dtype
        gate = F.gelu(h @ p["w_gate"].to(dt), approximate="tanh")  # [B,S,W]
        x = h @ p["w_x"].to(dt)
        k = _CONV
        if cache is None:
            xp = F.pad(x, (0, 0, k - 1, 0))
        else:
            xp = torch.cat([cache["conv"].to(dt), x], dim=1)
        s = x.shape[1]
        xc = sum(xp[:, i:i + s] * p["conv_w"][i].to(dt) for i in range(k))
        xc = xc + p["conv_b"].to(dt)

        r = torch.sigmoid(_blockdiag_apply(p["gate_a"], xc).float())
        i = torch.sigmoid(_blockdiag_apply(p["gate_x"], xc).float())
        log_a = -_C * F.softplus(p["lambda_"].float()) * r
        a = torch.exp(log_a)
        mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                      min=1e-12))
        b = mult * i * xc.float()
        if cache is None:
            with named_scope("griffin.scan"):
                y = lru_scan(a, b)
        else:  # one step; the new state written into the cache
            h1 = a[:, 0] * cache["h"] + b[:, 0]
            write_into(cache["conv"], xp[:, -(k - 1):])
            write_into(cache["h"], h1)
            y = h1[:, None]
        return (y.to(dt) * gate) @ p["w_out"].to(dt)

    def _rec_block(self, p, x: torch.Tensor, cache=None) -> torch.Tensor:
        eps = self.cfg.norm_eps
        h = self._boundary(rms_norm(x, p["ln"], eps))
        x = x + self._boundary(self._rec_mixer(p, h, cache))
        h = self._boundary(rms_norm(x, p["mlp_ln"], eps))
        return x + self._boundary(ffn.mlp_apply(p["mlp"], h, self.cfg))

    def _att_block(self, p, x: torch.Tensor, positions, cache=None,
                   pos=None) -> torch.Tensor:
        cfg = self.cfg
        h = self._boundary(rms_norm(x, p["ln"], cfg.norm_eps))
        if cache is None:
            a = attn.attn_apply(p["attn"], h, cfg, positions, local=True,
                                rules=self.rules)
        else:
            a, _ = attn.attn_decode(p["attn"], h, cfg, cache, pos, local=True,
                                    rules=self.rules)
        x = x + a
        h = rms_norm(x, p["mlp_ln"], cfg.norm_eps)
        return x + ffn.mlp_apply(p["mlp"], h, cfg)

    def _layers(self, p, cache=None):
        """("rec" or "att", parameters, cache) for every layer in order: the
        parameters taken apart once (`unstack`), the caches as views
        (decode writes into them; None without `cache`)."""
        def at(tree, *i):
            return None if tree is None else tree_map(lambda a: a[i], tree)

        c = cache or {}
        rec, att = unstack(p["rec"]), unstack(p["att"])
        for g in range(_groups(self.cfg)):
            for j in range(2):
                yield "rec", rec[2 * g + j], at(c.get("rec"), g, j)
            yield "att", att[g], at(c.get("att"), g)
        tail = unstack(p["tail"]) if _tail(self.cfg) else []
        for t, lp in enumerate(tail):
            yield "rec", lp, at(c.get("tail"), t)

    # -- forward ---------------------------------------------------------
    @mesh_forward
    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] -> float32 logits [B, S, V] (the fused prefill, or
        the train step's forward: it runs under the caller's grad mode)."""
        p = self.params.tree()
        b, s = tokens.shape
        if positions is None:
            positions = default_positions(b, s, device=tokens.device)
        x = self._embed(p, tokens)
        for kind, pi, _ in self._layers(p):
            if kind == "rec":
                x = self._layer_call(self._rec_block, pi, x)
            else:  # the end of a (rec, rec, attn) group
                x = self._layer_call(self._att_block, pi, x, positions)
                x = sp_constrain(x, self.mesh, self.sp, self.rules)
        x = rms_norm(x, p["final_norm"], self.cfg.norm_eps)
        return self._unembed(p, x)

    # -- decode ----------------------------------------------------------
    def _rec_cache(self, batch: int, dtype: torch.dtype, lead=()):
        w = self.cfg.lru_width
        dev = self._cache_device()
        return {"conv": torch.zeros(lead + (batch, _CONV - 1, w), dtype=dtype,
                                    device=dev),
                "h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                                 device=dev)}

    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The reference's cache tree: ``rec`` [groups, 2, ...], ``att``
        [groups, ...] (rolling, ``min(local_window, max_seq)`` slots) and
        ``tail`` [tail, ...]; the conv state holds the last 3 inputs in
        `dtype`, ``h`` is float32; on a mesh laid out per
        `cache_pspecs`."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        g = _groups(cfg)
        ac = attn.init_cache(cfg, batch, max_seq, True, dtype,
                             self._cache_device())
        out = {"rec": self._rec_cache(batch, dtype, (g, 2)),
               "att": tree_map(lambda a: a.expand((g,) + a.shape).clone(),
                               ac)}
        if _tail(cfg):
            out["tail"] = self._rec_cache(batch, dtype, (_tail(cfg),))
        return self._place_cache(out, batch, max_seq)

    @mesh_inference
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor,
                    pos: int):
        """tokens [B, 1], pos an int -> (float32 logits [B, 1, V], cache);
        the cache is updated in place and returned."""
        p = self.params.tree()
        x = self._embed(p, tokens)
        for kind, pi, ci in self._layers(p, cache):
            x = self._rec_block(pi, x, ci) if kind == "rec" \
                else self._att_block(pi, x, None, ci, pos)
        x = rms_norm(x, p["final_norm"], self.cfg.norm_eps)
        return self._unembed(p, x), cache
