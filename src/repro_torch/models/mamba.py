"""Mamba-1 (falcon-mamba-7b): depthwise conv + selective SSM scan.

The JAX package's ``models/mamba.py`` as an ``nn.Module``.  The parameters
keep the reference's tree -- ``embedding``, ``final_norm`` and ``layers``
with ``ln``, ``in_proj`` [d, 2, E], ``conv_w``, ``conv_b``, ``x_proj``,
``dt_proj``, ``dt_bias``, ``a_log``, ``d``, ``out_proj`` stacked over the
layers -- so `convert.params_from_reference` is a name-for-name copy.

Prefill runs the selective scan chunk by chunk, as the reference does:
the discretized [B, chunk, E, N] tensors exist one chunk at a time, in
float32, and the state is carried from chunk to chunk; where autograd
records, each chunk runs under a checkpoint, as the reference's
``jax.checkpoint(chunk_step)``, so a train step keeps no chunk's
transients for the backward.  Inside a chunk the recurrence is
`griffin.lru_scan` (a log-depth Hillis-Steele scan) in place of the
reference's ``lax.associative_scan``.  Decode is the O(1)
recurrent step on the reference's cache (``conv`` [L, B, k-1, E] in the
model dtype, ``ssm`` [L, B, E, N] float32), updated in place.  The
reference unembeds with the embedding's transpose whatever
``tie_embeddings`` says, and so does this model.  The stacked leaves are
taken apart once a call (`common.unstack`).  ``remat="full"`` recomputes
each layer in the backward; "2level" recomputes none, as the reference,
whose ``forward`` checks for "full" alone (the chunk checkpoints stay).
On a ``mesh`` the parameters are DTensors placed per `param_pspecs`, each
layer carries the reference's anchors (`sp_boundary` around the mixer,
`sp_constrain` on the residual) and the softplus runs on each rank's
shard (`softplus`); `init_cache` lays the decode cache out per
`cache_specs` and `decode_step` runs on the mesh too.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..obs.profiler import named_scope
from ..parallel.sharding import (DEFAULT_RULES, AxisRules, is_dtensor,
                                 replicate_like, spec_for)
from .common import (LanguageModel, ParamDef, embed_lookup, mesh_forward,
                     mesh_inference, records_grad, rms_norm, sp_constrain,
                     stack_defs, unstack, write_into)
from .config import ModelConfig
from .griffin import lru_scan

__all__ = ["MambaLM", "defs", "cache_specs", "selective_scan", "softplus"]

_CHUNK = 256


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``F.softplus`` (``x`` above 20, else ``log1p(exp(x))``: no overflow).
    On a DTensor under ``local_map`` on each rank's shard, forward and
    backward (a Partial input reduced first): DTensor shards softplus's
    forward by its decomposition but has no strategy for its backward,
    which then gathers the whole tensor on every rank."""
    if not is_dtensor(x):
        return F.softplus(x)
    from torch.distributed.tensor import Replicate
    from ..parallel.compat import local_map

    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return local_map(F.softplus, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def _chunk(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
           af: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """One chunk of `selective_scan`: the state h [B, E, N] and the
    chunk's x, dt [B, cs, E], b, c [B, cs, N] -> (y [B, cs, E] float32
    without the skip term, the state after the chunk)."""
    dtf = dt.float()
    da = torch.exp(dtf[..., None] * af)  # [B, cs, E, N]
    dbx = (dtf * x.float())[..., None] * b[:, :, None, :].float()
    if records_grad(dbx, da, h) or is_dtensor(dbx):
        dbx = torch.cat([torch.addcmul(dbx[:, :1], da[:, :1], h[:, None]),
                         dbx[:, 1:]], dim=1)
    else:
        dbx[:, 0].addcmul_(da[:, 0], h)
    hs = lru_scan(da, dbx)
    del da, dbx
    y = torch.einsum("bsen,bsn->bse", hs, c.float())
    return y, hs[:, -1].clone()


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, chunk: int = _CHUNK):
    """x [B,S,E], dt [B,S,E], a [E,N], b/c [B,S,N], d [E] -> (y [B,S,E] in
    x's dtype, h [B,E,N] float32).

    h_t = exp(dt A) h_{t-1} + dt * B_t x_t ;  y_t = C_t . h_t + D x_t

    The reference's chunking: ``max(1, S // chunk)`` chunks of equal
    length, and a ValueError where they do not divide S (the reference
    asserts).  The state entering a chunk is folded into the chunk's first
    element (b_0 <- a_0 h + b_0), so the scan starts from 0; the reference
    scans the chunk and adds (prod a) h afterwards, so the two agree to
    float32 rounding, not bit for bit.  Where autograd records, or on a
    mesh, the fold is out of place (the same product and sum), and where
    autograd records each chunk runs under a non-reentrant checkpoint (the
    reference's ``jax.checkpoint(chunk_step)``): the backward recomputes
    a chunk's [B, cs, E, N] float32 transients from its inputs and state
    instead of keeping every chunk's (the same bits)."""
    bsz, s, e = x.shape
    n = a.shape[1]
    nchunks = max(1, s // chunk)
    if s % nchunks != 0:
        raise ValueError(f"selective_scan: S = {s} does not split into "
                         f"{nchunks} equal chunks (chunk {chunk})")
    cs = s // nchunks
    h = replicate_like(torch.zeros((bsz, e, n), dtype=torch.float32,
                                   device=x.device), x) if h0 is None else h0
    af = a.float()
    ys = []
    for i in range(nchunks):
        part = slice(i * cs, (i + 1) * cs)
        args = (h, x[:, part], dt[:, part], af, b[:, part], c[:, part])
        if records_grad(*args):
            y, h = checkpoint(_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            y, h = _chunk(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1) + x.float() * d.float()
    return y.to(x.dtype), h


def _block_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, e, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    return {
        "ln": ParamDef((d,), ("embed",), "zeros"),
        "in_proj": ParamDef((d, 2, e), ("embed", None, "inner")),
        "conv_w": ParamDef((cfg.ssm_conv, e), (None, "inner"), scale=0.5),
        "conv_b": ParamDef((e,), ("inner",), "zeros"),
        "x_proj": ParamDef((e, r + 2 * n), ("inner", None)),
        "dt_proj": ParamDef((r, e), (None, "inner")),
        "dt_bias": ParamDef((e,), ("inner",), "normal", scale=0.1),
        "a_log": ParamDef((e, n), ("inner", "state"), "normal", scale=0.1),
        "d": ParamDef((e,), ("inner",), "ones"),
        "out_proj": ParamDef((e, d), ("inner", "embed")),
    }


def defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter table of `cfg` (the reference's ``MambaLM.defs``),
    allocating nothing."""
    return {
        "embedding": ParamDef((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed_table"), "fan_in", fan_dims=(1,)),
        "final_norm": ParamDef((cfg.d_model,), ("embed",), "zeros"),
        "layers": stack_defs(_block_defs(cfg), cfg.num_layers),
    }


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                rules: Optional[AxisRules] = None) -> Dict[str, Any]:
    """Specs of `MambaLM.init_cache`'s tree (the reference's
    ``cache_pspecs``), allocating nothing."""
    rules = rules or DEFAULT_RULES
    L = cfg.num_layers
    return {
        "conv": spec_for((L, batch, cfg.ssm_conv - 1, cfg.d_inner),
                         ("layers", "batch", None, "inner"), mesh, rules),
        "ssm": spec_for((L, batch, cfg.d_inner, cfg.ssm_state),
                        ("layers", "batch", "inner", "state"), mesh, rules),
    }


def _in_proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [B, S, d] times in_proj [d, 2, E] -> [B, S, 2, E].  On a mesh
    under ``local_map`` as GSPMD partitions it: h batch-sharded where it
    is, w's E sharded where it is (a mesh dim that shards both keeps h's
    batch), each rank's product [B_loc, S, 2, E_loc]; h's gradient is
    partial over w's mesh dims, w's over h's.  DTensor's own product
    flattens (2, E) with E sharded, which torch 2.11 refuses."""
    b, s, d = h.shape
    e = w.shape[2]
    if not is_dtensor(h):
        return (h @ w.reshape(d, 2 * e)).view(b, s, 2, e)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from ..parallel.compat import local_map

    w = replicate_like(w, h)
    hp, wp, out, gh, gw = [], [], [], [], []
    for hpl, wpl in zip(h.placements, w.placements):
        # (h, w, the product, h's gradient, w's gradient) on this mesh dim
        if isinstance(hpl, Shard) and hpl.dim == 0:
            row = (hpl, Replicate(), hpl, hpl, Partial())
        elif isinstance(wpl, Shard) and wpl.dim == 2:
            row = (Replicate(), wpl, Shard(3), Partial(), wpl)
        else:
            row = (Replicate(),) * 5
        for lst, pl in zip((hp, wp, out, gh, gw), row):
            lst.append(pl)

    def local(x, v):
        el = v.shape[2]
        return (x @ v.reshape(d, 2 * el)).view(x.shape[0], s, 2, el)

    return local_map(local, out_placements=out, in_placements=(hp, wp),
                     in_grad_placements=(gh, gw), device_mesh=h.device_mesh,
                     redistribute_inputs=True)(h, w)


class MambaLM(LanguageModel):
    """The SSM LM with `params`, a tree of `defs(cfg)`'s shapes (from
    `common.init_params` or `convert.params_from_reference`)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 remat: str = "full", *, mesh=None, sp: bool = False,
                 rules: Optional[AxisRules] = None):
        super().__init__(cfg, params, defs(cfg), remat, mesh=mesh, sp=sp,
                         rules=rules)

    def cache_pspecs(self, mesh, batch: int, max_seq: int,
                     rules: Optional[AxisRules] = None) -> Dict[str, Any]:
        return cache_specs(self.cfg, mesh, batch, max_seq, rules)

    # -- mixer -----------------------------------------------------------
    def _mixer(self, p, h: torch.Tensor, cache=None) -> torch.Tensor:
        """The reference's ``_mixer``: h [B, S, d] -> [B, S, d].  With
        `cache` (S == 1) the layer's conv and ssm state are read and the
        new ones written into it."""
        cfg = self.cfg
        e, n, r, k = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
        dt_ = h.dtype
        bsz, s, dm = h.shape
        xz = _in_proj(h, p["in_proj"].to(dt_))
        x, z = xz[:, :, 0], xz[:, :, 1]  # [B, S, E]
        if cache is None:
            xp = F.pad(x, (0, 0, k - 1, 0))
        else:
            xp = torch.cat([cache["conv"].to(dt_), x], dim=1)
        # depthwise causal conv1d, the reference's sum of k shifted products
        xc = sum(xp[:, i:i + s] * p["conv_w"][i].to(dt_) for i in range(k))
        xc = F.silu(xc + p["conv_b"].to(dt_))
        proj = xc @ p["x_proj"].to(dt_)  # [B, S, r + 2n]
        dt_raw, bmat, cmat = torch.split(proj, [r, n, n], dim=-1)
        dt = softplus(dt_raw @ p["dt_proj"].to(dt_) + p["dt_bias"].to(dt_))
        a = -torch.exp(p["a_log"].float())
        if cache is None:
            with named_scope("mamba.scan"):
                y, _ = selective_scan(xc, dt, a, bmat, cmat, p["d"].float())
        else:  # one step; the new state written into the cache
            dtf = dt[:, 0].float()  # [B, E]
            da = torch.exp(dtf[..., None] * a)
            dbx = (dtf * xc[:, 0].float())[..., None] \
                * bmat[:, 0, None, :].float()
            h1 = da * cache["ssm"] + dbx
            y = torch.einsum("ben,bn->be", h1, cmat[:, 0].float())
            y = (y + xc[:, 0].float() * p["d"].float())[:, None].to(dt_)
            write_into(cache["conv"], xp[:, -(k - 1):])
            write_into(cache["ssm"], h1)
        return (y.to(dt_) * F.silu(z)) @ p["out_proj"].to(dt_)

    def _layers(self, p, cache=None):
        """(parameters, cache) of every layer: the parameters taken apart
        once (`unstack`), the cache as views (decode writes into them)."""
        for i, lp in enumerate(unstack(p["layers"])):
            yield lp, None if cache is None else {key: t[i] for key, t
                                                  in cache.items()}

    def _logits(self, p, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, p["final_norm"], self.cfg.norm_eps)
        return self._unembed(p, x, tied=True)

    def _block(self, lp, x: torch.Tensor) -> torch.Tensor:
        h = self._boundary(rms_norm(x, lp["ln"], self.cfg.norm_eps))
        x = x + self._boundary(self._mixer(lp, h))
        return sp_constrain(x, self.mesh, self.sp, self.rules)

    # -- forward ---------------------------------------------------------
    @mesh_forward
    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] -> float32 logits [B, S, V] (the fused prefill, or
        the train step's forward: it runs under the caller's grad mode;
        `positions` is accepted and unused, as in the reference)."""
        p = self.params.tree()
        x = embed_lookup(p["embedding"], tokens, self.mesh, self.rules)
        for lp, _ in self._layers(p):
            x = self._layer_call(self._block, lp, x)
        return self._logits(p, x)

    # -- decode ----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The reference's cache: ``conv`` [L, B, k-1, E] in `dtype` and
        ``ssm`` [L, B, E, N] float32, both zero (on a mesh laid out per
        `cache_pspecs`); `max_seq` is unused (the state is O(1))."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        L, dev = cfg.num_layers, self._cache_device()
        return self._place_cache({
            "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=dtype, device=dev),
            "ssm": torch.zeros((L, batch, cfg.d_inner, cfg.ssm_state),
                               dtype=torch.float32, device=dev),
        }, batch, max_seq)

    @mesh_inference
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor,
                    pos: int):
        """tokens [B, 1] -> (float32 logits [B, 1, V], cache); the cache
        is updated in place and returned (`pos` is unused: the state
        carries the position)."""
        p = self.params.tree()
        x = embed_lookup(p["embedding"], tokens, self.mesh, self.rules)
        for lp, lc in self._layers(p, cache):
            x = x + self._mixer(lp, rms_norm(x, lp["ln"], self.cfg.norm_eps),
                                lc)
        return self._logits(p, x), cache
