"""Feed-forward blocks: dense (SwiGLU / GeGLU / squared-ReLU / GELU) and MoE.

The JAX package's ``models/mlp.py``.  ``jax.nn.gelu`` is the tanh
approximation by default, so the GELUs here pass ``approximate="tanh"``
(PyTorch's default is erf).

MoE (qwen2-moe, deepseek-moe): shared experts (an always-on dense FFN of
width ``shared_d_ff``, with no gate) + routed experts with top-k gating and
a per-group capacity, dropped slots included, as the reference computes
them.  qwen2-moe's 60 experts are padded to 64, the pad experts' router
logits forced to ``NEG_INF``.

Expert parallelism (``moe_apply(..., mesh=...)`` on a mesh with a
``model`` axis), as the reference's ``shard_map``: tokens stay sharded
over the dp axes and replicated over ``model``, each ``model`` rank runs
its ``e_local = experts_padded / model`` experts from ``e_start = rank *
e_local`` on its local tokens (the capacity from the local token count),
and the partial outputs are summed over ``model`` (an all-reduce of the
``model`` sub-group, DTensor's ``Partial`` -> ``Replicate``).  No
all-to-all: activations are replicated across the TP axis between blocks.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..obs.profiler import named_scope
from ..parallel.sharding import (P, batch_axes, constrain, is_dtensor,
                                 mesh_axis_sizes, placements, replicate_like)
from .common import ParamDef
from .config import ModelConfig

__all__ = ["mlp_defs", "mlp_apply", "moe_defs", "moe_route", "moe_dispatch",
           "moe_apply", "MoeRoute", "NEG_INF"]

NEG_INF = -1e30


def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    defs = {"wu": ParamDef((d, f), ("embed", "ff")),
            "wd": ParamDef((f, d), ("ff", "embed"))}
    if cfg.mlp in ("swiglu", "geglu"):
        defs["wg"] = ParamDef((d, f), ("embed", "ff"))
    return defs


def _ff_weight(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`w` in `x`'s dtype and, for a DTensor `x`, laid out as GSPMD lays
    out an FFN weight for the product: replicated over the mesh dims that
    `x`'s batch is sharded on (the weight shard is gathered, not the
    [B, S, d] activation, which DTensor's matmul strategy would gather),
    every other placement kept (the ``ff`` dim stays sharded over
    "model").  The redistribute's backward lays the gradient out as the
    parameter (a reduce-scatter over the batch's dims).  On a plain
    tensor, or a mesh of one, the same bits as ``w.to(x.dtype)``."""
    w = replicate_like(w, x).to(x.dtype)
    if not is_dtensor(x):
        return w
    from torch.distributed.tensor import Replicate, Shard

    places = [Replicate() if isinstance(xp, Shard) and xp.dim == 0 else wp
              for xp, wp in zip(x.placements, w.placements)]
    return w.redistribute(w.device_mesh, places)


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    def w(name):
        return _ff_weight(p[name], x)

    if cfg.mlp == "swiglu":
        h = F.silu(x @ w("wg")) * (x @ w("wu"))
    elif cfg.mlp == "geglu":  # gemma / recurrentgemma gated GeLU
        h = F.gelu(x @ w("wg"), approximate="tanh") * (x @ w("wu"))
    elif cfg.mlp == "relu2":  # nemotron squared ReLU
        h = torch.square(F.relu(x @ w("wu")))
    elif cfg.mlp == "gelu":
        h = F.gelu(x @ w("wu"), approximate="tanh")
    else:
        raise ValueError(cfg.mlp)
    return h @ _ff_weight(p["wd"], h)


# ----------------------------------------------------------------------------
# MoE FFN
# ----------------------------------------------------------------------------

def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.experts_padded
    defs = {
        "router": ParamDef((d, e), ("embed", None), scale=0.02, init="normal"),
        "wg": ParamDef((e, d, f), ("experts", "embed", "ff"), fan_dims=(1,)),
        "wu": ParamDef((e, d, f), ("experts", "embed", "ff"), fan_dims=(1,)),
        "wd": ParamDef((e, f, d), ("experts", "ff", "embed"), fan_dims=(1,)),
    }
    if cfg.shared_d_ff:
        defs["shared"] = mlp_defs(cfg, cfg.shared_d_ff)
    return defs


_MOE_GROUP = 2048  # tokens per dispatch group; bounds the capacity buffers


def _group_size(t: int) -> int:
    """The reference's dispatch group: the largest of 2048 .. 128 that
    divides `t` (and is at most `t`), else all of `t`."""
    for cand in (2048, 1024, 512, 256, 128):
        if cand <= _MOE_GROUP and t % cand == 0 and t >= cand:
            return cand
    return t


class MoeRoute(NamedTuple):
    """Where each (token, k) slot goes: `idx`, `gate`, `pos`, `within` are
    [G, g, K] (expert, renormalised gate, position in the expert's buffer,
    kept); `g` tokens a group, `cap` slots an expert and group."""
    g: int
    cap: int
    idx: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    within: torch.Tensor


def moe_route(router: torch.Tensor, x2d: torch.Tensor, cfg: ModelConfig,
              capacity: int) -> MoeRoute:
    """The reference's router on x2d [T, d] (``_moe_local``'s first half):
    float32 logits (pad experts at NEG_INF), softmax, top-k, the gates
    renormalised, each slot's position = the number of earlier slots of its
    group, in (token, k) order, that chose the same expert; slots at or past
    the group's capacity `cap` are dropped (``within`` False)."""
    t, _ = x2d.shape
    k, e_total = cfg.top_k, cfg.experts_padded
    g = _group_size(t)
    ngroups = t // g
    # Python integer arithmetic, as the reference's
    cap = max(1, int(capacity * g / t)) if capacity < t * k else g * k
    logits = (x2d.float() @ router.float()).view(ngroups, g, e_total)
    if cfg.num_experts < e_total:  # mask padded experts
        logits[..., cfg.num_experts:] = NEG_INF
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)  # [G, g, K], largest first
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # exclusive running count of each expert over the group's slots, laid
    # out [G, E, g*K] so that the scan runs along the innermost dim (along
    # an outer dim PyTorch scans each column serially: 2.4 ms a
    # deepseek-moe-16b layer at S = 4096 on an H100).  A comparison, not
    # F.one_hot, which reads idx's range back to the host
    flat = idx.view(ngroups, 1, g * k)
    onehot = flat == torch.arange(e_total, device=idx.device).view(1, -1, 1)
    earlier = torch.cumsum(onehot, dim=2) - onehot.long()
    pos = earlier.gather(1, flat).view(ngroups, g, k)
    return MoeRoute(g, cap, idx, gate, pos, pos < cap)


def moe_dispatch(x2d: torch.Tensor, r: MoeRoute, cfg: ModelConfig,
                 e_start: int = 0, e_local: Optional[int] = None):
    """(xe, row): the kept slots' token rows of x2d [T, d] gathered into an
    expert-major buffer xe [E_loc, G * cap, d] for experts e_start ..
    e_start + e_local - 1 (default: all; group-major within an expert,
    then position; an empty slot is a zero row), and row [T * K], each
    (token, k) slot's row in it (E_loc * G * cap for a slot dropped or
    routed to another shard's expert).  The reference's one-hot product
    with 0/1 entries is exact, so xe holds its dispatched rows bit for
    bit."""
    t, d = x2d.shape
    k = cfg.top_k
    e_local = cfg.experts_padded if e_local is None else e_local
    ngroups = t // r.g
    group = torch.arange(ngroups, device=x2d.device).view(ngroups, 1, 1)
    lidx = r.idx - e_start if e_start else r.idx
    row = (lidx * ngroups + group) * r.cap + r.pos
    rows = e_local * ngroups * r.cap
    keep = _kept(r, e_start, e_local, cfg.experts_padded)
    row = torch.where(keep, row, rows).view(-1)
    token = torch.arange(t, device=x2d.device).repeat_interleave(k)
    src = torch.full((rows + 1,), t, dtype=torch.long, device=x2d.device)
    src[row] = token  # kept rows are unique; only the dump row repeats
    xpad = torch.cat([x2d, x2d.new_zeros(1, d)])  # row t: the empty slot
    return xpad[src[:rows]].view(e_local, ngroups * r.cap, d), row


def _kept(r: MoeRoute, e_start: int, e_local: int,
          e_total: int) -> torch.Tensor:
    """[G, g, K]: slots within capacity whose expert is one of this
    shard's (`r.within` itself on a single shard)."""
    if e_start == 0 and e_local == e_total:
        return r.within
    return r.within & (r.idx >= e_start) & (r.idx < e_start + e_local)


def _moe_local(p, x2d: torch.Tensor, cfg: ModelConfig, e_start: int,
               e_local: int, capacity: int) -> torch.Tensor:
    """Routed-expert math on one shard: x2d [T, d], the expert weights
    those of experts e_start .. e_start + e_local - 1 (all of them on a
    single shard: 0, experts_padded).

    The reference builds one-hot dispatch and combine tensors [G, g, E, C]
    and contracts them with einsums; at deepseek-moe-16b's S = 4096 prefill
    those two contractions cost about as many FLOPs as the experts
    themselves.  Here the same function goes through index tensors: the
    kept slots' rows are gathered (`moe_dispatch`), the experts run as
    batched matrix products, and each token gathers its K expert outputs
    back, weighted by its gates rounded to the activation dtype (the
    reference's ``comb.astype(dt)``; a dropped slot, or one routed to
    another shard's expert, weighs 0).  The combine sums the K terms in
    top-k order, the reference's einsum in expert order.  The four steps
    are labelled for `torch.profiler` ("moe.route", "moe.dispatch",
    "moe.experts", "moe.combine")."""
    dt = x2d.dtype
    t, d = x2d.shape
    with named_scope("moe.route"):
        r = moe_route(p["router"], x2d, cfg, capacity)
    with named_scope("moe.dispatch"):
        xe, row = moe_dispatch(x2d, r, cfg, e_start, e_local)
    with named_scope("moe.experts"):
        h = F.silu(torch.bmm(xe, p["wg"].to(dt))) \
            * torch.bmm(xe, p["wu"].to(dt))
        ye = torch.bmm(h, p["wd"].to(dt)).view(-1, d)
    with named_scope("moe.combine"):
        keep = _kept(r, e_start, e_local, cfg.experts_padded)
        w = (r.gate.to(dt) * keep).view(t, 1, cfg.top_k)
        back = ye[torch.where(keep.view(-1), row, 0)].view(t, cfg.top_k, d)
        return torch.bmm(w, back).view(t, d)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, mesh=None,
              dropless: bool = False) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d].  Without a mesh (or a ``model`` axis) the
    reference's single-shard path; with one, expert parallelism (the
    module docstring) on `x`'s batch shard.  ``dropless=True`` sizes the
    capacity at T * top_k (no drops; the serving path)."""
    d = x.shape[-1]
    e_total = cfg.experts_padded

    def run(x3d, router, wg, wu, wd, e_start, e_local):
        t = x3d.shape[0] * x3d.shape[1]
        if dropless:
            capacity = t * cfg.top_k
        else:
            capacity = max(1, int(cfg.moe_capacity_factor * t * cfg.top_k
                                  / e_total))
        pp = {"router": router, "wg": wg, "wu": wu, "wd": wd}
        y = _moe_local(pp, x3d.reshape(t, d), cfg, e_start, e_local,
                       capacity)
        return y.view(x3d.shape)

    if mesh is None or "model" not in mesh_axis_sizes(mesh):
        out = run(x, p["router"], p["wg"], p["wu"], p["wd"], 0, e_total)
    else:
        from torch.distributed.tensor import Partial
        from ..parallel.compat import local_map

        e_local = e_total // mesh_axis_sizes(mesh)["model"]
        e_start = mesh.get_local_rank("model") * e_local
        xs, ws = P(batch_axes(mesh), None, None), P("model", None, None)
        names = list(mesh_axis_sizes(mesh))
        dp = set(batch_axes(mesh))
        # the local sums, Partial over `model` until the all-reduce
        part = [Partial() if n == "model" else pl for n, pl
                in zip(names, placements(xs, mesh))]
        args = [constrain(x, mesh, xs), constrain(p["router"], mesh,
                                                  P(None, None))]
        args += [constrain(p[k], mesh, ws) for k in ("wg", "wu", "wd")]
        # the gradients each rank forms: x's and the router's hold only
        # this rank's experts' share (partial over `model`), the router's
        # and the experts' only this rank's tokens' (partial over the dp
        # axes)
        grads = (part,
                 [Partial() if n == "model" or n in dp else pl
                  for n, pl in zip(names, args[1].placements)],
                 *([Partial() if n in dp else pl
                    for n, pl in zip(names, a.placements)]
                   for a in args[2:]))
        out = local_map(lambda *a: run(*a, e_start, e_local),
                        out_placements=part,
                        in_placements=tuple(a.placements for a in args),
                        in_grad_placements=grads,
                        device_mesh=mesh)(*args)
        x = args[0]
        out = out.redistribute(mesh, placements(xs, mesh))
    if cfg.shared_d_ff:  # (plain weights join a DTensor x replicated)
        shared = {k: replicate_like(w, x) for k, w in p["shared"].items()}
        out = out + mlp_apply(shared, x, cfg)
    return out
