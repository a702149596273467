"""AdamW and Adafactor with dtype-configurable state, and the cosine
schedule (no optimizer library).

The JAX package's ``train/optimizer.py``.  The state is a plain tree of
tensors ({"mu", "nu", "count"} or {"vr", "vc", "count"}) beside the
parameters', so the checkpointer writes it by path.  ``update`` is
functional: it returns new parameters and a new state and modifies
neither input (a donated, in-place update is later work).  Everything it
computes stays on the parameters' device, metrics included: a step reads
nothing back on the host.  The global gradient norm sums the leaves in
the reference's order (``jax.tree.flatten`` sorts dict keys).

On a mesh the parameters, gradients and moments are DTensors: AdamW's
moments are made like their parameters (``zeros_like``) and shard as
they do (``state_pspecs``); Adafactor's factored moments have specs of
their own (``state_pspecs``) and are placed by
``train.elastic.reshard_state``; its update keeps every tensor the size
of a parameter laid out as the parameter (`_factored_update`).
`global_norm` sums each DTensor leaf's squares over its shards first.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ..models.common import tree_items, tree_map
from ..parallel.sharding import P, is_dtensor

__all__ = ["AdamW", "Adafactor", "cosine_schedule", "global_norm"]

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """step (an int tensor or a number) -> float32 learning rate: linear
    warm-up over `warmup` steps, then a cosine down to `min_frac` of
    `base_lr` at `total`."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def _sum_squares(g: torch.Tensor) -> torch.Tensor:
    """A leaf's sum of squares; a DTensor's reduced across its shards
    (a plain tensor, the same on every rank)."""
    sq = torch.sum(g * g)
    return sq.full_tensor() if is_dtensor(sq) else sq


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, float32, the leaves
    summed in the JAX tree order (a DTensor leaf's own sum runs over its
    shards in another order: the same bits only on a mesh of one)."""
    return torch.sqrt(sum(_sum_squares(g) for _, g in tree_items(grads)))


def _learning_rate(lr, count: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(count - 1)
    return torch.tensor(lr, dtype=torch.float32, device=count.device)


def _factored_update(g: torch.Tensor, r: torch.Tensor, vc: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Adafactor's ``g * rsqrt(max(r[..., None] * vc[..., None, :], eps))``
    for g [..., m, n], r [..., m], vc [..., n].  On a mesh under
    ``local_map``: g as it is laid out, r and vc laid out as the factored
    moments (g's layout without its last or its second last dim), so each
    rank's rows of r and columns of vc are those of its block of g and
    the [..., m, n] products stay in g's layout; left to DTensor, the
    broadcast product was formed whole on every rank."""
    def local(g, r, vc):
        return g * torch.rsqrt(torch.clamp(r[..., None] * vc[..., None, :],
                                           min=eps))

    if not is_dtensor(g):
        return local(g, r, vc)
    from ..parallel.compat import local_map

    return local_map(local, out_placements=list(g.placements),
                     in_placements=(g.placements, r.placements,
                                    vc.placements),
                     device_mesh=g.device_mesh,
                     redistribute_inputs=True)(g, r, vc)


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`t` laid out as `ref` (a DTensor), or `t` itself."""
    if not is_dtensor(ref):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def _unzip(out: Any, n: int):
    """n trees from a tree of n-tuples."""
    return tuple(tree_map(lambda t, i=i: t[i], out) for i in range(n))


@dataclass(frozen=True)
class AdamW:
    learning_rate: Any = 3e-4  # float or schedule(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"  # moments dtype: float32 | bfloat16

    def _sd(self) -> torch.dtype:
        return _STATE_DTYPES[self.state_dtype]

    def init(self, params) -> Dict[str, Any]:
        sd = self._sd()
        zeros = lambda p: torch.zeros_like(  # noqa: E731
            p, dtype=sd, memory_format=torch.contiguous_format)
        device = tree_items(params)[0][1].device
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(self, grads, state, params):
        """Returns (new_params, new_state, metrics)."""
        count = state["count"] + 1
        gf = tree_map(lambda g: g.float(), grads)
        gnorm = global_norm(gf)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            gf = tree_map(lambda g: g * scale, gf)
        lr = _learning_rate(self.learning_rate, count)
        b1, b2 = self.b1, self.b2
        c = count.float()
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        sd = self._sd()

        def upd(p, g, mu, nu):
            mu32 = mu.float() * b1 + g * (1 - b1)
            nu32 = nu.float() * b2 + g * g * (1 - b2)
            step = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + self.eps)
            step = step + self.weight_decay * p.float()
            newp = p.float() - lr * step
            return newp.to(p.dtype), mu32.to(sd), nu32.to(sd)

        new_p, new_mu, new_nu = _unzip(
            tree_map(upd, params, gf, state["mu"], state["nu"]), 3)
        new_state = {"mu": new_mu, "nu": new_nu, "count": count}
        return new_p, new_state, {"grad_norm": gnorm, "lr": lr}

    def state_pspecs(self, param_pspecs, params_template=None):
        """Moments shard exactly like their parameters."""
        return {"mu": param_pspecs, "nu": param_pspecs, "count": P()}


@dataclass(frozen=True)
class Adafactor:
    """Factored second-moment optimizer (Shazeer & Stern 2018) -- the
    memory-frugal choice for the >=100B configs (PaLM-style: no first
    moment, row/col-factored v, update clipped by RMS).  State is ~2/n of
    Adam's."""

    learning_rate: Any = 1e-2
    decay: float = 0.8  # beta2 annealed as 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_size_to_factor: int = 128

    def _factored(self, shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= self.min_dim_size_to_factor
                and shape[-2] >= self.min_dim_size_to_factor)

    def init(self, params) -> Dict[str, Any]:
        def zeros(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vr(p):
            return zeros(p.shape[:-1] if self._factored(p.shape) else (1,), p)

        def vc(p):
            return zeros(p.shape[:-2] + p.shape[-1:]
                         if self._factored(p.shape) else p.shape, p)

        device = tree_items(params)[0][1].device
        return {"vr": tree_map(vr, params), "vc": tree_map(vc, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(self, grads, state, params):
        count = state["count"] + 1
        c = count.float()
        beta2 = 1.0 - c ** (-self.decay)
        lr = _learning_rate(self.learning_rate, count)
        gf = tree_map(lambda g: g.float(), grads)
        gnorm = global_norm(gf)
        eps = self.eps

        def upd(p, g, vr, vc):
            g2 = g * g + eps
            if self._factored(p.shape):
                # the row and column means reduced over their shards, each
                # moment kept in its own layout
                new_vr = _like(beta2 * vr + (1 - beta2) * g2.mean(dim=-1), vr)
                new_vc = _like(beta2 * vc + (1 - beta2) * g2.mean(dim=-2), vc)
                denom = new_vr.mean(dim=-1, keepdim=True)
                r = _like(new_vr / torch.clamp(denom, min=eps), vr)
                u = _factored_update(g, r, new_vc, eps)
            else:
                new_vc = beta2 * vc + (1 - beta2) * g2
                new_vr = vr
                u = g * torch.rsqrt(torch.clamp(new_vc, min=eps))
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            pf = p.float()
            newp = pf - lr * u - lr * self.weight_decay * pf
            return newp.to(p.dtype), new_vr, new_vc

        new_p, new_vr, new_vc = _unzip(
            tree_map(upd, params, gf, state["vr"], state["vc"]), 3)
        return (new_p, {"vr": new_vr, "vc": new_vc, "count": count},
                {"grad_norm": gnorm, "lr": lr})

    def state_pspecs(self, param_pspecs, params_template=None):
        """Specs of the state: a factored leaf's ``vr`` drops its
        parameter's last dim and ``vc`` its second last; an unfactored
        leaf's ``vr`` (shape (1,)) is replicated and its ``vc`` shards like
        the parameter.  Needs `params_template` (tensors, meta tensors or
        anything with a ``shape``) to know which leaves are factored."""
        if params_template is None:
            raise ValueError("Adafactor specs need the parameters' shapes "
                             "(params_template)")

        def vr_spec(spec, p):
            return P(*spec[:-1]) if self._factored(p.shape) else P()

        def vc_spec(spec, p):
            if self._factored(p.shape):
                return P(*(tuple(spec[:-2]) + tuple(spec[-1:])))
            return spec

        return {"vr": tree_map(vr_spec, param_pspecs, params_template),
                "vc": tree_map(vc_spec, param_pspecs, params_template),
                "count": P()}
