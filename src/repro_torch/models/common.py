"""Parameter-definition tables + shared layer math.

Each module declares its parameters once as a (possibly nested) dict of
`ParamDef(shape, logical_axes, init)`, as in the JAX package's
``models/common.py``; `init_params` builds the tensors from that table.
Layer stacks are `stack_defs`-wrapped: every leaf gets a leading
``layers`` dimension, the JAX package's scan-over-layers layout, which the
port keeps so that the two trees match name for name and shape for shape.
The logical axes are kept for the sharding slice (`param_specs` waits for
``parallel/sharding``, ROADMAP Queue 1 item 10).

The models' ``forward`` runs under the caller's grad mode, so a train
step differentiates it functionally (``torch.func.functional_call`` with
leaves in place of the frozen `ParamTree` parameters; `train.train_step`).
Where autograd records, ``remat="full"`` (the JAX package's default)
recomputes each layer in the backward (`LanguageModel._layer_call`), and
the few in-place steps of the inference path take an out-of-place form
(here `_unembed`'s softcap).  Serve runs under ``inference_mode`` and is
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device

__all__ = ["ParamDef", "init_params", "stack_defs", "rms_norm", "dtype_of",
           "count_params", "embed_lookup", "tree_map", "tree_leaves",
           "tree_items", "tree_from_items", "records_grad", "ParamTree",
           "LanguageModel", "REMAT"]

REMAT = ("full", "none")

# fill a large tensor this many elements at a time, so the float32 draw
# beside a bfloat16 [layers, d, d_ff] stack stays small
_INIT_CHUNK = 1 << 26


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "fan_in"  # fan_in | normal | zeros | ones
    fan_dims: Tuple[int, ...] = (0,)  # dims whose product is fan-in
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of nested dicts (a parameter or cache tree),
    with the matching leaves of the trees `rest` as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any):
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def tree_items(tree: Any, prefix: Tuple[str, ...] = ()):
    """[(path, leaf)] of nested dicts in the JAX tree order (``jax.tree.
    flatten`` sorts dict keys at every level); a path is a tuple of keys."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(tree_items(tree[key], prefix + (key,)))
    return out


def tree_from_items(items) -> Dict[str, Any]:
    """The nested dicts of (path, leaf) pairs (`tree_items`' inverse)."""
    out: Dict[str, Any] = {}
    for path, leaf in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def records_grad(*tensors) -> bool:
    """Whether autograd records an op on `tensors`: grad mode is on and one
    of them requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _init_one(d: ParamDef, generator: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "normal":
        std = d.scale
    elif d.init == "fan_in":  # variance scaling
        fan = float(np.prod([d.shape[i] for i in d.fan_dims])) or 1.0
        std = d.scale / np.sqrt(fan)
    else:
        raise ValueError(f"unknown init {d.init!r}")
    out = torch.empty(d.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), _INIT_CHUNK):
        part = flat[start:start + _INIT_CHUNK]
        draw = torch.empty(part.shape, dtype=torch.float32, device=device)
        # a normal truncated at +-2 standard deviations, then scaled
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        part.copy_(draw * std)
    return out


def init_params(defs: Any, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: Union[str, torch.device, None] = "cuda") -> Any:
    """A tree of tensors of `defs`' shapes on `device`: zeros or ones as
    declared, else a normal truncated at +-2 std times ``scale`` ("normal")
    or ``scale / sqrt(fan)`` ("fan_in"), drawn in
    float32 from `generator` (which must live on `device`) and cast to
    `dtype`."""
    dev = resolve_device(device)
    return tree_map(lambda d: _init_one(d, generator, dtype, dev), defs)


def stack_defs(defs: Any, num_layers: int) -> Any:
    """Prepend a `layers` dimension to every ParamDef (scan layout)."""
    return tree_map(
        lambda d: ParamDef((num_layers,) + d.shape, ("layers",) + d.logical,
                           d.init, tuple(i + 1 for i in d.fan_dims), d.scale),
        defs)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with (1 + scale) parametrization (gemma/qwen style).

    The JAX package's rounding steps: the square in the input dtype, its
    mean in float32, the normalizer and the weight cast back to x's dtype
    before the two multiplies.  (The reference's ``zero_centered=False``
    has no caller and is not carried over.)"""
    var = x.square().float().mean(dim=-1, keepdim=True)
    nrm = torch.rsqrt(var + eps).to(x.dtype)
    return x * nrm * (1.0 + scale.float()).to(x.dtype)


def count_params(tree: Any) -> int:
    """Number of parameters in a tree of tensors or of `ParamDef`s (the
    latter allocates nothing)."""
    return int(sum(np.prod(p.shape, dtype=np.int64)
                   for p in tree_leaves(tree)))


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows `tokens` of `table` (the JAX package's gather path, no mesh).
    ``F.embedding``: the same gather as ``table[tokens]``, with a backward
    that sums repeated rows in a fixed order (PyTorch's determinism notes
    list indexing's backward on the CPU as nondeterministic), so a train
    step repeats bit for bit."""
    return F.embedding(tokens, table)


class ParamTree(nn.Module):
    """A nested dict of tensors as registered, frozen parameters, so that
    ``state_dict`` names follow the JAX tree ("layers.attn.wq")."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        out = {n: m.tree() for n, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


class LanguageModel(nn.Module):
    """What the port's LMs share: `params` checked against their table
    `table` (shapes, name for name) and held as frozen parameters, the
    embedding and unembedding the JAX models compute alike, and `remat`
    ("full": each layer recomputed in the backward; "none")."""

    def __init__(self, cfg, params: Dict[str, Any], table: Dict[str, Any],
                 remat: str = "full"):
        super().__init__()
        want = tree_map(lambda d: tuple(d.shape), table)
        got = tree_map(lambda t: tuple(t.shape), params)
        if want != got:
            raise ValueError(f"params do not match {cfg.name}'s table: "
                             f"expected {want}, got {got}")
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        self.cfg = cfg
        self.remat = remat
        self.params = ParamTree(params)

    def _layer_call(self, fn: Callable, p, x: torch.Tensor, *args):
        """``fn(p, x, *args)``, one layer.  Where autograd records and
        `remat` is "full", under ``torch.utils.checkpoint`` (non-reentrant):
        the backward runs the layer again instead of keeping its
        activations, as the reference's ``jax.checkpoint`` does; no layer
        draws random numbers, so no RNG state is kept."""
        if self.remat == "full" and records_grad(x, *tree_leaves(p)):
            return checkpoint(fn, p, x, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(p, x, *args)

    @property
    def device(self) -> torch.device:
        return self.params.embedding.device

    @property
    def dtype(self) -> torch.dtype:
        return self.params.embedding.dtype

    def _embed(self, p, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_lookup(p["embedding"], tokens)
        if self.cfg.emb_scale_by_sqrt_dim:  # the scale rounded to x's dtype
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _unembed(self, p, x: torch.Tensor,
                 tied: Optional[bool] = None) -> torch.Tensor:
        """float32 logits of x.  The embedding's transpose is the output
        table where `tied` (default: ``cfg.tie_embeddings``), else
        ``lm_head``: the Mamba reference unembeds with the embedding
        whatever its config says and has no ``lm_head``."""
        tied = self.cfg.tie_embeddings if tied is None else tied
        w = p["embedding"].T if tied else p["lm_head"]
        logits = (x @ w.to(x.dtype)).float()
        cap = self.cfg.final_softcap
        if cap is not None and records_grad(logits):
            logits = torch.tanh(logits / cap) * cap  # the same bits
        elif cap is not None:  # in place: [B, S, V] float32 is large
            logits.div_(cap).tanh_().mul_(cap)
        return logits
