"""Parameter-definition tables + shared layer math.

Each module declares its parameters once as a (possibly nested) dict of
`ParamDef(shape, logical_axes, init)`, as in the JAX package's
``models/common.py``; `init_params` builds the tensors and `param_specs`
the sharding specs from that one table, so the two cannot drift apart.
Layer stacks are `stack_defs`-wrapped: every leaf gets a leading
``layers`` dimension, the JAX package's scan-over-layers layout, which the
port keeps so that the two trees match name for name and shape for shape.

On a mesh (a torch ``DeviceMesh`` with named dims, `parallel.sharding`)
the parameters are DTensors placed per `param_specs`, the activations
DTensors whose layout torch's sharding propagation chooses, and the
reference's ``with_sharding_constraint`` anchors are ``redistribute``
calls (`constrain`: `sp_boundary`, `sp_constrain`, `logits_constrain`).
The embedding is then the reference's one-hot contraction (`embed_lookup`)
and plain tensors that meet activations (positions, tables, the batch)
are the global values, the same on every rank (`replicate_like`).
Without a mesh none of this runs and the bits are those of the meshless
path.

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

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel.sharding import (DEFAULT_RULES, AxisRules, P, batch_axes,
                                 constrain, mesh_axis_sizes, placements,
                                 spec_for)

__all__ = ["ParamDef", "init_params", "init_stacked", "param_specs",
           "stack_defs", "rms_norm", "dtype_of", "count_params",
           "embed_lookup", "logits_constrain", "sp_boundary", "sp_constrain",
           "tree_map", "tree_leaves", "tree_items", "tree_from_items",
           "records_grad", "ParamTree", "LanguageModel", "REMAT",
           "mesh_forward"]

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


def param_specs(defs: Any, mesh, rules: AxisRules = DEFAULT_RULES) -> Any:
    """The tree of `defs`' sharding specs on `mesh` (a `DeviceMesh` or a
    `parallel.sharding.MeshShape`)."""
    return tree_map(lambda d: spec_for(d.shape, d.logical, mesh, rules), defs)


def init_stacked(defs_one_layer: Any, num_layers: int,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = "cuda") -> Any:
    """One layer's table initialized `num_layers` (>= 1) times, layer
    after layer from `generator`, and stacked: leaves with a leading
    [layers] dim (the reference's vmap over per-layer keys)."""
    layers = [init_params(defs_one_layer, generator, dtype, device)
              for _ in range(num_layers)]
    return tree_map(lambda *ts: torch.stack(ts), *layers)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, mesh=None,
                 rules: Optional[AxisRules] = None) -> torch.Tensor:
    """Rows `tokens` of `table`.

    Without a mesh, the gather: ``F.embedding``, whose backward sums
    repeated rows in a fixed order (PyTorch's determinism notes list
    indexing's backward on the CPU as nondeterministic), so a train step
    repeats bit for bit.

    With a mesh, the reference's one-hot contraction: ``onehot(tokens) @
    table``, the one-hot laid out batch over the dp axes and vocab as the
    table's vocab dim, so the product partitions over a vocab-sharded table
    without gathering it.  Each output row has one nonzero product, so the
    forward gives the gather's bits; the table's gradient is ``onehot^T g``
    summed inside a GEMM, another order than the gather's.  This rank's
    columns of the one-hot are built from `tokens` (the global batch, a
    plain tensor the same on every rank, or a DTensor) by a comparison."""
    if mesh is None:
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor

    v = table.shape[0]
    spec = spec_for(tuple(tokens.shape) + (v,),
                    ("batch",) * tokens.dim() + ("vocab",), mesh,
                    rules or DEFAULT_RULES)
    tok = constrain(tokens, mesh, P(*spec[:-1])).to_local()
    cols = constrain(torch.arange(v, device=tok.device), mesh,
                     P(spec[-1])).to_local()
    oh = DTensor.from_local((tok[..., None] == cols).to(table.dtype), mesh,
                            placements(spec, mesh), run_check=False)
    return oh @ table


def logits_constrain(logits: torch.Tensor, mesh,
                     rules: Optional[AxisRules] = None) -> torch.Tensor:
    """Keep [.., V] logits vocab-TP-sharded (and batch-dp-sharded)."""
    if mesh is None:
        return logits
    spec = spec_for(tuple(logits.shape),
                    ("batch",) + (None,) * (logits.dim() - 2) + ("vocab",),
                    mesh, rules or DEFAULT_RULES)
    return constrain(logits, mesh, spec)


def sp_boundary(x: torch.Tensor, mesh, enable: bool,
                rules: Optional[AxisRules] = None) -> torch.Tensor:
    """Activation anchor at block boundaries: [B, S, d] batch over the dp
    axes, the rest replicated.  With sequence parallelism (`enable`) this
    is the all-gather side of the SP pair (the seq dim re-replicates
    before the TP matmuls); either way a no-op where the layout already
    matches, and without a mesh, a ``"model"`` axis or a 3-dim `x`, as the
    reference's."""
    if mesh is None or "model" not in mesh_axis_sizes(mesh) or x.dim() != 3:
        return x
    return constrain(x, mesh, spec_for(tuple(x.shape), ("batch", None, None),
                                       mesh, rules or DEFAULT_RULES))


def sp_constrain(x: torch.Tensor, mesh, enable: bool,
                 rules: Optional[AxisRules] = None) -> torch.Tensor:
    """Megatron-style sequence parallelism: the residual stream [B, S, d]
    with S sharded over the ``model`` axis between blocks (``P(dp,
    "model", None)``), so the remat checkpoints are 1/TP the size; a
    no-op unless `enable`, and under the reference's conditions (no mesh,
    no ``"model"`` axis, not 3-dim, S not a multiple of its size)."""
    if not enable or mesh is None:
        return x
    sizes = mesh_axis_sizes(mesh)
    if "model" not in sizes or x.dim() != 3 \
            or x.shape[1] % sizes["model"] != 0:
        return x
    return constrain(x, mesh, P(batch_axes(mesh), "model", None))


def mesh_forward(fn: Callable) -> Callable:
    """A model method that, on a mesh, runs under ``no_grad`` where the
    caller asked for ``inference_mode``: DTensor views refuse inference
    mode in some torch versions ("Cannot set version_counter for
    inference tensor", 2.13), and the two give the same values."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        if self.mesh is None or not torch.is_inference_mode_enabled():
            return fn(self, *args, **kwargs)
        with torch.inference_mode(False), torch.no_grad():
            return fn(self, *args, **kwargs)
    return run


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
    ("full": each layer recomputed in the backward; "none").

    With a `mesh` the parameters are DTensors placed per `param_pspecs`
    under `rules` (default `DEFAULT_RULES`): a plain leaf is the global
    value, the same on every rank, and the model keeps this rank's shard
    of it (on a mesh of one, the tensor itself: no copy); a DTensor leaf
    is redistributed.  `sp` turns on the sequence-parallel residual
    stream (`sp_constrain`).  Decode on a mesh is not ported: it raises."""

    def __init__(self, cfg, params: Dict[str, Any], table: Dict[str, Any],
                 remat: str = "full", *, mesh=None, sp: bool = False,
                 rules: Optional[AxisRules] = None):
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
        self.mesh, self.sp, self.rules = mesh, sp, rules
        self._table = table
        if mesh is not None:
            params = tree_map(lambda t, s: constrain(t, mesh, s), params,
                              self.param_pspecs(mesh))
        self.params = ParamTree(params)

    def param_pspecs(self, mesh, rules: Optional[AxisRules] = None):
        """The parameters' specs on `mesh` under `rules` (default: the
        model's, else `DEFAULT_RULES`)."""
        return param_specs(self._table, mesh,
                           rules or self.rules or DEFAULT_RULES)

    def _boundary(self, x: torch.Tensor) -> torch.Tensor:
        """`sp_boundary` with the model's mesh, sp and rules."""
        return sp_boundary(x, self.mesh, self.sp, self.rules)

    def _no_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                f"{what} on a mesh is not ported (no sharded cache); build "
                f"the model without a mesh to serve")

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
        x = embed_lookup(p["embedding"], tokens, self.mesh, self.rules)
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
        # on a mesh laid out before the softcap (elementwise: the same
        # values as the reference's constraint after it)
        logits = logits_constrain((x @ w.to(x.dtype)).float(), self.mesh,
                                  self.rules)
        cap = self.cfg.final_softcap
        if cap is not None and records_grad(logits):
            logits = torch.tanh(logits / cap) * cap  # the same bits
        elif cap is not None:  # in place: [B, S, V] float32 is large
            logits.div_(cap).tanh_().mul_(cap)
        return logits
