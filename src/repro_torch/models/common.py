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
recomputes each layer in the backward (`LanguageModel._layer_call`),
``remat="2level"`` nests the transformer's scanned groups two checkpoints
deep (`LanguageModel._two_level`), and the few in-place steps of the
inference path take an out-of-place form (here `_unembed`'s softcap).
Serve runs under ``inference_mode`` and is unchanged.

A model takes its stacked layers apart once a call (`unstack`: one
``unbind`` a leaf), so the backward writes each stacked gradient once, as
the reference's ``lax.scan`` does, where a ``t[i]`` view a layer would
write a zero-filled stack a layer and sum them.
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
                                 constrain, is_dtensor, mesh_axis_sizes,
                                 placements, replicate_like, spec_for)

__all__ = ["ParamDef", "init_params", "init_stacked", "param_specs",
           "stack_defs", "rms_norm", "dtype_of", "count_params",
           "embed_lookup", "unembed_product", "logits_constrain",
           "sp_boundary", "sp_constrain",
           "tree_map", "tree_leaves", "tree_items", "tree_from_items",
           "records_grad", "unstack", "two_level_split", "ParamTree",
           "LanguageModel", "REMAT",
           "mesh_forward", "mesh_inference", "write_into", "write_slot",
           "sharded_full"]

REMAT = ("full", "2level", "none")

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


def unstack(tree: Any) -> list:
    """The per-layer trees of `tree`, whose leaves are stacked over a
    leading layers dim: each leaf taken apart once with ``unbind(0)``, so
    autograd writes the stacked gradient once (``stack``), with each
    layer's bits (a ``-0.0`` kept), where ``t[i]`` a layer writes a
    zero-filled stack a layer and sums them.  On a mesh the layers dim
    is never sharded, and each piece keeps the leaf's placements on its
    other dims (`LanguageModel._layer_call` lays its gradient out so)."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    n = len(next(tree_leaves(parts)))
    return [tree_map(lambda ts, i=i: ts[i], parts) for i in range(n)]


def _grads_in_layout(tree: Any) -> Any:
    """`tree` with each DTensor leaf that requires grad passed through
    `_GradAsInput`, so its gradient is laid out as the leaf (on a mesh of
    one device every layout is the whole tensor: left as it is)."""
    return tree_map(lambda t: _GradAsInput.apply(t) if is_dtensor(t)
                    and t.requires_grad and t.device_mesh.size() > 1
                    else t, tree)


class _GradAsInput(torch.autograd.Function):
    """The identity on a DTensor, whose backward lays the gradient out as
    the input.  A layer's weight gradient leaves its matmul partial over
    the batch's mesh dims or laid out as the activations were (16x a
    shard of nemotron-4-340b's FFN weights on the pod); the reference's
    scan writes the stacked gradient in the parameter's layout.  Applied
    where a layer starts (`LanguageModel._layer_call`): autograd runs the
    ready node made last first, so its backward runs as soon as its
    layer's has (made with the unbind, before every layer, it ran after
    all of them, and every layer's gradient waited in its matmul's
    layout)."""

    @staticmethod
    def forward(ctx, t):
        ctx.layout = (t.device_mesh, t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout)


def _tensors(obj):
    """The tensors in nested dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (dict, list, tuple)):
        for v in (obj.values() if isinstance(obj, dict) else obj):
            yield from _tensors(v)


def two_level_split(groups: int) -> Tuple[int, int]:
    """(outer, inner) of ``remat="2level"`` over `groups` scanned groups,
    the reference's: inner the largest divisor of `groups` not above
    ``int(sqrt(groups))`` (1 where none is), outer ``groups // inner``;
    24 groups give (6, 4), 96 give (12, 8)."""
    inner = 1
    for cand in range(int(np.sqrt(groups)), 0, -1):
        if groups % cand == 0:
            inner = cand
            break
    return groups // inner, inner


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

    With a mesh, the reference's one-hot contraction ``onehot(tokens) @
    table``, partitioned as GSPMD partitions it, under ``local_map``: each
    rank compares its batch shard of `tokens` (the global batch, a plain
    tensor the same on every rank, or a DTensor) with its vocab columns
    and multiplies the one-hot by its rows of the table; where the vocab
    is sharded the products are partial sums over those mesh dims (one
    nonzero term a row, so the gather's bits), reduced where the next op
    needs them.  The table's gradient is ``onehot^T g`` on each rank,
    partial over the batch's mesh dims (another order of summation than
    the gather's).  The one-hot never meets DTensor's sharding
    propagation, which at 512 ranks spends seconds planning its
    transposed [V, B * S] layouts in the backward."""
    if mesh is None:
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial
    from ..parallel.compat import local_map

    v = table.shape[0]
    spec = spec_for(tuple(tokens.shape) + (v,),
                    ("batch",) * tokens.dim() + ("vocab",), mesh,
                    rules or DEFAULT_RULES)
    tok = constrain(tokens, mesh, P(*spec[:-1]))
    cols = constrain(torch.arange(v, device=tok.device), mesh, P(spec[-1]))
    table = constrain(table, mesh, P(spec[-1], None))
    vocab = set(_axes(spec[-1]))
    batch = set(a for entry in spec[:-1] for a in _axes(entry))
    names = list(mesh_axis_sizes(mesh))
    out = [Partial() if n in vocab else pl
           for n, pl in zip(names, placements(P(*spec[:-1], None), mesh))]
    grad = [Partial() if n in batch else pl
            for n, pl in zip(names, table.placements)]

    def local(t, c, w):
        return (t[..., None] == c).to(w.dtype) @ w

    return local_map(local, out_placements=out,
                     in_placements=(tok.placements, cols.placements,
                                    table.placements),
                     in_grad_placements=(tok.placements, cols.placements,
                                         grad),
                     device_mesh=mesh)(tok, cols, table)


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logits_constrain(logits: torch.Tensor, mesh,
                     rules: Optional[AxisRules] = None) -> torch.Tensor:
    """Keep [.., V] logits vocab-TP-sharded (and batch-dp-sharded)."""
    if mesh is None:
        return logits
    spec = spec_for(tuple(logits.shape),
                    ("batch",) + (None,) * (logits.dim() - 2) + ("vocab",),
                    mesh, rules or DEFAULT_RULES)
    return constrain(logits, mesh, spec)


def unembed_product(x: torch.Tensor, w: torch.Tensor, mesh,
                    rules: Optional[AxisRules] = None) -> torch.Tensor:
    """``x @ w`` for x [B, S, d] and a [d, V] output table (the
    embedding's transpose or ``lm_head``).  On a mesh under ``local_map``
    as GSPMD partitions it: x batch over the dp axes and replicated
    elsewhere, `w` vocab-parallel, the product [B, S, V] batch- and
    vocab-sharded with no communication; x's gradient is partial over the
    vocab's mesh dims, `w`'s over the batch's.  The [V, B * S] cotangent
    of `w`'s gradient never meets DTensor's sharding propagation (at 512
    ranks it planned its layouts for minutes)."""
    if mesh is None:
        return x @ w
    from torch.distributed.tensor import Partial
    from ..parallel.compat import local_map

    b, s, d = x.shape
    spec = spec_for((b, s, w.shape[1]), ("batch", None, "vocab"), mesh,
                    rules or DEFAULT_RULES)
    x = constrain(x, mesh, P(spec[0], None, None))
    w = constrain(w, mesh, P(None, spec[2]))
    vocab = set(_axes(spec[2]))
    batch = set(_axes(spec[0]))
    names = list(mesh_axis_sizes(mesh))
    gx = [Partial() if n in vocab else pl for n, pl in zip(names,
                                                           x.placements)]
    gw = [Partial() if n in batch else pl for n, pl in zip(names,
                                                           w.placements)]
    return local_map(torch.matmul, out_placements=list(placements(spec, mesh)),
                     in_placements=(x.placements, w.placements),
                     in_grad_placements=(gx, gw), device_mesh=mesh)(x, w)


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


def mesh_inference(fn: Callable) -> Callable:
    """A model method under ``inference_mode``, or under ``no_grad`` on a
    mesh (`mesh_forward`'s reason): the decode steps."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        if self.mesh is None:
            with torch.inference_mode():
                return fn(self, *args, **kwargs)
        with torch.inference_mode(False), torch.no_grad():
            return fn(self, *args, **kwargs)
    return run


def _shard_range(t: torch.Tensor, dim: int) -> Tuple[int, int]:
    """(first index, length) of dim `dim` of DTensor `t` on this rank: the
    dim's mesh dims split it evenly (as `spec_for` shards only where it
    divides), the first major, as DTensor's ``Shard`` over several mesh
    dims does."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    index, parts = 0, 1
    for m, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim % t.dim() == dim:
            index = index * mesh.size(m) + coord[m]
            parts *= mesh.size(m)
    size = t.shape[dim] // parts
    return index * size, size


def write_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for a cache leaf `dst`, in place.  A DTensor
    `dst` takes `src` laid out as itself (`src` a DTensor, partial or
    not, or the global value as a plain tensor) into its local shard."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    src = replicate_like(src, dst).redistribute(dst.device_mesh,
                                                dst.placements)
    dst.to_local().copy_(src.to_local())


def write_slot(dst: torch.Tensor, dim: int, index: int,
               src: torch.Tensor) -> None:
    """``dst.select(dim, index).copy_(src.select(dim, 0))`` in place: row
    `index` of a cache leaf along `dim` from `src`, which has `dst`'s
    shape but 1 along `dim`.  On a mesh only the rank whose shard of
    `dim` holds `index` writes, from `src` laid out as `dst` elsewhere
    and replicated along `dim` (the reference's ``dynamic_update_slice``
    into a sharded cache)."""
    if not is_dtensor(dst):
        dst.select(dim, index).copy_(src.select(dim, 0))
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = dst.device_mesh
    want = [Replicate() if isinstance(pl, Shard) and pl.dim % dst.dim()
            == dim else pl for pl in dst.placements]
    local = replicate_like(src, dst).redistribute(mesh, want).to_local()
    start, size = _shard_range(dst, dim)
    if start <= index < start + size:
        dst.to_local().select(dim, index - start).copy_(local.select(dim, 0))


def sharded_full(shape: Tuple[int, ...], fill, dtype: torch.dtype, device,
                 mesh, spec) -> torch.Tensor:
    """A DTensor of `shape` filled with `fill`, laid out per `spec` on
    `mesh`; only this rank's shard is allocated (on `device`: the meta
    device allocates nothing)."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_axis_sizes(mesh)
    local = list(shape)
    for i, entry in enumerate(spec):
        for a in _axes(entry):
            local[i] //= sizes[a]
    t = torch.full(local, fill, dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


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
    ("full": each layer recomputed in the backward; "2level": the
    transformer's sqrt-checkpointing, `_two_level`, and no checkpoint in
    the families whose reference checks for "full" alone; "none").

    With a `mesh` the parameters are DTensors placed per `param_pspecs`
    under `rules` (default `DEFAULT_RULES`): a plain leaf is the global
    value, the same on every rank, and the model keeps this rank's shard
    of it (on a mesh of one, the tensor itself: no copy); a DTensor leaf
    is redistributed.  `sp` turns on the sequence-parallel residual
    stream (`sp_constrain`).  Decode runs on a mesh too: `init_cache`
    lays each cache leaf out per the model's ``cache_pspecs``
    (`_place_cache`) and the decode steps write into the local shards
    (`write_into`, `write_slot`)."""

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

    def _cache_device(self) -> torch.device:
        """Where `init_cache` builds its tree: the model's device, or the
        meta device on a mesh, where `_place_cache` allocates the
        shards."""
        return self.device if self.mesh is None else torch.device("meta")

    def _place_cache(self, cache, batch: int, max_seq: int):
        """`cache` as is without a mesh; on one, each leaf a DTensor laid
        out per the model's ``cache_pspecs``, this rank's shard
        allocated on the model's device: a leaf already a DTensor is
        redistributed, a meta one (`_cache_device`) filled as
        `init_cache` fills it: ``slot_pos`` with -1, the rest with 0."""
        if self.mesh is None:
            return cache
        spec_of = dict(tree_items(self.cache_pspecs(self.mesh, batch,
                                                    max_seq, self.rules)))
        out = []
        for path, leaf in tree_items(cache):
            if leaf.device.type != "meta" or is_dtensor(leaf):
                out.append((path, constrain(leaf, self.mesh,
                                            spec_of[path])))
                continue
            fill = -1 if path[-1] == "slot_pos" else 0
            out.append((path, sharded_full(tuple(leaf.shape), fill,
                                           leaf.dtype, self.device,
                                           self.mesh, spec_of[path])))
        return tree_from_items(out)

    @staticmethod
    def _remat_call(on: bool, fn: Callable, p, x: torch.Tensor, *args):
        """``fn(p, x, *args)``; where `on` and autograd records (on `x` or
        a tensor in `p`: nested dicts, lists and tuples), under
        ``torch.utils.checkpoint`` (non-reentrant): the backward runs `fn`
        again instead of keeping its activations, as the reference's
        ``jax.checkpoint`` does; no layer draws random numbers, so no RNG
        state is kept."""
        if on and records_grad(x, *_tensors(p)):
            return checkpoint(fn, p, x, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(p, x, *args)

    def _layer_call(self, fn: Callable, p, x: torch.Tensor, *args):
        """``fn(p, x, *args)``, one layer, recomputed in the backward
        where `remat` is "full" (`_remat_call`); on a mesh each parameter's
        gradient is laid out as the parameter as soon as the layer's
        backward is done (`_GradAsInput`)."""
        return self._remat_call(self.remat == "full", fn,
                                _grads_in_layout(p), x, *args)

    def _two_level(self, group: Callable, groups: list,
                   x: torch.Tensor) -> torch.Tensor:
        """x through every scanned group in order, ``group(gp, x)`` running
        the one of parameters `gp`, under the reference's
        sqrt-checkpointing (``remat="2level"``): the groups split into
        `two_level_split`'s outer groups of `inner`, each group under a
        checkpoint and each outer group under another around them, so the
        forward keeps the outer boundaries alone and the backward runs
        each layer's forward twice more (an outer group's recompute stops
        at its last group's input, which its own recompute then takes
        over)."""
        _, inner = two_level_split(len(groups))

        def outer(ogs, x):
            for gp in ogs:
                x = self._remat_call(True, group, gp, x)
            return x

        for start in range(0, len(groups), inner):
            x = self._remat_call(True, outer, groups[start:start + inner], x)
        return x

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
        logits = logits_constrain(
            unembed_product(x, w.to(x.dtype), self.mesh, self.rules).float(),
            self.mesh, self.rules)
        cap = self.cfg.final_softcap
        if cap is not None and records_grad(logits):
            logits = torch.tanh(logits / cap) * cap  # the same bits
        elif cap is not None:  # in place: [B, S, V] float32 is large
            logits.div_(cap).tanh_().mul_(cap)
        return logits
