"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

The JAX package's ``parallel/sharding.py`` on torch ``DeviceMesh`` /
``DTensor``.  Every parameter/activation dimension carries a *logical*
axis name; rules map logical names to mesh axes.  A dimension is sharded
over a mesh axis only if it divides evenly, otherwise it falls back to
replicated (e.g. qwen2-0.5b's 14 attention heads on a 4-way model axis).

Default 2D scheme (single pod, mesh ("data", "model")):
  * tensor parallelism over "model": heads / ff / experts / vocab
  * ZeRO-3 / FSDP over "data": the `embed` dimension of every weight
  * batch over "data" (and "pod" when multi-pod)

A spec is a `PartitionSpec`: a tuple with one entry a tensor dim, each
None, a mesh axis name or a tuple of names (the dim sharded over their
product, the first name major).  It compares equal to the JAX package's
``tuple(PartitionSpec(...))``.  `placements` turns a spec into DTensor
placements on a `DeviceMesh` (one per mesh dim: ``Shard(tensor dim)`` or
``Replicate()``).  The spec functions take a `DeviceMesh` or a
`MeshShape` (axis names and sizes, no devices), so the specs of the
256- and 512-chip production meshes are computed on one host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ["AxisRules", "DEFAULT_RULES", "FSDP_RULES", "FSDP_EP_RULES",
           "PROFILES", "PartitionSpec", "P", "MeshShape", "spec_for",
           "tree_specs_to_shardings", "mesh_axis_sizes", "batch_axes",
           "placements", "spec_of_placements", "is_dtensor", "constrain",
           "replicate_like"]

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """``P("data", None, ("data", "model"))``: one entry a tensor dim."""

    def __new__(cls, *parts: MeshAxes) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


@dataclass(frozen=True)
class MeshShape:
    """A mesh with names and sizes and no devices (the spec functions'
    stand-in for a `DeviceMesh` that this host cannot build)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axis names {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")


@dataclass(frozen=True)
class AxisRules:
    rules: Dict[str, MeshAxes] = field(default_factory=dict)

    def get(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical)


DEFAULT_RULES = AxisRules({
    "batch": ("pod", "data"),
    "embed": "data",          # ZeRO-3: weights fully sharded over dp
    "embed_table": None,      # embedding/lm_head d-dim: replicated
                              # (Megatron vocab-parallel; avoids a full
                              # token all-gather in the embedding wgrad)
    "vocab": "model",
    "qheads": "model",
    "kvheads": "model",
    "ff": "model",
    "experts": "model",
    "inner": "model",         # mamba d_inner / rg-lru width
    "lru": "model",
    "seq": None,
    "kv_seq": "model",        # decode KV cache sequence dim (SP for serving)
    "layers": None,
    "head_dim": None,
    "state": None,
})

FSDP_RULES = AxisRules({
    # pure ZeRO-3: no tensor parallelism -- activations shard batch over
    # the whole mesh and every weight is fully sharded over all axes
    # (gathered per layer)
    "batch": ("pod", "data", "model"),
    "embed": ("data", "model"),
    "embed_table": None,
    "vocab": None,
    "qheads": None,
    "kvheads": None,
    "ff": "data",   # second FSDP axis for the big matrices
    "experts": None,
    "inner": "data",
    "lru": "data",
    "seq": None,
    "kv_seq": "model",
    "layers": None,
    "head_dim": None,
    "state": None,
})

FSDP_EP_RULES = AxisRules({
    # MoE hybrid: FSDP for attention / shared FFN, expert parallelism kept
    # over `model` (the only axis the EP dispatch needs); the remaining
    # model-axis collective is the MoE combine's all-reduce
    "batch": ("pod", "data"),
    "embed": ("data", "model"),
    "embed_table": None,
    "vocab": None,
    "qheads": None,
    "kvheads": None,
    "ff": None,
    "experts": "model",
    "inner": None,
    "lru": None,
    "seq": None,
    "kv_seq": "model",
    "layers": None,
    "head_dim": None,
    "state": None,
})

PROFILES = {"tp2d": DEFAULT_RULES, "fsdp": FSDP_RULES,
            "fsdp_ep": FSDP_EP_RULES}


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or a `MeshShape`, in mesh
    order."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh's dims need names (mesh_dim_names)")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _resolve(dim: int, logical: Optional[str], rules: AxisRules,
             sizes: Dict[str, int]) -> MeshAxes:
    axes = rules.get(logical)
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    # keep only axes present in the mesh; require divisibility by the product
    axes = tuple(a for a in axes if a in sizes)
    if not axes:
        return None
    prod = 1
    for a in axes:
        prod *= sizes[a]
    if dim % prod != 0:
        # try progressively shorter prefixes before replicating
        for cut in range(len(axes) - 1, 0, -1):
            sub = axes[:cut]
            prod = 1
            for a in sub:
                prod *= sizes[a]
            if dim % prod == 0:
                return sub if len(sub) > 1 else sub[0]
        return None
    return axes if len(axes) > 1 else axes[0]


def spec_for(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
             mesh, rules: AxisRules = DEFAULT_RULES) -> PartitionSpec:
    """PartitionSpec for a concrete shape + logical axis names."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} and logical axes {logical} differ "
                         f"in rank")
    sizes = mesh_axis_sizes(mesh)
    used = set()
    parts = []
    for dim, name in zip(shape, logical):
        axes = _resolve(dim, name, rules, sizes)
        if isinstance(axes, str):
            axes = (axes,)
        if axes:
            axes = tuple(a for a in axes if a not in used)
            if axes:
                prod = 1
                for a in axes:
                    prod *= sizes[a]
                if dim % prod != 0:
                    axes = ()
        if axes:
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        else:
            parts.append(None)
    return P(*parts)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the global batch (dp axes)."""
    return tuple(a for a in ("pod", "data") if a in mesh_axis_sizes(mesh))


def placements(spec: Sequence[MeshAxes], mesh) -> Tuple[Any, ...]:
    """DTensor placements of `spec` on `mesh`: for each mesh dim,
    ``Shard(i)`` where tensor dim i names it, else ``Replicate()``.

    DTensor shards a tensor dim over several mesh dims in mesh order, the
    first major, as a spec entry ``("data", "model")`` does; an entry whose
    axes are not in mesh order (``("model", "data")``) has no placement
    and raises ValueError, and so does an axis the mesh lacks or one named
    twice."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    seen = set()
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        for a in axes:
            if a not in names or a in seen:
                raise ValueError(f"spec {spec}: axis {a!r} is not in the "
                                 f"mesh {names} or is named twice")
            seen.add(a)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {i} shards over {axes}, not "
                             f"in the mesh's order {names}; DTensor cannot "
                             f"place it")
        for j in order:
            out[j] = Shard(i)
    return tuple(out)


def spec_of_placements(places: Sequence[Any], mesh,
                       ndim: int) -> PartitionSpec:
    """The spec of DTensor `places` on `mesh` for an `ndim`-dim tensor
    (`placements`' inverse; a ``Partial`` placement has no spec and
    raises ValueError)."""
    from torch.distributed.tensor import Replicate, Shard

    parts: list = [()] * ndim
    for name, pl in zip(mesh_axis_sizes(mesh), places):
        if isinstance(pl, Shard):
            parts[pl.dim % ndim] = parts[pl.dim % ndim] + (name,)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} on {name!r} has no spec")
    return P(*(None if not a else a[0] if len(a) == 1 else a for a in parts))


def tree_specs_to_shardings(tree, mesh):
    """A tree of specs -> the same tree of ``(mesh, placements)``."""
    if isinstance(tree, dict):
        return {k: tree_specs_to_shardings(v, mesh) for k, v in tree.items()}
    return (mesh, placements(tree, mesh))


# ---------------------------------------------------------------------------
# tensors on a mesh
# ---------------------------------------------------------------------------

def is_dtensor(t) -> bool:
    """Whether `t` is a DTensor."""
    if not isinstance(t, torch.Tensor) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def constrain(x: torch.Tensor, mesh, spec: Sequence[MeshAxes]):
    """`x` laid out per `spec` on `mesh` (the reference's
    ``with_sharding_constraint``): a DTensor is redistributed (the
    collectives its placements need, none where they match); a plain
    tensor is taken as the global value, the same on every rank, and
    becomes a DTensor holding this rank's shard of it (no communication).
    Both are differentiable."""
    from torch.distributed.tensor import DTensor, Replicate

    places = placements(spec, mesh)
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, places)


def replicate_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`t` as a replicated DTensor on `ref`'s mesh where `ref` is a DTensor
    and `t` is not (a plain tensor that meets activations: positions,
    tables, targets), else `t` itself."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
