"""Meshes on torch ``DeviceMesh``.  Functions only: importing this module
touches no device and no process group.

The JAX package's ``launch/mesh.py``.  A mesh spans ranks of the default
process group (``torch.distributed.init_process_group``, which the caller
sets up: nothing here finds a cluster); the device type follows the
backend, "cuda" under NCCL and "cpu" under gloo.  Where the world is not
the production size, `make_production_mesh` raises, and the spec
functions of `parallel.sharding` take `production_mesh_shape` instead.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..parallel.sharding import MeshShape

__all__ = ["make_mesh", "make_production_mesh", "make_test_mesh",
           "production_mesh_shape"]


def _device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              devices: Optional[Sequence[int]] = None):
    """A `DeviceMesh` of `shape` with dims named `axes` over all ranks of
    the world (``init_device_mesh``), or over the ranks `devices` (row
    major), which every rank of the world must call it with."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if devices is None:
        return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)
    ranks = torch.tensor(list(devices), dtype=torch.int64)
    if ranks.numel() != int(torch.tensor(shape).prod()):
        raise ValueError(f"{ranks.numel()} ranks for a mesh of {shape}")
    return DeviceMesh(_device_type(), ranks.reshape(shape),
                      mesh_dim_names=axes)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: 16x16 = 256 ranks (data, model).  Multi-pod: 2x16x16 =
    512 (pod, data, model).  Names and sizes only (`MeshShape`)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh as a `DeviceMesh`; raises ValueError unless the
    world has exactly its 256 (512) ranks."""
    import torch.distributed as dist

    want = production_mesh_shape(multi_pod=multi_pod)
    size = 1
    for s in want.axis_sizes:
        size *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != size:
        raise ValueError(f"the production mesh {want} needs a world of "
                         f"{size} ranks, this one has {world}; compute its "
                         f"specs on production_mesh_shape("
                         f"multi_pod={multi_pod}) instead")
    return make_mesh(want.axis_sizes, want.axis_names)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0):
    """Small mesh for multi-rank tests (a world of data*model[*pod]
    ranks, e.g. gloo processes on the CPU)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))
