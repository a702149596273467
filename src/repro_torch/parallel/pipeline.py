"""GPipe-style pipeline parallelism over a mesh axis (optional feature).

The JAX package's ``parallel/pipeline.py`` on torch ``DeviceMesh``.  The
layer stack splits into ``n_stages`` contiguous stages (stage s owns the
[s]-th slice of the stacked layer params, sharded over the pipeline axis)
and microbatches stream through with a ring send/recv between neighbours
(``batch_isend_irecv``, the reference's ``ppermute``).  Bubble fraction is
the usual (S-1)/(M+S-1).

The reference's ``shard_map`` body is explicit per-rank code here, on
each rank's local tensors; the schedule is the reference's step for step.
The sends are not differentiable: this is a forward schedule.  One card
is one stage, so it runs only where the axis spans several ranks (gloo
processes on the CPU in the tests).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..models.common import tree_map
from .sharding import P, batch_axes, constrain, mesh_axis_sizes

__all__ = ["gpipe"]


def _ring_shift(t: torch.Tensor, group, stage: int, n: int) -> torch.Tensor:
    """`t` from the previous stage of the ring (stage s gets s - 1's)."""
    if n == 1:
        return t
    out = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t.contiguous(),
                   dist.get_global_rank(group, (stage + 1) % n), group),
        dist.P2POp(dist.irecv, out,
                   dist.get_global_rank(group, (stage - 1) % n), group)])
    for r in reqs:
        r.wait()
    return out


def gpipe(stage_fn: Callable, stage_params, x_mb: torch.Tensor, mesh,
          axis: str = "pod"):
    """Run a layer-stack pipeline over `axis` of `mesh`.

    stage_fn(params_slice, x) -> y : applies ONE stage's layers.
    stage_params: tree whose leaves have leading dim n_stages (plain
        tensors, the same on every rank, or DTensors); each rank keeps its
        stage's slice.
    x_mb: [n_microbatches, mb, ...] microbatched inputs (replicated over
        `axis`; the mb dim over the other dp axes).
    Returns y_mb with the same shape as x_mb: a DTensor laid out as x_mb.
    """
    sizes = mesh_axis_sizes(mesh)
    n_stages = sizes[axis]
    n_mb = x_mb.shape[0]
    steps = n_mb + n_stages - 1
    group, stage = mesh.get_group(axis), mesh.get_local_rank(axis)

    # microbatch dim replicated; batch dim over the remaining dp axes
    dp = tuple(a for a in batch_axes(mesh) if a != axis) or None
    spec_x = P(None, dp, *([None] * (x_mb.dim() - 2)))
    x_dt = constrain(x_mb, mesh, spec_x)
    x_local = x_dt.to_local()
    p = tree_map(lambda a: constrain(
        a, mesh, P(axis, *([None] * (a.dim() - 1)))).to_local()[0],
        stage_params)

    out_buf = torch.zeros_like(x_local)
    prev = torch.zeros_like(x_local[0])
    for t in range(steps):
        # receive activation from the previous stage
        recv = _ring_shift(prev, group, stage, n_stages)
        # stage 0 injects microbatch t (when in range)
        x_in = x_local[min(t, n_mb - 1)] if stage == 0 else recv
        y = stage_fn(p, x_in)
        # last stage writes microbatch (t - n_stages + 1) when valid
        out_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and out_idx >= 0:
            out_buf[out_idx] = y
        prev = y
    # the last stage's outputs to every stage: the reference's masked psum
    if stage != n_stages - 1:
        out_buf.zero_()
    dist.all_reduce(out_buf, group=group)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(out_buf, mesh, x_dt.placements,
                              run_check=False)
