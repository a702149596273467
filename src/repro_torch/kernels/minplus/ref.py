"""Plain PyTorch versions of the path-cost reduction and the tropical
(min,+) matrix product.

The CPU paths of `ops.path_costs` and `ops.minplus`, and the oracles the
CUDA kernels (`csrc/path_costs.cu`, `csrc/minplus.cu`) are held against on
the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# headroom so INF + INF does not overflow float32 (the JAX package's INF)
INF = float(np.float32(3.0e38) / np.float32(4))

# unreachable in the integer APSP route (csrc/minplus_dpx.cu): above every
# hop count of a graph of at most this many vertices, and twice it fits int16
HOPS_UNREACHABLE = 16383

# elements of the [rows, k, n] candidate block `minplus_ref` materialises
# at once (256 MB of float32)
_CHUNK_ELEMENTS = 1 << 26


def path_costs_ref(delay: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """Per-candidate path costs from a padded per-link delay table.

    ``delay`` is ``[E + 1]`` (the last slot is the zero pad that -1-padded
    edge ids were remapped to); ``eidx`` is ``[F, K, L]`` int32.  Returns
    ``cost[f, k] = sum_l delay[eidx[f, k, l]]`` in ``delay.dtype``.

    The sum runs in an explicit loop ``l = 0 .. L-1`` starting from 0, so
    its order is defined: the kernel adds in the same order and matches
    this bit for bit, and so does the JAX package's ``path_costs_ref`` on
    the CPU (XLA reduces the short L axis in order).
    """
    acc = torch.zeros(eidx.shape[:-1], dtype=delay.dtype, device=delay.device)
    for l in range(eidx.shape[-1]):
        acc = acc + delay[eidx[..., l]]
    return acc


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C[i, j] = min_k A[i, k] + B[k, j]`` in float32.

    Works through the rows of A in chunks, so at most `_CHUNK_ELEMENTS`
    candidates exist at once (the whole ``[m, k, n]`` block is 1 PB at
    PF(79)).  Each candidate is one rounded add and min is exact, so the
    result does not depend on the chunking or on the order of k: it equals
    the JAX package's ``minplus_ref`` bit for bit.
    """
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rows = max(1, _CHUNK_ELEMENTS // max(k * n, 1))
    for lo in range(0, m, rows):
        blk = a[lo:lo + rows, :, None] + b[None, :, :]
        out[lo:lo + rows] = blk.amin(dim=1)
    return out


def minplus_hops_ref(d: torch.Tensor) -> torch.Tensor:
    """``C[i, j] = min_k D[i, k] + D[k, j]`` of an int16 hop-count matrix
    with entries in ``[0, HOPS_UNREACHABLE]``; int16.

    The plain version of csrc/minplus_dpx.cu (which reads ``D[j, k]`` for
    ``D[k, j]``: `apsp` gives it symmetric matrices only).  Sums in int32;
    none exceeds ``2 * HOPS_UNREACHABLE``, which int16 holds, so the
    kernel's int16 sums are the same."""
    n, k = d.shape
    d32 = d.to(torch.int32)
    out = torch.empty((n, n), dtype=torch.int16, device=d.device)
    rows = max(1, _CHUNK_ELEMENTS // max(k * n, 1))
    for lo in range(0, n, rows):
        blk = d32[lo:lo + rows, :, None] + d32[None, :, :]
        out[lo:lo + rows] = blk.amin(dim=1).to(torch.int16)
    return out


def adjacency_to_dist0(adj: torch.Tensor) -> torch.Tensor:
    """Boolean adjacency -> 1-step distance matrix (0 diag, 1 edge, INF
    else), float32."""
    n = adj.shape[0]
    d = torch.where(adj, 1.0, INF).to(torch.float32)
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    return torch.where(eye, 0.0, d).to(torch.float32)


def apsp_steps(n: int) -> int:
    """Tropical squarings that cover every path of a graph on n vertices:
    ``ceil(log2(max(n - 1, 2)))``, as the JAX package takes."""
    return max(1, int(math.ceil(math.log2(max(n - 1, 2)))))


def apsp_ref(adj: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest paths by repeated tropical squaring; INF marks
    unreachable pairs (as the JAX package's ``apsp_ref``)."""
    d = adjacency_to_dist0(adj)
    for _ in range(apsp_steps(adj.shape[0])):
        d = minplus_ref(d, d)
    return d
