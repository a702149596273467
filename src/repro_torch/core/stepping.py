"""Per-hop stepping core shared by path construction and the packet engine.

Every consumer that moves "one hop at a time" through the routing state
used to carry its own copy of the same three pieces of machinery:

* a **next-hop walk** -- gather the next node for a batch of rows,
  `diameter` times, with the unreachable / diameter-overrun checks
  (`core.routing.minimal_paths` over the dense table, the blocked path
  builder's `_walk_edges_block` over next-hop columns);
* a **shortest-path successor table** -- for a block of destinations,
  the per-node list of neighbors at distance - 1 in CSR order plus
  counts, walked with pre-drawn uniforms (the ECMP walk of
  `simulation.paths`, both engines);
* the **node-walk -> edge-walk** conversion -- consecutive pairs of an
  absorbing node walk become directed edge ids, pads where the walk has
  already absorbed.

This module is that machinery, written once.  `simulation.paths` builds
flow candidates on it, `core.routing.minimal_paths` is a thin wrapper
over `walk_next_hops`, and `simulation.packet` steps per-packet routes
with the same successor-column logic instead of duplicating it.  All
functions are pure numpy on host arrays: the stepping core runs at
*construction* time (paths, workloads); the per-cycle packet dynamics
live in jit land on top of the arrays built here.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from .graph import UNREACHABLE

__all__ = ["walk_next_hops", "successor_tables", "walk_successors",
           "edge_walk", "edge_sources"]


def walk_next_hops(lookup: Callable[[np.ndarray], np.ndarray],
                   src: np.ndarray, dst: np.ndarray,
                   diameter: int) -> np.ndarray:
    """Walk a batch of rows one next-hop gather at a time.

    `lookup(cur)` returns the next node toward each row's destination
    (`next_hop[cur, dst]` on a dense table, `nh_cols[cur, ld]` on a
    destination-block's columns -- the caller closes over the
    destination representation).  Returns [R, diameter + 1] int32 node
    sequences starting at `src`; destinations absorb (`next_hop[d, d] =
    d`), so callers recover hop validity as ``nodes[:, h] != nodes[:,
    h + 1]``.  Raises ValueError on unreachable pairs and on walks that
    fail to absorb within `diameter` hops, with the row's endpoints in
    the message.
    """
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    if src.shape != dst.shape:
        raise ValueError("src/dst shape mismatch")
    nodes = np.empty((src.shape[0], diameter + 1), dtype=np.int32)
    nodes[:, 0] = src
    cur = src
    for h in range(diameter):
        nxt = np.asarray(lookup(cur), dtype=np.int64)
        if (nxt == UNREACHABLE).any():
            i = int(np.flatnonzero(nxt == UNREACHABLE)[0])
            raise ValueError(f"no route {int(src[i])}->{int(dst[i])}")
        nodes[:, h + 1] = nxt
        cur = nxt
    if (cur != dst).any():
        i = int(np.flatnonzero(cur != dst)[0])
        raise ValueError(
            f"path {int(src[i])}->{int(dst[i])} exceeds diameter "
            f"{diameter}")
    return nodes


def successor_tables(dist_cols: np.ndarray, nb: np.ndarray,
                     present: np.ndarray, safe_nb: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Shortest-path successor tables for one destination block.

    `dist_cols` is the block's [n, B] distance columns (a dense-table
    slice or a blocked-BFS product -- bit-identical either way); `nb` /
    `present` / `safe_nb` are the padded-neighbor views.  Returns
    ``(succ, cnt)``: ``succ[u, d_local, j]`` is the j-th neighbor of u
    on a shortest path toward the block's d_local-th destination (CSR
    neighbor order preserved, good slots first), ``cnt[u, d_local]`` the
    number of such neighbors.
    """
    dist_nb = dist_cols[safe_nb]  # [n, dmax, B]
    good = (dist_nb.transpose(0, 2, 1)
            == (dist_cols - np.int16(1))[:, :, None]) & present[:, None, :]
    cnt = good.sum(axis=2).astype(np.int64)
    order = np.argsort(~good, axis=2, kind="stable")  # good slots first
    succ = np.take_along_axis(
        np.broadcast_to(nb[:, None, :], good.shape), order, axis=2)
    return succ, cnt


def walk_successors(succ: np.ndarray, cnt: np.ndarray, src_f: np.ndarray,
                    d_f: np.ndarray, l_f: np.ndarray, u_f: np.ndarray,
                    k: int, diam: int) -> np.ndarray:
    """Walk K random shortest paths per flow over successor tables.

    Hop h of candidate (i, c) picks good-neighbor index
    ``floor(u_f[i, c, h] * cnt)`` among the current node's successors
    toward the flow's destination (`l_f` indexes the block's local
    destination axis).  Returns [Fb, k, diam] int64 node walks, source
    column excluded; absorbed walks repeat the destination.
    """
    fb = len(src_f)
    cur = np.broadcast_to(src_f[:, None], (fb, k)).copy().astype(np.int64)
    d_b = np.broadcast_to(d_f[:, None], (fb, k))
    l_b = np.broadcast_to(l_f[:, None], (fb, k))
    walk = np.empty((fb, k, diam), dtype=np.int64)
    for h in range(diam):
        active = cur != d_b
        j = np.floor(u_f[:, :, h] * cnt[cur, l_b]).astype(np.int64)
        cur = np.where(active, succ[cur, l_b, j], cur).astype(np.int64)
        walk[:, :, h] = cur
    return walk


def edge_walk(edge_ids: Callable[[np.ndarray, np.ndarray], np.ndarray],
              nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Absorbing node walk -> (edge ids, hop counts).

    `nodes` is [..., D + 1] with destinations absorbing; consecutive
    equal nodes mark exhausted hops.  `edge_ids(u, v)` is the vectorized
    directed-edge lookup (`DirectedEdges.edge_ids`).  Returns
    ``([..., D] int32 edge ids, -1 padded; [...] int32 hop counts)``.
    """
    u, v = nodes[..., :-1], nodes[..., 1:]
    real = u != v
    edges = np.where(real, edge_ids(u, v), np.int32(-1))
    return edges.astype(np.int32), real.sum(axis=-1).astype(np.int32)


def edge_sources(offsets: np.ndarray, eids: np.ndarray) -> np.ndarray:
    """Source node of each directed edge id (CSR row recovery).

    The directed-edge id space IS the CSR layout, so the source of edge
    e is the row whose offset range contains e.  Used by the packet
    engine's edge-space remap (re-routed tables after a failure live in
    the damaged graph's CSR space) -- the inverse of
    `DirectedEdges.edge_ids` on the source side.
    """
    e = np.asarray(eids, dtype=np.int64)
    return (np.searchsorted(offsets, e.ravel(), side="right") - 1) \
        .astype(np.int32).reshape(e.shape)
