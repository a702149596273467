"""Routing for PolarFly and baseline topologies (paper §VII).

* minimal static routing: the unique 1- or 2-hop path in ER_q; computed
  algebraically via the GF(q) cross product (§IV-D) for PolarFly, or via BFS
  next-hop tables for arbitrary graphs.
* Valiant (§VII-B): random intermediate router, two minimal segments (<=4 hops).
* Compact Valiant: intermediate drawn from N(source); <=3 hops; only used
  when source and destination are not adjacent (paper's bounce-back rule).
* UGAL / UGAL_PF (§VII-C): per-packet min-vs-valiant decision from local
  queue occupancy; UGAL_PF uses Compact Valiant + a 2/3 adaptation threshold.
  (The queue-driven decision itself lives in repro_torch.simulation.)

Batched API: `minimal_paths(next_hop, src, dst, diameter)` extracts [F, D+1]
node sequences for F flows at once via `diameter` next-hop gathers (at most 2
for diameter-2 graphs like ER_q); `RoutingTables.paths` is the bound
convenience.  The scalar `minimal_path` remains for one-off queries.

Two-engine convention
---------------------
Like the path builders (`repro_torch.simulation.paths`) and the fluid solver
(`repro_torch.simulation.fluid`), the all-pairs distance / next-hop computation has
two engines that must agree bit-exactly:

* ``engine="dense"`` -- the small-n reference engine: boolean-matrix frontier
  expansion (switching to a float32 BLAS matmul for n >= 512), then a
  per-source argmin over neighbor distance rows for the next-hop table.
  Memory envelope: O(n^2) for the frontier/reachability masks, plus another
  O(n^2) float32 pair above the BLAS threshold (~4 * n^2 * 4 bytes peak) --
  fine through a few thousand vertices, cubic time per hop beyond that.
* ``engine="sparse"`` -- the scale engine: a source-blocked frontier BFS over
  the cached CSR view ``Graph.csr = (indptr int64 [n+1], indices int32
  [E_dir])``.  A block of B sources expands level by level with vectorized
  ragged gathers; first-hop labels propagate along the shortest-path DAG as a
  segmented minimum, which reproduces the dense engine's lowest-id tie break
  exactly (the set of valid first hops toward w is exactly the set of
  neighbors v of s with dist(v, w) == dist(s, w) - 1, and the min of that set
  equals the min over shortest-path predecessors of their first-hop minima).
  Memory envelope: O(B * n) for the block's distance / next-hop / frontier
  rows plus O(B * E_dir) transient edge-gather arrays -- `bfs_block_size`
  picks B from a byte budget (default `_BFS_BUDGET_BYTES`), and
  `bfs_peak_bytes` exposes the resulting peak estimate (asserted < 2 GiB for
  the benchmark scale tier by tests/test_sparse_engine.py).

``engine="auto"`` (every public default) picks dense below `_DENSE_MAX_N`
vertices and sparse above; both produce identical int16 distances (with
`UNREACHABLE` = -1 marking disconnected pairs) and identical int32 next-hop
tables, on intact and damaged graphs.  `distance_blocks` additionally exposes
the sparse engine as a streaming iterator so metrics (diameter / ASPL,
resilience sweeps) never need to materialize an [n, n] table at all.

The block loops themselves run on the shared blockwise executor
(`repro_torch.parallel.blockwise.run_blocks`): ``backend="host"`` is the
sequential reference loop, ``backend="sharded"`` runs the source or
destination blocks a round at a time, one block a device (`devices` of
the visible cards, an explicit list, or ``device`` alone where that is
one or `devices` is None -- ``device="cpu"`` for the CPU), through the
PyTorch twins of `_bfs_block` and `_next_hop_rows` (`_bfs_device_fn`,
`_dest_device_fn`; one twin a device, each with its own copy of the
neighbour tables), and
``backend="auto"`` stays on the host loop unless a multi-device run is
requested via ``devices``.  Backends are bit-identical
(tests/test_torch_blockwise.py asserts it against the JAX package's host
engine), so every consumer -- `sparse_routing_tables`,
`destination_blocks`, the metrics streams, the blocked path builder -- is
backend-blind.

Destination-blocked consumption
-------------------------------
The flow-path builders walk next hops *toward* a flow's destination, i.e.
they consume next-hop table **columns** ``nh[:, d]``, not the rows the
source-blocked BFS produces.  `destination_blocks` serves exactly that view:
for a block of B destinations it BFSes *from* the destinations (distances
are symmetric on undirected graphs) and derives each column as the first
sorted neighbor at distance - 1 -- bit-identical to ``next_hop_table(g)[:,
dests]`` -- in O(B * (n + E) + B * n * deg_max) working memory.
`BlockedRouting` (`build_blocked_routing`) packages this as a routing state
with no [n, n] table at all, which is what retires the dense next-hop table
as the simulator's last [n, n] consumer (see repro_torch.simulation.paths,
``engine="blocked"``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from .graph import Graph, UNREACHABLE
from .polarfly import PolarFly
from .stepping import walk_next_hops
from ..device import resolve_device
from ..parallel.blockwise import (DEFAULT_BUDGET_BYTES, Devices,
                                  available_devices, block_size_for_budget,
                                  peak_bytes, plan_blocks, resolve_devices,
                                  run_blocks)

__all__ = [
    "UNREACHABLE",
    "bfs_distances",
    "bfs_block_size",
    "bfs_peak_bytes",
    "distance_blocks",
    "destination_blocks",
    "dest_block_size",
    "dest_block_peak_bytes",
    "sparse_routing_tables",
    "BlockedRouting",
    "build_blocked_routing",
    "all_pairs_distances",
    "next_hop_table",
    "polarfly_next_hop_table",
    "RoutingTables",
    "build_routing",
    "minimal_path",
    "minimal_paths",
    "valiant_path",
    "compact_valiant_candidates",
]

DeviceLike = Union[str, torch.device]

# Largest vertex count routed through the dense reference engine by default;
# tests assert sparse/dense bit-identity across topologies up to this size.
_DENSE_MAX_N = 2048

# int16 stand-in for +inf in dense argmin scans (never stored in outputs;
# UNREACHABLE is the only sentinel that leaves this module).
_INT16_INF = np.int16(np.iinfo(np.int16).max)

# Default working-set budget for the blocked BFS (transient arrays only; the
# caller's output tables are on top of this).  Owned by the shared blockwise
# core now; the historical name stays because callers/tests pin it.
_BFS_BUDGET_BYTES = DEFAULT_BUDGET_BYTES


# ----------------------------------------------------------------------------
# sparse engine: source-blocked frontier BFS over the CSR view
# ----------------------------------------------------------------------------

def _bfs_bytes_per_source(n: int, e_dir: int) -> int:
    """Working-set estimate for one BFS source row.

    Per source: int16 distance row (2n) + int32 first-hop row (4n) + the
    frontier/newly boolean rows (2n); the worst-case level touches every
    directed edge once, and each frontier edge carries ~24 bytes of transient
    gather state (int64 row + gather index, int32 target + label).
    """
    return 8 * max(n, 1) + 24 * e_dir


def bfs_block_size(n: int, e_dir: int,
                   budget_bytes: int = _BFS_BUDGET_BYTES) -> int:
    """Sources per blocked-BFS batch so the working set fits `budget_bytes`.

    Always returns at least 1 (a single source is the floor the streaming
    engine can run at) and never more than n.  Delegates to the shared
    accounting helper in `repro_torch.parallel.blockwise`.
    """
    return block_size_for_budget(n, _bfs_bytes_per_source(n, e_dir),
                                 budget_bytes)


def bfs_peak_bytes(n: int, e_dir: int, block: int,
                   dist_table: bool = True, next_hop: bool = True) -> int:
    """Estimated peak bytes of a blocked all-pairs run at this block size:
    transient working set + whichever [n, n] output tables are materialized
    (int16 distances and/or int32 next hops; streaming callers pass False)."""
    out = n * n * ((2 if dist_table else 0) + (4 if next_hop else 0))
    return peak_bytes(block, _bfs_bytes_per_source(n, e_dir),
                      resident_bytes=out)


def _bfs_block(indptr: np.ndarray, indices: np.ndarray, sources: np.ndarray,
               want_next_hop: bool) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Frontier BFS from a block of B sources at once.

    Returns (dist [B, n] int16, first_hop [B, n] int32 or None).  Each level
    expands every (source-row, frontier-node) pair with one vectorized ragged
    gather from the CSR arrays; first-hop labels propagate as a segmented
    minimum over the discovered edges, matching the dense next-hop table's
    lowest-id tie break bit-exactly (see module docstring).
    """
    b, n = len(sources), len(indptr) - 1
    rows0 = np.arange(b)
    src = sources.astype(np.int64)
    dist = np.full((b, n), UNREACHABLE, dtype=np.int16)
    dist[rows0, src] = 0
    nh = None
    if want_next_hop:
        nh = np.full((b, n), UNREACHABLE, dtype=np.int32)
        nh[rows0, src] = src
    frow, fnode = rows0, src
    d = 0
    while fnode.size:
        d += 1
        counts = indptr[fnode + 1] - indptr[fnode]
        total = int(counts.sum())
        if total == 0:
            break
        # ragged gather of every frontier node's neighbor range
        starts = indptr[fnode]
        cum = np.cumsum(counts)
        gather = np.repeat(starts - (cum - counts), counts) + np.arange(total)
        nbrs = indices[gather].astype(np.int64)
        erow = np.repeat(frow, counts)
        unv = dist[erow, nbrs] == UNREACHABLE
        if want_next_hop and d > 1:
            usrc = np.repeat(fnode, counts)[unv]
        erow, nbrs = erow[unv], nbrs[unv]
        newly = np.zeros((b, n), dtype=bool)
        newly[erow, nbrs] = True
        dist[newly] = np.int16(d)
        if want_next_hop and erow.size:
            # level 1 seeds the labels (first hop of a neighbor is itself);
            # deeper levels take the min label over all discovering edges.
            # The segmented min runs as one combined-key sort: keys order by
            # (row, node) first and label second, so the head of each
            # (row, node) run carries its minimum label.
            lab = nbrs if d == 1 else nh[erow, usrc].astype(np.int64)
            combined = np.sort((erow * n + nbrs) * (n + 1) + lab)
            flat = combined // (n + 1)
            head = np.empty(flat.size, dtype=bool)
            head[0] = True
            np.not_equal(flat[1:], flat[:-1], out=head[1:])
            nh.ravel()[flat[head]] = (combined[head] % (n + 1)).astype(np.int32)
        frow, fnode = np.nonzero(newly)
    return dist, nh


def _bfs_device_fn(g: Graph, want_next_hop: bool, device: DeviceLike):
    """PyTorch twin of `_bfs_block` for `run_blocks`' sharded backend,
    running on `device`.

    Same frontier BFS in a dense-gather formulation: level d gathers every
    node's padded-neighbor frontier membership ([B, n, deg_max] bool) and
    discovers the nodes with any frontier neighbor; first-hop labels
    propagate as the minimum label over discovering neighbors (level 1
    seeds each discovered node with its own id), which is the same set-min
    the host engine computes via its segmented sort -- the discovering
    edges of w are exactly the frontier neighbors of w on an undirected
    graph -- so outputs are bit-identical.  The loop over levels is a
    Python loop with one host check of the new frontier per level
    (diameter + 1 checks).  Returns None (callers fall back to the host
    loop) when the graph has no edges.
    """
    nb, _ = g.padded_neighbors
    n, dmax = nb.shape
    if dmax == 0:
        return None
    dev = resolve_device(device)
    pres = torch.from_numpy(nb >= 0).to(dev)[None, :, :]
    snb = torch.from_numpy(np.where(nb >= 0, nb, 0).astype(np.int64)).to(dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    unreachable = int(UNREACHABLE)

    def fn(sources: torch.Tensor):
        src = sources.to(dev)
        b = src.shape[0]
        rows = torch.arange(b, device=dev)
        dist = torch.full((b, n), unreachable, dtype=torch.int16, device=dev)
        dist[rows, src] = 0
        front = torch.zeros((b, n), dtype=torch.bool, device=dev)
        front[rows, src] = True
        if want_next_hop:
            nh = torch.full((b, n), unreachable, dtype=torch.int32,
                            device=dev)
            nh[rows, src] = src.to(torch.int32)
        d = 0
        while True:
            d += 1
            fr_nb = front[:, snb] & pres  # [B, n, deg_max]
            newly = fr_nb.any(dim=2) & (dist == unreachable)
            if not bool(newly.any()):  # reprolint-torch: allow[host-sync] -- one host read of the new frontier per BFS level (diameter + 1 a source block); ROADMAP item 14 removes it
                break
            dist.masked_fill_(newly, d)
            if want_next_hop:
                if d == 1:
                    cand = ids.expand(b, n)
                else:
                    cand = torch.where(fr_nb, nh[:, snb], n).amin(dim=2)
                nh = torch.where(newly, cand, nh)
            front = newly
        return (dist, nh) if want_next_hop else (dist,)

    return fn


def _device_run(backend: str, devices: Devices,
                device: DeviceLike, factory):
    """(block-plan width, twins or None): one twin a device of
    `resolve_devices(devices, device)` where a device run is wanted --
    asked for by name (`devices=None` then means `device` alone), or
    "auto" with more than one device to spread over (the reference's
    rule: `devices=None`, or a count on a machine with fewer than two
    cards, is the host loop, and the card is not asked for).  Each twin
    is built on its device by `factory(device)`, with its own copy of the
    neighbour tables; None where no twin exists (an edge-free graph)."""
    if backend not in ("auto", "sharded") or (backend == "auto" and (
            devices is None or (isinstance(devices, (int, np.integer))
                                and available_devices() < 2))):
        return 1, None
    devs = resolve_devices(devices, device)
    if backend == "auto" and len(devs) < 2:
        return 1, None
    twins = [factory(d) for d in devs]
    return len(devs), None if any(t is None for t in twins) else twins


def distance_blocks(g: Graph, block: Optional[int] = None,
                    next_hop: bool = False,
                    budget_bytes: int = _BFS_BUDGET_BYTES,
                    backend: str = "auto", devices: Devices = None,
                    device: DeviceLike = "cuda",
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                        Optional[np.ndarray]]]:
    """Stream the sparse engine: yields (sources, dist [B, n] int16,
    first_hop [B, n] int32 or None) per source block.

    Lets metrics consume all-pairs information in O(block * (n + E)) memory
    without ever materializing an [n, n] table.  `backend`/`devices`
    select the blockwise executor backend: "host" is the sequential
    reference loop, "sharded" runs the BFS one block a device a round
    (bit-identical; degrades to the host loop on edge-free graphs), and
    "auto" (the default) stays on the host loop unless `devices > 1` is
    requested and that many devices exist.  `devices` is a count
    (`cuda:0 .. cuda:ndev - 1`, `device` alone where that is one; None:
    `device` alone) or an explicit list of devices
    (`parallel.blockwise.resolve_devices`).
    """
    indptr, indices = g.csr
    if block is None:
        block = bfs_block_size(g.n, len(indices), budget_bytes)
    ndev, twins = _device_run(backend, devices, device,
                              lambda d: _bfs_device_fn(g, next_hop, d))
    plan = plan_blocks(g.n, block=block, devices=ndev)

    def host_fn(srcs):
        dist, nh = _bfs_block(indptr, indices, srcs, next_hop)
        return (dist, nh) if next_hop else (dist,)

    for srcs, outs in run_blocks(
            np.arange(g.n, dtype=np.int64), plan, host_fn, twins,
            backend="host" if twins is None else backend):
        yield srcs, outs[0], outs[1] if next_hop else None


def sparse_routing_tables(g: Graph, block: Optional[int] = None,  # reprolint-torch: allow[dense-square] -- contract IS the full [n, n] table pair; built block-by-block, only the output is dense
                          backend: str = "auto",
                          devices: Devices = None,
                          device: DeviceLike = "cuda",
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Full ([n, n] int16 distances, [n, n] int32 next hops) via the blocked
    BFS engine; bit-identical to the dense `all_pairs_distances` +
    `next_hop_table` pair on either executor backend."""
    dist = np.empty((g.n, g.n), dtype=np.int16)
    nh = np.empty((g.n, g.n), dtype=np.int32)
    for srcs, db, nb in distance_blocks(g, block, next_hop=True,
                                        backend=backend, devices=devices,
                                        device=device):
        dist[srcs] = db
        nh[srcs] = nb
    return dist, nh


# ----------------------------------------------------------------------------
# destination-blocked next-hop columns (the flow-path builders' view)
# ----------------------------------------------------------------------------

def _dest_bytes_per_target(n: int, e_dir: int, deg_max: int) -> int:
    """Working-set estimate for one destination column.

    Per destination: the BFS source row (distances are symmetric, so the
    column's distance data comes from a BFS rooted at the destination) plus
    the column derivation's [n, deg_max] neighbor-distance gather (int16) and
    goodness mask (bool), plus the int16 distance / int32 next-hop output
    columns.
    """
    return (_bfs_bytes_per_source(n, e_dir)
            + 3 * max(n, 1) * max(deg_max, 1) + 6 * max(n, 1))


def dest_block_size(n: int, e_dir: int, deg_max: int,
                    budget_bytes: int = _BFS_BUDGET_BYTES) -> int:
    """Destinations per `destination_blocks` batch so the working set fits
    `budget_bytes`; at least 1, at most n (same contract as
    `bfs_block_size`; same shared accounting helper)."""
    return block_size_for_budget(n, _dest_bytes_per_target(n, e_dir, deg_max),
                                 budget_bytes)


def dest_block_peak_bytes(n: int, e_dir: int, deg_max: int,
                          block: int) -> int:
    """Estimated peak transient bytes of one destination block (no [n, n]
    output exists on this path -- consumers hold per-flow arrays only)."""
    return peak_bytes(block, _dest_bytes_per_target(n, e_dir, deg_max))


def _next_hop_rows(nb: np.ndarray, dests: np.ndarray,
                   dist_rows: np.ndarray) -> np.ndarray:
    """Next-hop columns toward each destination of a block, row-major.

    `dist_rows` is [B, n] int16 from a BFS rooted at each destination (equal
    to dist[:, dests].T on an undirected graph).  Returns [B, n] int32 where
    row b holds nh[:, dests[b]]: for every u the lowest-id neighbor v with
    dist(v, d) == dist(u, d) - 1, which is exactly the dense
    `next_hop_table`'s argmin-with-first-occurrence tie break (neighbor rows
    are sorted).  nh[d, d] = d; unreachable -> UNREACHABLE.  Block-leading
    so the blockwise executor can stack rows; `destination_blocks`
    transposes to the column view consumers expect.
    """
    b, n = dist_rows.shape
    rows_b = np.arange(b)
    if nb.shape[1] == 0:  # edge-free graph: only the diagonal is routable
        nh = np.full((b, n), UNREACHABLE, dtype=np.int32)
        nh[rows_b, dests] = dests
        return nh
    present = nb >= 0
    safe_nb = np.where(present, nb, 0)
    dist_nb = dist_rows[:, safe_nb]  # [B, n, deg_max]
    # dist_rows > 0 excludes u == d (want would be -1, matching unreachable
    # neighbors) and unreachable u (want would be -2)
    good = ((dist_nb == (dist_rows - np.int16(1))[:, :, None])
            & present[None, :, :] & (dist_rows > 0)[:, :, None])
    any_good = good.any(axis=2)
    first = good.argmax(axis=2)  # [B, n] first good slot = lowest-id neighbor
    nh = np.where(any_good, nb[np.arange(n)[None, :], first],
                  np.int32(UNREACHABLE)).astype(np.int32)
    nh[rows_b, dests] = dests
    return nh


def _next_hop_columns(nb: np.ndarray, dests: np.ndarray,
                      dist_rows: np.ndarray) -> np.ndarray:
    """Column-major [n, B] view of `_next_hop_rows` (the historical
    shape of this helper)."""
    return np.ascontiguousarray(_next_hop_rows(nb, dests, dist_rows).T)


def _dest_device_fn(g: Graph, device: DeviceLike):
    """PyTorch twin of one `destination_blocks` block for the sharded
    backend: the no-next-hop device BFS plus the `_next_hop_rows` column
    derivation, both on `device`.  None when the host fallback applies."""
    bfs = _bfs_device_fn(g, False, device)
    if bfs is None:
        return None
    dev = resolve_device(device)
    nb, _ = g.padded_neighbors
    n = nb.shape[0]
    pres = torch.from_numpy(nb >= 0).to(dev)[None, :, :]
    nbt = torch.from_numpy(nb.astype(np.int32)).to(dev)
    snb = torch.from_numpy(np.where(nb >= 0, nb, 0).astype(np.int64)).to(dev)
    cols = torch.arange(n, device=dev)[None, :]

    def fn(dests: torch.Tensor):
        (dist_rows,) = bfs(dests)
        d = dests.to(dev)
        rows_b = torch.arange(d.shape[0], device=dev)
        dist_nb = dist_rows[:, snb]  # [B, n, deg_max]
        good = ((dist_nb == (dist_rows - 1)[:, :, None])
                & pres & (dist_rows > 0)[:, :, None])
        # argmax takes no bool; both frameworks return the first maximum
        first = good.to(torch.uint8).argmax(dim=2)
        nh = torch.where(good.any(dim=2), nbt[cols, first],
                         int(UNREACHABLE))
        nh[rows_b, d] = d.to(torch.int32)
        return dist_rows, nh

    return fn


def destination_blocks(g: Graph, dests: Optional[np.ndarray] = None,
                       block: Optional[int] = None,
                       budget_bytes: int = _BFS_BUDGET_BYTES,
                       backend: str = "auto", devices: Devices = None,
                       device: DeviceLike = "cuda",
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
    """Stream routing state one destination block at a time: yields
    (dests_blk, dist_cols [n, B] int16, nh_cols [n, B] int32).

    `dist_cols[:, b]` / `nh_cols[:, b]` are bit-identical to the dense
    ``all_pairs_distances(g)[:, dests_blk[b]]`` /
    ``next_hop_table(g)[:, dests_blk[b]]`` columns; only destinations that
    appear in `dests` (default: all n) are ever computed, so sampled-flow
    workloads pay for the destinations they use and nothing else.
    `backend`/`devices`/`device` select the blockwise executor backend
    exactly as in `distance_blocks` -- the destination BFS is where the
    blocked path builder spends its time at scale.
    """
    indptr, indices = g.csr
    nb, _ = g.padded_neighbors
    if dests is None:
        dests = np.arange(g.n, dtype=np.int64)
    dests = np.asarray(dests, dtype=np.int64).ravel()
    if block is None:
        block = dest_block_size(g.n, len(indices), nb.shape[1], budget_bytes)
    ndev, twins = _device_run(backend, devices, device,
                              lambda d: _dest_device_fn(g, d))
    plan = plan_blocks(len(dests), block=block, devices=ndev)

    def host_fn(dblk):
        dist_rows, _ = _bfs_block(indptr, indices, dblk, False)
        return dist_rows, _next_hop_rows(nb, dblk, dist_rows)

    for dblk, (dist_rows, nh_rows) in run_blocks(
            dests, plan, host_fn, twins,
            backend="host" if twins is None else backend):
        yield (dblk, np.ascontiguousarray(dist_rows.T),
               np.ascontiguousarray(nh_rows.T))


@dataclass
class BlockedRouting:
    """Routing state for the destination-blocked flow-path builder.

    Unlike `RoutingTables` there is no [n, n] table anywhere: next-hop
    columns are recomputed per destination block from the blocked BFS, so
    the resident state is the graph plus two integers.  Shares the
    `dest_blocks` iteration protocol with `RoutingTables` (which serves the
    same blocks by slicing its dense tables), so
    ``build_flow_paths(engine="blocked")`` accepts either.
    """

    graph: Graph
    diameter: int
    block: int  # default destinations per block
    backend: str = "auto"  # blockwise executor backend for column sweeps
    devices: Devices = None  # device count or list for backend="sharded"
    device: DeviceLike = "cuda"  # the one device where devices resolve to one

    def dest_blocks(self, dests: Optional[np.ndarray] = None,
                    block: Optional[int] = None,
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        return destination_blocks(self.graph, dests,
                                  self.block if block is None else block,
                                  backend=self.backend, devices=self.devices,
                                  device=self.device)


def build_blocked_routing(g: Graph, block: Optional[int] = None,
                          budget_bytes: int = _BFS_BUDGET_BYTES,
                          diameter: Optional[int] = None,
                          backend: str = "auto",
                          devices: Devices = None,
                          device: DeviceLike = "cuda",
                          ) -> BlockedRouting:
    """Streaming counterpart of `build_routing`: computes the diameter via
    `distance_blocks` (never holding an [n, n] table) and returns a
    `BlockedRouting` whose per-block working set fits `budget_bytes`.

    Same disconnected-graph semantics as `build_routing`: the diameter is
    the largest *finite* distance (UNREACHABLE = -1 never wins the max), and
    path extraction through the blocked builder raises on unreachable
    pairs.  Constructions with a known diameter (any intact ER_q is 2 by
    §IV; PolarStar is 3) can pass `diameter=` to skip the n-source BFS
    sweep -- at PF(157) scale (n = 24807) that sweep costs more than the
    path build it unlocks.  `backend`/`devices`/`device` carry through to
    every column sweep the returned state serves.
    """
    if diameter is None:
        diam = 0
        for _, db, _ in distance_blocks(g, budget_bytes=budget_bytes,
                                        backend=backend, devices=devices,
                                        device=device):
            diam = max(diam, int(db.max()))  # reprolint-torch: allow[host-sync] -- distance_blocks yields numpy blocks (the device backend copies each back once, in blockwise._run_sharded)
    else:
        diam = int(diameter)
    if block is None:
        _, indices = g.csr
        block = dest_block_size(g.n, len(indices),
                                g.padded_neighbors[0].shape[1], budget_bytes)
    return BlockedRouting(graph=g, diameter=diam, block=block,
                          backend=backend, devices=devices, device=device)


def _resolve_engine(engine: str, n: int) -> str:
    if engine == "auto":
        return "dense" if n <= _DENSE_MAX_N else "sparse"
    if engine not in ("dense", "sparse"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


# ----------------------------------------------------------------------------
# single-source + dense reference engine
# ----------------------------------------------------------------------------

def bfs_distances(g: Graph, src: int) -> np.ndarray:
    """Single-source BFS distances (int16, UNREACHABLE = -1)."""
    indptr, indices = g.csr
    dist, _ = _bfs_block(indptr, indices, np.array([src]), False)
    return dist[0]


def all_pairs_distances(g: Graph, engine: str = "auto") -> np.ndarray:  # reprolint-torch: allow[dense-square] -- contract IS the full [n, n] distance matrix; dense branch is the small-n reference engine
    """[n, n] int16 distance matrix (UNREACHABLE = -1 off-diagonal marks
    disconnected pairs).

    engine="dense" runs the boolean-matrix BFS reference: above a size
    threshold the frontier expansion runs as a float32 matmul (BLAS) instead
    of a boolean one -- numpy's bool matmul is a generic inner loop, ~10-20x
    slower at the PF(37+)/PolarStar scales (same reachability either way).
    engine="sparse" assembles the same matrix from the blocked frontier BFS
    in O(block * (n + E)) working memory.  engine="auto" picks by size.
    """
    if _resolve_engine(engine, g.n) == "sparse":
        dist = np.empty((g.n, g.n), dtype=np.int16)
        for srcs, db, _ in distance_blocks(g):
            dist[srcs] = db
        return dist
    n = g.n
    adj = g.adjacency
    adj_f = adj.astype(np.float32) if n >= 512 else None
    dist = np.full((n, n), UNREACHABLE, dtype=np.int16)
    np.fill_diagonal(dist, 0)
    reach = np.eye(n, dtype=bool)
    frontier = np.eye(n, dtype=bool)
    d = 0
    while frontier.any():  # reprolint-torch: allow[host-sync] -- frontier is a numpy bool matrix: the host dense engine, no tensor
        d += 1
        if adj_f is not None:
            grown = frontier.astype(np.float32) @ adj_f > 0.0
        else:
            grown = frontier @ adj
        nxt = grown & ~reach
        dist[nxt] = d
        reach |= nxt
        frontier = nxt
    return dist


def next_hop_table(g: Graph, dist: Optional[np.ndarray] = None,  # reprolint-torch: allow[dense-square] -- contract IS the full [n, n] next-hop table (legacy API); blocked engine backs the sparse branch
                   engine: str = "auto") -> np.ndarray:
    """[n, n] int32 next-hop table for minimal routing on any graph.

    nh[s, d] = neighbor of s on a shortest s->d path (lowest-id tie break;
    deterministic).  nh[s, s] = s; unreachable -> UNREACHABLE (-1).  Both
    engines produce bit-identical tables; the sparse engine recomputes its
    own blocked BFS and ignores `dist`.
    """
    if _resolve_engine(engine, g.n) == "sparse":
        return sparse_routing_tables(g)[1]
    if dist is None:
        dist = all_pairs_distances(g, engine="dense")
    n = g.n
    nh = np.full((n, n), UNREACHABLE, dtype=np.int32)
    np.fill_diagonal(nh, np.arange(n))
    for s in range(n):
        nbs = g.neighbors[s]
        if len(nbs) == 0:
            continue
        # next hop: neighbor v minimizing dist[v, d]
        dn = dist[nbs]  # [deg, n]
        ok = dn != UNREACHABLE
        dn = np.where(ok, dn, _INT16_INF)
        best = np.argmin(dn, axis=0)  # [n]
        cand = nbs[best]
        reachable = dist[s] != UNREACHABLE
        good = dn[best, np.arange(n)] == dist[s] - 1
        nh[s] = np.where(reachable & good, cand, nh[s])
        nh[s, s] = s
    return nh


def polarfly_next_hop_table(pf: PolarFly) -> np.ndarray:
    """Minimal next-hop table for ER_q from the algebraic construction:
    adjacent -> d; non-adjacent -> the unique cross-product intermediate.
    Matches `next_hop_table` up to tie-breaking (PolarFly min paths are unique,
    so it matches exactly for s != d)."""
    n = pf.n
    adj = pf.graph.adjacency
    inter = pf.intermediates_all_pairs()  # [N, N]
    d_ids = np.broadcast_to(np.arange(n, dtype=np.int32), (n, n))
    nh = np.where(adj, d_ids, inter.astype(np.int32))
    np.fill_diagonal(nh, np.arange(n))
    return nh


@dataclass
class RoutingTables:
    """Precomputed routing state used by the simulator and the fabric."""

    graph: Graph
    dist: np.ndarray  # [n, n] int16
    next_hop: np.ndarray  # [n, n] int32 minimal
    diameter: int

    def path(self, s: int, d: int) -> List[int]:
        return minimal_path(self.next_hop, s, d)

    def paths(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Batched minimal paths: [F, diameter + 1] node ids (see
        `minimal_paths`)."""
        return minimal_paths(self.next_hop, src, dst, self.diameter)

    def dest_blocks(self, dests: Optional[np.ndarray] = None,
                    block: Optional[int] = None,
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """`BlockedRouting`-compatible destination-block iteration, served
        by slicing the dense tables.  Fancy indexing copies the selected
        columns, so each yielded block transiently duplicates
        O(block * n * 6) bytes of already-materialized state; the default
        single block is fine for the small-n graphs RoutingTables targets,
        and memory-conscious consumers (the blocked path builder) always
        pass an explicit bounded `block`."""
        if dests is None:
            dests = np.arange(self.graph.n, dtype=np.int64)
        dests = np.asarray(dests, dtype=np.int64).ravel()
        if block is None:
            block = max(len(dests), 1)
        for lo in range(0, len(dests), block):
            dblk = dests[lo:lo + block]
            yield dblk, self.dist[:, dblk], self.next_hop[:, dblk]


def build_routing(g: Graph, pf: Optional[PolarFly] = None,
                  engine: str = "auto") -> RoutingTables:
    """Build routing tables via the dense reference engine or the blocked
    sparse engine (`engine="auto"` picks by size; identical tables either
    way).  When `pf` matches `g`, the dense path uses the O(1) algebraic
    PolarFly table, which coincides with the BFS table entry-for-entry."""
    if _resolve_engine(engine, g.n) == "sparse":
        dist, nh = sparse_routing_tables(g)
    else:
        dist = all_pairs_distances(g, engine="dense")
        if pf is not None and pf.graph is g:
            nh = polarfly_next_hop_table(pf)
        else:
            nh = next_hop_table(g, dist, engine="dense")
    diam = int(dist.max())
    return RoutingTables(graph=g, dist=dist, next_hop=nh, diameter=diam)


def minimal_paths(next_hop: np.ndarray, src: np.ndarray, dst: np.ndarray,
                  diameter: int) -> np.ndarray:
    """Batched minimal-path extraction via next-hop-table gathers.

    Returns [F, diameter + 1] int32 node sequences.  Row i starts at src[i]
    and, after dist(src[i], dst[i]) hops, reaches dst[i]; `next_hop[d, d] = d`
    absorbs, so the remaining columns repeat dst[i] (callers recover hop
    validity as `nodes[:, h] != nodes[:, h + 1]`).  Raises ValueError on any
    unreachable pair.  The whole walk is `diameter` vectorized gathers -- no
    per-flow Python loop; the gather loop itself is the shared stepping core
    (`repro_torch.core.stepping.walk_next_hops`), closed over the dense table here
    and over next-hop columns in the blocked path builder.
    """
    dst = np.asarray(dst, dtype=np.int64).ravel()
    return walk_next_hops(lambda cur: next_hop[cur, dst], src, dst, diameter)


def minimal_path(next_hop: np.ndarray, s: int, d: int) -> List[int]:
    path = [s]
    u = s
    while u != d:
        u = int(next_hop[u, d])
        if u < 0:
            raise ValueError(f"no route {s}->{d}")
        path.append(u)
        if len(path) > next_hop.shape[0]:
            raise RuntimeError("routing loop")
    return path


def valiant_path(rt: RoutingTables, s: int, d: int, rng: np.random.Generator) -> List[int]:
    """General Valiant: random intermediate r != s, d; min(s->r) + min(r->d)."""
    n = rt.graph.n
    while True:
        r = int(rng.integers(n))
        if r != s and r != d:
            break
    p1 = minimal_path(rt.next_hop, s, r)
    p2 = minimal_path(rt.next_hop, r, d)
    return p1 + p2[1:]


def compact_valiant_candidates(rt: RoutingTables, s: int, d: int) -> np.ndarray:
    """Compact Valiant (§VII-B): intermediates drawn from N(s).

    Only valid when s and d are NOT adjacent (otherwise packets can bounce
    back through s); callers must fall back to minimal or general Valiant for
    adjacent pairs.  Excludes neighbors whose min path to d passes back
    through s (cannot happen in PolarFly for non-adjacent s, d; guarded for
    generality)."""
    if rt.dist[s, d] == 1:
        raise ValueError("Compact Valiant is undefined for adjacent pairs")
    nbs = rt.graph.neighbors[s]
    ok = rt.next_hop[nbs, d] != s
    ok &= nbs != d  # r == d is just the minimal path
    return nbs[ok]
