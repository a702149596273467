"""Candidate-path construction for the fluid simulator.

A copy of the JAX package's ``simulation/paths.py`` (numpy on the host,
bit-identical outputs), except that `FlowPaths.device_arrays` returns torch
tensors on a chosen device and `FlowPaths.from_reference` builds a
FlowPaths from the reference's arrays.

Every (flow, candidate) is a fixed-length padded list of *directed link* ids.
Candidate kinds per routing mode (paper §VII):

  min      -- the single minimal path (unique in PolarFly).
  ecmp     -- K random shortest paths (used for fat-tree "non-blocking" min).
  valiant  -- K random intermediates r != s, d; min(s,r) + min(r,d).
  cvaliant -- Compact Valiant: intermediates from N(s), skipping neighbors
              whose min path to d bounces through s; falls back to general
              Valiant for adjacent pairs (paper §VII-B bounce-back rule).
  ugal     -- {min} + valiant candidates (queue-adaptive choice in solver).
  ugal_pf  -- {min} + cvaliant candidates + 2/3 threshold gate in solver.

Three engines build identical outputs:

  * `engine="dense"` (alias `"vectorized"`, the pre-PR-4 name) -- batched
    minimal-path extraction via next-hop gathers over the dense [n, n]
    table (`repro_torch.core.routing.minimal_paths`), CSR binary-search edge-id
    lookups (`DirectedEdges.edge_ids`), destination-blocked ECMP successor
    tables (`_ECMP_BLOCK_MAX_ENTRIES` entries per block), and array-level
    candidate construction (vectorized intermediates, batched segment
    stitching, vectorized bounce-back filtering).  No Python loop over
    flows.  Kept as the small-n reference engine; requires a
    `RoutingTables`.
  * `engine="blocked"` -- the scale engine: candidate sets are built one
    destination block at a time from next-hop *columns*
    (`dest_blocks` on `RoutingTables` / `BlockedRouting`), so no [n, n]
    table is ever required.  Flows group by destination (the
    `_ECMP_BLOCK_MAX_ENTRIES` machinery); min / ECMP / CValiant walks
    route toward in-block destinations directly, and Valiant s->r segments
    re-group by random intermediate for a second sweep of column blocks.
    Only per-flow path arrays ever reach `FlowPaths`
    (`blocked_paths_peak_bytes` estimates the envelope).
  * `engine="reference"` -- the original per-flow scalar loop, kept as the
    executable specification.

`engine="auto"` (the default) picks "dense" when the routing state carries
dense tables (`RoutingTables`) and "blocked" when it streams
(`BlockedRouting`).  All engines consume the same pre-drawn randomness
(`_draw_randomness`), so for any (pattern, mode, k, seed) they produce
bit-identical edges/hops/valid/is_min/first_edge -- see
tests/test_simulation.py and tests/test_blocked_paths.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

import torch

from ..core.graph import Graph
from ..core.routing import (RoutingTables, dest_block_peak_bytes,
                            minimal_path, minimal_paths)
from ..core.stepping import (edge_walk, successor_tables, walk_next_hops,
                             walk_successors)
from ..parallel.blockwise import (DEFAULT_BUDGET_BYTES, block_size_for_budget,
                                  peak_bytes, plan_blocks, run_blocks)
from .traffic import TrafficPattern

__all__ = ["DirectedEdges", "FlowPaths", "build_directed_edges",
           "build_flow_paths", "build_flow_paths_chunks",
           "build_flow_paths_reference", "blocked_paths_peak_bytes"]

# Absolute padded-incidence entry cap for FlowPaths.device_arrays: beyond
# 4 * nnz the padded gather matrix wastes memory on incidence skew, but up
# to this many entries (128 MiB of int32) the ~5x gather-vs-scatter-add
# speed (measured on XLA:CPU for the JAX package) is worth the waste -- the scale-tier adaptive solves
# (e.g. PS(9,61) UGAL_PF, ~18M entries) would otherwise fall onto the
# serialized scatter path and run ~5x slower per Frank-Wolfe step.
_INC_PAD_MAX_ENTRIES = 32_000_000


@dataclass
class DirectedEdges:
    """Directed-link id space: id = offset[u] + position of v in neighbors[u]."""
    offsets: np.ndarray  # [n+1]
    targets: np.ndarray  # [E_dir]
    num: int
    _table: Optional[np.ndarray] = field(default=None, repr=False)
    _keys: Optional[np.ndarray] = field(default=None, repr=False)
    _nb_pad: Optional[Tuple[np.ndarray, np.ndarray]] = field(default=None,
                                                             repr=False)

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    @property
    def table(self) -> np.ndarray:  # reprolint-torch: allow[dense-square] -- lazy small-n reference view; nothing on the path-construction hot path touches it
        """Dense [n, n] int32 lookup: table[u, v] = directed edge id, -1 if
        (u, v) is not an edge.  Built lazily, O(n^2) memory.  Kept as the
        small-n reference view; nothing on the path-construction hot path
        uses it (see `edge_ids`)."""
        if self._table is None:
            n = self.n
            t = -np.ones((n, n), dtype=np.int32)
            srcs = np.repeat(np.arange(n), np.diff(self.offsets))
            t[srcs, self.targets] = np.arange(self.num, dtype=np.int32)
            self._table = t
        return self._table

    @property
    def keys(self) -> np.ndarray:
        """[E_dir] int64 sorted key u * n + v per directed edge.  The CSR
        layout is row-major with sorted neighbor rows, so the edge id of
        (u, v) is exactly its position in this sorted key array."""
        if self._keys is None:
            srcs = np.repeat(np.arange(self.n, dtype=np.int64),
                             np.diff(self.offsets))
            self._keys = srcs * self.n + self.targets
        return self._keys

    def edge_ids(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Vectorized lookup; -1 where (u, v) is not an edge.  A CSR binary
        search (global searchsorted over the sorted edge keys) -- O(n^2)
        dense tables are never needed."""
        qa = np.asarray(u, dtype=np.int64) * self.n + np.asarray(v)
        if self.num == 0:
            return np.full(qa.shape, -1, dtype=np.int32)  # reprolint-torch: allow[sentinel] -- -1 here means 'no such directed edge' (lookup miss), not an unreachable distance
        q = qa.ravel()
        pos = np.searchsorted(self.keys, q)
        safe = np.minimum(pos, self.num - 1)
        hit = self.keys[safe] == q
        return np.where(hit, safe, -1).astype(np.int32).reshape(qa.shape)

    def edge_id(self, u: int, v: int) -> int:
        """Scalar fallback (CSR binary search; no dense table needed)."""
        nb = self.targets[self.offsets[u]:self.offsets[u + 1]]
        i = int(np.searchsorted(nb, v))
        if i >= len(nb) or nb[i] != v:
            raise ValueError(f"no edge {u}->{v}")
        return int(self.offsets[u] + i)

    def padded_neighbors(self) -> Tuple[np.ndarray, np.ndarray]:
        """([n, deg_max] int32 neighbor matrix padded with -1, [n] degrees).

        `build_directed_edges` seeds this from `Graph.padded_neighbors`
        (cached once per graph); the fallback below only runs for
        hand-constructed instances."""
        if self._nb_pad is None:
            deg = np.diff(self.offsets)
            dmax = int(deg.max()) if len(deg) else 0
            nb = -np.ones((self.n, dmax), dtype=np.int32)
            if dmax:
                rows = np.repeat(np.arange(self.n), deg)
                cols = np.arange(self.num) - np.repeat(self.offsets[:-1], deg)
                nb[rows, cols] = self.targets
            self._nb_pad = (nb, deg.astype(np.int64))
        return self._nb_pad


def build_directed_edges(g: Graph) -> DirectedEdges:
    # the directed edge id space IS the graph's CSR layout; the padded
    # neighbor view is shared with the graph's per-instance cache
    indptr, indices = g.csr
    return DirectedEdges(indptr, indices, int(indptr[-1]),
                         _nb_pad=g.padded_neighbors)


@dataclass
class FlowPaths:
    """[F, K, L] edge ids (-1 padded), per-candidate hop counts, validity."""
    pattern: TrafficPattern
    edges: np.ndarray  # [F, K, L] int32, -1 pad
    hops: np.ndarray  # [F, K] int32 (0 => invalid candidate)
    valid: np.ndarray  # [F, K] bool
    is_min: np.ndarray  # [F, K] bool (candidate 0 for min-containing modes)
    first_edge: np.ndarray  # [F] int32 first link of the *min* path (UGAL gate)
    num_links: int
    mode: str
    _device: Dict[str, tuple] = field(default_factory=dict, repr=False,
                                      compare=False)

    def device_arrays(self, device) -> tuple:
        """Solver-ready torch tensors of the path arrays on `device`, cached
        on the instance per device so repeated solver calls (bisection
        probes, latency sweeps) skip both the host-side preprocessing and
        the host->device copies.

        Returns (eidx, loads_rep, valid, is_min, first_edge, demand, hops):

          eidx      [F, K, L] int32 -- edge ids with -1 pads remapped to
                    `num_links`, so gathers from a length num_links+1 table
                    land on a zero pad slot (no masking multiply needed).
          loads_rep -- incidence structure for link-load accumulation:
                    ("pad", inc [E, W] int32) gathers each edge's candidate
                    weights from a padded per-edge incidence matrix (pad
                    index F*K -> appended zero weight) and accumulates
                    edge-locally.  ("scatter",) falls back to `index_add_`
                    when padding would blow up (pathologically skewed
                    incidence counts, past `_INC_PAD_MAX_ENTRIES`).
          valid, is_min [F, K] bool; first_edge [F] int32;
          demand    [F] float32 -- cast on entry: every solver tensor is
                    float32, as the JAX package pins it;
          hops      [F, K] int32 per-candidate hop counts.

        The same host preprocessing as the JAX package's `device_arrays`,
        so the incidence matrix is bit-identical to the reference's.  The
        edge ids are range-checked here, once, on the host: the CUDA
        path-cost kernel trusts them (checking per call would sync).
        """
        dev = torch.device(device)
        key = str(dev)
        if key not in self._device:
            f, k, l = self.edges.shape
            flat = self.edges.reshape(-1)
            if flat.size and (flat.min() < -1 or flat.max() >= self.num_links):
                raise ValueError("edge ids must lie in [-1, num_links)")
            real = flat >= 0
            nnz = int(real.sum())
            fk = np.repeat(np.arange(f * k, dtype=np.int32), l)[real]
            e_of = flat[real]
            order = np.argsort(e_of, kind="stable")
            counts = np.bincount(e_of, minlength=self.num_links)
            w_max = int(counts.max()) if nnz else 0
            if self.num_links * w_max <= max(4 * nnz, _INC_PAD_MAX_ENTRIES):
                inc = np.full((self.num_links, w_max), f * k, dtype=np.int32)
                cols = np.concatenate([np.arange(c) for c in counts]) \
                    if nnz else np.zeros(0, dtype=np.int64)
                inc[e_of[order], cols] = fk[order]
                loads_rep = ("pad", torch.from_numpy(inc).to(dev))
            else:
                loads_rep = ("scatter",)
            eidx = np.where(self.edges >= 0, self.edges, self.num_links)

            def put(a, dtype):
                return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

            self._device[key] = (put(eidx, np.int32), loads_rep,
                                 put(self.valid, np.bool_),
                                 put(self.is_min, np.bool_),
                                 put(self.first_edge, np.int32),
                                 put(self.pattern.demand, np.float32),
                                 put(self.hops, np.int32))
        return self._device[key]

    @classmethod
    def from_reference(cls, arrays: Dict[str, np.ndarray], num_links: int,
                       mode: str, demand: np.ndarray) -> "FlowPaths":
        """Build the port's FlowPaths from the JAX package's FlowPaths
        arrays, so both solvers can be fed identical inputs.

        `arrays` holds the reference's ``edges``, ``hops``, ``valid``,
        ``is_min`` and ``first_edge`` fields and its pattern's ``src`` and
        ``dst``, as numpy arrays; `demand` is its ``pattern.demand``.  The
        arrays are copied and cast to the canonical dtypes.
        """
        pat = TrafficPattern("reference", arrays["src"], arrays["dst"],
                             demand, 0)
        return cls(pattern=pat,
                   edges=np.array(arrays["edges"], dtype=np.int32),
                   hops=np.array(arrays["hops"], dtype=np.int32),
                   valid=np.array(arrays["valid"], dtype=bool),
                   is_min=np.array(arrays["is_min"], dtype=bool),
                   first_edge=np.array(arrays["first_edge"], dtype=np.int32),
                   num_links=int(num_links), mode=mode)

    @classmethod
    def concat(cls, chunks: Sequence["FlowPaths"]) -> "FlowPaths":
        """Assemble one FlowPaths from chunks built over disjoint flow
        batches of the same graph / mode / candidate count (pad widths may
        differ; shorter chunks are -1-padded up).

        This is the incremental-assembly hook for the blocked builder:
        callers can construct paths one traffic shard at a time and either
        concatenate explicitly or hand the chunk list straight to any fluid
        entry point (`evaluate_load`, `saturation_throughput`,
        `latency_curve`, `truncation_error`), which normalizes through this
        method.
        """
        chunks = list(chunks)
        if not chunks:
            raise ValueError("no FlowPaths chunks to concatenate")
        first = chunks[0]
        if len(chunks) == 1:
            return first
        if any(c.mode != first.mode or c.num_links != first.num_links
               or c.edges.shape[1] != first.edges.shape[1] for c in chunks):
            raise ValueError(
                "FlowPaths chunks disagree on mode / link space / candidates")
        lmax = max(c.edges.shape[2] for c in chunks)
        edges = np.concatenate(
            [np.pad(c.edges, ((0, 0), (0, 0), (0, lmax - c.edges.shape[2])),
                    constant_values=-1) for c in chunks])
        pat = TrafficPattern(
            first.pattern.name,
            np.concatenate([c.pattern.src for c in chunks]),
            np.concatenate([c.pattern.dst for c in chunks]),
            np.concatenate([c.pattern.demand for c in chunks]),
            first.pattern.endpoints_per_router)
        return cls(pattern=pat, edges=edges,
                   hops=np.concatenate([c.hops for c in chunks]),
                   valid=np.concatenate([c.valid for c in chunks]),
                   is_min=np.concatenate([c.is_min for c in chunks]),
                   first_edge=np.concatenate([c.first_edge for c in chunks]),
                   num_links=first.num_links, mode=first.mode)


# --------------------------------------------------------------------------
# shared mode layout + randomness (consumed identically by both engines)
# --------------------------------------------------------------------------

def _mode_layout(mode: str, k_candidates: int):
    """(include_min, alt_kind, k_alt, k_total) for a routing mode."""
    if mode not in ("min", "ecmp", "valiant", "cvaliant", "ugal", "ugal_pf"):
        raise ValueError(f"unknown routing mode {mode!r}")
    include_min = mode in ("min", "ugal", "ugal_pf")
    alt_kind = {"min": None, "ecmp": "ecmp", "valiant": "valiant",
                "cvaliant": "cvaliant", "ugal": "valiant",
                "ugal_pf": "cvaliant"}[mode]
    k_alt = 0 if alt_kind in (None, "ecmp") else k_candidates
    if mode == "ecmp":
        k_total = k_candidates
    else:
        k_total = (1 if include_min else 0) + k_alt
    return include_min, alt_kind, k_alt, k_total


def _draw_randomness(rng: np.random.Generator, alt_kind: Optional[str],
                     f: int, k: int, n: int, deg_max: int,
                     depth: int) -> Dict[str, np.ndarray]:
    """All random draws, generated up front in a fixed order.

    ecmp      -> U [F, K, depth]  uniform (depth = diameter, the max hops a
                 shortest path can take); hop h picks good-neighbor index
                 floor(U * count).
    valiant   -> RV [F, K]     integers in [0, n-2); mapped to r != s, d by
                 the order-statistics skip trick (no rejection loop).
    cvaliant  -> RV (adjacent-pair Valiant fallback) + KEYS [F, deg_max]
                 uniform sort keys selecting min(k, #cands) intermediates
                 from N(s) without replacement.
    """
    draws: Dict[str, np.ndarray] = {}
    if alt_kind == "ecmp":
        draws["U"] = rng.random((f, k, depth))
    elif alt_kind == "valiant":
        draws["RV"] = rng.integers(max(n - 2, 1), size=(f, k))
    elif alt_kind == "cvaliant":
        draws["RV"] = rng.integers(max(n - 2, 1), size=(f, k))
        draws["KEYS"] = rng.random((f, deg_max))
    return draws


def _skip2(u, s, d):
    """Map u in [0, n-2) to r in [0, n) with r != s and r != d (s != d)."""
    lo = np.minimum(s, d)
    hi = np.maximum(s, d)
    r = u + (u >= lo)
    return r + (r >= hi)


# --------------------------------------------------------------------------
# vectorized engine
# --------------------------------------------------------------------------

def _batched_path_edges(rt: RoutingTables, de: DirectedEdges,
                        src: np.ndarray, dst: np.ndarray):
    """Minimal paths for F (src, dst) pairs -> ([F, diameter] edge ids, -1
    padded; [F] hop counts)."""
    nodes = minimal_paths(rt.next_hop, src, dst, rt.diameter)  # [F, D+1]
    return edge_walk(de.edge_ids, nodes)


def _stitch(seg1_e, h1, seg2_e, lmax: int) -> np.ndarray:
    """Concatenate per-row edge segments: seg2 starts at column h1[row].

    seg1_e/seg2_e are [R, D] (-1 padded); result is [R, lmax].  Positions
    h1 + j for j >= hops(seg2) receive seg2's -1 pad, which is what the
    result should hold there anyway, so a single scatter suffices.
    """
    r, dmax = seg1_e.shape
    out = -np.ones((r, lmax), dtype=np.int32)
    out[:, :dmax] = seg1_e
    cols = h1[:, None].astype(np.int64) + np.arange(seg2_e.shape[1])[None, :]
    np.put_along_axis(out, cols, seg2_e, axis=1)
    return out


def _vectorized_valiant(rt, de, src, dst, rv, lmax):
    """[F, K] intermediates from RV -> ([F, K, lmax] edges, [F, K] hops)."""
    f, k = rv.shape
    s_b = np.broadcast_to(src[:, None], (f, k)).ravel()
    d_b = np.broadcast_to(dst[:, None], (f, k)).ravel()
    r_b = _skip2(rv.ravel(), s_b, d_b)
    e1, h1 = _batched_path_edges(rt, de, s_b, r_b)
    e2, h2 = _batched_path_edges(rt, de, r_b, d_b)
    edges = _stitch(e1, h1, e2, lmax).reshape(f, k, lmax)
    return edges, (h1 + h2).reshape(f, k).astype(np.int32)


def _vectorized_cvaliant_select(rt, de, src, dst, keys):
    """Bounce-back-filtered intermediate selection from N(s), vectorized.

    Returns ([F, K] selected neighbors, -1 pad; [F] candidate counts) where
    K = keys-implied k_alt is applied by the caller (we return the full key
    ordering and let the caller slice)."""
    nb, deg = de.padded_neighbors()  # [n, dmax]
    nb_s = nb[src]  # [F, dmax]
    present = nb_s >= 0
    safe_nb = np.where(present, nb_s, 0)
    ok = present & (rt.next_hop[safe_nb, dst[:, None]] != src[:, None]) \
        & (nb_s != dst[:, None])
    cnt = ok.sum(axis=1).astype(np.int64)
    masked = np.where(ok, keys[:, :nb.shape[1]], np.inf)
    order = np.argsort(masked, axis=1, kind="stable")  # valid slots first
    return np.take_along_axis(nb_s, order, axis=1), cnt


def _cvaliant_assemble(de: DirectedEdges, s_arr: np.ndarray,
                       d_arr: np.ndarray, sel_nb: np.ndarray,
                       cnt: np.ndarray, k_alt: int, lmax: int, walk):
    """Shared Compact-Valiant slot machinery (both batched engines).

    Truncates the filtered intermediate ordering to k_alt slots (k_alt may
    exceed deg_max -- the extra slots can never hold a candidate), fills
    empty slots with the route-safe destination, builds each candidate as
    the s->r first hop plus the walked min(r -> d) segment, and masks
    everything back to the slot validity.  `walk(srcs, dsts) -> ([R, D]
    edge ids, [R] hops)` is the only engine-specific piece
    (`_batched_path_edges` on the dense table, `_walk_edges_block` on a
    column block).  Returns (edges [F, K, lmax], hops [F, K], valid [F, K]).
    """
    fb = len(s_arr)
    k_take = min(k_alt, sel_nb.shape[1])
    sel = np.full((fb, k_alt), -1, dtype=np.int64)  # reprolint-torch: allow[sentinel] -- -1 pads empty candidate slots; masked out by slot_ok before use
    sel[:, :k_take] = sel_nb[:, :k_take]
    n_sel = np.minimum(cnt, k_alt)  # [F]
    slot_ok = np.arange(k_alt)[None, :] < n_sel[:, None]  # [F, K]  # reprolint-torch: allow[dense-square] -- [F, K] flow-by-candidate mask (K = k_alt, small constant), not an [n, n] matrix
    safe_sel = np.where(slot_ok, sel, d_arr[:, None])  # route-safe filler
    d_rep = np.broadcast_to(d_arr[:, None], (fb, k_alt)).reshape(-1)
    e2, h2 = walk(safe_sel.reshape(-1), d_rep)
    e0 = de.edge_ids(s_arr[:, None], safe_sel)  # [F, K] first hop s->r
    ec = -np.ones((fb * k_alt, lmax), dtype=np.int32)
    ec[:, 0] = e0.reshape(-1)
    ec[:, 1:1 + e2.shape[1]] = e2
    ec = ec.reshape(fb, k_alt, lmax)
    hc = (1 + h2).reshape(fb, k_alt).astype(np.int32)
    return (np.where(slot_ok[:, :, None], ec, np.int32(-1)),
            np.where(slot_ok, hc, 0).astype(np.int32), slot_ok.copy())


# Entry budget for one destination block of the shortest-path-successor
# table: flows are grouped by destination and each block builds a
# [n, B, deg_max] table, with B sized so the block never exceeds this many
# entries (memory stays bounded at any graph size; B >= n degenerates to the
# old whole-table fast path).
_ECMP_BLOCK_MAX_ENTRIES = 16_000_000


def _dest_block(n: int, deg_max: int) -> int:
    """Destinations per block so per-block tables stay under the entry cap
    (shared by the ECMP successor tables and the blocked engine's column
    consumption; B >= n degenerates to one whole-table block)."""
    return max(1, _ECMP_BLOCK_MAX_ENTRIES // max(1, n * max(deg_max, 1)))


def _ecmp_walk_block(dist_cols: np.ndarray, nb: np.ndarray,
                     present: np.ndarray, safe_nb: np.ndarray,
                     src_f: np.ndarray, d_f: np.ndarray, l_f: np.ndarray,
                     u_f: np.ndarray, k: int, diam: int) -> np.ndarray:
    """One destination block of the ECMP walk.

    `dist_cols` is the block's [n, B] distance columns (a dense-table slice
    or a blocked-BFS product -- bit-identical either way).  Successor-table
    construction and the hop-by-hop walk both live in the shared stepping
    core (`repro_torch.core.stepping`), which the JAX package's packet engine consumes too;
    this wrapper just binds the two calls.  Returns [Fb, k, diam] int64
    node walks (source column excluded).
    """
    succ, cnt_t = successor_tables(dist_cols, nb, present, safe_nb)
    return walk_successors(succ, cnt_t, src_f, d_f, l_f, u_f, k, diam)


def _ecmp_nodes(rt: RoutingTables, de: DirectedEdges, src: np.ndarray,
                dst: np.ndarray, u_draw: np.ndarray, k: int) -> np.ndarray:
    """K random shortest paths per flow -> [F, K, diameter + 1] node walks.

    Hop h of candidate (i, c) picks good-neighbor index
    floor(U[i, c, h] * count) among the neighbors of the current node that
    make progress toward dst[i], in sorted-neighbor order (matching the
    scalar reference exactly).

    Successor tables are destination-blocked (`_ecmp_walk_block`): flows are
    grouped by destination, and each group of B destinations builds its
    tables from the dense table's column slice, then walks its flows.
    Every flow's walk is independent and consumes its own pre-drawn
    randomness, so the grouping changes nothing about the output -- it only
    caps the table memory at `_ECMP_BLOCK_MAX_ENTRIES` entries per block.
    """
    f = len(src)
    nb, _ = de.padded_neighbors()
    n, dmax = nb.shape
    nodes = np.empty((f, k, rt.diameter + 1), dtype=np.int64)
    nodes[:, :, 0] = np.broadcast_to(src[:, None], (f, k))
    present = nb >= 0
    safe_nb = np.where(present, nb, 0)
    uniq, inv = np.unique(dst, return_inverse=True)
    bdst = _dest_block(n, dmax)
    for lo in range(0, len(uniq), bdst):
        dblk = uniq[lo:lo + bdst].astype(np.int64)  # [B] destinations
        fsel = np.flatnonzero((inv >= lo) & (inv < lo + len(dblk)))
        nodes[fsel, :, 1:] = _ecmp_walk_block(
            rt.dist[:, dblk], nb, present, safe_nb, src[fsel], dst[fsel],
            inv[fsel] - lo, u_draw[fsel], k, rt.diameter)
    return nodes


def _build_vectorized(rt: RoutingTables, pattern: TrafficPattern, mode: str,
                      k_candidates: int, seed: int) -> FlowPaths:
    rng = np.random.default_rng(seed)
    de = build_directed_edges(rt.graph)
    n = rt.graph.n
    f = pattern.num_flows
    src = pattern.src.astype(np.int64)
    dst = pattern.dst.astype(np.int64)

    include_min, alt_kind, k_alt, k_total = _mode_layout(mode, k_candidates)
    lmax = 2 * max(2, rt.diameter)
    _, deg = de.padded_neighbors()
    draws = _draw_randomness(rng, alt_kind, f, k_total if mode == "ecmp" else k_alt,
                             n, int(deg.max()) if len(deg) else 0,
                             rt.diameter)

    edges = -np.ones((f, k_total, lmax), dtype=np.int32)
    hops = np.zeros((f, k_total), dtype=np.int32)
    valid = np.zeros((f, k_total), dtype=bool)
    is_min = np.zeros((f, k_total), dtype=bool)

    min_e, min_h = _batched_path_edges(rt, de, src, dst)  # [F, D], [F]
    first_edge = min_e[:, 0].copy()
    col = 0
    if include_min:
        edges[:, 0, :min_e.shape[1]] = min_e
        hops[:, 0] = min_h
        valid[:, 0] = True
        is_min[:, 0] = True
        col = 1

    if mode == "ecmp":
        nodes = _ecmp_nodes(rt, de, src, dst, draws["U"], k_total)
        e, h = edge_walk(de.edge_ids, nodes)
        edges[:, :, :e.shape[2]] = e
        hops[:, :] = h
        valid[:, :] = True
        is_min[:, :] = True
    elif alt_kind == "valiant":
        e, h = _vectorized_valiant(rt, de, src, dst, draws["RV"], lmax)
        edges[:, col:col + k_alt] = e
        hops[:, col:col + k_alt] = h
        valid[:, col:col + k_alt] = True
    elif alt_kind == "cvaliant":
        # non-adjacent rows: intermediates from N(s); adjacent rows fall back
        # to general Valiant (paper §VII-B), computed only for those rows
        # (indexing the pre-drawn RV keeps outputs bit-identical).
        sel_nb, cnt = _vectorized_cvaliant_select(rt, de, src, dst,
                                                  draws["KEYS"])
        edges_blk, hops_blk, valid_blk = _cvaliant_assemble(
            de, src, dst, sel_nb, cnt, k_alt, lmax,
            lambda s, d: _batched_path_edges(rt, de, s, d))
        adj = rt.dist[src, dst] == 1  # [F]
        if adj.any():
            ev, hv = _vectorized_valiant(rt, de, src[adj], dst[adj],
                                         draws["RV"][adj], lmax)
            edges_blk[adj] = ev
            hops_blk[adj] = hv
            valid_blk[adj] = True
        edges[:, col:col + k_alt] = edges_blk
        hops[:, col:col + k_alt] = hops_blk
        valid[:, col:col + k_alt] = valid_blk

    return FlowPaths(pattern=pattern, edges=edges, hops=hops, valid=valid,
                     is_min=is_min, first_edge=first_edge, num_links=de.num,
                     mode=mode)


# --------------------------------------------------------------------------
# destination-blocked engine (no [n, n] table anywhere)
# --------------------------------------------------------------------------

def _walk_edges_block(de: DirectedEdges, nh_cols: np.ndarray,
                      srcs: np.ndarray, ld: np.ndarray, dsts: np.ndarray,
                      diameter: int) -> Tuple[np.ndarray, np.ndarray]:
    """Blocked analogue of `_batched_path_edges`: walk each row from
    srcs[i] toward dsts[i] using the destination's next-hop *column*
    nh_cols[:, ld[i]].  Returns ([R, diameter] edge ids, -1 padded; [R] hop
    counts); raises ValueError on unreachable pairs / diameter overruns with
    the same messages as `minimal_paths` (both ride
    `repro_torch.core.stepping.walk_next_hops`)."""
    nodes = walk_next_hops(lambda cur: nh_cols[cur, ld], srcs, dsts,
                           diameter)
    return edge_walk(de.edge_ids, nodes)


def _cvaliant_select_block(nh_cols: np.ndarray, nb: np.ndarray,
                           src_f: np.ndarray, d_f: np.ndarray,
                           l_f: np.ndarray, keys_f: np.ndarray):
    """`_vectorized_cvaliant_select` on one destination block's next-hop
    columns: bounce-back-filtered intermediate ordering from N(s)."""
    nb_s = nb[src_f]  # [Fb, dmax]
    present = nb_s >= 0
    safe_nb = np.where(present, nb_s, 0)
    ok = present & (nh_cols[safe_nb, l_f[:, None]] != src_f[:, None]) \
        & (nb_s != d_f[:, None])
    cnt = ok.sum(axis=1).astype(np.int64)
    masked = np.where(ok, keys_f[:, :nb.shape[1]], np.inf)
    order = np.argsort(masked, axis=1, kind="stable")  # valid slots first
    return np.take_along_axis(nb_s, order, axis=1), cnt


def _per_flow_bytes(mode: str, k_candidates: int = 8,
                    diameter: int = 2) -> int:
    """Bytes one flow contributes to a blocked path build: the [F, K, L]
    int32 edges + hops/valid/is_min (+ first_edge/min scratch), plus
    Valiant/CValiant segment scratch and intermediate bookkeeping.  Shared
    by the peak estimator and the flow-chunk sizing of
    `build_flow_paths_chunks`."""
    _, alt_kind, k_alt, k_total = _mode_layout(mode, k_candidates)
    lmax = 2 * max(2, diameter)
    per_flow = k_total * (4 * lmax + 6) + 12 + 4 * max(diameter, 1)
    if alt_kind in ("valiant", "cvaliant"):
        # e1/e2 segment scratch + intermediate bookkeeping per candidate
        per_flow += k_alt * (8 * max(diameter, 1) + 16)
    return per_flow


def blocked_paths_peak_bytes(n: int, e_dir: int, deg_max: int,
                             num_flows: int, mode: str = "min",
                             k_candidates: int = 8, diameter: int = 2,
                             block: Optional[int] = None) -> int:
    """Estimated peak bytes of a destination-blocked `build_flow_paths` run:
    the per-flow candidate arrays plus one destination block's transient
    working set (routing columns, successor tables, segment scratch).  No
    term scales as [n, n] -- flow memory is proportional to the flow batch
    and block memory to the `_ECMP_BLOCK_MAX_ENTRIES` budget, which is what
    lets the scale tier route inside the 2 GiB test envelope
    (tests/test_blocked_paths.py).  Composed from the shared accounting
    helper in `repro_torch.parallel.blockwise` (`peak_bytes`), like the routing
    estimators it rides on."""
    dmax = max(deg_max, 1)
    if block is None:
        block = _dest_block(n, dmax)
    # succ/cnt/order tables (ecmp) or the column-derivation gather -- both
    # bounded by the same block * n * deg_max entry budget
    table = 15 * block * n * dmax if mode == "ecmp" else 0
    return peak_bytes(
        num_flows, _per_flow_bytes(mode, k_candidates, diameter),
        resident_bytes=table + dest_block_peak_bytes(n, e_dir, deg_max,
                                                     block))


def _build_blocked(rt, pattern: TrafficPattern, mode: str,
                   k_candidates: int, seed: int,
                   draws: Optional[Dict[str, np.ndarray]] = None
                   ) -> FlowPaths:
    """Destination-blocked candidate construction (`engine="blocked"`).

    `rt` is anything with the `dest_blocks` protocol (`RoutingTables` slices
    its dense tables; `BlockedRouting` recomputes columns from the blocked
    BFS).  Pass 1 groups flows by destination and consumes one column block
    at a time: min walks (and the UGAL first edge), ECMP walks, CValiant
    intermediate selection and every r->d segment route toward an in-block
    destination.  Valiant s->r segments route toward random intermediates
    instead, so pass 2 re-groups those segments by intermediate and walks
    them from a second sweep of column blocks -- only destinations that
    actually appear in the flow batch (or its intermediate draws) are ever
    BFSed.  Randomness is pre-drawn identically to the other engines, so
    outputs are bit-identical for equal arguments; `build_flow_paths_chunks`
    passes row slices of a full-batch draw via `draws`, which is what makes
    chunked assembly bit-identical to the monolithic build.
    """
    g = rt.graph
    de = build_directed_edges(g)
    n = g.n
    f = pattern.num_flows
    src = pattern.src.astype(np.int64)
    dst = pattern.dst.astype(np.int64)

    include_min, alt_kind, k_alt, k_total = _mode_layout(mode, k_candidates)
    diam = rt.diameter
    lmax = 2 * max(2, diam)
    nb, deg = de.padded_neighbors()
    dmax = int(deg.max()) if len(deg) else 0
    if draws is None:
        draws = _draw_randomness(np.random.default_rng(seed), alt_kind, f,
                                 k_total if mode == "ecmp" else k_alt,
                                 n, dmax, diam)

    edges = -np.ones((f, k_total, lmax), dtype=np.int32)
    hops = np.zeros((f, k_total), dtype=np.int32)
    valid = np.zeros((f, k_total), dtype=bool)
    is_min = np.zeros((f, k_total), dtype=bool)

    present = nb >= 0
    safe_nb = np.where(present, nb, 0)
    # destinations per column block: the successor/column entry cap, further
    # tightened by the routing state's own byte-budget block when it has one
    # (BlockedRouting carries the bfs budget; RoutingTables slices for free)
    block = _dest_block(n, dmax)
    rt_block = getattr(rt, "block", None)
    if rt_block is not None:
        block = min(block, rt_block)
    col = 1 if include_min else 0

    min_e = np.full((f, diam), -1, dtype=np.int32)  # reprolint-torch: allow[sentinel] -- -1 pads unused hop slots of the [F, diam] edge matrix; consumers mask on hop count
    min_h = np.zeros(f, dtype=np.int32)
    if alt_kind in ("valiant", "cvaliant"):
        s_rep = np.broadcast_to(src[:, None], (f, k_alt)).reshape(-1)
        d_rep = np.broadcast_to(dst[:, None], (f, k_alt)).reshape(-1)
        r_all = _skip2(draws["RV"].reshape(-1), s_rep, d_rep)  # [F * K]
        e2 = -np.ones((f * k_alt, diam), dtype=np.int32)  # r->d segments
        h2 = np.zeros(f * k_alt, dtype=np.int32)
        adj = np.zeros(f, dtype=bool)

    # ---- pass 1: flow-destination blocks --------------------------------
    uniq, inv = np.unique(dst, return_inverse=True)
    off = 0
    for dblk, dist_cols, nh_cols in rt.dest_blocks(uniq, block):
        b = len(dblk)
        fsel = np.flatnonzero((inv >= off) & (inv < off + b))
        ld = inv[fsel] - off
        s_f, d_f = src[fsel], dst[fsel]
        fb = len(fsel)
        me, mh = _walk_edges_block(de, nh_cols, s_f, ld, d_f, diam)
        min_e[fsel] = me
        min_h[fsel] = mh
        if mode == "ecmp":
            walk = _ecmp_walk_block(dist_cols, nb, present, safe_nb, s_f,
                                    d_f, ld, draws["U"][fsel], k_total, diam)
            nodes = np.concatenate(
                [np.broadcast_to(s_f[:, None, None], (fb, k_total, 1)),
                 walk], axis=2)
            e, h = edge_walk(de.edge_ids, nodes)
            edges[fsel, :, :e.shape[2]] = e
            hops[fsel] = h
            valid[fsel] = True
            is_min[fsel] = True
        elif alt_kind == "cvaliant":
            adj[fsel] = dist_cols[s_f, ld] == 1
            sel_nb, cnt = _cvaliant_select_block(nh_cols, nb, s_f, d_f, ld,
                                                 draws["KEYS"][fsel])
            ld_rep = np.repeat(ld, k_alt)
            eb, hb, vb = _cvaliant_assemble(
                de, s_f, d_f, sel_nb, cnt, k_alt, lmax,
                lambda s, d: _walk_edges_block(de, nh_cols, s, ld_rep, d,
                                               diam))
            edges[fsel, col:col + k_alt] = eb
            hops[fsel, col:col + k_alt] = hb
            valid[fsel, col:col + k_alt] = vb
        if alt_kind in ("valiant", "cvaliant") and k_alt:
            # r->d second segments (general Valiant, or the adjacent-pair
            # Compact Valiant fallback): d is in this block
            rows_f = fsel if alt_kind == "valiant" else fsel[adj[fsel]]
            if len(rows_f):
                seg = (rows_f[:, None] * k_alt
                       + np.arange(k_alt)[None, :]).reshape(-1)
                ld_seg = np.broadcast_to(
                    (inv[rows_f] - off)[:, None],
                    (len(rows_f), k_alt)).reshape(-1)
                e2b, h2b = _walk_edges_block(de, nh_cols, r_all[seg], ld_seg,
                                             d_rep[seg], diam)
                e2[seg] = e2b
                h2[seg] = h2b
        off += b

    # ---- pass 2: Valiant s->r segments, grouped by intermediate ---------
    if alt_kind in ("valiant", "cvaliant") and k_alt:
        if alt_kind == "valiant":
            seg = np.arange(f * k_alt)
        else:
            seg = (np.flatnonzero(adj)[:, None] * k_alt
                   + np.arange(k_alt)[None, :]).reshape(-1)
        if len(seg):
            e1 = np.empty((len(seg), diam), dtype=np.int32)
            h1 = np.empty(len(seg), dtype=np.int32)
            r_seg, s_seg = r_all[seg], s_rep[seg]
            uniq_r, inv_r = np.unique(r_seg, return_inverse=True)
            off_r = 0
            for dblk, _, nh_cols in rt.dest_blocks(uniq_r, block):
                b = len(dblk)
                ssel = np.flatnonzero((inv_r >= off_r) & (inv_r < off_r + b))
                e1[ssel], h1[ssel] = _walk_edges_block(
                    de, nh_cols, s_seg[ssel], inv_r[ssel] - off_r,
                    r_seg[ssel], diam)
                off_r += b
            ev = _stitch(e1, h1, e2[seg], lmax)
            hv = (h1 + h2[seg]).astype(np.int32)
            rows, cols = seg // k_alt, col + (seg % k_alt)
            edges[rows, cols] = ev
            hops[rows, cols] = hv
            valid[rows, cols] = True

    first_edge = (min_e[:, 0].copy() if min_e.shape[1]
                  else np.zeros(f, dtype=np.int32))
    if include_min:
        edges[:, 0, :min_e.shape[1]] = min_e
        hops[:, 0] = min_h
        valid[:, 0] = True
        is_min[:, 0] = True
    return FlowPaths(pattern=pattern, edges=edges, hops=hops, valid=valid,
                     is_min=is_min, first_edge=first_edge, num_links=de.num,
                     mode=mode)


# --------------------------------------------------------------------------
# scalar reference engine (the executable spec)
# --------------------------------------------------------------------------

def _path_edges(de: DirectedEdges, path) -> list:
    return [de.edge_id(path[i], path[i + 1]) for i in range(len(path) - 1)]


def build_flow_paths_reference(rt: RoutingTables, pattern: TrafficPattern,
                               mode: str, k_candidates: int = 8,
                               seed: int = 0) -> FlowPaths:
    """Per-flow scalar builder; consumes the same pre-drawn randomness as the
    vectorized engine, so outputs are bit-identical for equal arguments."""
    rng = np.random.default_rng(seed)
    de = build_directed_edges(rt.graph)
    n = rt.graph.n
    f = pattern.num_flows

    include_min, alt_kind, k_alt, k_total = _mode_layout(mode, k_candidates)
    lmax = 2 * max(2, rt.diameter)
    _, deg = de.padded_neighbors()
    draws = _draw_randomness(rng, alt_kind, f,
                             k_total if mode == "ecmp" else k_alt,
                             n, int(deg.max()) if len(deg) else 0,
                             rt.diameter)

    edges = -np.ones((f, k_total, lmax), dtype=np.int32)
    hops = np.zeros((f, k_total), dtype=np.int32)
    valid = np.zeros((f, k_total), dtype=bool)
    is_min = np.zeros((f, k_total), dtype=bool)
    first_edge = np.zeros(f, dtype=np.int32)

    def valiant_nodes(i: int, c: int, s: int, d: int) -> list:
        r = int(_skip2(int(draws["RV"][i, c]), s, d))
        return minimal_path(rt.next_hop, s, r) + minimal_path(rt.next_hop, r, d)[1:]

    for i in range(f):
        s, d = int(pattern.src[i]), int(pattern.dst[i])
        mp = minimal_path(rt.next_hop, s, d)
        me = _path_edges(de, mp)
        first_edge[i] = me[0]
        col = 0
        if include_min:
            edges[i, col, :len(me)] = me
            hops[i, col] = len(me)
            valid[i, col] = True
            is_min[i, col] = True
            col += 1
        if mode == "ecmp":
            for c in range(k_total):
                path = [s]
                u, h = s, 0
                while u != d:
                    nbs = rt.graph.neighbors[u]
                    good = nbs[rt.dist[nbs, d] == rt.dist[u, d] - 1]
                    u = int(good[int(draws["U"][i, c, h] * len(good))])
                    path.append(u)
                    h += 1
                pe = _path_edges(de, path)
                edges[i, c, :len(pe)] = pe
                hops[i, c] = len(pe)
                valid[i, c] = True
                is_min[i, c] = True
            continue
        if alt_kind == "valiant" or (alt_kind == "cvaliant"
                                     and rt.dist[s, d] == 1):
            # adjacent pair under Compact Valiant: bounce-back through s is
            # unavoidable -> fall back to general Valiant (paper §VII-B)
            for c in range(k_alt):
                pe = _path_edges(de, valiant_nodes(i, c, s, d))
                edges[i, col, :len(pe)] = pe
                hops[i, col] = len(pe)
                valid[i, col] = True
                col += 1
        elif alt_kind == "cvaliant":
            nbs = rt.graph.neighbors[s]
            ok = (rt.next_hop[nbs, d] != s) & (nbs != d)
            cands = nbs[ok]
            keys = draws["KEYS"][i, :len(nbs)][ok]
            sel = cands[np.argsort(keys, kind="stable")][:k_alt]
            for r in sel:
                r = int(r)
                pe = _path_edges(de, [s] + minimal_path(rt.next_hop, r, d))
                edges[i, col, :len(pe)] = pe
                hops[i, col] = len(pe)
                valid[i, col] = True
                col += 1

    return FlowPaths(pattern=pattern, edges=edges, hops=hops, valid=valid,
                     is_min=is_min, first_edge=first_edge, num_links=de.num,
                     mode=mode)


def build_flow_paths(rt, pattern: TrafficPattern, mode: str,
                     k_candidates: int = 8, seed: int = 0,
                     engine: str = "auto") -> FlowPaths:
    """Build candidate paths for every flow of `pattern` under `mode`.

    `rt` is a `RoutingTables` (dense [n, n] tables) or a `BlockedRouting`
    (streamed next-hop columns, no [n, n] state).  Engines -- all
    bit-identical for equal arguments:

      "auto"       -- "dense" when `rt` carries dense tables, "blocked"
                      when it streams.
      "dense"      -- batched array engine over the dense next-hop table
                      (alias "vectorized", the pre-blocked-engine name).
      "blocked"    -- destination-blocked construction; works with either
                      routing state and never materializes [n, n].
      "reference"  -- the per-flow scalar spec (requires dense tables).
    """
    if engine == "auto":
        engine = "dense" if getattr(rt, "next_hop", None) is not None \
            else "blocked"
    if engine in ("dense", "vectorized"):
        return _build_vectorized(rt, pattern, mode, k_candidates, seed)
    if engine == "blocked":
        return _build_blocked(rt, pattern, mode, k_candidates, seed)
    if engine == "reference":
        return build_flow_paths_reference(rt, pattern, mode, k_candidates, seed)
    raise ValueError(f"unknown engine {engine!r}")


def build_flow_paths_chunks(rt, pattern: TrafficPattern, mode: str,
                            k_candidates: int = 8, seed: int = 0,
                            chunk: Optional[int] = None,
                            budget_bytes: Optional[int] = None
                            ) -> Iterator[FlowPaths]:
    """Stream blocked-engine `FlowPaths` chunks over flow batches.

    The chunk axis runs through the shared blockwise executor
    (`repro_torch.parallel.blockwise.run_blocks`, host backend -- the per-chunk
    body is itself the destination-blocked engine, so the chunk loop is
    pure orchestration), sized from `budget_bytes` via the same per-flow
    accounting as `blocked_paths_peak_bytes` unless an explicit `chunk`
    is given.  Randomness is drawn once for the full flow batch and
    row-sliced per chunk, so ``FlowPaths.concat(list(...))`` is
    bit-identical to the monolithic
    ``build_flow_paths(..., engine="blocked")`` -- and the chunk stream
    can be handed straight to the fluid entry points, which normalize
    through `FlowPaths.concat`.
    """
    f = pattern.num_flows
    g = rt.graph
    de = build_directed_edges(g)
    _, alt_kind, k_alt, k_total = _mode_layout(mode, k_candidates)
    _, deg = de.padded_neighbors()
    dmax = int(deg.max()) if len(deg) else 0
    diam = rt.diameter
    draws = _draw_randomness(np.random.default_rng(seed), alt_kind, f,
                             k_total if mode == "ecmp" else k_alt,
                             g.n, dmax, diam)
    if chunk is None:
        chunk = block_size_for_budget(
            f, _per_flow_bytes(mode, k_candidates, diam),
            DEFAULT_BUDGET_BYTES if budget_bytes is None else budget_bytes)
    plan = plan_blocks(f, block=chunk)

    def _chunk_fn(idx: np.ndarray) -> FlowPaths:
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        sub = TrafficPattern(pattern.name, pattern.src[lo:hi],
                             pattern.dst[lo:hi], pattern.demand[lo:hi],
                             pattern.endpoints_per_router)
        return _build_blocked(rt, sub, mode, k_candidates, seed,
                              draws={k: v[lo:hi] for k, v in draws.items()})

    for _, (fp,) in run_blocks(np.arange(f, dtype=np.int64), plan, _chunk_fn,
                               backend="host"):
        yield fp
