"""Structural metrics (paper §IX, §X, Figs. 1/2/12/14, Tables II/VI).

Diameter / ASPL, Moore-bound efficiency, feasible-degree enumeration,
bisection bandwidth (spectral + Kernighan-Lin; METIS is unavailable offline),
link-failure resilience sweeps, triangle census, and exact small-length path
counting (Table VI validation).

A copy of the JAX package's ``core/metrics.py`` (which is numpy only).
`diameter_and_aspl` also takes ``device=``: with ``backend="sharded"`` its
streamed BFS runs there (`repro_torch.core.routing.distance_blocks`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .gf import is_prime_power, primes_and_prime_powers
from .graph import Graph, UNREACHABLE
from .polarfly import moore_bound
from ..parallel.blockwise import Devices
from .routing import _resolve_engine, all_pairs_distances, distance_blocks

__all__ = [
    "diameter_and_aspl",
    "polarfly_feasible_degrees",
    "slimfly_feasible_degrees",
    "bisection_fraction",
    "resilience_sweep",
    "ResiliencePoint",
    "triangle_census",
    "count_paths_upto4",
]


def diameter_and_aspl(g: Graph, dist: Optional[np.ndarray] = None,
                      engine: str = "auto", backend: str = "auto",
                      devices: Devices = None,
                      device: str = "cuda") -> Tuple[int, float]:
    """(diameter, average shortest path length) over connected pairs.

    Returns diameter = -1 for a disconnected graph (paper footnote 1: the
    diameter becomes infinite on disconnection).  With no precomputed `dist`
    and the sparse engine selected (auto above the dense threshold), the
    reduction streams over blocked-BFS source blocks and never materializes
    an [n, n] matrix; sums stay in exact integer arithmetic, so both engines
    return identical values.  `backend`/`devices` pass through to
    `distance_blocks` on the streaming path (the blockwise executor's host
    loop vs the device BFS, a round of source blocks at a time, one a
    device -- bit-identical, so the exact integer sums are preserved
    either way).
    """
    if dist is None and _resolve_engine(engine, g.n) == "sparse":
        diam, total, pairs = 0, 0, 0
        for srcs, db, _ in distance_blocks(g, backend=backend,
                                           devices=devices, device=device):
            if (db == UNREACHABLE).any():  # diagonal is 0, so any hit is real
                return int(UNREACHABLE), float("inf")
            diam = max(diam, int(db.max()))
            total += int(db.sum(dtype=np.int64))  # diagonal contributes 0
            pairs += db.shape[0] * (g.n - 1)
        return diam, total / pairs
    if dist is None:
        dist = all_pairs_distances(g, engine=engine)
    off = ~np.eye(g.n, dtype=bool)  # reprolint-torch: allow[dense-square] -- dense-engine branch only; masks a dist matrix the caller already materialized
    vals = dist[off]
    if (vals == UNREACHABLE).any():
        return int(UNREACHABLE), float("inf")
    return int(vals.max()), float(vals.mean())


# ----------------------------------------------------------------------------
# Fig. 1 / Fig. 2: design-space and Moore-bound scalability
# ----------------------------------------------------------------------------

def polarfly_feasible_degrees(max_k: int) -> List[int]:
    """Feasible PolarFly radixes k = q+1 <= max_k, q any prime power."""
    return [q + 1 for q in primes_and_prime_powers(2, max_k - 1)]


def slimfly_feasible_degrees(max_k: int) -> List[int]:
    """Feasible Slim Fly (MMS, diameter 2) radixes k = (3q - delta)/2 <= max_k,
    q = 4w + delta prime power, delta in {-1, 0, 1}."""
    out = set()
    for q in primes_and_prime_powers(2, (2 * max_k) // 3 + 2):
        for delta in (-1, 0, 1):
            if (q - delta) % 4 == 0 and (3 * q - delta) % 2 == 0:
                k = (3 * q - delta) // 2
                if 2 <= k <= max_k:
                    out.add(k)
    return sorted(out)


# ----------------------------------------------------------------------------
# Fig. 12: bisection bandwidth (spectral + KL refinement)
# ----------------------------------------------------------------------------

def _fiedler_vector(g: Graph, iters: int = 600, seed: int = 0) -> np.ndarray:
    """Approximate Fiedler (2nd-smallest Laplacian eigen-) vector via power
    iteration on (c*I - L), deflating the all-ones vector.  The A @ x product
    runs as a CSR gather + bincount segment sum (no per-node Python loop)."""
    n = g.n
    deg = g.degrees.astype(np.float64)
    c = 2.0 * deg.max() + 1.0
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    ones = np.ones(n) / np.sqrt(n)
    _, indices = g.csr
    rows = g._csr_rows
    for _ in range(iters):
        x = x - (x @ ones) * ones
        # y = (c I - L) x = c x - deg*x + A x
        ax = np.bincount(rows, weights=x[indices], minlength=n)
        x = (c - deg) * x + ax
        x /= np.linalg.norm(x) + 1e-30
    return x


def _kl_refine(g: Graph, side: np.ndarray, passes: int = 4) -> np.ndarray:
    """Balanced Kernighan-Lin-style refinement by greedy pair swaps."""
    side = side.copy()
    _, indices = g.csr
    rows = g._csr_rows
    deg = g.degrees
    for _ in range(passes):
        # KL gain of flipping u: external - internal edge count
        same = np.bincount(rows, weights=(side[indices] == side[rows]),
                           minlength=g.n)
        gain = deg - 2.0 * same
        a = np.where(side)[0]
        b = np.where(~side)[0]
        a = a[np.argsort(-gain[a])][: max(1, len(a) // 8)]
        b = b[np.argsort(-gain[b])][: max(1, len(b) // 8)]
        improved = False
        for u, v in zip(a, b):
            delta = gain[u] + gain[v] - 2 * (1 if g.has_edge(int(u), int(v)) else 0)
            if delta > 0:
                side[u] = ~side[u]
                side[v] = ~side[v]
                improved = True
        if not improved:
            break
    return side


def bisection_fraction(g: Graph, seed: int = 0) -> float:
    """Fraction of edges crossing a balanced bisection (lower = worse for the
    network; paper Fig. 12 reports cut edges / total edges)."""
    x = _fiedler_vector(g, seed=seed)
    order = np.argsort(x)
    side = np.zeros(g.n, dtype=bool)
    side[order[: g.n // 2]] = True
    side = _kl_refine(g, side)
    e = g.edge_list
    cut = int((side[e[:, 0]] != side[e[:, 1]]).sum())
    return cut / max(1, g.num_edges)


# ----------------------------------------------------------------------------
# Fig. 14: resilience under random link failure
# ----------------------------------------------------------------------------

@dataclass
class ResiliencePoint:
    fail_fraction: float
    diameter: int  # -1 => disconnected
    aspl: float


def resilience_sweep(g: Graph, fractions, seed: int = 0) -> List[ResiliencePoint]:
    """Remove a random fraction of links (cumulatively, one shuffled order per
    seed, as in the paper's per-run curves) and report diameter/ASPL."""
    rng = np.random.default_rng(seed)
    edges = g.edge_list.copy()
    rng.shuffle(edges)
    out = []
    for f in fractions:
        k = int(round(f * len(edges)))
        damaged = g.subgraph_without_edges(edges[:k])
        diam, aspl = diameter_and_aspl(damaged)
        out.append(ResiliencePoint(float(f), diam, aspl))
    return out


# ----------------------------------------------------------------------------
# §V-C: triangles
# ----------------------------------------------------------------------------

def triangle_census(g: Graph) -> int:
    """Total number of triangles (trace(A^3) / 6), dense boolean matmul."""
    a = g.adjacency.astype(np.int64)
    return int(np.trace(a @ a @ a)) // 6


def triangles_by_cluster(g: Graph, cluster_of: np.ndarray) -> Dict[str, int]:
    """Split triangles into intra-cluster vs inter-cluster (3 distinct racks)
    vs mixed (2 racks; the paper proves 0 of these for PolarFly)."""
    a = g.adjacency
    n = g.n
    intra = inter3 = mixed = 0
    for u in range(n):
        nu = g.neighbors[u]
        nu = nu[nu > u]
        for v in nu:
            common = np.intersect1d(nu, g.neighbors[int(v)])
            for w in common[common > v]:
                cs = {int(cluster_of[u]), int(cluster_of[int(v)]), int(cluster_of[int(w)])}
                if len(cs) == 1:
                    intra += 1
                elif len(cs) == 3:
                    inter3 += 1
                else:
                    mixed += 1
    return {"intra": intra, "inter3": inter3, "mixed": mixed}


# ----------------------------------------------------------------------------
# Table VI: exact path counting for lengths 1..4 (small graphs)
# ----------------------------------------------------------------------------

def count_3paths_avoiding(g: Graph, v: int, w: int, avoid: int) -> int:
    """Simple 3-paths v-a-b-w with a, b != `avoid`.

    This is Table VI's length-3 semantic: the number of length-3
    *alternatives* that survive when the unique 2-hop intermediate fails
    (the fault-tolerance question of §IX-B) -- exactly q-1 when the
    intermediate is non-quadric and q when it is quadric."""
    nb = g.neighbors
    set_w = set(int(x) for x in nb[w])
    n = 0
    for a in nb[v]:
        a = int(a)
        if a in (v, w) or a == avoid:
            continue
        for b in nb[a]:
            b = int(b)
            if b in (v, w, a) or b == avoid:
                continue
            if b in set_w:
                n += 1
    return n


def count_paths_upto4(g: Graph, v: int, w: int) -> Dict[int, int]:
    """Exact number of simple paths of length 1..4 between v and w (v != w)."""
    assert v != w
    counts = {1: 0, 2: 0, 3: 0, 4: 0}
    counts[1] = 1 if g.has_edge(v, w) else 0
    nb = g.neighbors
    set_w = set(int(x) for x in nb[w])
    # length 2: v - a - w
    for a in nb[v]:
        a = int(a)
        if a != w and a in set_w:
            counts[2] += 1
    # length 3: v - a - b - w
    for a in nb[v]:
        a = int(a)
        if a in (v, w):
            continue
        for b in nb[a]:
            b = int(b)
            if b in (v, w, a):
                continue
            if b in set_w:
                counts[3] += 1
    # length 4: v - a - b - c - w
    for a in nb[v]:
        a = int(a)
        if a in (v, w):
            continue
        for b in nb[a]:
            b = int(b)
            if b in (v, w, a):
                continue
            for c in nb[b]:
                c = int(c)
                if c in (v, w, a, b):
                    continue
                if c in set_w:
                    counts[4] += 1
    return counts
