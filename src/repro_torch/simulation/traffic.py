"""Traffic patterns of paper §VIII-A.

All patterns are *router-level* (co-packaged setting: permutations map
routers to routers; each router carries `p` endpoints whose traffic shares
the router's paths).

A pattern is a set of (source, destination) flows with per-flow demand in
flits/cycle at unit offered load; total injection per host router = p.

`hosts` restricts traffic endpoints to a node subset (e.g. leaf switches of
an indirect fat tree); default is every node (direct networks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.graph import Graph
from ..core.routing import RoutingTables

__all__ = ["TrafficPattern", "uniform", "tornado", "random_permutation",
           "perm_khop", "make_pattern", "PATTERNS"]


@dataclass
class TrafficPattern:
    name: str
    src: np.ndarray  # [F] int32 node ids
    dst: np.ndarray  # [F] int32 node ids
    demand: np.ndarray  # [F] float32, flits/cycle per unit offered load
    endpoints_per_router: int

    def __post_init__(self):
        # canonical dtypes: the vectorized path engine gathers on these
        # arrays directly, and self-flows have no first link (UGAL gate).
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        self.demand = np.asarray(self.demand, dtype=np.float32)
        if not (len(self.src) == len(self.dst) == len(self.demand)):
            raise ValueError("src/dst/demand length mismatch")
        if (self.src == self.dst).any():
            raise ValueError("self-flows (src == dst) are not allowed")

    @property
    def num_flows(self) -> int:
        return len(self.src)


def _hosts(g: Graph, hosts: Optional[np.ndarray]) -> np.ndarray:
    if hosts is None:
        return np.arange(g.n, dtype=np.int32)
    return np.asarray(hosts, dtype=np.int32)


def uniform(g: Graph, p: int = 16, hosts: Optional[np.ndarray] = None,
            max_flows: int = 120_000, seed: int = 0,
            rng: Optional[np.random.Generator] = None) -> TrafficPattern:
    """Uniform random traffic; exact all-pairs when it fits in max_flows,
    else a uniform sample of pairs carrying the same aggregate demand."""
    h = _hosts(g, hosts)
    nh = len(h)
    if nh * (nh - 1) <= max_flows:
        s, d = np.meshgrid(np.arange(nh), np.arange(nh), indexing="ij")
        mask = s != d
        src = h[s[mask]]
        dst = h[d[mask]]
        demand = np.full(len(src), p / (nh - 1), dtype=np.float32)
    else:
        if rng is None:
            rng = np.random.default_rng(seed)
        f = max_flows
        si = rng.integers(nh, size=f)
        di = (si + 1 + rng.integers(nh - 1, size=f)) % nh
        # aggregate duplicate (src, dst) draws into one flow each: the
        # solver's padded incidence table indexes candidate slots per flow,
        # so a pair drawn twice would double-count its slots; summing the
        # multiplicity into the demand keeps the aggregate at p * nh exactly
        pair, counts = np.unique(si * np.int64(nh) + di, return_counts=True)
        si, di = pair // nh, pair % nh
        src, dst = h[si], h[di]
        demand = (counts * (p * nh / f)).astype(np.float32)
    return TrafficPattern("uniform", src.astype(np.int32), dst.astype(np.int32),
                          demand, p)


def _perm_pattern(name: str, h: np.ndarray, perm_idx: np.ndarray, p: int) -> TrafficPattern:
    keep = perm_idx != np.arange(len(h))
    return TrafficPattern(name, h[keep].astype(np.int32),
                          h[perm_idx[keep]].astype(np.int32),
                          np.full(int(keep.sum()), float(p), dtype=np.float32), p)


def tornado(g: Graph, p: int = 16, hosts: Optional[np.ndarray] = None) -> TrafficPattern:
    """Host router i sends all traffic to host router i + H/2 (mod H)."""
    h = _hosts(g, hosts)
    nh = len(h)
    perm = (np.arange(nh) + nh // 2) % nh
    return _perm_pattern("tornado", h, perm, p)


def random_permutation(g: Graph, p: int = 16, hosts: Optional[np.ndarray] = None,
                       seed: int = 0,
                       rng: Optional[np.random.Generator] = None
                       ) -> TrafficPattern:
    h = _hosts(g, hosts)
    if rng is None:
        rng = np.random.default_rng(seed)
    return _perm_pattern("random_perm", h, rng.permutation(len(h)), p)


def perm_khop(rt: RoutingTables, k: int, p: int = 16,
              hosts: Optional[np.ndarray] = None, seed: int = 0,
              rng: Optional[np.random.Generator] = None) -> TrafficPattern:
    """PermKHop (§VIII-A(4)): a permutation whose destinations are at distance
    exactly k; found by bipartite matching (Kuhn) on the distance-k graph."""
    h = _hosts(rt.graph, hosts)
    nh = len(h)
    if rng is None:
        rng = np.random.default_rng(seed)
    if getattr(rt, "dist", None) is None:
        raise ValueError(
            "perm_khop needs dense distances (build_routing); BlockedRouting "
            "streams them -- build a RoutingTables for k-hop matchings")
    dist = rt.dist[np.ix_(h, h)]
    cands = [np.where(dist[i] == k)[0] for i in range(nh)]
    match_of_dst = -np.ones(nh, dtype=np.int64)

    def try_assign(i0, visited):
        """Kuhn augmenting-path DFS with an explicit stack (augmenting
        chains can reach depth nh, which would blow the C stack through
        recursion at large nh).  Frames draw their candidate permutation on
        push and claim one destination at a time, exactly mirroring the
        recursive formulation's rng call order, so matchings are unchanged.
        """
        stack = [[int(i0), iter(rng.permutation(cands[int(i0)])), -1]]
        while stack:
            frame = stack[-1]
            pushed = False
            for j in frame[1]:
                j = int(j)
                if visited[j]:
                    continue
                visited[j] = True
                frame[2] = j
                owner = int(match_of_dst[j])
                if owner < 0:
                    # free destination: the whole stack is an augmenting
                    # path; reassign every frame's claimed destination
                    for i, _, jj in stack:
                        match_of_dst[jj] = i
                    return True
                stack.append([owner, iter(rng.permutation(cands[owner])), -1])
                pushed = True
                break
            if not pushed:
                stack.pop()
        return False

    for i in rng.permutation(nh):
        visited = np.zeros(nh, dtype=bool)
        if not try_assign(int(i), visited):
            raise RuntimeError(f"no perfect {k}-hop permutation exists")
    perm = -np.ones(nh, dtype=np.int64)
    for j in range(nh):
        perm[int(match_of_dst[j])] = j
    assert (perm >= 0).all()
    assert (dist[np.arange(nh), perm] == k).all()
    return _perm_pattern(f"perm{k}hop", h, perm, p)


PATTERNS = ("uniform", "tornado", "random_perm", "perm1hop", "perm2hop")


def make_pattern(name: str, rt: RoutingTables, p: int = 16,
                 hosts: Optional[np.ndarray] = None, seed: int = 0,
                 max_flows: int = 120_000,
                 rng: Optional[np.random.Generator] = None
                 ) -> TrafficPattern:
    """Build a named pattern.  All randomness flows through one generator:
    pass `rng` to share a stream across pattern + workload construction,
    or rely on `seed` -- every builder resolves
    ``np.random.default_rng(seed)`` exactly once, so equal seeds give
    identical `TrafficPattern`s (and, downstream, identical packet-engine
    tail metrics -- see tests/test_packet_engine.py)."""
    g = rt.graph
    if name == "uniform":
        return uniform(g, p, hosts, max_flows=max_flows, seed=seed, rng=rng)
    if name == "tornado":
        return tornado(g, p, hosts)
    if name == "random_perm":
        return random_permutation(g, p, hosts, seed=seed, rng=rng)
    if name == "perm1hop":
        return perm_khop(rt, 1, p, hosts, seed=seed, rng=rng)
    if name == "perm2hop":
        return perm_khop(rt, 2, p, hosts, seed=seed, rng=rng)
    raise ValueError(f"unknown pattern {name!r}")
