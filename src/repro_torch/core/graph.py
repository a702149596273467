"""Lightweight undirected-graph container shared by all topologies.

Host-side (numpy) representation: neighbor lists + derived views.  The
primary derived view is the cached CSR pair ``csr = (indptr, indices)``
(`indptr` int64 [n+1], `indices` int32 [E_dir], rows sorted) that the sparse
graph engine (blocked BFS, streaming metrics, CSR edge-id lookups) consumes;
the dense boolean ``adjacency`` remains available as the small-n reference
view.  Everything downstream (metrics, simulator, fabric) consumes this.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Graph", "GraphBuilder", "UNREACHABLE"]

# Canonical "no path" sentinel for every core module: unreachable entries of
# distance arrays (int16) and missing next hops (int32) both hold this value.
# (Dense argmin scans that need a +inf-like mask use np.iinfo(...).max
# locally; UNREACHABLE is the only value stored in returned tables.)
UNREACHABLE = np.int16(-1)


@dataclass
class Graph:
    name: str
    n: int
    neighbors: List[np.ndarray]  # sorted int32 arrays, no self loops
    params: Dict[str, Any] = field(default_factory=dict)
    # optional vertex annotations (e.g. PolarFly vertex vectors / classes)
    labels: Dict[str, np.ndarray] = field(default_factory=dict)

    # -- basic quantities ------------------------------------------------------
    @functools.cached_property
    def csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """Cached CSR view: (indptr int64 [n+1], indices int32 [E_dir]).

        Row u's sorted neighbors are indices[indptr[u]:indptr[u+1]].  This is
        the primary representation of the sparse engine; the directed edge id
        space of the simulator (`DirectedEdges`) uses the same layout.
        """
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        if self.n:
            np.cumsum([len(nb) for nb in self.neighbors], out=indptr[1:])
        if self.n and indptr[-1]:
            indices = np.concatenate(self.neighbors).astype(np.int32,
                                                            copy=False)
        else:
            indices = np.zeros(0, dtype=np.int32)
        return indptr, indices

    @functools.cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.csr[0])

    @functools.cached_property
    def num_edges(self) -> int:
        return int(self.degrees.sum()) // 2

    @functools.cached_property
    def max_degree(self) -> int:
        return int(self.degrees.max())

    @functools.cached_property
    def _csr_rows(self) -> np.ndarray:
        """[E_dir] int64 source row of every CSR slot."""
        return np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)

    @functools.cached_property
    def adjacency(self) -> np.ndarray:
        """Dense boolean adjacency [n, n] (small-n reference view)."""
        _, indices = self.csr
        a = np.zeros((self.n, self.n), dtype=bool)
        a[self._csr_rows, indices] = True
        return a

    @functools.cached_property
    def padded_neighbors(self) -> Tuple[np.ndarray, np.ndarray]:
        """([n, deg_max] int32 sorted-neighbor matrix padded with -1,
        [n] int64 degrees).  The ragged-to-rectangular view the
        destination-blocked routing columns and the simulator's candidate
        builders gather from; cached once per graph."""
        indptr, indices = self.csr
        deg = self.degrees
        dmax = int(deg.max()) if self.n else 0
        nb = np.full((self.n, dmax), -1, dtype=np.int32)  # reprolint-torch: allow[sentinel] -- -1 pads the ragged [n, deg_max] neighbor matrix; consumers mask by degree
        if dmax:
            cols = np.arange(len(indices)) - np.repeat(indptr[:-1], deg)
            nb[self._csr_rows, cols] = indices
        return nb, deg.astype(np.int64)

    @functools.cached_property
    def edge_list(self) -> np.ndarray:
        """[E, 2] int32, u < v, sorted lexicographically."""
        _, indices = self.csr
        rows = self._csr_rows
        keep = rows < indices
        return np.stack([rows[keep], indices[keep]],
                        axis=1).astype(np.int32).reshape(-1, 2)

    def has_edge(self, u: int, v: int) -> bool:
        nb = self.neighbors[u]
        i = np.searchsorted(nb, v)
        return i < len(nb) and nb[i] == v

    def subgraph_without_edges(self, removed: np.ndarray) -> "Graph":
        """Copy of the graph with the given [k, 2] edges removed."""
        indptr, indices = self.csr
        rows = self._csr_rows
        n = max(self.n, 1)
        if len(removed):
            r = np.asarray(removed, dtype=np.int64).reshape(-1, 2)
            bad = np.concatenate([r[:, 0] * n + r[:, 1],
                                  r[:, 1] * n + r[:, 0]])
            keep = ~np.isin(rows * n + indices, bad)
        else:
            keep = np.ones(len(indices), dtype=bool)
        deg = np.bincount(rows[keep], minlength=self.n)
        nbs = np.split(indices[keep], np.cumsum(deg)[:-1])
        return Graph(self.name + "-damaged", self.n, nbs, dict(self.params))

    def validate(self) -> None:
        """Symmetry + no self loops + sorted neighbor lists (vectorized)."""
        indptr, indices = self.csr
        rows = self._csr_rows
        assert not (rows == indices).any(), \
            f"self loop at {rows[rows == indices][:1]}"
        interior = np.ones(len(indices), dtype=bool)
        interior[indptr[:-1][self.degrees > 0]] = False  # first slot per row
        assert (np.diff(indices)[interior[1:]] > 0).all(), \
            "neighbor lists not strictly sorted"
        n = max(self.n, 1)
        fwd = rows * n + indices  # already sorted row-major
        rev = np.sort(indices.astype(np.int64) * n + rows)
        assert np.array_equal(fwd, rev), "adjacency not symmetric"


class GraphBuilder:
    """Mutable adjacency-set builder -> frozen Graph."""

    def __init__(self, name: str, n: int):
        self.name = name
        self.adj: List[set] = [set() for _ in range(n)]
        self.params: Dict[str, Any] = {}
        self.labels: Dict[str, np.ndarray] = {}

    @classmethod
    def from_graph(cls, g: Graph, name: Optional[str] = None) -> "GraphBuilder":
        b = cls(name or g.name, g.n)
        for u, nb in enumerate(g.neighbors):
            b.adj[u] = set(int(v) for v in nb)
        b.params = dict(g.params)
        b.labels = dict(g.labels)
        return b

    @property
    def n(self) -> int:
        return len(self.adj)

    def add_vertex(self) -> int:
        self.adj.append(set())
        return len(self.adj) - 1

    def add_edge(self, u: int, v: int) -> None:
        if u == v:
            raise ValueError(f"self loop at {u}")
        self.adj[u].add(v)
        self.adj[v].add(u)

    def has_edge(self, u: int, v: int) -> bool:
        return v in self.adj[u]

    def freeze(self) -> Graph:
        nbs = [np.array(sorted(s), dtype=np.int32) for s in self.adj]
        return Graph(self.name, len(nbs), nbs, dict(self.params), dict(self.labels))
