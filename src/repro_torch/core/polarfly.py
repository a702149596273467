"""PolarFly: the Erdos-Renyi polarity graph ER_q (paper §IV).

Construction (paper §IV-C/§IV-E): vertices are the left-normalized nonzero
vectors of F_q^3 (= points of PG(2, q)); (v, w) is an edge iff v . w == 0 in
GF(q).  Vertices with v . v == 0 are *quadrics* (W); vertices adjacent to a
quadric form V1; the rest form V2.

N = q^2 + q + 1, degree = q + 1 (quadrics have q neighbors + a conceptual
self-loop), diameter 2, asymptotically Moore optimal.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from .gf import GF, is_prime_power
from .graph import Graph

__all__ = ["PolarFly", "build_polarfly", "moore_bound", "moore_efficiency"]


def moore_bound(k: int, d: int = 2) -> int:
    """Moore bound on vertices for max degree k, diameter d (paper eq. (1))."""
    n = 1
    term = k
    for _ in range(d):
        n += term
        term *= (k - 1)
    return n


def moore_efficiency(n: int, k: int, d: int = 2) -> float:
    return n / moore_bound(k, d)


def _enumerate_projective_points(q: int) -> np.ndarray:
    """All left-normalized nonzero vectors of F_q^3, shape [q^2+q+1, 3].

    Order: [0,0,1], [0,1,z], [1,y,z] (lexicographic within each class).
    """
    pts = [(0, 0, 1)]
    for z in range(q):
        pts.append((0, 1, z))
    for y in range(q):
        for z in range(q):
            pts.append((1, y, z))
    return np.array(pts, dtype=np.int32)


@dataclass
class PolarFly:
    """ER_q polarity graph with PolarFly vertex taxonomy."""

    q: int
    gf: GF = field(repr=False)
    graph: Graph = field(repr=False)
    vertices: np.ndarray = field(repr=False)  # [N, 3] left-normalized vectors
    quadric_mask: np.ndarray = field(repr=False)  # [N] bool  (W)
    v1_mask: np.ndarray = field(repr=False)  # [N] bool
    v2_mask: np.ndarray = field(repr=False)  # [N] bool
    index: Dict[Tuple[int, int, int], int] = field(repr=False)

    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def degree(self) -> int:
        """Network radix k = q + 1."""
        return self.q + 1

    @functools.cached_property
    def quadrics(self) -> np.ndarray:
        return np.where(self.quadric_mask)[0].astype(np.int32)

    @functools.cached_property
    def v1(self) -> np.ndarray:
        return np.where(self.v1_mask)[0].astype(np.int32)

    @functools.cached_property
    def v2(self) -> np.ndarray:
        return np.where(self.v2_mask)[0].astype(np.int32)

    def vertex_id(self, vec) -> int:
        v = self.gf.normalize3(np.asarray(vec, dtype=np.int32))
        return self.index[tuple(int(x) for x in v)]

    # -- paper §IV-D: minimal-route intermediate vertex ----------------------
    def intermediate(self, s: int, d: int) -> int:
        """Unique mid vertex of the 2-hop s->d path via GF cross product."""
        c = self.gf.cross3(self.vertices[s], self.vertices[d])
        c = self.gf.normalize3(c)
        return self.index[tuple(int(x) for x in c)]

    def intermediates_all_pairs(self) -> np.ndarray:
        """[N, N] int32 table of 2-hop intermediate vertices.

        Entry [s, d] is the unique intermediate vertex of the minimal 2-hop
        path (meaningful when s, d are distinct and non-adjacent; for adjacent
        pairs it is the common neighbor completing the unique triangle /
         2-hop alternative, and for s == d it degenerates).
        """
        vt = self.vertices
        c = self.gf.cross3(vt[:, None, :], vt[None, :, :])  # [N, N, 3]
        c = self.gf.normalize3(c)
        # map vectors -> ids via positional encoding
        q = self.q
        code = (c[..., 0] * q + c[..., 1]) * q + c[..., 2]
        lut = -np.ones(q ** 3, dtype=np.int32)
        vcode = (vt[:, 0] * q + vt[:, 1]) * q + vt[:, 2]
        lut[vcode] = np.arange(self.n, dtype=np.int32)
        return lut[code]


def build_polarfly(q: int, chunk: int = 2048) -> PolarFly:
    """Construct ER_q for any prime power q."""
    if not is_prime_power(q):
        raise ValueError(f"q={q} must be a prime power")
    gf = GF(q)
    vt = _enumerate_projective_points(q)  # [N, 3]
    n = vt.shape[0]
    assert n == q * q + q + 1

    neighbors = []
    quadric = np.zeros(n, dtype=bool)
    # chunked all-pairs dot products (tables are int32; N^2*3 lookups)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        d = gf.dot3(vt[lo:hi, None, :], vt[None, :, :])  # [hi-lo, N]
        for i in range(lo, hi):
            row = d[i - lo]
            nb = np.where(row == 0)[0]
            if row[i] == 0:
                quadric[i] = True
                nb = nb[nb != i]
            neighbors.append(nb.astype(np.int32))

    v1 = np.zeros(n, dtype=bool)
    for w in np.where(quadric)[0]:
        v1[neighbors[w]] = True
    v1 &= ~quadric
    v2 = ~(quadric | v1)

    graph = Graph(
        f"PF({q})", n, neighbors,
        params={"q": q, "radix": q + 1},
        labels={"quadric": quadric, "v1": v1, "v2": v2, "vectors": vt},
    )
    index = {tuple(int(x) for x in vt[i]): i for i in range(n)}
    return PolarFly(q=q, gf=gf, graph=graph, vertices=vt,
                    quadric_mask=quadric, v1_mask=v1, v2_mask=v2, index=index)
