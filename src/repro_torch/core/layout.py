"""PolarFly modular layout (paper §V, Algorithm 1).

Clusters ("racks"): C_0 = the q+1 quadrics; for each neighbor u of a starter
quadric v, cluster C_i = {u} + non-quadric neighbors of u.  For odd q each
non-quadric cluster is a fan of (q-1)/2 triangles sharing the center u.

A copy of the JAX package's ``core/layout.py`` (which is numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from .polarfly import PolarFly

__all__ = ["Layout", "build_layout"]


@dataclass
class Layout:
    pf: PolarFly = field(repr=False)
    starter: int  # the quadric chosen in Algorithm 1, line 3
    cluster_of: np.ndarray  # [N] int32 cluster id; C_0 = quadrics
    centers: np.ndarray  # [q] int32 centers of the non-quadric clusters (C_1..C_q)
    clusters: List[np.ndarray] = field(repr=False)  # member lists per cluster

    @property
    def num_clusters(self) -> int:
        return len(self.clusters)

    def cluster_members(self, i: int) -> np.ndarray:
        return self.clusters[i]

    def inter_cluster_edge_counts(self) -> np.ndarray:
        """[q+1, q+1] symmetric matrix of link counts between racks."""
        k = self.num_clusters
        m = np.zeros((k, k), dtype=np.int64)
        for u, v in self.pf.graph.edge_list:
            cu, cv = self.cluster_of[u], self.cluster_of[v]
            m[cu, cv] += 1
            if cu != cv:
                m[cv, cu] += 1
        return m


def build_layout(pf: PolarFly, starter: int | None = None) -> Layout:
    """Algorithm 1.  `starter` defaults to the first quadric."""
    g = pf.graph
    if starter is None:
        starter = int(pf.quadrics[0])
    if not pf.quadric_mask[starter]:
        raise ValueError(f"starter vertex {starter} is not a quadric")

    n = g.n
    cluster_of = -np.ones(n, dtype=np.int32)
    cluster_of[pf.quadric_mask] = 0  # line 2: all quadrics -> C_0

    centers = []
    cid = 0
    for u in g.neighbors[starter]:  # line 4
        u = int(u)
        if pf.quadric_mask[u]:
            continue  # (starter's neighbors are non-quadric for odd q; guard anyway)
        cid += 1
        centers.append(u)
        assert cluster_of[u] == -1, "center already assigned (violates Prop. V.1)"  # reprolint-torch: allow[sentinel] -- -1 means 'cluster not yet assigned' during Algorithm 1 construction, not a distance
        cluster_of[u] = cid  # line 5
        for w in g.neighbors[u]:  # line 6
            w = int(w)
            if not pf.quadric_mask[w]:
                assert cluster_of[w] in (-1, cid), "vertex in two clusters"
                cluster_of[w] = cid

    assert (cluster_of >= 0).all(), "Algorithm 1 left unassigned vertices"
    nclusters = cid + 1
    clusters = [np.where(cluster_of == i)[0].astype(np.int32) for i in range(nclusters)]
    return Layout(pf=pf, starter=starter, cluster_of=cluster_of,
                  centers=np.array(centers, dtype=np.int32), clusters=clusters)
