"""Incremental expansion of PolarFly (paper §VI).

Two rewiring-free methods, both based on cluster replication (Def. VI.1):

* `replicate_quadric_cluster` (§VI-A): copy C_0; replicas keep all
  inter-cluster edges of their originals; every quadric and all of its
  replicas are directly interconnected.  +q+1 vertices per step, diameter
  stays 2, degree growth concentrated on W and V1.

* `replicate_nonquadric_cluster` (§VI-B): copy a non-quadric cluster C_i
  (intra-cluster fan edges + inter-cluster edges).  For every other cluster
  C_j there is exactly one vertex u' in C_i with no edge to C_j
  (Prop. V.4.3); the *replica* of u' is additionally wired to the center of
  C_j to keep the degree distribution near uniform.  +q vertices per step,
  diameter becomes 3, ASPL < 2.

A copy of the JAX package's ``core/expansion.py`` (which is numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from .graph import Graph, GraphBuilder
from .layout import Layout

__all__ = ["ExpandedPolarFly", "replicate_quadric_cluster", "replicate_nonquadric_cluster", "expand"]


@dataclass
class ExpandedPolarFly:
    """Expansion state: growing graph + bookkeeping of clusters/replicas."""

    graph: Graph
    layout: Layout = field(repr=False)
    cluster_of: np.ndarray  # [n] cluster id in the *expanded* graph
    centers: List[int]  # center vertex per cluster id (0 = quadric rack, no center -> -1)
    replica_of: np.ndarray  # [n] original vertex id (identity for originals)
    num_quadric_replications: int = 0
    num_nonquadric_replications: int = 0
    next_nonquadric: int = 1  # round-robin pointer for §VI-B


def _init_state(layout: Layout) -> ExpandedPolarFly:
    g = layout.pf.graph
    centers = [-1] + [int(c) for c in layout.centers]
    return ExpandedPolarFly(
        graph=g,
        layout=layout,
        cluster_of=layout.cluster_of.copy(),
        centers=centers,
        replica_of=np.arange(g.n, dtype=np.int32),
    )


def _replicate(state: ExpandedPolarFly, members: np.ndarray, new_cluster_id: int):
    """Def. VI.1: clone `members` with intra edges between replicas and inter
    edges to the originals' outside neighbors.  Returns (builder, member->replica map)."""
    b = GraphBuilder.from_graph(state.graph)
    mset = set(int(m) for m in members)
    rep = {}
    for mvert in members:
        r = b.add_vertex()
        rep[int(mvert)] = r
    cluster_of = list(state.cluster_of)
    replica_of = list(state.replica_of)
    for mvert in members:
        mvert = int(mvert)
        r = rep[mvert]
        cluster_of.append(new_cluster_id)
        replica_of.append(int(state.replica_of[mvert]))
        for w in state.graph.neighbors[mvert]:
            w = int(w)
            if w in mset:
                b.add_edge(r, rep[w])  # intra-cluster edge between replicas
            else:
                b.add_edge(r, w)  # inter-cluster edge to the original's neighbor
    state_cluster_of = np.array(cluster_of, dtype=np.int32)
    state_replica_of = np.array(replica_of, dtype=np.int32)
    return b, rep, state_cluster_of, state_replica_of


def replicate_quadric_cluster(state: ExpandedPolarFly) -> ExpandedPolarFly:
    """§VI-A: replicate C_0 once (always clones the *original* quadric rack;
    Def. VI.1 then carries over edges to earlier replicas automatically)."""
    orig_c0 = np.where(state.layout.cluster_of == 0)[0]
    new_cid = len(state.centers)
    b, rep, cluster_of, replica_of = _replicate(state, orig_c0, new_cid)
    # interconnect each quadric with ALL of its replicas (originals + previous ones)
    for q0 in orig_c0:
        q0 = int(q0)
        copies = [q0] + [i for i in range(len(replica_of))
                         if replica_of[i] == q0 and i != q0]
        for i in range(len(copies)):
            for j in range(i + 1, len(copies)):
                b.add_edge(copies[i], copies[j])
    g = b.freeze()
    g.params["expansions"] = g.params.get("expansions", 0) + 1
    return ExpandedPolarFly(
        graph=g, layout=state.layout, cluster_of=cluster_of,
        centers=state.centers + [-1], replica_of=replica_of,
        num_quadric_replications=state.num_quadric_replications + 1,
        num_nonquadric_replications=state.num_nonquadric_replications,
        next_nonquadric=state.next_nonquadric,
    )


def replicate_nonquadric_cluster(state: ExpandedPolarFly) -> ExpandedPolarFly:
    """§VI-B: replicate the next non-quadric cluster (round robin C_1..C_q)."""
    q = state.layout.pf.q
    cid = state.next_nonquadric
    members = np.where(state.layout.cluster_of == cid)[0]  # original members
    new_cid = len(state.centers)
    b, rep, cluster_of, replica_of = _replicate(state, members, new_cid)
    center = int(state.layout.centers[cid - 1])

    # degree fix-up: for every other non-quadric cluster C_j (and its replicas),
    # connect the replica of the unique u' in C_i with no edges to C_j to the
    # center of C_j.
    member_set = set(int(m) for m in members)
    ncl = len(state.centers)
    for j in range(1, ncl):
        if j == cid:
            continue
        cj_center = state.centers[j]
        if cj_center < 0:
            continue
        cj_members = set(int(x) for x in np.where(state.cluster_of == j)[0])
        uprime = None
        for u in members:
            u = int(u)
            if u == center:
                continue  # Prop. V.4.3: u' is in V1(q, C_i) \ {c_i}
            if not any(int(w) in cj_members for w in state.graph.neighbors[u]):
                uprime = u
                break
        if uprime is not None:
            b.add_edge(rep[uprime], cj_center)

    g = b.freeze()
    g.params["expansions"] = g.params.get("expansions", 0) + 1
    nxt = cid % q + 1
    return ExpandedPolarFly(
        graph=g, layout=state.layout, cluster_of=cluster_of,
        centers=state.centers + [rep[center]], replica_of=replica_of,
        num_quadric_replications=state.num_quadric_replications,
        num_nonquadric_replications=state.num_nonquadric_replications + 1,
        next_nonquadric=nxt,
    )


def expand(layout: Layout, num_steps: int, method: str = "nonquadric") -> ExpandedPolarFly:
    """Apply `num_steps` replications of the chosen kind."""
    state = _init_state(layout)
    step = {"quadric": replicate_quadric_cluster,
            "nonquadric": replicate_nonquadric_cluster}[method]
    for _ in range(num_steps):
        state = step(state)
    return state
