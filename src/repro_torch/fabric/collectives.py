"""Topology-aware collective cost models over PolarFly placement.

Every algorithm is costed from *actual link contention*: a round of a
collective is a set of (src, dst) node pairs each moving `bytes_per_pair`;
the pairs route over the PolarFly minimal routing tables, the max link load
L of the round determines its time  t = bytes_per_pair * L / link_bw.

Algorithms:
  ring           -- classic ring reduce-scatter + all-gather (2(n-1) rounds)
  rhd            -- recursive halving/doubling (2 log2 n rounds); on a
                    diameter-2 graph every pairing is <= 2 hops
  polar2phase    -- *beyond-paper*: hierarchical all-reduce exploiting the
                    Algorithm-1 rack structure: intra-rack reduce-scatter
                    (1-hop star around the rack center), inter-rack
                    all-reduce over the q-2 parallel rack-to-rack bundles
                    (Prop. V.4.2), intra-rack all-gather.

A copy of the JAX package's ``fabric/collectives.py`` (numpy only, host
code: there is nothing to put on the card) with one change.  The
reference defaults every ``link_bw`` to its ``LINK_BW``, a TPU interconnect
rate; the port states no link rate of its own.  Every function keeps the
reference's parameter list and order, so a positional call binds the same
way, but ``link_bw`` defaults to None and None raises ValueError: the
caller gives the rate of the links it models, in bytes/s per link.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .placement import PodPlacement

__all__ = ["CollectiveCost", "round_time", "ring_allreduce", "rhd_allreduce",
           "polar2phase_allreduce", "all_gather", "all_to_all", "best_allreduce"]


def _link_rate(link_bw: Optional[float]) -> float:
    """`link_bw` as a positive float; None (the default of every cost
    model here) raises, since the port states no link rate of its own."""
    if link_bw is None:
        raise ValueError("link_bw is None: pass the link rate (bytes/s per "
                         "link) of the fabric being modelled")
    if not link_bw > 0:
        raise ValueError(f"link_bw must be > 0, got {link_bw}")
    return float(link_bw)


@dataclass
class CollectiveCost:
    algorithm: str
    seconds: float
    rounds: int
    max_link_load: float  # worst per-round link contention (1 = contention-free)
    bytes_on_wire: float


def _link_loads(pp: PodPlacement, pairs: Sequence[Tuple[int, int]]) -> float:
    """Max directed-link load when all (src, dst) PF-node pairs send 1 unit
    simultaneously over minimal routes."""
    nh = pp.routing.next_hop
    loads: Dict[Tuple[int, int], float] = {}
    for s, d in pairs:
        u = s
        while u != d:
            v = int(nh[u, d])
            loads[(u, v)] = loads.get((u, v), 0.0) + 1.0
            u = v
    return max(loads.values()) if loads else 0.0


def round_time(pp: PodPlacement, pairs, bytes_per_pair: float,
               link_bw: Optional[float] = None) -> Tuple[float, float]:
    link_bw = _link_rate(link_bw)
    load = _link_loads(pp, pairs)
    return bytes_per_pair * load / link_bw, load


def _axis_nodes(pp: PodPlacement, axis: str, index: int) -> np.ndarray:
    """PF nodes of one axis group: a row (model group) or column (data group)."""
    if axis == "model":
        return pp.node_of[index, :]
    if axis == "data":
        return pp.node_of[:, index]
    raise ValueError(axis)


def ring_allreduce(pp: PodPlacement, axis: str, nbytes: float,
                   index: int = 0, link_bw: Optional[float] = None) -> CollectiveCost:
    link_bw = _link_rate(link_bw)
    nodes = _axis_nodes(pp, axis, index)
    n = len(nodes)
    pairs = [(int(nodes[i]), int(nodes[(i + 1) % n])) for i in range(n)]
    t1, load = round_time(pp, pairs, nbytes / n, link_bw)
    secs = 2 * (n - 1) * t1
    return CollectiveCost("ring", secs, 2 * (n - 1), load,
                          2 * (n - 1) * nbytes / n * n)


def rhd_allreduce(pp: PodPlacement, axis: str, nbytes: float,
                  index: int = 0, link_bw: Optional[float] = None) -> CollectiveCost:
    """Recursive halving (reduce-scatter) + doubling (all-gather)."""
    link_bw = _link_rate(link_bw)
    nodes = _axis_nodes(pp, axis, index)
    n = len(nodes)
    if n & (n - 1):
        raise ValueError(f"rhd requires a power-of-two group, got {n}")
    secs, maxload, wire = 0.0, 0.0, 0.0
    chunk = nbytes
    rounds = 0
    for stage in range(int(np.log2(n))):
        stride = 1 << stage
        chunk = chunk / 2
        pairs = []
        for i in range(n):
            j = i ^ stride
            pairs.append((int(nodes[i]), int(nodes[j])))
        t, load = round_time(pp, pairs, chunk, link_bw)
        secs += 2 * t  # once in reduce-scatter, once mirrored in all-gather
        maxload = max(maxload, load)
        wire += 2 * chunk * n
        rounds += 2
    return CollectiveCost("rhd", secs, rounds, maxload, wire)


def polar2phase_allreduce(pp: PodPlacement, nbytes: float,
                          link_bw: Optional[float] = None) -> CollectiveCost:
    """Full-mesh (all-chips) all-reduce using the rack structure:

      1. intra-rack reduce-scatter: fan members -> shards, via <=2-hop
         intra-rack paths (ring over the rack, contention ~2).
      2. inter-rack all-reduce of each shard index m: the m-th member of
         every rack ring-reduces across racks; the q-2 parallel bundles
         between rack pairs keep these D rings nearly contention-free.
      3. intra-rack all-gather (mirror of 1).
    """
    link_bw = _link_rate(link_bw)
    D, M = pp.data_size, pp.model_size
    n_total = D * M
    # phase 1/3: ring within each rack (simultaneously on all racks)
    intra_pairs = []
    for d in range(D):
        nodes = pp.node_of[d]
        intra_pairs += [(int(nodes[i]), int(nodes[(i + 1) % M])) for i in range(M)]
    t_intra, load_intra = round_time(pp, intra_pairs, nbytes / M, link_bw)
    secs = 2 * (M - 1) * t_intra  # phase 1 (RS, M-1 rounds) + phase 3 (AG, M-1)
    # phase 2: M simultaneous inter-rack rings on shards of nbytes/M
    inter_pairs = []
    for m in range(M):
        nodes = pp.node_of[:, m]
        inter_pairs += [(int(nodes[i]), int(nodes[(i + 1) % D])) for i in range(D)]
    t_inter, load_inter = round_time(pp, inter_pairs, nbytes / (M * D), link_bw)
    secs += 2 * (D - 1) * t_inter
    wire = 2 * (M - 1) * nbytes / M * M * 2 + 2 * (D - 1) * nbytes / (M * D) * n_total
    return CollectiveCost("polar2phase", secs, 2 * (2 * (M - 1)) + 2 * (D - 1),
                          max(load_intra, load_inter), wire)


def all_gather(pp: PodPlacement, axis: str, nbytes_per_shard: float,
               index: int = 0, link_bw: Optional[float] = None) -> CollectiveCost:
    """Ring all-gather of n shards (n-1 rounds)."""
    link_bw = _link_rate(link_bw)
    nodes = _axis_nodes(pp, axis, index)
    n = len(nodes)
    pairs = [(int(nodes[i]), int(nodes[(i + 1) % n])) for i in range(n)]
    t1, load = round_time(pp, pairs, nbytes_per_shard, link_bw)
    return CollectiveCost("ag-ring", (n - 1) * t1, n - 1, load,
                          (n - 1) * nbytes_per_shard * n)


def all_to_all(pp: PodPlacement, axis: str, nbytes_total: float,
               index: int = 0, link_bw: Optional[float] = None) -> CollectiveCost:
    """Direct all-to-all: n-1 rounds of shifted permutations (each node sends
    nbytes_total/n to every peer); on diameter-2 PolarFly every round is <=2
    hops."""
    link_bw = _link_rate(link_bw)
    nodes = _axis_nodes(pp, axis, index)
    n = len(nodes)
    per_pair = nbytes_total / n
    secs, maxload = 0.0, 0.0
    for shift in range(1, n):
        pairs = [(int(nodes[i]), int(nodes[(i + shift) % n])) for i in range(n)]
        t, load = round_time(pp, pairs, per_pair, link_bw)
        secs += t
        maxload = max(maxload, load)
    return CollectiveCost("a2a-direct", secs, n - 1, maxload,
                          (n - 1) * per_pair * n)


def best_allreduce(pp: PodPlacement, axis: str, nbytes: float,
                   index: int = 0, link_bw: Optional[float] = None) -> CollectiveCost:
    """Pick the cheapest all-reduce algorithm for this axis/size (the
    fabric scheduler's decision rule)."""
    link_bw = _link_rate(link_bw)
    cands: List[CollectiveCost] = [
        ring_allreduce(pp, axis, nbytes, index, link_bw),
        rhd_allreduce(pp, axis, nbytes, index, link_bw),
    ]
    return min(cands, key=lambda c: c.seconds)
