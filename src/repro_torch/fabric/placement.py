"""Logical-mesh -> PolarFly placement (the paper as a *fabric* for training).

A 256-chip pod's logical (data=16, model=16) mesh is placed onto PF(17)
(N = 307, radix 18) using the paper's Algorithm-1 rack structure:

  * model axis (TP, latency/bandwidth critical) -> *within* a rack: the
    16 placed members of one non-quadric cluster.  Intra-rack distance is 1
    hop to the center and <= 2 between fan vertices, and racks are physical
    (short copper / single multi-core fiber bundles, paper §V-B).
  * data axis (DP/FSDP) -> *across* the q isomorphic non-quadric racks,
    which are pairwise joined by q-2 = 15 parallel link bundles
    (Prop. V.4.2) -- near-uniform rack-to-rack bandwidth for the gradient
    reduce-scatter.

The 51 unplaced nodes (the quadric rack + one spare rack + one spare node
per used rack) are hot spares for fault tolerance: on node failure the
elastic layer (`remap_failed`) remaps the affected coordinate to a
spare, which by diameter-2 is <= 2 hops from every surviving node.

A copy of the JAX package's ``fabric/placement.py`` (numpy only) on the
port's own ``core.{polarfly,layout,routing}``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.layout import Layout, build_layout
from ..core.polarfly import PolarFly, build_polarfly
from ..core.routing import RoutingTables, build_routing

__all__ = ["PodPlacement", "place_pod", "DEFAULT_POD_Q"]

DEFAULT_POD_Q = 17  # PF(17): 307 nodes >= 256 chips, radix 18


@dataclass
class PodPlacement:
    pf: PolarFly = field(repr=False)
    layout: Layout = field(repr=False)
    routing: RoutingTables = field(repr=False)
    node_of: np.ndarray  # [data, model] -> PF node id
    spares: np.ndarray  # unused PF node ids

    @property
    def data_size(self) -> int:
        return self.node_of.shape[0]

    @property
    def model_size(self) -> int:
        return self.node_of.shape[1]

    def coord_of(self) -> dict:
        return {int(self.node_of[d, m]): (d, m)
                for d in range(self.data_size) for m in range(self.model_size)}

    # -- fault tolerance hook --------------------------------------------------
    def remap_failed(self, data_idx: int, model_idx: int) -> "PodPlacement":
        """Replace a failed chip's PF node with a hot spare (no rewiring)."""
        if len(self.spares) == 0:
            raise RuntimeError("no spare nodes left in pod")
        node_of = self.node_of.copy()
        failed = node_of[data_idx, model_idx]
        # prefer a spare in the same rack (same cluster id) for locality
        cid = self.layout.cluster_of[failed]
        same_rack = [s for s in self.spares if self.layout.cluster_of[s] == cid]
        pick = same_rack[0] if same_rack else int(self.spares[0])
        node_of[data_idx, model_idx] = pick
        spares = np.array([s for s in self.spares if s != pick], dtype=np.int32)
        return PodPlacement(self.pf, self.layout, self.routing, node_of, spares)


def place_pod(data: int = 16, model: int = 16, q: int = DEFAULT_POD_Q,
              pf: Optional[PolarFly] = None) -> PodPlacement:
    """Place a (data x model) logical mesh on PF(q) racks."""
    pf = pf or build_polarfly(q)
    if data > q:
        raise ValueError(f"data={data} > q={q} non-quadric racks available")
    layout = build_layout(pf)
    rt = build_routing(pf.graph, pf)
    node_of = np.zeros((data, model), dtype=np.int32)
    used = set()
    for d in range(data):
        members = layout.clusters[d + 1]  # non-quadric rack d+1
        if model > len(members):
            raise ValueError(f"model={model} > rack size {len(members)}")
        # center first (TP hub), then fan members in id order
        center = layout.centers[d]
        rest = [int(x) for x in members if int(x) != int(center)]
        ordered = [int(center)] + rest
        for m in range(model):
            node_of[d, m] = ordered[m]
            used.add(ordered[m])
    spares = np.array([v for v in range(pf.n) if v not in used], dtype=np.int32)
    return PodPlacement(pf=pf, layout=layout, routing=rt, node_of=node_of,
                        spares=spares)
