"""PolarFly as the physical fabric of the training framework.

Placement of logical mesh axes onto PF(q) racks and topology-aware
collective cost models (contention computed on the paper's routing
tables).  The JAX package's ``fabric/`` on the port's own host modules;
the cost models take the link rate from the caller (see `collectives`).
"""

from .placement import PodPlacement, place_pod, DEFAULT_POD_Q  # noqa: F401
from .collectives import (  # noqa: F401
    CollectiveCost, ring_allreduce, rhd_allreduce, polar2phase_allreduce,
    all_gather, all_to_all, best_allreduce,
)
