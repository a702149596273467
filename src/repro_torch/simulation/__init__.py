"""Fluid network simulator reproducing the paper's §VIII evaluation.

The fluid engines are all ported: batched and scalar, certified
(`Certificate`, `CertifiedResult`) and traced (`trace=True`).  The
flit-level packet engine of the JAX package is not ported yet (ROADMAP
Queue 1, item 8), so nothing of it is exported here.
"""

from .traffic import TrafficPattern, make_pattern, PATTERNS  # noqa: F401
from .paths import (FlowPaths, build_flow_paths,  # noqa: F401
                    build_flow_paths_chunks, build_flow_paths_reference,
                    build_directed_edges, blocked_paths_peak_bytes)
from .fluid import (FluidResult, SaturationResult,  # noqa: F401
                    Certificate, CertifiedResult, evaluate_load,
                    saturation_throughput, truncation_error, latency_curve)
