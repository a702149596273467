"""Fluid network simulator reproducing the paper's §VIII evaluation, and
the flit-level packet engine for tail latency under transients.

The fluid engines are all ported: batched and scalar, certified
(`Certificate`, `CertifiedResult`) and traced (`trace=True`).  So is the
packet engine (`simulate_packets`, `simulate_packets_batch`, and the
scalar reference `simulate_packets_reference`).
"""

from .traffic import TrafficPattern, make_pattern, PATTERNS  # noqa: F401
from .paths import (FlowPaths, build_flow_paths,  # noqa: F401
                    build_flow_paths_chunks, build_flow_paths_reference,
                    build_directed_edges, blocked_paths_peak_bytes)
from .fluid import (FluidResult, SaturationResult,  # noqa: F401
                    Certificate, CertifiedResult, evaluate_load,
                    saturation_throughput, truncation_error, latency_curve)
from .packet import (BurstSchedule, PacketWorkload,  # noqa: F401
                     PacketResult, make_workload, build_failure_workload,
                     simulate_packets, simulate_packets_reference,
                     simulate_packets_batch, packet_peak_bytes,
                     tail_percentiles, occupancy_histogram,
                     record_occupancy)
