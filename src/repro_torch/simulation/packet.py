"""Cycle-driven flit-level packet engine: tail latency under transients.

The port of the JAX package's ``simulation/packet.py``: the host part
(workloads, results, the reference engine) is a copy; the batched engine
is PyTorch on a chosen device.

The fluid solver answers steady-state questions; this engine answers the
operational ones -- p50/p99/p999 packet latency under bursts, adaptive
routing transients, and mid-run link failures (the quantities the Slim
Fly deployment study measures on real hardware; see PAPERS.md).

Model (one spec, two engines)
-----------------------------
Wormhole-ish store-and-forward at packet granularity with flit-level
timing: every directed link has a FIFO output queue of `capacity`
packets; the head packet serializes for `size` cycles (one flit per
cycle) before it may advance; advancing requires a free slot in the next
link's queue (credit-based backpressure, credits returned with a
one-cycle delay: a slot freed this cycle is usable next cycle).  Each
cycle runs the same five phases in both engines:

1. serialization countdown: every non-empty link's head decrements its
   remaining service (floor 0); heads at 0 are *ready*.
2. in-flight intents: each ready head names its next link from its
   chosen candidate path (the stepping-core-built `FlowPaths` arrays),
   or exits if the path is exhausted (delivery always succeeds).
3. injection intents: per source router, the oldest pending packet
   (arrival ordering) chooses its candidate *now* -- oblivious modes use
   a pre-drawn index, UGAL picks ``argmin_c hops[c] + occupancy(first
   link of c)`` over valid candidates (UGAL_PF additionally keeps the
   minimal candidate unless the min path's first queue is at least 2/3
   full, the paper's adaptation gate) -- and bids for its first link.
4. arbitration per target link: `capacity - occupancy` slots (occupancy
   at cycle start) go to in-flight candidates in upstream-link-id order,
   then to the (unique) injection bid if a slot remains.  Losers stall
   and retry; winners append in that order.
5. head changes (departure or arrival-to-empty) reset the new head's
   serialization clock to `size`.

All quantities are integers and every tie is broken deterministically,
so the scalar reference and the batched engine agree **bit-identically**
on the delivered-packet latency multiset (tests/test_packet_engine.py
asserts it per graph x mode x damage combination).

Engines:

* `simulate_packets_reference` -- per-flit/per-queue Python event loop,
  explicit list queues, conservation invariants (no packet lost or
  duplicated, queues bounded by `capacity`, serialization clocks in
  range) asserted every cycle.  The executable spec; it runs on the host
  whatever the device.
* `simulate_packets` -- the scale engine, in PyTorch on `device`: per-link
  queues as one dense ``[E + 1, Q]`` int32 id matrix (row E is the
  arbitration dump row), a Python loop over cycles under `torch.no_grad`,
  sort-based arbitration (stable sort by target + segmented ranks from
  `torch.searchsorted` -- no scatter-add on the cycle path), gather-only
  routing lookups, no host sync inside the loop (the cycle index enters
  as a Python int; per-cycle occupancy goes into preallocated device
  tensors), and one read-back at the end.  `simulate_packets_batch` runs
  a stack of same-shape workloads (e.g. seed replicas) as one disjoint
  union through the same loop.

Scenarios (`make_workload` / `build_failure_workload`): steady uniform /
tornado / any `TrafficPattern` load, on-off bursts (`BurstSchedule`,
mean-preserving by default), and a mid-run link-failure transient --
epoch-0 paths up to `switch_cycle`, re-routed epoch-1 paths (built on
the damaged graph, remapped into the intact edge-id space via the
stepping core's CSR row recovery) afterwards; in-network packets whose
remaining path crosses a failed link are dropped at the switch, pending
packets re-decide on the new tables.

Per-packet routes are *not* rebuilt here: candidates come from
`build_flow_paths` (which itself rides `repro.core.stepping`), so the
packet engine consumes exactly the `RoutingTables` / `BlockedRouting`
next-hop machinery the fluid solver uses -- one path-construction stack,
two time resolutions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.stepping import edge_sources
from ..parallel.blockwise import peak_bytes
from .paths import DirectedEdges, FlowPaths, build_directed_edges, \
    build_flow_paths
from ..device import resolve_device
from .traffic import TrafficPattern

__all__ = ["BurstSchedule", "PacketWorkload", "PacketResult",
           "make_workload", "build_failure_workload", "remap_edge_space",
           "simulate_packets", "simulate_packets_reference",
           "simulate_packets_batch", "packet_peak_bytes", "tail_percentiles",
           "occupancy_histogram", "record_occupancy"]

# Paper §VIII-A buffering: 128-flit buffers, 4-flit packets -> 32-packet
# queues; the same constants the fluid solver's M/D/1 delay model uses
# (`fluid._BUF_PACKETS`).
DEFAULT_PACKET_FLITS = 4
DEFAULT_QUEUE_PACKETS = 32

# candidate-cost infinity for invalid slots (int32-safe)
_BIG = np.int32(2 ** 30)


def _gate_occ(capacity: int) -> int:
    """UGAL_PF adaptation gate in packets: adapt away from the minimal
    path only once its first queue is >= 2/3 full (paper §VII-C)."""
    return -(-2 * capacity // 3)


# --------------------------------------------------------------------------
# workload construction (host side, shared verbatim by both engines)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class BurstSchedule:
    """On-off injection modulation: each flow injects only during the
    `on`-cycle window of every `on + off` period (per-flow phase offsets
    are drawn by `make_workload`, desynchronizing flows); `scale`
    multiplies the on-window rate -- the default 0.0 means
    mean-preserving, ``(on + off) / on``."""
    on: int
    off: int
    scale: float = 0.0

    @property
    def period(self) -> int:
        return self.on + self.off

    def rate_scale(self) -> float:
        return self.scale if self.scale > 0 else self.period / self.on


@dataclass
class PacketWorkload:
    """Everything both engines consume, fully materialized host-side.

    Path arrays are epoch-stacked ([0] before `switch_cycle`, [1] after;
    without a failure scenario both epochs alias the same tables): `eidx`
    holds each candidate's directed-edge sequence padded with `num_links`
    (the exit marker), one column wider than the hop budget so the
    per-cycle next-edge gather never branches.  Packets are sorted by
    (source router, arrival cycle) and identified by their index;
    `src_off` gives each source's contiguous packet segment, which is
    what makes per-source FIFO injection a pointer per source.
    """
    eidx: np.ndarray       # [2, F, K, L + 1] int32, pads/exit -> num_links
    hops: np.ndarray       # [2, F, K] int32
    n_valid: np.ndarray    # [2, F] int32 (valid candidates are a prefix)
    pkt_flow: np.ndarray   # [P] int32
    pkt_t: np.ndarray      # [P] int32 arrival cycles (nondecreasing per src)
    pkt_cand: np.ndarray   # [2, P] int32 pre-drawn oblivious candidate
    src_off: np.ndarray    # [n + 1] int64 per-source packet segments
    num_links: int
    num_nodes: int
    size: int              # flits per packet == serialization cycles per hop
    capacity: int          # per-link queue capacity, packets
    cycles: int
    mode: str
    switch_cycle: int      # == cycles when there is no failure epoch
    fail_hop: np.ndarray   # [F, K] int32 last failed hop on epoch-0 paths
    #   (L + 1 for clean paths; a packet at hop h is dropped iff
    #    h <= fail_hop < hops -- some failed link is still ahead of or
    #    under it)
    pattern_name: str = ""

    @property
    def num_packets(self) -> int:
        return len(self.pkt_flow)

    @property
    def num_flows(self) -> int:
        return self.eidx.shape[1]

    @property
    def adaptive(self) -> bool:
        return self.mode in ("ugal", "ugal_pf")

    @property
    def gated(self) -> bool:
        return self.mode == "ugal_pf"


def _epoch_tables(fp: FlowPaths, edges: np.ndarray, hops: np.ndarray,
                  valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One epoch's (eidx [F, K, L + 1], n_valid [F]) from candidate arrays
    in `fp`'s edge-id space; asserts the prefix-validity every mode the
    engine supports satisfies (oblivious draws index the prefix)."""
    f, k, l = edges.shape
    n_valid = valid.sum(axis=1).astype(np.int32)
    if not (n_valid >= 1).all():
        raise ValueError("every flow needs at least one valid candidate")
    if not (valid == (np.arange(k) < n_valid[:, None])).all():
        raise ValueError("packet engine requires prefix-valid candidates")
    eidx = np.full((f, k, l + 1), fp.num_links, dtype=np.int32)
    real = edges >= 0
    eidx[:, :, :l] = np.where(real, edges, fp.num_links)
    # exit marker position == hops is automatic: pads already map to E
    return eidx, n_valid


def remap_edge_space(edges: np.ndarray, de_from: DirectedEdges,
                     de_to: DirectedEdges) -> np.ndarray:
    """Remap -1-padded directed-edge ids from one graph's CSR id space to
    another's (damaged subgraph -> intact parent).  Recovers each edge's
    (source, target) pair via the stepping core's CSR row recovery, then
    looks the pair up in the target space.  Raises if a real edge has no
    image (the damaged graph must be a subgraph)."""
    real = edges >= 0
    safe = np.where(real, edges, 0)
    u = edge_sources(de_from.offsets, safe)
    v = de_from.targets[safe]
    mapped = de_to.edge_ids(u, v)
    if not (mapped[real] >= 0).all():
        raise ValueError("edge remap misses: not a subgraph of the target")
    return np.where(real, mapped, np.int32(-1)).astype(np.int32)


def _injection_times(demand: np.ndarray, offered: float, size: int,
                     cycles: int, burst: Optional[BurstSchedule],
                     phase: np.ndarray, bphase: np.ndarray,
                     chunk: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """Arrival times per flow from a credit accumulator: flow f earns
    ``offered * demand[f] / size`` packets per cycle (scaled inside burst
    on-windows), seeded with a fractional phase in [0, 1); a packet
    arrives whenever the accumulator crosses an integer.  Returns
    (pkt_flow, pkt_t) unsorted; chunked over flows so the [F, T] credit
    matrix never materializes whole."""
    f = len(demand)
    rate = offered * demand.astype(np.float64) / float(size)
    t = np.arange(cycles, dtype=np.int64)
    flows: List[np.ndarray] = []
    times: List[np.ndarray] = []
    for lo in range(0, f, chunk):
        hi = min(f, lo + chunk)
        r = np.broadcast_to(rate[lo:hi, None], (hi - lo, cycles))
        if burst is not None:
            active = ((t[None, :] + bphase[lo:hi, None]) % burst.period
                      ) < burst.on
            r = r * (burst.rate_scale() * active)
        cum = phase[lo:hi, None] + np.cumsum(r, axis=1)
        cnt = np.floor(cum).astype(np.int64)
        prev = np.concatenate(
            [np.zeros((hi - lo, 1), dtype=np.int64), cnt[:, :-1]], axis=1)
        k_new = cnt - prev  # packets arriving at cycle t
        fi, ti = np.nonzero(k_new)
        rep = k_new[fi, ti]
        flows.append(np.repeat(fi + lo, rep).astype(np.int32))
        times.append(np.repeat(ti, rep).astype(np.int32))
    return (np.concatenate(flows) if flows else np.zeros(0, np.int32),
            np.concatenate(times) if times else np.zeros(0, np.int32))


def make_workload(fp: FlowPaths, offered: float, cycles: int, *,
                  size: int = DEFAULT_PACKET_FLITS,
                  capacity: int = DEFAULT_QUEUE_PACKETS,
                  burst: Optional[BurstSchedule] = None,
                  after: Optional[Tuple[np.ndarray, np.ndarray,
                                        np.ndarray]] = None,
                  switch_cycle: Optional[int] = None,
                  failed_edges: Optional[np.ndarray] = None,
                  num_nodes: Optional[int] = None,
                  flow_sample: Optional[int] = None,
                  max_packets: int = 400_000, seed: int = 0,
                  rng: Optional[np.random.Generator] = None
                  ) -> PacketWorkload:
    """Materialize a packet workload from flow candidates.

    `offered` scales the pattern's per-flow demand (flits/cycle at unit
    load) into packet arrival rates.  `burst` switches steady injection
    to on-off windows.  `after` = (edges, hops, valid) supplies epoch-1
    re-routed candidates **already remapped into fp's edge-id space**
    (see `build_failure_workload` for the assembled scenario) active
    from `switch_cycle` on, with `failed_edges` naming the dead directed
    links (epoch-0 packets still due to cross one are dropped at the
    switch).  `flow_sample` draws that many flows up front (the
    sampled-flow scale tier).  All randomness -- flow sampling, phases,
    oblivious candidate draws -- comes from the single `rng`
    (`np.random.default_rng(seed)` when not given), in a fixed order, so
    equal seeds give identical workloads and therefore identical tail
    metrics from either engine.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    pat = fp.pattern
    nn = int(num_nodes if num_nodes is not None
             else max(int(pat.src.max()), int(pat.dst.max())) + 1)
    sel = np.arange(fp.pattern.num_flows)
    if flow_sample is not None and flow_sample < len(sel):
        sel = np.sort(rng.choice(len(sel), size=flow_sample, replace=False))
    edges0, hops0, valid0 = (fp.edges[sel], fp.hops[sel], fp.valid[sel])
    src, demand = pat.src[sel], pat.demand[sel]
    eidx0, nv0 = _epoch_tables(fp, edges0, hops0, valid0)
    if after is not None:
        e1, h1, v1 = after
        eidx1, nv1 = _epoch_tables(fp, e1[sel], h1[sel], v1[sel])
        hops1 = h1[sel]
        if switch_cycle is None:
            raise ValueError("failure epoch needs switch_cycle")
    else:
        eidx1, nv1, hops1 = eidx0, nv0, hops0
        switch_cycle = cycles
    # epochs may disagree on max path length (re-routes around failures
    # run longer): pad both to the wider hop budget with the exit marker
    lmax = max(eidx0.shape[2], eidx1.shape[2])
    pad_l = lambda a: np.concatenate(  # noqa: E731
        [a, np.full(a.shape[:2] + (lmax - a.shape[2],), fp.num_links,
                    dtype=np.int32)], axis=2)
    eidx = np.stack([pad_l(eidx0), pad_l(eidx1)])
    hops2 = np.stack([hops0.astype(np.int32), hops1.astype(np.int32)])
    n_valid = np.stack([nv0, nv1])

    # last failed hop per epoch-0 candidate (L + 1 when the path is
    # clean); the drop test `hop <= fail_hop` must see the *last* failed
    # link, or a packet past one failure but short of a second survives
    l1 = eidx.shape[3]
    if failed_edges is not None and len(failed_edges):
        fmask = np.zeros(fp.num_links + 1, dtype=bool)
        fmask[np.asarray(failed_edges, dtype=np.int64)] = True
        onpath = fmask[eidx0]  # [F, K, L0 + 1] (pre-pad width)
        anyf = onpath.any(axis=2)
        last = onpath.shape[2] - 1 - onpath[:, :, ::-1].argmax(axis=2)
        fail_hop = np.where(anyf, last, l1).astype(np.int32)
    else:
        fail_hop = np.full(hops0.shape, l1, dtype=np.int32)

    phase = rng.random(len(sel))
    bphase = (rng.integers(burst.period, size=len(sel))
              if burst is not None else np.zeros(len(sel), np.int64))
    pkt_flow, pkt_t = _injection_times(demand, offered, size, cycles, burst,
                                       phase, bphase)
    if len(pkt_flow) > max_packets:
        raise ValueError(
            f"{len(pkt_flow)} packets exceed max_packets={max_packets}; "
            "lower offered/cycles or pass flow_sample")
    # id order = (source router, arrival cycle, flow): per-source FIFO
    order = np.lexsort((pkt_flow, pkt_t, src[pkt_flow]))
    pkt_flow, pkt_t = pkt_flow[order], pkt_t[order]
    src_off = np.searchsorted(src[pkt_flow], np.arange(nn + 1),
                              side="left").astype(np.int64)
    u = rng.random(len(pkt_flow))
    pkt_cand = np.stack([
        np.minimum((u * n_valid[ep, pkt_flow]).astype(np.int32),
                   n_valid[ep, pkt_flow] - 1)
        for ep in (0, 1)])
    return PacketWorkload(
        eidx=eidx, hops=hops2, n_valid=n_valid, pkt_flow=pkt_flow,
        pkt_t=pkt_t, pkt_cand=pkt_cand, src_off=src_off,
        num_links=fp.num_links, num_nodes=nn, size=size, capacity=capacity,
        cycles=cycles, mode=fp.mode, switch_cycle=int(switch_cycle),
        fail_hop=fail_hop, pattern_name=pat.name)


def build_failure_workload(rt, rt_after, pattern: TrafficPattern, mode: str,
                           offered: float, cycles: int, switch_cycle: int,
                           *, k_candidates: int = 8, seed: int = 0,
                           rng: Optional[np.random.Generator] = None,
                           **kw) -> PacketWorkload:
    """Assemble the mid-run link-failure transient: epoch-0 candidates on
    `rt` (intact), epoch-1 candidates on `rt_after` (whose graph must be
    an edge-subgraph of the intact one), remapped into the intact
    directed-edge space; directed links missing from the damaged graph
    become the failure set.  Extra keyword arguments pass through to
    `make_workload`."""
    fp = build_flow_paths(rt, pattern, mode, k_candidates=k_candidates,
                          seed=seed)
    fp2 = build_flow_paths(rt_after, pattern, mode,
                           k_candidates=k_candidates, seed=seed)
    de = build_directed_edges(rt.graph)
    de2 = build_directed_edges(rt_after.graph)
    edges1 = remap_edge_space(fp2.edges, de2, de)
    # failed = intact directed edges with no image in the damaged space
    u = edge_sources(de.offsets, np.arange(de.num))
    failed = np.flatnonzero(de2.edge_ids(u, de.targets) < 0)
    return make_workload(fp, offered, cycles,
                         after=(edges1, fp2.hops, fp2.valid),
                         switch_cycle=switch_cycle, failed_edges=failed,
                         num_nodes=rt.graph.n, seed=seed, rng=rng, **kw)


# --------------------------------------------------------------------------
# results
# --------------------------------------------------------------------------

def tail_percentiles(latencies: np.ndarray,
                     qs: Sequence[float] = (0.5, 0.99, 0.999)
                     ) -> Dict[str, int]:
    """Nearest-rank percentiles of an integer latency sample (exact order
    statistics -- no interpolation, so engine comparisons stay integer).
    Keys are p50/p99/p999-style."""
    lat = np.sort(np.asarray(latencies))
    if not len(lat):
        raise ValueError("no delivered packets to take percentiles of")
    out = {}
    for q in qs:
        idx = max(0, int(np.ceil(q * len(lat))) - 1)
        key = f"p{q * 100:g}".replace(".", "")
        out[key] = int(lat[idx])
    return out


@dataclass
class PacketResult:
    """Per-packet outcomes + time-resolved occupancy from one run."""
    deliver_t: np.ndarray   # [P] int32 (undefined where not delivered)
    delivered: np.ndarray   # [P] bool
    dropped: np.ndarray     # [P] bool (failure-transient casualties)
    inject_t: np.ndarray    # [P] int32 arrival cycles
    occ_sum: np.ndarray     # [T] int32 total queued packets, end of cycle
    occ_max: np.ndarray     # [T] int32 max per-link queue depth
    occ_rec: np.ndarray     # [T, R] int32 tracked links' depths (R may be 0)
    cycles: int
    size: int
    capacity: int

    def latencies(self) -> np.ndarray:
        """Sorted int32 latency multiset of delivered packets."""
        lat = (self.deliver_t[self.delivered]
               - self.inject_t[self.delivered]).astype(np.int32)
        return np.sort(lat)

    def histogram(self) -> np.ndarray:
        """Latency histogram (bin = cycle)."""
        lat = self.latencies()
        return np.bincount(lat) if len(lat) else np.zeros(1, np.int64)

    def tails(self) -> Dict[str, int]:
        return tail_percentiles(self.latencies())

    @property
    def num_delivered(self) -> int:
        return int(self.delivered.sum())

    @property
    def num_dropped(self) -> int:
        return int(self.dropped.sum())


def packet_peak_bytes(wl: PacketWorkload) -> int:
    """Estimated resident bytes of the batched engine's loop state: the
    dense queue matrix + per-link scalars, the epoch-stacked candidate
    tables, and the per-packet bookkeeping -- composed from the shared
    blockwise accounting helper, like the routing/path estimators.  No
    term scales as [n, n]."""
    e, p = wl.num_links, wl.num_packets
    f, k, l1 = wl.eidx.shape[1:]
    resident = 4 * ((e + 1) * wl.capacity + 4 * e)  # queues + occ/serve/etc
    resident += 4 * (2 * f * k * (l1 + 1) + 2 * f)  # eidx/hops/n_valid
    return peak_bytes(p, 7 * 4, resident_bytes=resident)


def occupancy_histogram(res: PacketResult,
                        max_depth: Optional[int] = None) -> np.ndarray:
    """Per-cycle max-queue-depth histogram: `hist[d]` = cycles whose
    deepest link queue held exactly `d` packets.  Bins run 0..capacity
    (or `max_depth`), so saturated runs show mass in the top bin."""
    cap = res.capacity if max_depth is None else int(max_depth)
    occ = np.minimum(res.occ_max, cap)
    return np.bincount(occ, minlength=cap + 1)


def record_occupancy(res: PacketResult, name: str = "packet",
                     recorder=None) -> Dict[str, float]:
    """Surface a run's per-cycle occupancy traces as obs metrics.

    Both engines already produce `occ_sum` / `occ_max` per cycle; this
    turns them into a queue-depth histogram, summary gauges, and
    downsampled time series on the (given or global) recorder, and
    returns the summary dict.  Host-side numpy only -- the batched
    engine's outputs have already been fetched by the time a
    `PacketResult` exists."""
    from ..obs.record import get_recorder
    rec = recorder if recorder is not None else get_recorder()
    occ_sum = np.asarray(res.occ_sum)
    occ_max = np.asarray(res.occ_max)
    cycles = int(res.cycles)
    summary = {
        "cycles": float(cycles),
        "occ_mean": float(occ_sum.mean()) if cycles else 0.0,
        "occ_peak": float(occ_max.max(initial=0)),
        "occ_p99": float(np.percentile(occ_max, 99)) if cycles else 0.0,
        "saturated_frac": float((occ_max >= res.capacity).mean())
        if cycles else 0.0,
    }
    rec.histogram(f"{name}.queue_depth", np.minimum(occ_max, res.capacity))
    rec.series(f"{name}.occ_sum", occ_sum)
    rec.series(f"{name}.occ_max", occ_max)
    for key, v in summary.items():
        rec.gauge(f"{name}.{key}", v)
    return summary


# --------------------------------------------------------------------------
# reference engine (the executable spec; invariants checked every cycle)
# --------------------------------------------------------------------------

def simulate_packets_reference(wl: PacketWorkload,
                               record_links: Optional[np.ndarray] = None,
                               check: bool = True) -> PacketResult:
    """Pure-Python per-flit event loop over explicit per-link FIFO queues.

    Implements the five-phase cycle of the module docstring verbatim;
    with `check` (default) it additionally asserts the conservation
    invariants every cycle: no packet lost or duplicated across queues,
    every queue bounded by `capacity`, serialization clocks in
    [0, size], and the pending/in-network/delivered/dropped partition
    sums to the packet count.
    """
    e_num, p_num = wl.num_links, wl.num_packets
    q_cap, size = wl.capacity, wl.size
    rec = (np.asarray(record_links, dtype=np.int64)
           if record_links is not None else np.zeros(0, np.int64))
    queues: List[List[int]] = [[] for _ in range(e_num)]
    serve = np.zeros(e_num, dtype=np.int64)
    hop = np.zeros(p_num, dtype=np.int64)
    chosen = np.zeros(p_num, dtype=np.int64)
    ep_pkt = np.zeros(p_num, dtype=np.int64)
    ptr = wl.src_off[:-1].copy()
    deliver_t = np.zeros(p_num, dtype=np.int32)
    delivered = np.zeros(p_num, dtype=bool)
    dropped = np.zeros(p_num, dtype=bool)
    occ_sum = np.zeros(wl.cycles, dtype=np.int32)
    occ_max = np.zeros(wl.cycles, dtype=np.int32)
    occ_rec = np.zeros((wl.cycles, len(rec)), dtype=np.int32)
    eidx, hops, n_valid = wl.eidx, wl.hops, wl.n_valid
    gate = _gate_occ(q_cap)
    admitted = 0

    def _invariants(t: int) -> None:
        seen: List[int] = []
        for e in range(e_num):
            assert len(queues[e]) <= q_cap, f"queue {e} over capacity at {t}"
            seen.extend(queues[e])
        assert len(seen) == len(set(seen)), f"duplicated packet at {t}"
        in_net = len(seen)
        pending = int(sum(wl.src_off[1:] - ptr))
        done = int(delivered.sum()) + int(dropped.sum())
        assert pending + in_net + done == p_num, f"packet leak at cycle {t}"
        assert ((serve >= 0) & (serve <= size)).all()

    for t in range(wl.cycles):
        if t == wl.switch_cycle:
            _drop_failed_reference(wl, queues, serve, hop, chosen, ep_pkt,
                                   dropped)
        occ0 = [len(q) for q in queues]  # cycle-start occupancies
        # phase 1: serialization countdown
        for e in range(e_num):
            if occ0[e] and serve[e] > 0:
                serve[e] -= 1
        # phase 2: in-flight intents (upstream-link-id order)
        movers: Dict[int, List[Tuple[int, int]]] = {}
        exits: List[Tuple[int, int]] = []
        for e in range(e_num):
            if not occ0[e] or serve[e] != 0:
                continue
            pid = queues[e][0]
            nxt = int(eidx[ep_pkt[pid], wl.pkt_flow[pid], chosen[pid],
                           hop[pid] + 1])
            if nxt == e_num:
                exits.append((e, pid))
            else:
                movers.setdefault(nxt, []).append((e, pid))
        # phase 3: injection intents (one bid per source, FIFO per source)
        ep_now = 1 if t >= wl.switch_cycle else 0
        bids: Dict[int, Tuple[int, int, int]] = {}
        for s in range(wl.num_nodes):
            p = int(ptr[s])
            if p >= wl.src_off[s + 1] or wl.pkt_t[p] > t:
                continue
            f = int(wl.pkt_flow[p])
            if wl.adaptive:
                c = _decide_reference(wl, occ0, ep_now, f, gate)
            else:
                c = int(wl.pkt_cand[ep_now, p])
            tgt = int(eidx[ep_now, f, c, 0])
            assert tgt not in bids  # first links are source-distinct
            bids[tgt] = (s, p, c)
        # phase 4: arbitration + apply (in-flight first, then the bid)
        heads0 = {e: queues[e][0] for e in range(e_num) if queues[e]}
        for e, pid in exits:
            queues[e].pop(0)
            deliver_t[pid] = t
            delivered[pid] = True
        for tgt in sorted(set(movers) | set(bids)):
            free = q_cap - occ0[tgt]
            cands = movers.get(tgt, [])
            for e, pid in cands[:free]:
                queues[e].pop(0)
                queues[tgt].append(pid)
                hop[pid] += 1
            if tgt in bids and min(len(cands), free) < free:
                s, p, c = bids[tgt]
                queues[tgt].append(p)
                hop[p] = 0
                chosen[p] = c
                ep_pkt[p] = ep_now
                ptr[s] += 1
                admitted += 1
        # phase 5: head changes reset the serialization clock
        for e in range(e_num):
            head = queues[e][0] if queues[e] else p_num
            if head != heads0.get(e, p_num):
                serve[e] = size
        occ1 = np.array([len(q) for q in queues], dtype=np.int32)
        occ_sum[t] = occ1.sum()
        occ_max[t] = occ1.max() if e_num else 0
        if len(rec):
            occ_rec[t] = occ1[rec]
        if check:
            _invariants(t)
    return PacketResult(deliver_t=deliver_t, delivered=delivered,
                        dropped=dropped, inject_t=wl.pkt_t.copy(),
                        occ_sum=occ_sum, occ_max=occ_max, occ_rec=occ_rec,
                        cycles=wl.cycles, size=size, capacity=q_cap)


def _decide_reference(wl: PacketWorkload, occ0: List[int], ep: int, f: int,
                      gate: int) -> int:
    """UGAL candidate choice: argmin over the valid prefix of
    hops + first-link occupancy (first index wins ties); UGAL_PF keeps
    the minimal candidate below the 2/3 gate."""
    eidx, hops = wl.eidx, wl.hops
    best_c, best_cost = 0, None
    for c in range(int(wl.n_valid[ep, f])):
        cost = int(hops[ep, f, c]) + occ0[int(eidx[ep, f, c, 0])]
        if best_cost is None or cost < best_cost:
            best_c, best_cost = c, cost
    if wl.gated and occ0[int(eidx[ep, f, 0, 0])] < gate:
        return 0
    return best_c


def _drop_failed_reference(wl: PacketWorkload, queues: List[List[int]],
                           serve: np.ndarray, hop: np.ndarray,
                           chosen: np.ndarray, ep_pkt: np.ndarray,
                           dropped: np.ndarray) -> None:
    """Failure switch: drop every in-network epoch-0 packet whose current
    or remaining hops cross a failed link (already-crossed links don't
    matter), compacting queues in order; changed heads restart their
    serialization clock."""
    for e in range(wl.num_links):
        if not queues[e]:
            continue
        head0 = queues[e][0]
        kept = []
        for pid in queues[e]:
            fh = int(wl.fail_hop[wl.pkt_flow[pid], chosen[pid]])
            hp = int(wl.hops[0, wl.pkt_flow[pid], chosen[pid]])
            if ep_pkt[pid] == 0 and hop[pid] <= fh < hp:
                dropped[pid] = True
            else:
                kept.append(pid)
        queues[e][:] = kept
        if (queues[e][0] if queues[e] else wl.num_packets) != head0:
            serve[e] = wl.size


# --------------------------------------------------------------------------
# batched engine (PyTorch, one loop over cycles; batches as disjoint unions)
# --------------------------------------------------------------------------

def _union_arrays(wls: Sequence[PacketWorkload], record: np.ndarray,
                  dev: torch.device) -> Dict[str, torch.Tensor]:
    """Device int32 tensors of the disjoint union of `wls` (one workload is
    the union of one), padded where the loop gathers demand a safe slot:
    packet arrays get slot B * P, link arrays slot B * E, which is also the
    shared exit marker.  Replica b's links, flows, packets and sources are
    offset by b times their count, so arbitration (per target link) and
    injection (per source) never mix replicas."""
    b_num, w0 = len(wls), wls[0]
    e, f, p = w0.num_links, w0.num_flows, w0.num_packets
    e_all = b_num * e
    eidx = np.concatenate(
        [np.where(w.eidx == e, e_all, w.eidx + b * e) for b, w in
         enumerate(wls)], axis=1)
    src_off = np.concatenate(
        [w.src_off[:-1] + b * p for b, w in enumerate(wls)]
        + [np.array([b_num * p])])
    cat = lambda name, axis: np.concatenate(  # noqa: E731
        [getattr(w, name) for w in wls], axis=axis)
    arrays = {
        "eidx": eidx, "hops": cat("hops", 1), "n_valid": cat("n_valid", 1),
        "pkt_flow": np.concatenate(
            [w.pkt_flow + b * f for b, w in enumerate(wls)] + [[0]]),
        "pkt_t": np.concatenate(
            [np.minimum(w.pkt_t, w.cycles) for w in wls] + [[0]]),
        "pkt_cand": np.concatenate([w.pkt_cand for w in wls]
                                   + [np.zeros((2, 1), np.int32)], axis=1),
        "src_off": src_off, "fail_hop": cat("fail_hop", 0),
        "record": record}
    return {k: torch.as_tensor(np.ascontiguousarray(v, dtype=np.int32)
                               ).to(dev)
            for k, v in arrays.items()}


class _BatchedRun:
    """One run of the batched engine: the state as dense int32 tensors on
    one device -- queues [E + 1, Q] (row E absorbs rejected scatter lanes),
    per-link occ/serve, per-packet hop/chosen/epoch/outcome with pad slot
    P -- and preallocated per-cycle outputs.  `cycle` is the five phases of
    the module docstring, `fail` the failure transform between the epochs;
    every update is gathers, one stable sort (arbitration order),
    segmented ranks via searchsorted and scatters whose repeated indices
    land only in the dump row or the pad slot, which nothing reads
    unmasked.  Nothing in either reads a value back on the host.  It
    runs the union of the same-shape workloads `wls` (`_union_arrays`)."""

    def __init__(self, wls: Sequence[PacketWorkload], record: np.ndarray,
                 dev: torch.device):
        w0 = wls[0]
        self.a = a = _union_arrays(wls, record, dev)
        self.e_num = e_num = len(wls) * w0.num_links
        self.groups = len(wls)
        self.size, self.q_cap = w0.size, w0.capacity
        self.adaptive, self.gated = w0.adaptive, w0.gated
        self.gate = _gate_occ(w0.capacity)
        self.cycles, self.switch = w0.cycles, w0.switch_cycle
        cycles, capacity = w0.cycles, w0.capacity
        eidx = a["eidx"]
        i32 = torch.int32
        self.dev = dev
        self.p_pad = a["pkt_flow"].shape[0] - 1
        self.l_max = eidx.shape[3] - 1  # the last hop-axis slot
        self.src_end = a["src_off"][1:]
        self.eids = torch.arange(e_num, dtype=i32, device=dev)
        self.zero = torch.zeros(1, dtype=i32, device=dev)
        self.no = torch.zeros(1, dtype=torch.bool, device=dev)
        # scatter values as 0-dim device tensors: a Python scalar set into
        # a CUDA tensor through an index tensor copies it from the host
        # and synchronises
        self.yes = torch.ones((), dtype=torch.bool, device=dev)
        self.times = torch.arange(cycles, dtype=i32, device=dev)
        self.epochs = torch.arange(2, dtype=i32, device=dev)
        self.pad_col = torch.full((e_num + 1, 1), self.p_pad, dtype=i32,
                                  device=dev)
        # per-epoch candidate tables: first links, and UGAL's hop costs
        # with invalid slots at _BIG on the exit marker (occupancy 0), so
        # hops + occupancy is the reference's masked cost
        k = eidx.shape[2]
        self.first = eidx[..., 0]                           # [2, F, K]
        ok = (torch.arange(k, device=dev)
              < a["n_valid"][..., None])                   # [2, F, K]
        self.ugal_first = torch.where(ok, self.first, e_num)
        self.ugal_hops = torch.where(ok, a["hops"], int(_BIG))
        p1 = self.p_pad + 1
        self.queues = torch.full((e_num + 1, capacity), self.p_pad,
                                 dtype=i32, device=dev)
        self.occ = torch.zeros(e_num, dtype=i32, device=dev)
        self.serve = torch.zeros(e_num, dtype=i32, device=dev)
        self.hop = torch.zeros(p1, dtype=i32, device=dev)
        self.chosen = torch.zeros(p1, dtype=i32, device=dev)
        self.ep_pkt = torch.zeros(p1, dtype=i32, device=dev)
        self.ptr = a["src_off"][:-1].clone()
        self.dlv_t = torch.zeros(p1, dtype=i32, device=dev)
        self.dlv = torch.zeros(p1, dtype=torch.bool, device=dev)
        self.dropped = torch.zeros(p1, dtype=torch.bool, device=dev)
        self.occ_sum = torch.zeros((cycles, self.groups), dtype=i32,
                                   device=dev)
        self.occ_max = torch.zeros((cycles, self.groups), dtype=i32,
                                   device=dev)
        self.occ_rec = torch.zeros((cycles, a["record"].shape[0]),
                                   dtype=i32, device=dev)

    def cycle(self, t: int, ep_now: int) -> None:
        """One cycle at Python-int time `t` on epoch `ep_now`'s tables."""
        a, e_num, p_pad, q_cap = self.a, self.e_num, self.p_pad, self.q_cap
        i32 = torch.int32
        queues, occ, hop = self.queues, self.occ, self.hop
        heads = queues[:e_num, 0]
        # phase 1: serialization countdown
        nonempty = occ > 0
        serve = torch.where(nonempty & (self.serve > 0), self.serve - 1,
                            self.serve)
        ready = nonempty & (serve == 0)
        # phase 2: in-flight intents.  An empty link's head is the pad
        # slot, whose hop holds whatever the last pad-lane scatter left:
        # clamp the hop index into the axis (the lane is masked by `ready`;
        # a real ready head's next hop is at most its exit marker's slot)
        nh = torch.clamp_max(hop[heads] + 1, self.l_max)
        nxt = a["eidx"][self.ep_pkt[heads], a["pkt_flow"][heads],
                        self.chosen[heads], nh]
        exit_ = ready & (nxt == e_num)
        tgt = torch.where(ready & (nxt < e_num), nxt, e_num)
        # phase 3: injection intents (one bid per source; first links are
        # source-distinct, so bids never collide on a target)
        have = self.ptr < self.src_end
        bid_p = torch.where(have, self.ptr, p_pad)
        pend = have & (a["pkt_t"][bid_p] <= t)
        pf = a["pkt_flow"][bid_p]
        occ_pad = torch.cat([occ, self.zero])
        if self.adaptive:
            firsts = self.ugal_first[ep_now][pf]                # [S, K]
            cost = self.ugal_hops[ep_now][pf] + occ_pad[firsts]
            c = torch.argmin(cost, dim=1).to(i32)  # first index wins ties
            if self.gated:
                c = torch.where(occ_pad[firsts[:, 0]] >= self.gate, c, 0)
        else:
            c = a["pkt_cand"][ep_now][bid_p]
        itgt = torch.where(pend, self.first[ep_now][pf, c], e_num)
        # phase 4: arbitration -- stable sort by target, rank in segment
        free = q_cap - occ
        st, order = torch.sort(tgt, stable=True)
        rank = self.eids - torch.searchsorted(st, st, out_int32=True)
        free_pad = torch.cat([free, self.zero])
        acc_s = (st < e_num) & (rank < free_pad[st])
        cnt_cand = (torch.searchsorted(st, self.eids, right=True,
                                       out_int32=True)
                    - torch.searchsorted(st, self.eids, out_int32=True))
        acc_cnt = torch.minimum(cnt_cand, free)
        acc_cnt_pad = torch.cat([acc_cnt, self.zero])
        inj_acc = pend & (itgt < e_num) & (acc_cnt_pad[itgt]
                                           < free_pad[itgt])
        # apply: pops (exits + accepted movers) ...
        acc_lin = torch.zeros(e_num, dtype=torch.bool, device=self.dev)
        acc_lin[order] = acc_s
        dep = exit_ | acc_lin
        dep_pad = torch.cat([dep, self.no])
        shifted = torch.cat([queues[:, 1:], self.pad_col], dim=1)
        new_q = torch.where(dep_pad[:, None], shifted, queues)
        occ_dep = occ - dep.to(i32)
        occ_dep_pad = torch.cat([occ_dep, self.zero])
        # ... then pushes: movers land at base + rank, the bid after
        mrow = torch.where(acc_s, st, e_num)
        mpos = torch.clamp(occ_dep_pad[st] + rank, 0, q_cap - 1)
        mpid = heads[order]
        new_q[mrow, mpos] = torch.where(acc_s, mpid, new_q[mrow, mpos])
        irow = torch.where(inj_acc, itgt, e_num)
        ipos = torch.clamp(occ_dep_pad[itgt] + acc_cnt_pad[itgt], 0,
                           q_cap - 1)
        new_q[irow, ipos] = torch.where(inj_acc, bid_p, new_q[irow, ipos])
        inj_lin = torch.zeros(e_num + 1, dtype=i32, device=self.dev)
        inj_lin[irow] = inj_acc.to(i32)
        occ = occ_dep + acc_cnt + inj_lin[:e_num]
        # per-packet bookkeeping (unique pids per scatter, pads aside)
        hop[torch.where(acc_s, mpid, p_pad)] = hop[mpid] + 1
        ipid = torch.where(inj_acc, bid_p, p_pad)
        hop.index_put_((ipid,), self.zero)
        self.chosen[ipid] = c
        self.ep_pkt.index_put_((ipid,), self.epochs[ep_now])
        dpid = torch.where(exit_, heads, p_pad)
        self.dlv_t.index_put_((dpid,), self.times[t])
        self.dlv.index_put_((dpid,), self.yes)
        self.dlv[p_pad].fill_(False)
        self.ptr = self.ptr + inj_acc.to(i32)
        # phase 5: head changes restart serialization
        self.serve = torch.where(new_q[:e_num, 0] != heads, self.size,
                                 serve)
        self.queues, self.occ = new_q, occ
        self._record(t)

    def _record(self, t: int) -> None:
        occ = self.occ
        if self.e_num:
            per = occ.view(self.groups, -1)
            self.occ_sum[t] = per.sum(dim=1)
            self.occ_max[t] = per.amax(dim=1)
        if self.occ_rec.shape[1]:
            self.occ_rec[t] = occ[self.a["record"]]

    def fail(self) -> None:
        """The failure transform between the epochs: drop every epoch-0
        packet whose current or remaining hops cross a failed link,
        compacting each queue in order; changed heads restart their
        serialization clock."""
        a, e_num, p_pad = self.a, self.e_num, self.p_pad
        pids = self.queues[:e_num]
        fq, cq = a["pkt_flow"][pids], self.chosen[pids]
        fh = a["fail_hop"][fq, cq]
        real = pids < p_pad
        dropq = (real & (self.ep_pkt[pids] == 0) & (fh >= self.hop[pids])
                 & (fh < a["hops"][0][fq, cq]))
        keep = real & ~dropq
        heads0 = self.queues[:e_num, 0]
        qm = torch.where(keep, pids, p_pad)
        ordk = torch.sort((dropq | ~real).to(torch.int8), dim=1,
                          stable=True).indices
        qe = torch.gather(qm, 1, ordk)
        self.queues = torch.cat([qe, self.queues[e_num:]], dim=0)
        self.occ = keep.sum(dim=1).to(torch.int32)
        self.serve = torch.where(qe[:, 0] != heads0, self.size, self.serve)
        self.dropped.index_put_(
            (torch.where(dropq, pids, p_pad).reshape(-1),), self.yes)
        self.dropped[p_pad].fill_(False)

    def run(self, stop: Optional[int] = None) -> None:
        """Cycles 0 .. `stop` - 1 (all of them by default), the failure
        transform before the switch cycle."""
        for t in range(self.cycles if stop is None else stop):
            if t == self.switch:
                self.fail()
            self.cycle(t, int(t >= self.switch))

    def fetch(self) -> Dict[str, np.ndarray]:
        """Every output on the host, in one copy: deliver_t, delivered,
        dropped [P], occ_sum / occ_max [T, B], occ_rec [T, R]."""
        p = self.p_pad
        parts = {"deliver_t": self.dlv_t[:p], "delivered": self.dlv[:p],
                 "dropped": self.dropped[:p], "occ_sum": self.occ_sum,
                 "occ_max": self.occ_max, "occ_rec": self.occ_rec}
        flat = torch.cat([v.reshape(-1).to(torch.int32)
                          for v in parts.values()]).cpu().numpy()
        out, lo = {}, 0
        for k, v in parts.items():
            n = v.numel()
            out[k] = flat[lo:lo + n].reshape(tuple(v.shape))
            lo += n
        for k in ("delivered", "dropped"):
            out[k] = out[k].astype(bool)
        return out


@torch.no_grad()
def _run_batched(wls: Sequence[PacketWorkload], record: np.ndarray,
                 dev: torch.device) -> Dict[str, np.ndarray]:
    """The whole run on `dev`: epoch 0, the failure transform, epoch 1;
    the outputs come back to the host once, at the end."""
    run = _BatchedRun(wls, record, dev)
    run.run()
    return run.fetch()


def simulate_packets(wl: PacketWorkload,
                     record_links: Optional[np.ndarray] = None,
                     engine: str = "auto",
                     device: str = "cuda") -> PacketResult:
    """Run a workload through the batched engine on `device`
    (`engine="batched"`, also the "auto" choice) or the scalar reference
    on the host (`engine="reference"`).  Results are bit-identical."""
    if engine == "reference":
        return simulate_packets_reference(wl, record_links)
    if engine not in ("auto", "batched"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = resolve_device(device)
    rec = (np.asarray(record_links, dtype=np.int64)
           if record_links is not None else np.zeros(0, np.int64))
    if wl.num_packets == 0:
        z = np.zeros(wl.cycles, np.int32)
        return PacketResult(
            deliver_t=np.zeros(0, np.int32), delivered=np.zeros(0, bool),
            dropped=np.zeros(0, bool), inject_t=np.zeros(0, np.int32),
            occ_sum=z, occ_max=z.copy(),
            occ_rec=np.zeros((wl.cycles, len(rec)), np.int32),
            cycles=wl.cycles, size=wl.size, capacity=wl.capacity)
    out = _run_batched([wl], rec, dev)
    return PacketResult(
        deliver_t=out["deliver_t"], delivered=out["delivered"],
        dropped=out["dropped"], inject_t=wl.pkt_t.copy(),
        occ_sum=out["occ_sum"][:, 0], occ_max=out["occ_max"][:, 0],
        occ_rec=out["occ_rec"], cycles=wl.cycles, size=wl.size,
        capacity=wl.capacity)


def simulate_packets_batch(wls: Sequence[PacketWorkload],
                           device: str = "cuda") -> List[PacketResult]:
    """Run a stack of same-shape workloads (seed replicas, burst-phase
    replicas) through the batched engine on `device` in one loop, as one
    disjoint union.  All workloads must share static config and array
    shapes (same graph / mode / cycles / packet count -- pad or resample
    to equalize counts)."""
    dev = resolve_device(device)
    if not wls:
        return []
    w0 = wls[0]
    for w in wls[1:]:
        if (w.num_links, w.num_packets, w.cycles, w.size, w.capacity,
                w.mode, w.switch_cycle, w.eidx.shape) != \
           (w0.num_links, w0.num_packets, w0.cycles, w0.size, w0.capacity,
                w0.mode, w0.switch_cycle, w0.eidx.shape):
            raise ValueError("simulate_packets_batch needs same-shape "
                             "workloads")
    out = _run_batched(wls, np.zeros(0, np.int64), dev)
    p = w0.num_packets
    res = []
    for i, w in enumerate(wls):
        cut = slice(i * p, (i + 1) * p)
        res.append(PacketResult(
            deliver_t=out["deliver_t"][cut], delivered=out["delivered"][cut],
            dropped=out["dropped"][cut], inject_t=w.pkt_t.copy(),
            occ_sum=out["occ_sum"][:, i].copy(),
            occ_max=out["occ_max"][:, i].copy(),
            occ_rec=np.zeros((w.cycles, 0), np.int32),
            cycles=w.cycles, size=w.size, capacity=w.capacity))
    return res
