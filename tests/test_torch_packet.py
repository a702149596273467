"""The port's flit-level packet engine against itself:
tests/test_packet_engine.py on `repro_torch`, on the CPU.

The scalar reference (conservation-checked every cycle) and the batched
PyTorch engine agree bit for bit on per-packet outcomes across graphs
(PolarFly / Slim Fly / Jellyfish), routing modes and damage; plus
zero-load latency, the failure transient, bursts and recorded links,
batches against single runs, determinism, the monotone tail ladder, peak
bytes, the two hypothesis properties, and UGAL's first-index tie break.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401 -- one intra-op thread a worker
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch.core.polarfly import build_polarfly  # noqa: E402
from repro_torch.core.routing import build_routing  # noqa: E402
from repro_torch.core.topologies import (build_jellyfish,  # noqa: E402
                                         build_slimfly)
from repro_torch.simulation import (BurstSchedule,  # noqa: E402
                                    build_failure_workload, build_flow_paths,
                                    make_pattern, make_workload,
                                    packet_peak_bytes, simulate_packets,
                                    simulate_packets_batch,
                                    simulate_packets_reference)
from repro_torch.simulation import packet  # noqa: E402

MODES = ("min", "valiant", "ugal")
CPU = "cpu"


def _graph(name):
    if name == "pf7":
        pf = build_polarfly(7)
        return pf.graph, pf
    if name == "sf5":
        return build_slimfly(5), None
    if name == "jf":
        return build_jellyfish(36, 6, seed=0), None
    raise ValueError(name)


def _routing(name, damaged):
    g, pf = _graph(name)
    if damaged:
        rng = np.random.default_rng(7)
        el = g.edge_list
        g = g.subgraph_without_edges(el[rng.choice(len(el), 2,
                                                   replace=False)])
        pf = None  # algebraic tables no longer apply
    return build_routing(g, pf)


_RT_CACHE = {}


def _rt(name, damaged=False):
    key = (name, damaged)
    if key not in _RT_CACHE:
        _RT_CACHE[key] = _routing(name, damaged)
    return _RT_CACHE[key]


def _workload(rt, mode, offered=0.3, cycles=140, seed=2, **kw):
    pat = make_pattern("uniform", rt, p=4, seed=seed)
    fp = build_flow_paths(rt, pat, mode, seed=seed)
    return make_workload(fp, offered, cycles, seed=seed, **kw)


def _assert_identical(wl, r_ref, r_bat):
    """The differential contract: identical per-packet outcomes (hence
    identical latency multisets) and identical occupancy traces."""
    np.testing.assert_array_equal(r_ref.delivered, r_bat.delivered)
    np.testing.assert_array_equal(r_ref.dropped, r_bat.dropped)
    np.testing.assert_array_equal(r_ref.deliver_t[r_ref.delivered],
                                  r_bat.deliver_t[r_bat.delivered])
    np.testing.assert_array_equal(r_ref.latencies(), r_bat.latencies())
    np.testing.assert_array_equal(r_ref.occ_sum, r_bat.occ_sum)
    np.testing.assert_array_equal(r_ref.occ_max, r_bat.occ_max)
    _spot_check(wl, r_bat)


def _spot_check(wl, r):
    """Batched-engine conservation spot checks (the reference asserts the
    full invariants every cycle internally): queue bound, disjoint
    outcomes, and the delivered/dropped/in-network/pending partition."""
    assert (r.occ_max <= wl.capacity).all()
    assert not (r.delivered & r.dropped).any()
    in_network_end = int(r.occ_sum[-1])
    assert r.num_delivered + r.num_dropped + in_network_end \
        <= wl.num_packets
    assert (r.deliver_t[r.delivered] >= r.inject_t[r.delivered]).all()


@pytest.mark.parametrize("damaged", [False, True], ids=["intact", "damaged"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("graph", ["pf7", "sf5", "jf"])
def test_engines_bit_identical(graph, mode, damaged):
    rt = _rt(graph, damaged)
    wl = _workload(rt, mode)
    r_ref = simulate_packets_reference(wl)  # invariants every cycle
    r_bat = simulate_packets(wl, device=CPU)
    assert r_ref.num_delivered > 100  # the comparison is non-vacuous
    _assert_identical(wl, r_ref, r_bat)


def test_zero_load_latency_is_hops_times_size():
    """A lone packet pays exactly hops * size cycles (store-and-forward
    flit serialization, no contention)."""
    rt = _rt("pf7")
    pat = make_pattern("uniform", rt, p=4, seed=0)
    fp = build_flow_paths(rt, pat, "min", seed=0)
    wl = make_workload(fp, 0.001, 120, seed=0)
    assert 0 < wl.num_packets < 200
    r = simulate_packets(wl, device=CPU)
    hops = wl.hops[0, wl.pkt_flow, wl.pkt_cand[0]]
    lat = r.deliver_t - r.inject_t
    assert (lat[r.delivered] == (hops * wl.size)[r.delivered]).all()
    r_ref = simulate_packets_reference(wl)
    _assert_identical(wl, r_ref, r)


def test_failure_transient_drops_and_reroutes():
    """Mid-run failure: both engines drop the same doomed in-network
    packets at the switch and keep delivering on the re-routed tables."""
    rt = _rt("pf7")
    g = rt.graph
    rng = np.random.default_rng(0)
    el = g.edge_list
    g2 = g.subgraph_without_edges(el[rng.choice(len(el), 3, replace=False)])
    rt2 = build_routing(g2)
    pat = make_pattern("uniform", rt, p=4, seed=3)
    for mode in MODES:
        wl = build_failure_workload(rt, rt2, pat, mode, 0.3, 260, 110,
                                    seed=2)
        r_ref = simulate_packets_reference(wl)
        r_bat = simulate_packets(wl, device=CPU)
        assert r_ref.num_dropped > 0, mode
        # deliveries continue after the switch (re-routed epoch works)
        post = r_ref.deliver_t[r_ref.delivered] > wl.switch_cycle
        assert post.sum() > 50, mode
        _assert_identical(wl, r_ref, r_bat)
        # dropped packets are never delivered and vice versa; every drop
        # was admitted before the switch on an epoch-0 path
        assert (wl.pkt_t[r_ref.dropped] < wl.switch_cycle).all()


def test_burst_schedule_and_link_records():
    rt = _rt("pf7")
    wl = _workload(rt, "ugal", offered=0.4, cycles=160,
                   burst=BurstSchedule(on=15, off=45))
    rec = np.array([0, 9, 31])
    r_ref = simulate_packets_reference(wl, record_links=rec)
    r_bat = simulate_packets(wl, record_links=rec, device=CPU)
    _assert_identical(wl, r_ref, r_bat)
    np.testing.assert_array_equal(r_ref.occ_rec, r_bat.occ_rec)
    assert r_ref.occ_rec.shape == (wl.cycles, 3)
    # mean-preserving modulation: same aggregate arrivals (+- phase
    # rounding) as the steady workload built from the same stream
    steady = _workload(rt, "ugal", offered=0.4, cycles=160)
    assert abs(wl.num_packets - steady.num_packets) \
        < 0.1 * steady.num_packets


def _replicas(wl, n, seed=5):
    """`n` same-shape variants of `wl`: the oblivious draws permuted
    (shapes and statics unchanged), as the reference's batch test does."""
    rng = np.random.default_rng(seed)
    wls = [wl]
    for _ in range(n - 1):
        cand = wl.pkt_cand[:, rng.permutation(wl.num_packets)]
        wls.append(dataclasses.replace(wl, pkt_cand=cand))
    return wls


def test_batch_matches_single_runs():
    rt = _rt("pf7")
    wl = _workload(rt, "ugal_pf", offered=0.3, cycles=120)
    wls = _replicas(wl, 3)
    rs = simulate_packets_batch(wls, device=CPU)
    assert len(rs) == 3
    for w, r in zip(wls, rs):
        r1 = simulate_packets(w, device=CPU)
        np.testing.assert_array_equal(r.latencies(), r1.latencies())
        np.testing.assert_array_equal(r.occ_sum, r1.occ_sum)
    with pytest.raises(ValueError, match="same-shape"):
        simulate_packets_batch([wl, _workload(rt, "ugal_pf", cycles=60)],
                               device=CPU)
    assert simulate_packets_batch([], device=CPU) == []


@pytest.mark.parametrize("mode", ["valiant", "ugal"])
def test_batch_union_is_bit_identical_per_replica(mode):
    """The batch runs as one disjoint union (links, flows, packets and
    sources offset per replica): every output of every replica equals its
    single run, through a failure switch and at an offered load where the
    queues fill."""
    rt = _rt("pf7")
    g = rt.graph
    el = g.edge_list
    rng = np.random.default_rng(1)
    rt2 = build_routing(g.subgraph_without_edges(
        el[rng.choice(len(el), 3, replace=False)]))
    pat = make_pattern("random_perm", rt, p=4, seed=4)
    wl = build_failure_workload(rt, rt2, pat, mode, 0.8, 150, 70, seed=4)
    wls = _replicas(wl, 4, seed=6)
    for w, r in zip(wls, simulate_packets_batch(wls, device=CPU)):
        r1 = simulate_packets(w, device=CPU)
        for f in ("delivered", "dropped", "deliver_t", "occ_sum",
                  "occ_max"):
            np.testing.assert_array_equal(getattr(r, f), getattr(r1, f), f)
        assert r1.num_dropped > 0


def test_traffic_and_workload_determinism():
    """One seeded generator threads the whole construction -- same seed =>
    identical TrafficPattern, identical workload arrays, identical tail
    metrics; explicit rng= matches the seed path."""
    rt = _rt("pf7")
    for name in ("uniform", "random_perm", "perm2hop"):
        a = make_pattern(name, rt, p=4, seed=11)
        b = make_pattern(name, rt, p=4, seed=11)
        c = make_pattern(name, rt, p=4,
                         rng=np.random.default_rng(11))
        for f in ("src", "dst", "demand"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(getattr(a, f), getattr(c, f))
    fp = build_flow_paths(rt, make_pattern("uniform", rt, p=4, seed=11),
                          "ugal", seed=1)
    w1 = make_workload(fp, 0.3, 120, seed=9)
    w2 = make_workload(fp, 0.3, 120, rng=np.random.default_rng(9))
    np.testing.assert_array_equal(w1.pkt_flow, w2.pkt_flow)
    np.testing.assert_array_equal(w1.pkt_t, w2.pkt_t)
    np.testing.assert_array_equal(w1.pkt_cand, w2.pkt_cand)
    assert simulate_packets(w1, device=CPU).tails() == \
        simulate_packets(w2, device=CPU).tails()


def test_monotone_tail_ladder():
    """Higher offered load => p99 non-decreasing (fixed seed ladder)."""
    rt = _rt("pf7")
    pat = make_pattern("uniform", rt, p=4, seed=1)
    fp = build_flow_paths(rt, pat, "min", seed=1)
    p99s = []
    for offered in (0.1, 0.3, 0.6, 0.9):
        r = simulate_packets(make_workload(fp, offered, 160, seed=4),
                             device=CPU)
        p99s.append(r.tails()["p99"])
    assert p99s == sorted(p99s), p99s


def test_peak_bytes_scales_with_links_not_n_squared():
    wl7 = _workload(_rt("pf7"), "min", cycles=40)
    b = packet_peak_bytes(wl7)
    assert b > 0
    # doubling only the queue capacity moves the estimate by O(E * Q)
    wide = dataclasses.replace(wl7, capacity=wl7.capacity * 2)
    assert packet_peak_bytes(wide) > b


def test_ugal_ties_pick_the_first_candidate():
    """UGAL's argmin over hops + occupancy ties all the time (at cycle 0
    every queue is empty, so equal-length candidates tie): the batched
    engine's first-cycle choices equal the reference's first-index
    rule, and torch.argmin keeps the first of equal minima."""
    x = torch.tensor([[3, 1, 1, 1], [2, 2, 2, 2], [5, 0, 4, 0]],
                     dtype=torch.int32)
    assert torch.argmin(x, dim=1).tolist() == [1, 0, 1]
    rt = _rt("pf7")
    for mode in ("ugal", "ugal_pf"):
        wl = _workload(rt, mode, offered=0.6, cycles=10)
        run = packet._BatchedRun([wl], np.zeros(0, np.int64),
                            torch.device(CPU))
        run.cycle(0, 0)
        # every source's first packet due at cycle 0 bids, and on empty
        # queues every bid is accepted
        lo, hi = wl.src_off[:-1], wl.src_off[1:]
        injected = lo[lo < hi]
        injected = injected[wl.pkt_t[injected] == 0]
        occ0 = [0] * wl.num_links
        want = [packet._decide_reference(wl, occ0, 0, int(wl.pkt_flow[p]),
                                         packet._gate_occ(wl.capacity))
                for p in injected]
        assert len(want) > 10
        assert run.chosen[torch.as_tensor(injected)].tolist() == want
        # ties were present: some flow's best cost is shared
        f = wl.pkt_flow[injected]
        costs = np.where(np.arange(wl.hops.shape[2])
                         < wl.n_valid[0, f][:, None], wl.hops[0, f], 1 << 30)
        assert ((costs == costs.min(axis=1, keepdims=True)).sum(axis=1)
                > 1).any()


@given(offered=st.floats(min_value=0.05, max_value=0.35),
       mode=st.sampled_from(MODES),
       bursty=st.booleans(),
       on=st.integers(min_value=5, max_value=25),
       off=st.integers(min_value=5, max_value=50),
       seed=st.integers(min_value=0, max_value=10_000))
@settings(max_examples=6, deadline=None)
def test_property_engine_equivalence(offered, mode, bursty, on, off, seed):
    """Random traffic/burst schedules: the engines stay bit-identical."""
    rt = _rt("pf7")
    burst = BurstSchedule(on=on, off=off) if bursty else None
    wl = _workload(rt, mode, offered=offered, cycles=96, seed=seed,
                   burst=burst)
    _assert_identical(wl, simulate_packets_reference(wl),
                      simulate_packets(wl, device=CPU))


@given(lo=st.floats(min_value=0.08, max_value=0.25),
       factor=st.floats(min_value=2.5, max_value=3.5),
       seed=st.integers(min_value=0, max_value=1000))
@settings(max_examples=4, deadline=None)
def test_property_p99_monotone_in_load(lo, factor, seed):
    """Higher offered load never improves the p99 tail (same seed, well
    separated load points so sampling noise can't flip the order)."""
    rt = _rt("pf7")
    pat = make_pattern("uniform", rt, p=4, seed=1)
    fp = build_flow_paths(rt, pat, "min", seed=1)
    r_lo = simulate_packets(make_workload(fp, lo, 160, seed=seed),
                            device=CPU)
    r_hi = simulate_packets(make_workload(fp, lo * factor, 160, seed=seed),
                            device=CPU)
    assert r_hi.tails()["p99"] >= r_lo.tails()["p99"]
