"""The port's packet engine against the JAX package's, tolerance 0.

Each package builds its own routing, pattern, flow paths and workload
from the same seeds: every `PacketWorkload` field must be equal, and
every integer output of `PacketResult` (`delivered`, `dropped`,
`deliver_t`, `occ_sum`, `occ_max`, `occ_rec`) of the port's batched
engine on the CPU equal to the JAX engine's, over PF(7), Slim Fly and a
damaged Jellyfish x every mode x steady / burst / failure.  Then the
case where the JAX engine gathers past the hop axis (random_perm at
offered 1.0: an empty link's head is the pad slot, whose hop holds what
the last pad-lane scatter left), batches, tests/test_obs.py's occupancy
metrics on the port, and the engine on the card against the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401 -- one intra-op thread a worker
import repro.simulation as R  # noqa: E402
from repro.core.polarfly import (  # noqa: E402
    build_polarfly as r_build_polarfly)
from repro.core.routing import build_routing as r_build_routing  # noqa: E402
from repro.core.topologies import (build_jellyfish as r_jf,  # noqa: E402
                                   build_slimfly as r_sf)

import repro_torch.simulation as T  # noqa: E402
from repro_torch.core.polarfly import build_polarfly  # noqa: E402
from repro_torch.core.routing import build_routing  # noqa: E402
from repro_torch.core.topologies import (build_jellyfish,  # noqa: E402
                                         build_slimfly)
from repro_torch.obs import Recorder  # noqa: E402
from repro_torch.simulation import packet  # noqa: E402

OUTPUTS = ("delivered", "dropped", "deliver_t", "occ_sum", "occ_max",
           "occ_rec")
RECORD = np.array([0, 9, 31, 40])
_RT = {}


def _graphs(name):
    """(reference graph and PolarFly, port graph and PolarFly)."""
    if name == "pf7":
        a, b = r_build_polarfly(7), build_polarfly(7)
        return (a.graph, a), (b.graph, b)
    if name == "sf5":
        return (r_sf(5), None), (build_slimfly(5), None)
    if name == "jf":
        return (r_jf(36, 6, seed=0), None), (build_jellyfish(36, 6, seed=0),
                                             None)
    raise ValueError(name)


def _routings(name):
    """{"ref" | "port": (intact routing, routing with 3 links failed)}:
    each package's own, from the same graph and seeds."""
    if name not in _RT:
        out = {}
        for side, (g, pf), route in zip(
                ("ref", "port"), _graphs(name),
                (r_build_routing, build_routing)):
            el = g.edge_list
            rm = el[np.random.default_rng(0).choice(len(el), 3,
                                                    replace=False)]
            out[side] = (route(g, pf), route(g.subgraph_without_edges(rm)))
        _RT[name] = out
    return _RT[name]


def _workloads(name, pattern, mode, scenario, offered=0.3, cycles=140,
               seed=2):
    """(reference workload, port workload) from each package's pipeline."""
    out = []
    for side, mod in (("ref", R), ("port", T)):
        rt, rt2 = _routings(name)[side]
        pat = mod.make_pattern(pattern, rt, p=4, seed=seed)
        if scenario == "failure":
            out.append(mod.build_failure_workload(rt, rt2, pat, mode,
                                                  offered, cycles + 60, 90,
                                                  seed=seed))
            continue
        fp = mod.build_flow_paths(rt, pat, mode, seed=seed)
        burst = (mod.BurstSchedule(on=15, off=45) if scenario == "burst"
                 else None)
        out.append(mod.make_workload(fp, offered, cycles, seed=seed,
                                     burst=burst))
    return tuple(out)


def _assert_same_workload(rwl, twl):
    for f in dataclasses.fields(rwl):
        a, b = getattr(rwl, f.name), getattr(twl, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, f.name)
        else:
            assert a == b, f.name


def _assert_same_result(rr, tr):
    for f in OUTPUTS:
        a, b = getattr(rr, f), getattr(tr, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, f)
    assert rr.tails() == tr.tails()


GRID = ([("pf7", mode, scenario)
         for mode in ("min", "valiant", "ugal", "ugal_pf")
         for scenario in ("steady", "burst", "failure")]
        + [("sf5", mode, "failure") for mode in ("ugal", "ugal_pf")]
        + [("jf", "valiant", "burst"), ("jf", "ugal", "failure")])


@pytest.mark.parametrize("graph,mode,scenario", GRID)
def test_port_equals_jax(graph, mode, scenario):
    rwl, twl = _workloads(graph, "uniform", mode, scenario)
    _assert_same_workload(rwl, twl)
    rr = R.simulate_packets(rwl, record_links=RECORD)
    tr = T.simulate_packets(twl, record_links=RECORD, device="cpu")
    assert rr.num_delivered > 100
    if scenario == "failure":
        assert rr.num_dropped > 0
    _assert_same_result(rr, tr)


def _pad_hop_overruns(wl):
    """Cycles at which the pad slot's hop + 1 lies past the hop axis: the
    gathers the JAX engine clamps and PyTorch's indexing would reject."""
    run = packet._BatchedRun([wl], np.zeros(0, np.int64), torch.device("cpu"))
    over = 0
    for t in range(wl.cycles):
        over += int(run.hop[run.p_pad]) + 1 > run.l_max
        run.cycle(t, 0)
    return over


@pytest.mark.parametrize("mode", ["min", "ugal"])
def test_pad_slot_hop_overrun_case(mode):
    """PF(7) random_perm at offered 1.0, 140 cycles: the pad slot's hop
    runs past the hop axis in many cycles (the case is not vacuous), and
    the port still equals the JAX package bit for bit -- the clamped
    lanes are masked, no real packet is clamped."""
    rwl, twl = _workloads("pf7", "random_perm", mode, "steady",
                          offered=1.0)
    _assert_same_workload(rwl, twl)
    assert _pad_hop_overruns(twl) > 10
    _assert_same_result(R.simulate_packets(rwl, record_links=RECORD),
                        T.simulate_packets(twl, record_links=RECORD,
                                           device="cpu"))


def test_batch_equals_jax_vmap():
    """Three same-shape replicas (permuted oblivious draws): the port's
    disjoint-union batch equals the JAX package's vmapped batch."""
    rwl, twl = _workloads("pf7", "random_perm", "valiant", "failure",
                          offered=0.6)
    rng = np.random.default_rng(5)
    perms = [rng.permutation(rwl.num_packets) for _ in range(2)]
    rwls = [rwl] + [dataclasses.replace(rwl, pkt_cand=rwl.pkt_cand[:, p])
                    for p in perms]
    twls = [twl] + [dataclasses.replace(twl, pkt_cand=twl.pkt_cand[:, p])
                    for p in perms]
    for rr, tr in zip(R.simulate_packets_batch(rwls),
                      T.simulate_packets_batch(twls, device="cpu")):
        _assert_same_result(rr, tr)


def test_record_occupancy_consistent_with_result():
    """tests/test_obs.py's occupancy-metrics test on the port."""
    pf = build_polarfly(7)
    rt = build_routing(pf.graph, pf)
    pat = T.make_pattern("uniform", rt, p=4, seed=0)
    fp = T.build_flow_paths(rt, pat, "min", seed=5)
    wl = T.make_workload(fp, 0.4, 120, seed=1)
    res = T.simulate_packets(wl, device="cpu")
    hist = T.occupancy_histogram(res)
    assert hist.sum() == len(res.occ_max)  # one sample per cycle
    rec = Recorder()
    summ = T.record_occupancy(res, name="pkt", recorder=rec)
    assert summ["cycles"] == len(res.occ_max)
    assert summ["occ_peak"] == float(np.max(res.occ_max, initial=0))
    assert 0.0 <= summ["saturated_frac"] <= 1.0
    met = rec.metrics()
    assert met["gauges"]["pkt.occ_peak"]["last"] == summ["occ_peak"]
    assert sum(met["histograms"]["pkt.queue_depth"].values()) == \
        summ["cycles"]
    names = {ev["name"] for ev in rec.events()}
    assert {"pkt.occ_sum", "pkt.occ_max"} <= names


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["min", "valiant", "ugal", "ugal_pf"])
def test_card_equals_cpu(mode):
    """The engine on the card against the port's CPU run over PF(7)'s
    steady, burst, failure and offered-1.0 random_perm workloads, with
    recorded links and a batch; one run with synchronising calls made
    errors (the loop reads nothing back until its end)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [_workloads("pf7", "uniform", mode, s)[1]
             for s in ("steady", "burst", "failure")]
    cases.append(_workloads("pf7", "random_perm", mode, "steady",
                            offered=1.0)[1])
    for wl in cases:
        cpu = T.simulate_packets(wl, record_links=RECORD, device="cpu")
        card = T.simulate_packets(wl, record_links=RECORD, device="cuda")
        _assert_same_result(cpu, card)
    wls = [cases[2], dataclasses.replace(
        cases[2], pkt_cand=cases[2].pkt_cand[:, ::-1].copy())]
    for cpu, card in zip(T.simulate_packets_batch(wls, device="cpu"),
                         T.simulate_packets_batch(wls, device="cuda")):
        _assert_same_result(cpu, card)
    run = packet._BatchedRun([cases[3]], RECORD, torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run.run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = run.fetch()
    want = T.simulate_packets(cases[3], record_links=RECORD, device="cpu")
    for f in OUTPUTS:
        np.testing.assert_array_equal(np.squeeze(got[f], axis=1)
                                      if f in ("occ_sum", "occ_max")
                                      else got[f], getattr(want, f), f)
