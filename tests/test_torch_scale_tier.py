"""The scale tier on the port: PF(79) and PF(157) through the blocked
routing stack, held against the JAX package's run.

tests/fixtures/torch_port_scale_reference.json holds what
``scripts/make_torch_port_reference.py --scale`` recorded from the JAX
package on the CPU: for fig10's PF(79) ugal_pf point, the blockwise-scaling
LARGE tier at PF(157) (min) and fig_tail's PF(79) packet point, the sha256
of each pattern's and FlowPaths' arrays, the saturations, the PF(157)
sweep's column hashes, and the packet run's workload and result hashes,
counts and tails.  `chip_smoke.py`'s ``scale`` phase holds the port on the
card against it.

The tier-1 test reads the fixture's schema: the phase takes its settings
from the fixture's `config`, which must still be the script's `SCALE`.  The others rebuild the points with the
port on the CPU (the torch BFS, ``backend="sharded", device="cpu"``):
minutes each, so they are marked ``large`` (opt in with ``-m large``) and
``slow``.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "torch_port_scale_reference.json")
CPU = {"backend": "sharded", "device": "cpu"}
HASHED = ("src", "dst", "demand", "edges", "hops", "valid", "is_min",
          "first_edge")


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def smoke():
    return _module("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


def test_fixture_schema_matches_the_phase(fixture, smoke):
    script = _module("make_torch_port_reference", os.path.join(
        ROOT, "scripts", "make_torch_port_reference.py"))
    config = fixture["config"]
    assert config == script.SCALE
    assert fixture["script"] == "scripts/make_torch_port_reference.py --scale"
    assert fixture["jax"] and fixture["numpy"]
    pts = fixture["points"]
    assert set(pts) == set(config)
    for key, row in pts.items():
        c = config[key]
        assert set(row["sha256"]) == set(HASHED), key
        assert row["flows"] <= c["max_flows"]
        assert row["candidates"] == (1 if c["mode"] == "min"
                                     else c["k_candidates"] + 1)
        assert row["path_len"] == 4
        q = c["q"]
        assert row["num_links"] == (q * q + q + 1) * (q + 1) - (q + 1)
    a, b, p = (pts["pf79_ugal_pf"], pts["pf157_min"], pts["pf79_packet"])
    assert a["diameter"] == b["diameter"] == 2
    assert a["routers"] == 6321 and b["routers"] == 24807
    for key, row in (("pf79_ugal_pf", a), ("pf157_min", b)):
        assert 0.0 < row["saturation"] <= 1.0
        # the phase's bars are in bisection steps: the reference's
        # saturation is a whole number of them
        steps = row["saturation"] / smoke.bisection_step(config[key]["tol"])
        assert steps == int(steps) and steps >= 2, key
    assert 0.0 < a["saturation_fig10"] <= 1.0
    assert set(b["sweep_sha256"]) == {"dests", "dist_cols", "nh_cols"}
    assert set(p["workload_sha256"]) == {"pkt_flow", "pkt_t", "pkt_cand",
                                         "eidx", "fail_hop"}
    assert set(p["result_sha256"]) == {"delivered", "dropped",
                                       "deliver_t_delivered", "occ_sum",
                                       "occ_max"}
    assert set(p["tails"]) == {"p50", "p99", "p999"}
    assert 0 < p["delivered"] <= p["packets"] <= config[
        "pf79_packet"]["max_packets"]


# ---------------------------------------------------------------------------
# the port on the CPU at the fixture's sizes (minutes each)
# ---------------------------------------------------------------------------

def _hashes(smoke, fp):
    return smoke.flow_hashes(fp)


def _paths(rt, c):
    from repro_torch.simulation import build_flow_paths, make_pattern

    pat = make_pattern("uniform", rt, p=c["p"], seed=c["seed"],
                       max_flows=c["max_flows"])
    return build_flow_paths(rt, pat, c["mode"], k_candidates=c["k_candidates"],
                            seed=c["seed"])


@pytest.fixture(scope="module")
def pf79_routing():
    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_blocked_routing

    return build_blocked_routing(build_polarfly(79).graph, **CPU)


@pytest.mark.large
@pytest.mark.slow
def test_pf79_ugal_pf_flow_paths(fixture, smoke, pf79_routing):
    assert pf79_routing.diameter == 2
    fp = _paths(pf79_routing, fixture["config"]["pf79_ugal_pf"])
    assert _hashes(smoke, fp) == fixture["points"]["pf79_ugal_pf"]["sha256"]


@pytest.mark.large
@pytest.mark.slow
def test_pf79_packet_point_flow_paths_and_workload(fixture, smoke,
                                                   pf79_routing):
    from repro_torch.simulation import make_workload

    c = fixture["config"]["pf79_packet"]
    want = fixture["points"]["pf79_packet"]
    fp = _paths(pf79_routing, c)
    assert _hashes(smoke, fp) == want["sha256"]
    wl = make_workload(fp, c["offered"], c["cycles"], seed=c["seed"],
                       flow_sample=c["flow_sample"],
                       max_packets=c["max_packets"])
    assert wl.num_packets == want["packets"]
    assert {k: smoke.sha(getattr(wl, k)) for k in want["workload_sha256"]} \
        == want["workload_sha256"]


@pytest.mark.large
@pytest.mark.slow
def test_pf157_sweep_flow_paths_and_saturation(fixture, smoke):
    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import (build_blocked_routing,
                                          destination_blocks)
    from repro_torch.simulation import saturation_throughput

    c = fixture["config"]["pf157_min"]
    want = fixture["points"]["pf157_min"]
    g = build_polarfly(c["q"]).graph
    dests = smoke.sweep_dests(g.n, c["block"], c["sweep_blocks"])
    cols = list(destination_blocks(g, dests=dests, block=c["block"], **CPU))
    assert {"dests": smoke.sha(dests),
            "dist_cols": smoke.sha(np.concatenate([d for _, d, _ in cols],
                                                  axis=1)),
            "nh_cols": smoke.sha(np.concatenate([h for _, _, h in cols],
                                                axis=1))} \
        == want["sweep_sha256"]
    rt = build_blocked_routing(g, block=c["block"], diameter=c["diameter"],
                               **CPU)
    fp = _paths(rt, c)
    assert _hashes(smoke, fp) == want["sha256"]
    sat = saturation_throughput(fp, tol=c["tol"], iters=c["iters"],
                                engine="batched", device="cpu")
    # oblivious: held to the bit, as chip_smoke.py's phase holds it
    assert sat == want["saturation"]
