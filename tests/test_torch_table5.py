"""The paper's Table V comparison on the port: Slim Fly, Dragonfly,
Jellyfish and the fat tree through routing, traffic, flow paths and the
fluid engine, held against the JAX package at small sizes, and the
schema of the fixture that chip_smoke.py's ``table5`` phase holds the
port against at the paper's sizes.

Each topology is built by each package from its own code: SF(5) (50
routers), DF(4, 2) (36 routers, diameter 3, so adaptive paths of L = 6),
JF(60, 6, seed 0) and FT(4, 3) (48 switches, diameter 4, `ecmp` paths of
L = 8, traffic on its 16 leaf switches), with bench_fig8_saturation.py's
traffic (`chip_smoke.table5_traffic`: p = max(2, radix // 2)) and modes
(`min`, `ugal`, `ugal_pf`; `ecmp` alone on the fat tree).  Bars:
routing tables, patterns and FlowPaths arrays bit for bit; oblivious link
loads within 1e-6 relative and saturations equal; adaptive saturations
above 0, within 0.05 of the reference's, and within one bisection step
of it (`chip_smoke.table5_bar`, the phase's bar where no ulp band is
measured) or, where not, each package's runs with the demand one ulp up
and down spanning ranges that meet within one step (the gate plateau's
last-bit chaos: SF(5) random_perm ugal_pf, the port 0.6875 against
0.65625, the port itself 0.59375 and 0.65625 a ulp away), at 1000
Frank-Wolfe steps, on uniform traffic sampled to 1000 pairs (the
branch the paper-size runs take past 120,000 pairs; the port's CPU loop
would take ~10 s a saturation on JF's 3540 all-pairs flows); the plain
`path_costs` at L = 6 and 8 equal to the reference's
(tests/test_torch_table5_card.py holds the kernel against its plain
version at those widths on the card).
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import (FIELDS, TABLE5_SMALL as SMALL, assert_same,  # noqa: E402
                         long_path_inputs, smoke_module, to_port)

import repro.simulation as R  # noqa: E402
from repro.core import topologies as r_tp  # noqa: E402
from repro.core.routing import build_routing as r_build_routing  # noqa: E402
from repro.kernels.minplus.kernel import path_costs_pallas  # noqa: E402
from repro.kernels.minplus.ops import path_costs as r_path_costs  # noqa: E402
from repro.simulation import fluid as r_fluid  # noqa: E402

import repro_torch.simulation as T  # noqa: E402
from repro_torch.core import topologies as t_tp  # noqa: E402
from repro_torch.core.routing import build_routing as t_build_routing  # noqa: E402
from repro_torch.kernels.minplus import ops  # noqa: E402
from repro_torch.kernels.minplus.ref import path_costs_ref  # noqa: E402
from repro_torch.simulation import fluid as t_fluid  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "torch_port_table5_reference.json")
CPU = torch.device("cpu")
TOL = 0.01
ADAPTIVE_ITERS = 1000
PATTERNS = ("uniform", "random_perm")
MODES = {"SF": ("min", "ugal", "ugal_pf"), "DF1": ("min", "ugal", "ugal_pf"),
         "JF": ("min", "ugal", "ugal_pf"), "FT": ("ecmp",)}
SOLVE_MAX_FLOWS = 1000  # uniform pairs sampled for the adaptive solves
_BUILT = {}


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = smoke_module()


def built(name, max_flows=None):
    """{package: (routing, {pattern: (pattern, {mode: FlowPaths})})} of
    topology `name`, each package from its own graph, uniform traffic
    sampled to `max_flows` pairs (None: make_pattern's default, fig8's)
    (cached)."""
    key = (name, max_flows)
    if key not in _BUILT:
        fn, args = SMALL[name]
        out = {}
        for pkg, tp, build_routing, sim in (
                ("ref", r_tp, r_build_routing, R),
                ("port", t_tp, t_build_routing, T)):
            g = getattr(tp, fn)(*args)
            rt = build_routing(g)
            p, hosts = SMOKE.table5_traffic(g)
            pats = {}
            for pattern in PATTERNS:
                kw = {} if max_flows is None else {"max_flows": max_flows}
                pat = sim.make_pattern(pattern, rt, p=p, hosts=hosts, seed=0,
                                       **kw)
                pats[pattern] = (pat, {
                    m: sim.build_flow_paths(rt, pat, m, k_candidates=10,
                                            seed=0) for m in MODES[name]})
            out[pkg] = (rt, pats)
        _BUILT[key] = out
    return _BUILT[key]


def fps(name, pattern, mode, max_flows=None):
    b = built(name, max_flows)
    return (b["ref"][1][pattern][1][mode], b["port"][1][pattern][1][mode])


@pytest.mark.parametrize("max_flows", [None, SOLVE_MAX_FLOWS])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_table5_host_stages_bit_for_bit(name, max_flows):
    b = built(name, max_flows)
    (rt_r, pats_r), (rt_t, pats_t) = b["ref"], b["port"]
    assert_same(rt_t.graph.edge_list, rt_r.graph.edge_list, "edges")
    assert rt_t.graph.params == rt_r.graph.params
    assert_same(rt_t.dist, rt_r.dist, "dist")
    assert_same(rt_t.next_hop, rt_r.next_hop, "next_hop")
    assert rt_t.diameter == rt_r.diameter
    for pattern in PATTERNS:
        (pr, fr), (pt, ft) = pats_r[pattern], pats_t[pattern]
        for k in ("src", "dst", "demand"):
            assert_same(getattr(pt, k), getattr(pr, k), (pattern, k))
        for mode in MODES[name]:
            a, b = fr[mode], ft[mode]
            assert b.num_links == a.num_links and b.mode == a.mode
            for k in FIELDS:
                assert_same(getattr(b, k), getattr(a, k), (pattern, mode, k))
            # the chip phase's hashes see the same arrays
            assert SMOKE.flow_hashes(b) == SMOKE.flow_hashes(a)
    assert SMOKE.routing_hashes(rt_t) == SMOKE.routing_hashes(rt_r)


def test_table5_small_shapes_take_the_long_path_routes():
    """DF(4, 2)'s adaptive paths are L = 6 and FT(4, 3)'s ecmp paths L = 8,
    as at the paper's sizes: the generic kernel's widths."""
    assert fps("DF1", "uniform", "ugal")[1].edges.shape[1:] == (11, 6)
    assert fps("FT", "uniform", "ecmp")[1].edges.shape[1:] == (10, 8)
    assert fps("SF", "uniform", "ugal_pf")[1].edges.shape[2] == 4


OBLIVIOUS = [(n, p, m) for n in sorted(SMALL) for p in PATTERNS
             for m in MODES[n] if m in ("min", "ecmp")]
ADAPTIVE = [(n, p, m) for n in sorted(SMALL) for p in PATTERNS
            for m in MODES[n] if m in ("ugal", "ugal_pf")]


@pytest.mark.parametrize("name,pattern,mode", OBLIVIOUS)
def test_table5_oblivious_loads_and_saturation(name, pattern, mode):
    fp, tfp = fps(name, pattern, mode)
    _, rho_r, _ = r_fluid._run(fp, 0.3, 250)
    _, rho_t, _ = t_fluid._solve(tfp, 0.3, 250, CPU)
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_r), rtol=1e-6,
                               atol=0)
    sat_r = R.saturation_throughput(fp, tol=TOL, iters=250, engine="batched")
    sat_t = T.saturation_throughput(tfp, tol=TOL, iters=250,
                                    engine="batched", device="cpu")
    assert sat_t == sat_r


@pytest.mark.parametrize("name,pattern,mode", ADAPTIVE)
def test_table5_adaptive_saturation(name, pattern, mode):
    fp, tfp = fps(name, pattern, mode, SOLVE_MAX_FLOWS)
    sat_r = R.saturation_throughput(fp, tol=TOL, iters=ADAPTIVE_ITERS,
                                    engine="batched")
    sat_t = T.saturation_throughput(tfp, tol=TOL, iters=ADAPTIVE_ITERS,
                                    engine="batched", device="cpu")
    step = SMOKE.bisection_step(TOL)
    lo, hi = SMOKE.table5_bar({"saturation": sat_r}, step)
    assert 0.0 < sat_t <= 1.0 and abs(sat_t - sat_r) <= 0.05, (sat_t, sat_r)
    if lo <= sat_t <= hi:
        return
    # past one step: the gap must be the plateau's last-bit chaos, which
    # each package shows itself: its runs with the demand one ulp up and
    # down span a range that meets the other's within one step
    ref3, port3 = [sat_r], [sat_t]
    rt = built(name, SOLVE_MAX_FLOWS)["ref"][0]
    demand = fp.pattern.demand.astype(np.float32)
    for toward in (np.inf, -np.inf):
        moved = R.build_flow_paths(
            rt, dataclasses.replace(fp.pattern, demand=np.nextafter(
                demand, np.float32(toward))), mode, k_candidates=10, seed=0)
        ref3.append(R.saturation_throughput(moved, tol=TOL,
                                            iters=ADAPTIVE_ITERS,
                                            engine="batched"))
        port3.append(T.saturation_throughput(to_port(moved), tol=TOL,
                                             iters=ADAPTIVE_ITERS,
                                             engine="batched", device="cpu"))
    gap = max(min(ref3), min(port3)) - min(max(ref3), max(port3))
    assert gap <= step, (ref3, port3)


@pytest.mark.parametrize("name,mode,shape", [("DF1", "ugal", (11, 6)),
                                             ("FT", "ecmp", (10, 8))])
def test_table5_plain_path_costs_at_long_paths(name, mode, shape):
    import jax.numpy as jnp

    delay, eidx = long_path_inputs(name, mode)
    delay = delay.astype(np.float32)
    assert eidx.shape[1:] == shape
    # the same flows as the JAX package's
    assert_same(eidx, np.where(fps(name, "uniform", mode)[0].edges >= 0,
                               fps(name, "uniform", mode)[0].edges,
                               len(delay) - 1), "eidx")
    d, e = torch.from_numpy(delay), torch.from_numpy(eidx)
    want = np.asarray(r_path_costs(jnp.asarray(delay), jnp.asarray(eidx)))
    for out in (path_costs_ref(d, e).numpy(), ops.path_costs(d, e).numpy()):
        assert out.dtype == np.float32 and out.shape == eidx.shape[:2]
        assert np.array_equal(out, want)
    # the Pallas kernel in interpret mode on a 256-flow slice
    pal = np.asarray(path_costs_pallas(jnp.asarray(delay),
                                       jnp.asarray(eidx[:256]), bf=256,
                                       interpret=True))
    assert np.array_equal(pal, want[:256])


def test_table5_fixture_is_what_the_phase_reads():
    """The fixture's `config` is the script's `TABLE5`, and every row the
    phase reads is there: the five competitors of paper_table5_configs at
    their sizes, each pattern and mode of the grid, the hashes
    `flow_hashes` and `routing_hashes` give, saturations that are whole
    bisection steps; every random_perm adaptive run with the ±1-ulp runs
    of scripts/table5_sensitivity.py and the band they span with the
    saturation, which `chip_smoke.table5_bar` widens by one step."""
    script = _module("make_torch_port_reference", os.path.join(
        ROOT, "scripts", "make_torch_port_reference.py"))
    with open(FIXTURE) as fh:
        fixture = json.load(fh)
    config = fixture["config"]
    assert config == script.TABLE5
    assert fixture["script"] == \
        "scripts/make_torch_port_reference.py --table5"
    assert fixture["jax"] and fixture["numpy"]
    tops = fixture["topologies"]
    assert list(tops) == config["topologies"] == ["SF", "DF1", "DF2", "JF",
                                                  "FT"]
    sizes = {"SF": (1058, 35, 2), "DF1": (876, 17, 3), "DF2": (978, 32, 3),
             "JF": (993, 32, 3), "FT": (972, 36, 4)}
    step = SMOKE.bisection_step(config["tol"])
    for name, top in tops.items():
        n, radix, diameter = sizes[name]
        assert (top["routers"], top["radix"], top["diameter"]) == sizes[name]
        assert top["p"] == max(2, radix // 2)
        assert top["hosts"] == (n // 3 if name == "FT" else n)
        assert set(top["routing_sha256"]) == {"dist", "next_hop"}
        got = {(r["pattern"], r["mode"]) for r in top["runs"]}
        assert got == {(p, m) for p in config["patterns"]
                       for m in config["modes"][name]}
        for r in top["runs"]:
            assert set(r["sha256"]) == {"src", "dst", "demand", *FIELDS}
            assert r["iters"] == config["iters"][r["mode"]]
            assert r["path_len"] == 2 * max(2, diameter)
            assert r["candidates"] == (1 if r["mode"] == "min" else
                                       10 if r["mode"] == "ecmp" else 11)
            assert 0.0 < r["saturation"] <= 1.0
            steps = r["saturation"] / step
            assert steps == int(steps), (name, r["pattern"], r["mode"])
            measured = r["pattern"] == "random_perm" and r["mode"] in (
                "ugal", "ugal_pf")
            assert ("ulp_band" in r) == measured == ("ulp_runs" in r)
            if measured:
                three = [r["saturation"], *r["ulp_runs"].values()]
                assert sorted(r["ulp_runs"]) == ["minus_1ulp", "plus_1ulp"]
                assert r["ulp_band"] == [min(three), max(three)]
                assert all(v / step == int(v / step) and v > 0
                           for v in three)
            lo, hi = SMOKE.table5_bar(r, step)
            assert lo == r.get("ulp_band", [r["saturation"]])[0] - step
            assert hi == r.get("ulp_band", [r["saturation"]])[-1] + step
    assert fixture["ulp_script"] == "scripts/table5_sensitivity.py --write"
