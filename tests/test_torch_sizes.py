"""The paper's last device figures on the port, held against the JAX
package, and the schema of the fixture that chip_smoke.py's ``sizes``
phase and scripts/sizes_cards.py hold the card against.

tests/fixtures/torch_port_sizes_reference.json holds what
``scripts/make_torch_port_reference.py --sizes`` recorded from the JAX
package on the CPU: Fig. 10's size sweep (bench_fig10_sizes.py with its
BENCH_LARGE tier), Fig. 8's PF(79) point (bench_fig8_saturation.py's
`_run_large`) and Fig. 15's measured cost ratios (bench_fig15_cost.py).

* The fixture's `config` is the script's `SIZES`, and every run the phase
  reads is there, at the benchmarks' own settings.
* Fig. 10 at PF(13), the fixture's own size: graph, routing, patterns
  and FlowPaths by their hashes, the min saturation equal.  Its ugal_pf
  saturation and truncation gap equal the JAX package's on 1000 sampled
  pairs (the port's CPU iterate is the reference's bit for bit), and the
  fixture's at its 33,306 flows under ``-m large`` (about 3 minutes on
  the CPU: 3,937 Frank-Wolfe steps of 1.2M path entries).
* Fig. 15's four topologies: graphs, routing, patterns and FlowPaths by
  their hashes; the random_perm saturations and the fat tree's equal to
  the fixture's, with the random_perm cost ratios; the uniform adaptive
  ones equal to the JAX package's on 1000 sampled pairs, and to the
  fixture's at its size under ``-m large`` (1.5-2.5 minutes each).
* The large tier's graphs (SF(43), PS(9, 61), JF(6321, 80)) by their
  hashes, and PS(7, 49)'s routing tables, which `build_routing` builds
  through the blocked BFS at n = 2793.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import FIELDS, smoke_module  # noqa: E402

import repro.simulation as R  # noqa: E402
from repro.core import topologies as r_tp  # noqa: E402
from repro.core.polarfly import build_polarfly as r_build_polarfly  # noqa: E402
from repro.core.routing import build_routing as r_build_routing  # noqa: E402

import repro_torch.simulation as T  # noqa: E402
from repro_torch.core import topologies as t_tp  # noqa: E402
from repro_torch.core.polarfly import build_polarfly as t_build_polarfly  # noqa: E402
from repro_torch.core.routing import build_routing as t_build_routing  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = smoke_module()
with open(SMOKE.SIZES_FIXTURE) as _fh:
    DOC = json.load(_fh)
CONFIG = DOC["config"]
SAMPLED_FLOWS = 1000  # uniform pairs of the PF(13) ugal_pf parity
_BUILT = {}


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cached(key, fn):
    if key not in _BUILT:
        _BUILT[key] = fn()
    return _BUILT[key]


def whole_steps(v, tol):
    steps = v / SMOKE.bisection_step(tol)
    return 0.0 < v <= 1.0 and steps == int(steps)


# -- the fixture -------------------------------------------------------------

def test_sizes_fixture_is_what_the_phase_reads():
    """The fixture's `config` is the script's `SIZES` at the benchmarks'
    settings; every point and run the phase and the card script read is
    there, at `fig10_p` endpoints and `fig10_max_flows` flows; saturations
    are whole bisection steps; ugal_pf runs carry a truncation gap; PF(79)
    ugal_pf's saturation and FlowPaths are the scale fixture's; the cost
    ratios are `fig15_ratios` of the saturations with the benchmark's
    PORTS."""
    from benchmarks.bench_fig15_cost import PAPER_FT, PORTS

    script = _module("make_torch_port_reference", os.path.join(
        ROOT, "scripts", "make_torch_port_reference.py"))
    assert CONFIG == script.SIZES
    assert DOC["script"] == "scripts/make_torch_port_reference.py --sizes"
    assert DOC["jax"] and DOC["numpy"]
    hashed = {"src", "dst", "demand", *FIELDS}

    c = CONFIG["fig10"]
    assert (c["k_candidates"], c["tol"], c["iters"]) == (
        8, 0.02, {"min": 250, "ugal_pf": 1500})
    assert list(DOC["fig10"]) == list(c["points"])
    for name, (builder, args, blocked) in c["points"].items():
        top = DOC["fig10"][name]
        assert top["blocked"] is blocked
        assert ("routing_sha256" in top) is not blocked
        assert ("dest_block" in top) is blocked
        want_p = ((args[0] + 1) // 2 if builder == "build_polarfly"
                  and not blocked else top["radix"] // 2)
        assert top["p"] == want_p
        assert [r["mode"] for r in top["runs"]] == c["modes"]
        for r in top["runs"]:
            assert set(r["sha256"]) == hashed
            assert r["max_flows"] == SMOKE.fig10_max_flows(
                c, r["mode"], top["routers"])
            assert r["flows"] <= r["max_flows"]
            assert r["candidates"] == (1 if r["mode"] == "min" else 9)
            assert r["path_len"] == 2 * top["diameter"]
            assert whole_steps(r["saturation"], c["tol"])
            assert ("truncation_error" in r) == (r["mode"] == "ugal_pf")
    # every run the phase drives is in the fixture
    assert set(SMOKE.SIZES_PHASE_MODES) <= set(c["modes"])
    assert set(SMOKE.SIZES_PHASE_POINTS) <= set(DOC["fig10"])
    (key, (path, point, field)), = c["saturations_from"].items()
    name, mode = key.split(".")
    with open(os.path.join(ROOT, "tests", "fixtures", path)) as fh:
        other = json.load(fh)["points"][point]
    run = next(r for r in DOC["fig10"][name]["runs"] if r["mode"] == mode)
    assert run["saturation"] == other[field]
    assert run["sha256"] == other["sha256"]
    assert run["saturation_source"] == f"{path}:{point}:{field}"

    c = CONFIG["fig8_large"]
    top = DOC["fig8_large"]
    assert (top["routers"], top["diameter"], top["p"]) == (6321, 2, 40)
    assert top["graph_sha256"] == DOC["fig10"]["pf79"]["graph_sha256"]
    assert [(r["pattern"], r["mode"]) for r in top["runs"]] == [
        (p, m) for p in c["patterns"] for m in c["modes"]]
    for r in top["runs"]:
        assert set(r["sha256"]) == hashed and r["flows"] <= c["max_flows"]
        assert r["candidates"] == (1 if r["mode"] == "min" else 11)
        assert whole_steps(r["saturation"], c["tol"])
        assert ("truncation_error" in r) == (r["mode"] == "ugal_pf")

    c = CONFIG["fig15"]
    assert (c["ports"], c["paper_ft"]) == (PORTS, PAPER_FT)
    assert list(DOC["fig15"]["topologies"]) == list(c["graphs"])
    sats = {}
    for name, top in DOC["fig15"]["topologies"].items():
        p = max(2, top["radix"] // 2)
        assert top["p"] == p
        assert top["hosts"] == (64 if name == "FT" else top["routers"])
        assert [r["traffic"] for r in top["runs"]] == list(c["patterns"])
        for r in top["runs"]:
            assert r["pattern"] == c["patterns"][r["traffic"]]
            assert r["mode"] == c["modes"][name]
            assert whole_steps(r["saturation"], c["tol"])
            sats[name, r["traffic"]] = r["saturation"]
    assert DOC["fig15"]["ratios"] == SMOKE.fig15_ratios(
        sats, c["ports"], c["sat_floor"])

    # bands and ties only where a card reading called for one, each with
    # its reason (scripts/table5_sensitivity.py --sizes)
    runs = [(CONFIG[fig]["tol"], r) for fig, tops in (
        ("fig10", DOC["fig10"].values()),
        ("fig8_large", [DOC["fig8_large"]]),
        ("fig15", DOC["fig15"]["topologies"].values()))
        for top in tops for r in top["runs"]]
    assert DOC["ulp_script"] == "scripts/table5_sensitivity.py --sizes"
    assert any("ulp_runs" in r for _, r in runs)
    for tol, r in runs:
        adaptive = r["mode"] in ("ugal", "ugal_pf")
        if "ulp_runs" in r:
            assert adaptive and r["ulp_why"]
            assert sorted(r["ulp_runs"]) == ["minus_1ulp", "plus_1ulp"]
            for q, (lo, hi) in r["ulp_band"].items():
                vals = [r[q], *(u[q] for u in r["ulp_runs"].values())]
                assert [lo, hi] == [min(vals), max(vals)]
                assert q in r["port_cpu"]
        if "max_util_at" in r:
            assert not adaptive and r["tie_why"]
            step = SMOKE.bisection_step(tol)
            loads = sorted({r["saturation"],
                            min(r["saturation"] + step, 1.0)})
            assert [x for x, _ in r["max_util_at"]] == loads
            assert sorted(r["tie_ulp_runs"]) == ["minus_1ulp", "plus_1ulp"]
            for u in r["tie_ulp_runs"].values():
                assert whole_steps(u["saturation"], tol)
                assert [x for x, _ in u["max_util_at"]] == loads


# -- Fig. 10 at PF(13) -------------------------------------------------------

def pf13():
    """(routing, {mode: (pattern, FlowPaths)}) of Fig. 10's PF(13) point,
    built by the port at the fixture's settings (cached)."""
    c = CONFIG["fig10"]

    def build():
        pf = t_build_polarfly(13)
        rt = t_build_routing(pf.graph, pf)
        p = SMOKE.fig10_p("build_polarfly", [13], pf.graph, False)
        out = {}
        for mode in c["modes"]:
            pat = T.make_pattern("uniform", rt, p=p, seed=c["seed"],
                                 max_flows=SMOKE.fig10_max_flows(
                                     c, mode, pf.n))
            out[mode] = (pat, T.build_flow_paths(
                rt, pat, mode, k_candidates=c["k_candidates"],
                seed=c["seed"]))
        return rt, out
    return cached("pf13", build)


def test_fig10_pf13_host_stages_and_min_saturation():
    """PF(13)'s graph, routing tables, patterns and FlowPaths equal to the
    fixture's hashes at its own size; the min saturation equal."""
    c, top = CONFIG["fig10"], DOC["fig10"]["pf13"]
    rt, built = pf13()
    assert SMOKE.graph_hash(rt.graph) == top["graph_sha256"]
    assert SMOKE.routing_hashes(rt) == top["routing_sha256"]
    assert (rt.graph.n, int(rt.diameter)) == (top["routers"], top["diameter"])
    runs = {r["mode"]: r for r in top["runs"]}
    for mode, (_, fp) in built.items():
        assert SMOKE.flow_hashes(fp) == runs[mode]["sha256"], mode
    sat = T.saturation_throughput(built["min"][1], tol=c["tol"],
                                  iters=c["iters"]["min"],
                                  engine=c["engine"], device="cpu")
    assert sat == runs["min"]["saturation"]


@pytest.mark.parametrize("name", ["pf13", "pf25", "pf43"])
def test_fig10_min_ties_at_capacity(name):
    """Where the card read a min saturation one step above the
    reference's, the reference refused that load by a tie: its max link
    utilization there within `TIE_REL` of 1 (a link at capacity up to the
    float32 sum's order), which the port on the CPU, summing in XLA:CPU's
    order, reads to the bit; `oblivious_bar` then admits that one step
    and no more."""
    c, top = CONFIG["fig10"], DOC["fig10"][name]
    run = next(r for r in top["runs"] if r["mode"] == "min")
    step = SMOKE.bisection_step(c["tol"])
    builder, args, _ = c["points"][name]
    g, pf = SMOKE.sizes_graph(builder, args, t_tp, t_build_polarfly)
    rt = t_build_routing(g, pf)
    pat = T.make_pattern("uniform", rt, p=top["p"], seed=c["seed"],
                         max_flows=run["max_flows"])
    fp = T.build_flow_paths(rt, pat, "min", k_candidates=c["k_candidates"],
                            seed=c["seed"])
    for load, util in run["max_util_at"]:
        got = T.evaluate_load(fp, load, c["iters"]["min"], device="cpu")
        assert float(got.max_util) == util
    assert SMOKE.tie_loads(run) == [run["saturation"] + step]
    assert SMOKE.oblivious_bar(run, step) == (run["saturation"],
                                              run["saturation"] + step)
    assert SMOKE.oblivious_bar({"saturation": run["saturation"]}, step) == \
        (run["saturation"],) * 2


def sampled(key, c, graph, mode, traffic):
    """(reference FlowPaths, port FlowPaths, the reference's saturation)
    of a run at settings `c` on `SAMPLED_FLOWS` uniform pairs of `graph`
    ([builder, arguments]), each package building, routing and sampling
    on its own, with `traffic(graph)` its (endpoints a router, hosts)
    (cached under `key`)."""
    def build():
        fps = []
        for sim, tp, build_pf, routing in (
                (R, r_tp, r_build_polarfly, r_build_routing),
                (T, t_tp, t_build_polarfly, t_build_routing)):
            g, pf = SMOKE.sizes_graph(*graph, tp, build_pf)
            rt = routing(g, pf)
            p, hosts = traffic(g)
            pat = sim.make_pattern("uniform", rt, p=p, hosts=hosts,
                                   seed=c["seed"], max_flows=SAMPLED_FLOWS)
            fps.append(sim.build_flow_paths(
                rt, pat, mode, k_candidates=c["k_candidates"],
                seed=c["seed"]))
        sat = float(R.saturation_throughput(
            fps[0], tol=c["tol"], iters=c["iters"][mode],
            engine=c["engine"]))
        return fps[0], fps[1], sat
    return cached(("sampled", key), build)


def sampled_ugal_pf():
    """`sampled` of Fig. 10's PF(13) ugal_pf run."""
    c = CONFIG["fig10"]
    return sampled("fig10 pf13", c, c["points"]["pf13"][:2], "ugal_pf",
                   lambda g: (SMOKE.fig10_p("build_polarfly", [13], g,
                                            False), None))


def test_fig10_pf13_ugal_pf_saturation_on_sampled_pairs():
    """The port's ugal_pf saturation on the CPU equal to the JAX
    package's at Fig. 10's settings on 1000 sampled pairs, on FlowPaths
    that are bit for bit the reference's."""
    c = CONFIG["fig10"]
    fp_r, fp_t, sat = sampled_ugal_pf()
    assert SMOKE.flow_hashes(fp_t) == SMOKE.flow_hashes(fp_r)
    got = T.saturation_throughput(fp_t, tol=c["tol"],
                                  iters=c["iters"]["ugal_pf"],
                                  engine=c["engine"], device="cpu")
    assert 0.0 < sat <= 1.0 and got == sat


def test_fig10_pf13_ugal_pf_truncation_gap_on_sampled_pairs():
    """The port's truncation gap at the reference's saturation equal to
    the JAX package's, on the same sampled flows."""
    it = CONFIG["fig10"]["iters"]["ugal_pf"]
    fp_r, fp_t, sat = sampled_ugal_pf()
    want = float(R.truncation_error(fp_r, sat, it))
    assert want > 0.0
    assert T.truncation_error(fp_t, sat, it, device="cpu") == want


@pytest.mark.large
@pytest.mark.slow
@pytest.mark.parametrize("quantity", ["saturation", "truncation_error"])
def test_fig10_pf13_ugal_pf_at_the_fixture_size(quantity):
    """PF(13) ugal_pf at its 33,306 flows: the saturation and the
    truncation gap at the reference's saturation equal to the fixture's."""
    c = CONFIG["fig10"]
    it = c["iters"]["ugal_pf"]
    want = next(r for r in DOC["fig10"]["pf13"]["runs"]
                if r["mode"] == "ugal_pf")
    fp = pf13()[1]["ugal_pf"][1]
    if quantity == "saturation":
        got = T.saturation_throughput(fp, tol=c["tol"], iters=it,
                                      engine=c["engine"], device="cpu")
    else:
        got = T.truncation_error(fp, want["saturation"], it, device="cpu")
    assert got == want[quantity]


# -- Fig. 15 -----------------------------------------------------------------

def fig15(name):
    """(routing, {traffic: FlowPaths}) of Fig. 15's topology `name`, built
    by the port at the fixture's settings (cached)."""
    c = CONFIG["fig15"]

    def build():
        g, pf = SMOKE.sizes_graph(*c["graphs"][name], t_tp, t_build_polarfly)
        rt = t_build_routing(g, pf)
        p, hosts = SMOKE.table5_traffic(g)
        return rt, {key: T.build_flow_paths(
            rt, T.make_pattern(pattern, rt, p=p, hosts=hosts,
                               seed=c["seed"]),
            c["modes"][name], k_candidates=c["k_candidates"],
            seed=c["seed"]) for key, pattern in c["patterns"].items()}
    return cached(("fig15", name), build)


def fig15_saturation(name, key):
    """The port's Fig. 15 saturation of `name` under traffic `key` on the
    CPU (cached)."""
    c = CONFIG["fig15"]
    mode = c["modes"][name]
    return cached(("fig15 sat", name, key), lambda: T.saturation_throughput(
        fig15(name)[1][key], tol=c["tol"], iters=c["iters"][mode],
        engine=c["engine"], device="cpu"))


def fig15_want(name, key):
    return next(r for r in DOC["fig15"]["topologies"][name]["runs"]
                if r["traffic"] == key)


@pytest.mark.parametrize("name", list(CONFIG["fig15"]["graphs"]))
def test_fig15_host_stages(name):
    """Each Fig. 15 graph, its routing tables and both traffics' patterns
    and FlowPaths equal to the fixture's hashes."""
    top = DOC["fig15"]["topologies"][name]
    rt, fps = fig15(name)
    assert SMOKE.graph_hash(rt.graph) == top["graph_sha256"]
    assert SMOKE.routing_hashes(rt) == top["routing_sha256"]
    assert (rt.graph.n, rt.graph.params["radix"], int(rt.diameter)) == (
        top["routers"], top["radix"], top["diameter"])
    for key, fp in fps.items():
        want = fig15_want(name, key)
        assert SMOKE.flow_hashes(fp) == want["sha256"], key
        assert list(fp.edges.shape) == [want["flows"], want["candidates"],
                                        want["path_len"]]


CHEAP = [("PF", "perm"), ("SF", "perm"), ("DF1", "perm"), ("FT", "uniform"),
         ("FT", "perm")]


@pytest.mark.parametrize("name,key", CHEAP)
def test_fig15_saturation(name, key):
    """The random_perm saturations (a flow a router) and the fat tree's
    ecmp ones (oblivious) equal to the fixture's."""
    assert fig15_saturation(name, key) == fig15_want(name, key)["saturation"]


@pytest.mark.large
@pytest.mark.slow
@pytest.mark.parametrize("name", ["PF", "SF", "DF1"])
def test_fig15_uniform_adaptive_saturation(name):
    """The uniform ugal_pf saturations at their 12,882-33,306 flows equal
    to the fixture's."""
    assert fig15_saturation(name, "uniform") == \
        fig15_want(name, "uniform")["saturation"]


@pytest.mark.parametrize("name", ["PF", "SF", "DF1"])
def test_fig15_uniform_adaptive_saturation_on_sampled_pairs(name):
    """Each Fig. 15 uniform ugal_pf saturation on the CPU equal to the JAX
    package's at the figure's settings on 1000 sampled pairs, on FlowPaths
    that are bit for bit the reference's (the fixture-size solves run
    under ``-m large``)."""
    c = CONFIG["fig15"]
    mode = c["modes"][name]
    fp_r, fp_t, sat = sampled(("fig15", name), c, c["graphs"][name], mode,
                              SMOKE.table5_traffic)
    assert SMOKE.flow_hashes(fp_t) == SMOKE.flow_hashes(fp_r)
    got = T.saturation_throughput(fp_t, tol=c["tol"], iters=c["iters"][mode],
                                  engine=c["engine"], device="cpu")
    assert 0.0 < sat <= 1.0 and got == sat


def test_fig15_perm_cost_ratios():
    """The random_perm cost ratios from the port's saturations equal to
    the fixture's (its uniform ones are the fixture's saturations' by the
    schema test)."""
    c = CONFIG["fig15"]
    sats = {(name, "perm"): fig15_saturation(name, "perm")
            for name in c["graphs"]}
    assert SMOKE.fig15_ratios(sats, c["ports"], c["sat_floor"])["perm"] == \
        DOC["fig15"]["ratios"]["perm"]


# -- the large tier's graphs, PS(7, 49)'s routing -----------------------------

@pytest.mark.parametrize("name", ["sf43", "ps9x61", "jf6321"])
def test_large_tier_graph(name):
    """The port's SF(43), PS(9, 61) and JF(6321, 80) equal to the
    reference's by their edge lists' hashes, with the same sizes."""
    builder, args, blocked = CONFIG["fig10"]["points"][name]
    top = DOC["fig10"][name]
    g, _ = SMOKE.sizes_graph(builder, args, t_tp, t_build_polarfly)
    assert SMOKE.graph_hash(g) == top["graph_sha256"]
    assert (g.n, g.params["radix"], g.num_edges) == (
        top["routers"], top["radix"], top["links"])
    assert SMOKE.fig10_p(builder, args, g, blocked) == top["p"]


def test_ps7x49_routing_tables():
    """PS(7, 49) (n = 2793, above the dense engine's bound, so
    `build_routing` takes the blocked BFS) routed into the reference's
    tables."""
    builder, args, _ = CONFIG["fig10"]["points"]["ps7x49"]
    top = DOC["fig10"]["ps7x49"]
    g, _ = SMOKE.sizes_graph(builder, args, t_tp, t_build_polarfly)
    rt = t_build_routing(g)
    assert SMOKE.graph_hash(g) == top["graph_sha256"]
    assert SMOKE.routing_hashes(rt) == top["routing_sha256"]
    assert int(rt.diameter) == top["diameter"] == 3
    assert np.asarray(rt.dist).shape == (2793, 2793)
