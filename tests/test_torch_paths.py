"""The port's host modules against the JAX package's: PolarFly graphs,
routing tables, traffic patterns, FlowPaths arrays and their solver-ready
device arrays must be bit-identical, on PF(7) and PF(13), intact and
damaged, for every routing mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import (FIELDS, assert_same, damage,  # noqa: E402
                         hot_dst_pattern, to_port)

from repro.core import routing as r_routing  # noqa: E402
from repro.core.polarfly import build_polarfly as r_build_polarfly  # noqa: E402
from repro.simulation import paths as r_paths  # noqa: E402
from repro.simulation import traffic as r_traffic  # noqa: E402
from repro_torch.core import routing as t_routing  # noqa: E402
from repro_torch.core.polarfly import build_polarfly as t_build_polarfly  # noqa: E402
from repro_torch.parallel import blockwise as t_blockwise  # noqa: E402
from repro_torch.simulation import paths as t_paths  # noqa: E402
from repro_torch.simulation import traffic as t_traffic  # noqa: E402

MODES = ("min", "ecmp", "valiant", "cvaliant", "ugal", "ugal_pf")
GRID = [(q, which) for q in (7, 13) for which in ("intact", "damaged")]
_CACHE = {}


def _setup(q, which):
    """(reference pf, port pf, reference routing, port routing)."""
    key = (q, which)
    if key not in _CACHE:
        rpf, tpf = r_build_polarfly(q), t_build_polarfly(q)
        if which == "intact":
            rrt = r_routing.build_routing(rpf.graph, rpf)
            trt = t_routing.build_routing(tpf.graph, tpf)
        else:
            rrt = r_routing.build_routing(damage(rpf.graph, q))
            trt = t_routing.build_routing(damage(tpf.graph, q))
        _CACHE[key] = (rpf, tpf, rrt, trt)
    return _CACHE[key]


@pytest.mark.parametrize("q", [3, 7, 13, 16])
def test_polarfly_identical(q):
    rpf, tpf = r_build_polarfly(q), t_build_polarfly(q)
    assert_same(rpf.vertices, tpf.vertices, "vertices")
    assert_same(rpf.graph.adjacency, tpf.graph.adjacency, "adjacency")
    assert_same(rpf.graph.edge_list, tpf.graph.edge_list, "edge_list")
    for a, b in zip(rpf.graph.csr, tpf.graph.csr):
        assert_same(a, b, "csr")
    assert_same(rpf.quadrics, tpf.quadrics, "quadrics")


@pytest.mark.parametrize("q,chunk", [(31, 100), (79, 2048), (9, 10)])
def test_polarfly_identical_across_chunks(q, chunk):
    """The chunked all-pairs build (a prime q: one float32 matrix product
    a chunk, mod q; a prime power: table lookups) gives the reference's
    graph and vertex classes whatever the chunk."""
    rpf, tpf = r_build_polarfly(q), t_build_polarfly(q, chunk=chunk)
    assert_same(rpf.graph.edge_list, tpf.graph.edge_list, "edge_list")
    for a, b in zip(rpf.graph.csr, tpf.graph.csr):
        assert_same(a, b, "csr")
    for k in ("quadric_mask", "v1_mask", "v2_mask"):
        assert_same(getattr(rpf, k), getattr(tpf, k), k)


@pytest.mark.parametrize("q,which", GRID)
@pytest.mark.parametrize("engine", ["dense", "sparse"])
def test_routing_tables_identical(q, which, engine):
    rpf, tpf, rrt, trt = _setup(q, which)
    rg, tg = rrt.graph, trt.graph
    r = r_routing.build_routing(rg, rpf if which == "intact" else None,
                                engine=engine)
    t = t_routing.build_routing(tg, tpf if which == "intact" else None,
                                engine=engine)
    assert_same(r.dist, t.dist, "dist")
    assert_same(r.next_hop, t.next_hop, "next_hop")
    assert r.diameter == t.diameter
    # and the port's two engines agree with each other, as the reference's do
    assert_same(t.next_hop, trt.next_hop, "port dense vs sparse")


@pytest.mark.parametrize("q,which", GRID)
def test_destination_blocks_identical(q, which):
    _, _, rrt, trt = _setup(q, which)
    dests = np.arange(0, rrt.graph.n, 3)
    rb = list(r_routing.destination_blocks(rrt.graph, dests, block=7))
    tb = list(t_routing.destination_blocks(trt.graph, dests, block=7))
    assert len(rb) == len(tb)
    for a, b in zip(rb, tb):
        for x, y in zip(a, b):
            assert_same(x, y, "destination block")
    r = r_routing.build_blocked_routing(rrt.graph, block=5)
    t = t_routing.build_blocked_routing(trt.graph, block=5)
    assert (r.diameter, r.block) == (t.diameter, t.block)


def test_sharded_backend_not_ported():
    """The sharded backend never falls back quietly: it needs a device
    twin of the block function, and by default it runs on the card, so
    without one it raises (its bit-identity with the host engine is
    tests/test_torch_blockwise.py's)."""
    plan = t_blockwise.plan_blocks(4, block=2)
    with pytest.raises(ValueError, match="device_fn"):
        list(t_blockwise.run_blocks(np.arange(4), plan, lambda b: b,
                                    backend="sharded"))
    if not torch.cuda.is_available():
        pf = t_build_polarfly(3)
        with pytest.raises(RuntimeError, match="cuda"):
            list(t_routing.distance_blocks(pf.graph, backend="sharded"))


# k-hop permutations need the intact graph's distance structure
TRAFFIC_GRID = [(q, which, pattern) for q, which in GRID
                for pattern in r_traffic.PATTERNS
                if which == "intact" or not pattern.startswith("perm")]


@pytest.mark.parametrize("q,which,pattern", TRAFFIC_GRID)
def test_traffic_identical(q, which, pattern):
    _, _, rrt, trt = _setup(q, which)
    p = (q + 1) // 2
    for kw in ({"seed": 3}, {"seed": 0, "max_flows": 500}):
        r = r_traffic.make_pattern(pattern, rrt, p=p, **kw)
        t = t_traffic.make_pattern(pattern, trt, p=p, **kw)
        assert (r.name, r.endpoints_per_router) == (t.name,
                                                     t.endpoints_per_router)
        for f in ("src", "dst", "demand"):
            assert_same(getattr(r, f), getattr(t, f), (pattern, kw, f))


@pytest.mark.parametrize("q,which", GRID)
@pytest.mark.parametrize("mode", MODES)
def test_flow_paths_identical(q, which, mode):
    """Every FlowPaths array, from the dense and the blocked engines (and
    the scalar reference engine on PF(7))."""
    _, _, rrt, trt = _setup(q, which)
    p = (q + 1) // 2
    rpat = r_traffic.make_pattern("uniform", rrt, p=p, seed=2)
    tpat = t_traffic.make_pattern("uniform", trt, p=p, seed=2)
    engines = ["dense", "blocked"] + (["reference"] if q == 7 else [])
    for engine in engines:
        r = r_paths.build_flow_paths(rrt, rpat, mode, k_candidates=6, seed=5,
                                     engine=engine)
        t = t_paths.build_flow_paths(trt, tpat, mode, k_candidates=6, seed=5,
                                     engine=engine)
        for f in FIELDS:
            assert_same(getattr(r, f), getattr(t, f), (engine, mode, f))
        assert (r.num_links, r.mode) == (t.num_links, t.mode)


@pytest.mark.parametrize("q,which", GRID)
@pytest.mark.parametrize("mode", MODES)
def test_device_arrays_identical(q, which, mode):
    """`device_arrays` does the reference's host preprocessing: remapped
    pads, the padded incidence matrix, and every array bit for bit."""
    _, _, rrt, _ = _setup(q, which)
    pat = r_traffic.make_pattern("random_perm", rrt, p=(q + 1) // 2, seed=1)
    fp = r_paths.build_flow_paths(rrt, pat, mode, k_candidates=6, seed=5)
    ref = fp.device_arrays()
    port_fp = to_port(fp)
    port = port_fp.device_arrays("cpu")
    assert port_fp.device_arrays("cpu") is port  # cached per device
    assert ref[1][0] == port[1][0] == "pad"
    assert_same(np.asarray(ref[1][1]), port[1][1].numpy(), "inc")
    names = ("eidx", None, "valid", "is_min", "first_edge", "demand", "hops")
    for name, a, b in zip(names, ref, port):
        if name:
            assert_same(np.asarray(a), b.numpy(), name)


def test_device_arrays_scatter_branch(monkeypatch):
    """Past the padded-incidence cap both packages fall back to
    ("scatter",)."""
    _, _, rrt, _ = _setup(7, "intact")
    fp = r_paths.build_flow_paths(rrt, hot_dst_pattern(r_traffic, rrt.graph.n),
                                  "ugal", k_candidates=6, seed=5)
    monkeypatch.setattr(r_paths, "_INC_PAD_MAX_ENTRIES", 0)
    monkeypatch.setattr(t_paths, "_INC_PAD_MAX_ENTRIES", 0)
    ref = fp.device_arrays()
    port = to_port(fp).device_arrays("cpu")
    assert ref[1] == ("scatter",) and port[1] == ("scatter",)
    assert_same(np.asarray(ref[0]), port[0].numpy(), "eidx")


def test_device_arrays_reject_out_of_range_edges():
    _, _, rrt, _ = _setup(7, "intact")
    pat = r_traffic.make_pattern("tornado", rrt, p=4)
    fp = to_port(r_paths.build_flow_paths(rrt, pat, "min"))
    fp.edges[0, 0, 0] = fp.num_links
    with pytest.raises(ValueError, match="edge ids"):
        fp.device_arrays("cpu")


def test_from_reference_matches_port_build():
    """`from_reference` on the reference's arrays gives the same FlowPaths
    the port builds itself."""
    _, _, rrt, trt = _setup(13, "intact")
    rpat = r_traffic.make_pattern("random_perm", rrt, p=7, seed=0)
    tpat = t_traffic.make_pattern("random_perm", trt, p=7, seed=0)
    r = r_paths.build_flow_paths(rrt, rpat, "ugal_pf", k_candidates=10)
    t = t_paths.build_flow_paths(trt, tpat, "ugal_pf", k_candidates=10)
    c = to_port(r)
    for f in FIELDS:
        assert_same(getattr(c, f), getattr(t, f), f)
    assert_same(c.pattern.demand, t.pattern.demand, "demand")
