"""The port's copies of `core/topologies.py` and `core/metrics.py` against
the JAX package's.

Both modules are numpy on the host; the port keeps its own copies, so
each builder's edge list and every structural metric must be equal (bit
for bit, tolerance 0) over tests/test_sparse_engine.py's `TOPOS` grid and
the Fig. 14 smoke graphs of benchmarks/bench_fig14_resilience.py.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import metrics as r_metrics  # noqa: E402
from repro.core import topologies as r_tp  # noqa: E402
from repro.core.polarfly import build_polarfly as r_build_polarfly  # noqa: E402
from repro_torch.core import metrics as t_metrics  # noqa: E402
from repro_torch.core import topologies as t_tp  # noqa: E402
from repro_torch.core.polarfly import build_polarfly as t_build_polarfly  # noqa: E402

# (builder name, args); tests/test_sparse_engine.py's TOPOS and Fig. 14's
# smoke graphs (PF13 is in both), plus the remaining builders
GRAPHS = {
    "pf13": ("polarfly", (13,)),
    "sf11": ("build_slimfly", (11,)),
    "ps5x5": ("build_polarstar", (5, 5)),
    "df": ("build_dragonfly", (6, 3)),
    "ft": ("build_fat_tree", (6, 3)),
    "jf": ("build_jellyfish", (120, 7)),
    "sf9": ("build_slimfly", (9,)),
    "jf183": ("build_jellyfish", (183, 14)),
    "hx": ("build_hyperx", (4, 5)),
    "paley13": ("build_paley", (13,)),
}
FIG14 = ["pf13", "sf9", "jf183", "df"]
FRACTIONS = [0.05, 0.2, 0.4, 0.55]


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference graph, port graph) for `name` (cached)."""
    builder, args = GRAPHS[name]
    if builder == "polarfly":
        return (r_build_polarfly(*args).graph, t_build_polarfly(*args).graph)
    kw = {"seed": 0} if builder == "build_jellyfish" else {}
    return (getattr(r_tp, builder)(*args, **kw),
            getattr(t_tp, builder)(*args, **kw))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_builders_identical(name):
    r, t = _pair(name)
    assert (r.name, r.n) == (t.name, t.n)
    assert r.params == t.params
    assert np.array_equal(r.edge_list, t.edge_list)


def test_table5_configs_identical():
    r = r_tp.paper_table5_configs(seed=0)
    t = t_tp.paper_table5_configs(seed=0)
    assert sorted(r) == sorted(t)
    for key in r:
        assert np.array_equal(r[key].edge_list, t[key].edge_list), key


@pytest.mark.parametrize("engine", ["dense", "sparse"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_diameter_and_aspl_identical(name, engine):
    r, t = _pair(name)
    for rg, tg in ((r, t), (r.subgraph_without_edges(r.edge_list[::5][:8]),
                            t.subgraph_without_edges(t.edge_list[::5][:8]))):
        assert (t_metrics.diameter_and_aspl(tg, engine=engine)
                == r_metrics.diameter_and_aspl(rg, engine=engine))


@pytest.mark.parametrize("name", FIG14)
def test_resilience_sweep_identical(name):
    r, t = _pair(name)
    rp = r_metrics.resilience_sweep(r, FRACTIONS, seed=1)
    tp_ = t_metrics.resilience_sweep(t, FRACTIONS, seed=1)
    assert [(p.fail_fraction, p.diameter, p.aspl) for p in rp] \
        == [(p.fail_fraction, p.diameter, p.aspl) for p in tp_]


@pytest.mark.parametrize("name", ["pf13", "sf11", "df", "ft"])
def test_bisection_and_triangles_identical(name):
    r, t = _pair(name)
    assert (t_metrics.bisection_fraction(t, seed=0)
            == r_metrics.bisection_fraction(r, seed=0))
    assert t_metrics.triangle_census(t) == r_metrics.triangle_census(r)


def test_triangles_by_cluster_identical():
    r, t = _pair("pf13")
    cl = np.arange(r.n) % 7
    assert (t_metrics.triangles_by_cluster(t, cl)
            == r_metrics.triangles_by_cluster(r, cl))


def test_feasible_degrees_identical():
    for k in (16, 128, 512):
        assert (t_metrics.polarfly_feasible_degrees(k)
                == r_metrics.polarfly_feasible_degrees(k))
        assert (t_metrics.slimfly_feasible_degrees(k)
                == r_metrics.slimfly_feasible_degrees(k))


def test_path_counts_identical():
    r, t = _pair("pf13")
    for v, w in ((0, 5), (3, 100), (17, 18), (50, 182)):
        assert (t_metrics.count_paths_upto4(t, v, w)
                == r_metrics.count_paths_upto4(r, v, w))
        assert (t_metrics.count_3paths_avoiding(t, v, w, 1)
                == r_metrics.count_3paths_avoiding(r, v, w, 1))
