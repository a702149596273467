"""The port's Algorithm 1 layout and §VI expansion:
tests/test_layout_expansion.py on `repro_torch`, then `build_layout` and
`expand` arrays equal to the JAX package's."""
from math import comb

import numpy as np
import pytest

pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401 -- one intra-op thread a worker
from repro.core.expansion import expand as r_expand  # noqa: E402
from repro.core.layout import build_layout as r_build_layout  # noqa: E402
from repro.core.polarfly import (  # noqa: E402
    build_polarfly as r_build_polarfly)

from repro_torch.core.expansion import expand  # noqa: E402
from repro_torch.core.layout import build_layout  # noqa: E402
from repro_torch.core.metrics import (diameter_and_aspl,  # noqa: E402
                                      triangles_by_cluster)
from repro_torch.core.polarfly import build_polarfly  # noqa: E402


@pytest.mark.parametrize("q", [5, 7, 11])
def test_layout_partition_and_links(q):
    pf = build_polarfly(q)
    lay = build_layout(pf)
    assert lay.num_clusters == q + 1
    assert (np.bincount(lay.cluster_of) == [q + 1] + [q] * q).all()
    m = lay.inter_cluster_edge_counts()
    # Prop V.3.2: q+1 links between each non-quadric rack and the quadric rack
    assert (m[0, 1:] == q + 1).all()
    # Prop V.4.2: q-2 links between every pair of non-quadric racks
    off = m[1:, 1:][~np.eye(q, dtype=bool)]
    assert (off == q - 2).all()
    # intra-rack: fan of (q-1)/2 triangles = 3(q-1)/2 edges; C_0 empty
    assert m[0, 0] == 0
    assert (np.diag(m)[1:] == 3 * (q - 1) // 2).all()


@pytest.mark.parametrize("q", [5, 7])
def test_block_design_theorem(q):
    """Thm V.7: every non-quadric cluster triplet joined by exactly 1
    triangle; Prop V.6: no triangle spans exactly 2 clusters."""
    pf = build_polarfly(q)
    lay = build_layout(pf)
    cen = triangles_by_cluster(pf.graph, lay.cluster_of)
    assert cen["mixed"] == 0
    assert cen["intra"] == comb(q, 2)
    assert cen["inter3"] == comb(q, 3)


@pytest.mark.parametrize("q", [7, 11])
def test_quadric_expansion(q):
    pf = build_polarfly(q)
    lay = build_layout(pf)
    base_deg = pf.graph.degrees.copy()
    for n in (1, 2):
        st = expand(lay, n, "quadric")
        diam, aspl = diameter_and_aspl(st.graph)
        assert st.graph.n == pf.n + n * (q + 1)
        assert diam == 2 and aspl < 2
        # V1 degree grows by 2 per replication, quadrics by n (clique)
        v1 = pf.v1
        assert (st.graph.degrees[v1] == base_deg[v1] + 2 * n).all()


@pytest.mark.parametrize("q", [7, 11])
def test_nonquadric_expansion(q):
    pf = build_polarfly(q)
    lay = build_layout(pf)
    for n in (1, 3):
        st = expand(lay, n, "nonquadric")
        diam, aspl = diameter_and_aspl(st.graph)
        assert st.graph.n == pf.n + n * q
        assert diam == 3  # paper Table IV
        assert aspl < 2
        assert st.graph.max_degree == (q + 1) + (n + 1)  # paper: +n+1
    st.graph.validate()


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, what)


@pytest.mark.parametrize("q", [5, 7, 11, 13])
def test_layout_and_expansion_equal_reference(q):
    """Every array of the layout and of both expansions equal to the JAX
    package's on the same PolarFly."""
    lay, r_lay = build_layout(build_polarfly(q)), r_build_layout(
        r_build_polarfly(q))
    assert (lay.num_clusters, lay.starter) == (r_lay.num_clusters,
                                               r_lay.starter)
    _same(lay.cluster_of, r_lay.cluster_of, "cluster_of")
    assert len(lay.clusters) == len(r_lay.clusters)
    for i, (a, b) in enumerate(zip(lay.clusters, r_lay.clusters)):
        _same(a, b, f"cluster {i}")
    _same(lay.centers, r_lay.centers, "centers")
    _same(lay.inter_cluster_edge_counts(),
          r_lay.inter_cluster_edge_counts(), "inter-cluster edges")
    for method in ("quadric", "nonquadric"):
        for n in (1, 2):
            st, r_st = expand(lay, n, method), r_expand(r_lay, n, method)
            _same(st.graph.edge_list, r_st.graph.edge_list,
                  f"{method} {n} edges")
            _same(st.graph.degrees, r_st.graph.degrees,
                  f"{method} {n} degrees")
            for f in ("cluster_of", "replica_of", "centers"):
                _same(getattr(st, f), getattr(r_st, f), f"{method} {n} {f}")
            assert (st.num_quadric_replications,
                    st.num_nonquadric_replications, st.next_nonquadric) == (
                r_st.num_quadric_replications,
                r_st.num_nonquadric_replications, r_st.next_nonquadric)
