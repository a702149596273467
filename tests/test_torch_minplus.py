"""The port's tropical (min,+) product and APSP against the JAX package's.

On the CPU `repro_torch.kernels.minplus.ops.minplus` runs its plain
PyTorch version, which must equal (tolerance 0) the JAX package's
`minplus_ref` and its Pallas kernel in interpret mode at the shapes of
tests/test_kernels.py::test_minplus_matches_ref: every candidate is one
rounded add and min is exact, so no order of k changes a bit.  `apsp` and
`diameter_from_adj` (``device="cpu"``) must equal the JAX package's `apsp`
and the BFS distances on PolarFly graphs, intact and damaged in Fig. 14's
cumulative order (seed 1), disconnected ones included (``inf``).

The CUDA kernel itself runs only on the card: its tests carry the `cuda`
marker and skip here.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.polarfly import build_polarfly as r_build_polarfly  # noqa: E402
from repro.core.routing import all_pairs_distances  # noqa: E402
from repro.kernels.minplus import ops as r_ops  # noqa: E402
from repro.kernels.minplus.kernel import minplus_pallas  # noqa: E402
from repro.kernels.minplus.ref import minplus_ref as r_minplus_ref  # noqa: E402
from repro_torch.kernels.minplus import ops  # noqa: E402
from repro_torch.kernels.minplus import ref  # noqa: E402

SHAPES = [(64, 64, 64), (130, 70, 50), (256, 33, 128)]
FRACTIONS = [0.0, 0.05, 0.2, 0.4, 0.55]  # intact, then Fig. 14's


def _inputs(shape, with_inf=False):
    m, k, n = shape
    rng = np.random.default_rng(m * 31 + k * 7 + n)
    a = rng.random((m, k), dtype=np.float32) * 10
    b = rng.random((k, n), dtype=np.float32) * 10
    if with_inf:
        a[rng.random((m, k)) < 0.3] = ref.INF
        b[rng.random((k, n)) < 0.3] = ref.INF
    return a, b


def test_inf_is_the_references():
    from repro.kernels.minplus.ref import INF

    assert ref.INF == float(INF)
    assert np.float32(ref.INF) == INF


@pytest.mark.parametrize("with_inf", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_minplus_bit_identical_to_reference(shape, with_inf, monkeypatch):
    a, b = _inputs(shape, with_inf)
    want = np.asarray(r_minplus_ref(jnp.asarray(a), jnp.asarray(b)))
    pal = np.asarray(minplus_pallas(jnp.asarray(a), jnp.asarray(b), bm=64,
                                    bn=64, bk=64, interpret=True))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = ops.MINPLUS_LAUNCHES
    outs = [ref.minplus_ref(ta, tb).numpy(), ops.minplus(ta, tb).numpy()]
    monkeypatch.setattr(ref, "_CHUNK_ELEMENTS", 1)  # one row at a time
    outs.append(ref.minplus_ref(ta, tb).numpy())
    for out in outs:
        assert out.dtype == np.float32 and out.shape == (shape[0], shape[2])
        assert np.array_equal(out, want)
        assert np.array_equal(out, pal)
    assert ops.MINPLUS_LAUNCHES == before  # the CPU launches no kernel


@pytest.mark.parametrize("m,n", [(2, 2), (7, 30), (30, 2), (17, 17)])
def test_minplus_tropical_identity(m, n):
    """(A minplus I) == A with the tropical identity (0 diag, INF off)."""
    rng = np.random.default_rng(m * 31 + n)
    a = torch.from_numpy(rng.random((m, n), dtype=np.float32))
    eye = torch.where(torch.eye(n, dtype=torch.bool), 0.0, ref.INF)
    assert torch.equal(ops.minplus(a, eye.contiguous()), a)


@functools.lru_cache(maxsize=None)
def _damaged(q, frac):
    """PF(q) with `frac` of its links removed in `resilience_sweep`'s
    cumulative shuffled order, seed 1 (Fig. 14)."""
    g = r_build_polarfly(q).graph
    edges = g.edge_list.copy()
    np.random.default_rng(1).shuffle(edges)
    return g.subgraph_without_edges(edges[:int(round(frac * len(edges)))])


@pytest.mark.parametrize("frac", FRACTIONS)
@pytest.mark.parametrize("q", [5, 7, 13])
def test_apsp_matches_reference_and_bfs(q, frac):
    g = _damaged(q, frac)
    adj = g.adjacency
    got = ops.apsp(adj, device="cpu")
    assert got.dtype == np.float32 and got.shape == (g.n, g.n)
    assert np.array_equal(got, r_ops.apsp(adj))
    bfs = all_pairs_distances(g).astype(np.float32)
    bfs[bfs < 0] = np.inf  # UNREACHABLE
    assert np.array_equal(got, bfs)
    diam = ops.diameter_from_adj(adj, device="cpu")
    assert diam == r_ops.diameter_from_adj(adj)
    assert diam == float(bfs.max())


def test_apsp_grid_has_a_disconnected_case():
    assert ops.diameter_from_adj(_damaged(5, 0.55).adjacency,
                                 device="cpu") == np.inf


def test_apsp_takes_the_references_squarings():
    for n in (1, 2, 3, 993, 1025, 6321):
        want = max(1, int(np.ceil(np.log2(max(n - 1, 2)))))
        assert ref.apsp_steps(n) == want
    assert (ref.apsp_steps(993), ref.apsp_steps(6321)) == (10, 13)
    adj = r_build_polarfly(5).graph.adjacency
    before = ops.MINPLUS_LAUNCHES
    d = ref.apsp_ref(torch.from_numpy(adj))
    assert np.array_equal(ops.apsp(adj, device="cpu"),
                          np.where(d.numpy() >= ref.INF / 2, np.inf,
                                   d.numpy()))
    assert ops.MINPLUS_LAUNCHES == before


@pytest.mark.parametrize("bad", ["float64", "k_mismatch", "k_zero",
                                 "strided", "3d"])
def test_minplus_rejects_what_the_kernel_does_not_take(bad):
    a = torch.rand(6, 4)
    b = torch.rand(4, 5)
    err = ValueError
    if bad == "float64":
        a, err = a.double(), TypeError
    elif bad == "k_mismatch":
        b = torch.rand(3, 5)
    elif bad == "k_zero":
        a, b = torch.rand(6, 0), torch.rand(0, 5)
    elif bad == "strided":
        a = torch.rand(6, 8)[:, ::2]
    else:
        a = a[None]
    with pytest.raises(err):
        ops.minplus(a, b)


def test_apsp_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    adj = r_build_polarfly(3).graph.adjacency
    for fn in (ops.apsp, ops.diameter_from_adj):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(adj)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (130, 70, 50), (257, 129, 65),
                                   (993, 993, 993)])
def test_minplus_kernel_bit_identical_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    a, b = _inputs(shape, with_inf=True)
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    before = ops.MINPLUS_LAUNCHES
    out = ops.minplus(ta, tb)
    torch.cuda.synchronize()
    assert ops.MINPLUS_LAUNCHES == before + 1
    assert torch.equal(out, ref.minplus_ref(ta, tb))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [5, 13])
def test_apsp_on_card_matches_cpu(q):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    adj = _damaged(q, 0.2).adjacency
    before = ops.MINPLUS_HOPS_LAUNCHES
    got = ops.apsp(adj, device="cuda")
    # a symmetric hop-count APSP takes the integer (DPX) route
    assert ops.MINPLUS_HOPS_LAUNCHES == before + ref.apsp_steps(len(adj))
    assert np.array_equal(got, ops.apsp(adj, device="cpu"))
