"""The launch plans and the arithmetic of the port's Hopper path-cost and
tropical-product kernels, held on the CPU.

The kernels (`csrc/path_costs.cu`, `csrc/minplus.cu`,
`csrc/minplus_dpx.cu`) run only on the card, but what they compute is
fixed by two things the CPU can check: the launch plan the wrapper picks
from the shapes (`ops._path_costs_plan`, `ops._minplus_plan`,
`ops._hops_plan`), and the order in which a kernel combines its
candidates.  Here each plan is held to its contract (the grid fills the
card at PF(31)'s n = 993; the k ranges of the splits cover k exactly once),
and a torch emulation of each kernel's combination (16-k slices of a
padded A, +inf past the edges, split-K partial minima combined; the
integer route's k pairs in int16 halves with int16 wrap-around) is held
bit for bit against the plain version and, for `apsp`, against the JAX
package and the host BFS, on INF-laden ragged inputs and damaged PolarFly
graphs, disconnected ones included.  The `cuda`-marked tests run one case
per route on the card and skip here.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.polarfly import build_polarfly as r_build_polarfly  # noqa: E402
from repro.core.routing import all_pairs_distances  # noqa: E402
from repro.kernels.minplus import ops as r_ops  # noqa: E402
from repro_torch.kernels.minplus import ops  # noqa: E402
from repro_torch.kernels.minplus import ref  # noqa: E402

INF32 = float("inf")
# (m, k, n): PF(31), its padded form, PF(79), its padded form and a 256-row
# slice, then small ragged shapes
PLAN_SHAPES = [(993, 993, 993), (996, 996, 996), (6321, 6321, 6321),
               (6324, 6324, 6324), (256, 6321, 6321), (1, 1, 1),
               (130, 70, 50), (257, 129, 65), (64, 64, 64), (5, 1000, 3),
               (2048, 64, 2048), (300, 16, 300)]
EMULATED = [(1, 1, 1), (7, 3, 5), (130, 70, 50), (64, 33, 20),
            (17, 200, 9)]


@functools.lru_cache(maxsize=None)
def _damaged(q, frac):
    """PF(q) with `frac` of its links removed in `resilience_sweep`'s
    cumulative shuffled order, seed 1 (Fig. 14)."""
    g = r_build_polarfly(q).graph
    edges = g.edge_list.copy()
    np.random.default_rng(1).shuffle(edges)
    return g.subgraph_without_edges(edges[:int(round(frac * len(edges)))])


def _inputs(shape, seed=0):
    m, k, n = shape
    rng = np.random.default_rng(seed + m * 31 + k * 7 + n)
    a = rng.random((m, k), dtype=np.float32) * 10
    b = rng.random((k, n), dtype=np.float32) * 10
    a[rng.random((m, k)) < 0.3] = ref.INF
    b[rng.random((k, n)) < 0.3] = ref.INF
    return torch.from_numpy(a), torch.from_numpy(b)


# --- plans ------------------------------------------------------------


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_minplus_plan_covers_k_once(shape):
    m, k, n = shape
    plan = ops._minplus_plan(m, n, k)
    kper, splits = plan["kper"], plan["splits"]
    assert kper % ops.MINPLUS_K == 0 and splits >= 1
    ranges = [(z * kper, min(k, (z + 1) * kper)) for z in range(splits)]
    assert all(lo < hi for lo, hi in ranges)  # no empty split
    covered = np.zeros(k, np.int64)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    tiles = math.ceil(m / 128) * math.ceil(n / 128)
    assert plan["blocks"] == tiles * splits
    # never more blocks than the card's slots unless the tiles alone are
    assert plan["blocks"] <= max(tiles, ops.SMS * ops.MINPLUS_BLOCKS_PER_SM)


@pytest.mark.parametrize("n", [993, 996])
def test_minplus_plan_fills_the_card_at_pf31(n):
    plan = ops._minplus_plan(n, n, n)
    assert plan["blocks"] >= ops.SMS
    assert plan["splits"] > 1


@pytest.mark.parametrize("n", [6321, 6324])
def test_minplus_plan_does_not_split_pf79(n):
    plan = ops._minplus_plan(n, n, n)
    assert plan["splits"] == 1 and plan["blocks"] == 50 * 50


@pytest.mark.parametrize("n", [8, 184, 512, 1000, 2088, 6328, 16376])
def test_hops_plan_covers_k_once(n):
    plan = ops._hops_plan(n)
    kper, splits = plan["kper"], plan["splits"]
    assert kper % ops.HOPS_K == 0
    covered = np.zeros(n, np.int64)
    for z in range(splits):
        lo, hi = z * kper, min(n, (z + 1) * kper)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_hops_plan_fills_the_card_at_pf31():
    assert ops._hops_plan(1000)["blocks"] >= ops.SMS  # PF(31) padded to 8


@pytest.mark.parametrize("case", ["aligned4", "misaligned4", "aligned2",
                                  "misaligned2", "l1", "l3", "l5"])
def test_path_costs_plan(case):
    ptr, L, n_out = 1 << 20, 4, 1_243_440  # PF(31) uniform ugal_pf
    if case == "misaligned4":
        ptr += 4
    elif case == "aligned2":
        L, ptr = 2, ptr + 8
    elif case == "misaligned2":
        L, ptr = 2, ptr + 4
    elif case in ("l1", "l3"):
        L, ptr = int(case[1]), ptr + 4
    elif case == "l5":
        L = 5
    plan = ops._path_costs_plan(n_out, L, ptr)
    if case in ("misaligned4", "misaligned2", "l5"):
        assert plan["rows"] == 0
        assert plan["blocks"] == min(-(-n_out // 256), ops.SMS * 8)
    else:
        rows = plan["rows"]
        assert rows == ops.PATH_COSTS_ROWS == 8
        # every row in exactly one thread's share
        assert (plan["blocks"] - 1) * 256 * rows < n_out \
            <= plan["blocks"] * 256 * rows


# --- emulations of the kernels' arithmetic --------------------------------


def _emulate_minplus_kernel(a, b):
    """csrc/minplus.cu's combination: the wrapper's +inf-padded A, 16-k
    slices whose A chunks of 4 past the split's end and B rows past it are
    +inf, a running min per split, then the min over splits."""
    m, k = a.shape
    n = b.shape[1]
    plan = ops._minplus_plan(m, n, k)
    a_ = ops._aligned(a)
    assert a_.shape[1] % 4 == 0
    kp = a_.shape[1]
    parts = []
    for z in range(plan["splits"]):
        lo = z * plan["kper"]
        k_hi = min(k, lo + plan["kper"])
        a_hi = min(kp, lo + plan["kper"])
        acc = torch.full((m, n), INF32)
        for k0 in range(lo, k_hi, ops.MINPLUS_K):
            sa = torch.full((m, ops.MINPLUS_K), INF32)
            for kc in range(0, ops.MINPLUS_K, 4):
                if k0 + kc < a_hi:
                    sa[:, kc:kc + 4] = a_[:, k0 + kc:k0 + kc + 4]
            sb = torch.full((ops.MINPLUS_K, n), INF32)
            for kk in range(ops.MINPLUS_K):
                if k0 + kk < k_hi:
                    sb[kk] = b[k0 + kk]
            acc = torch.minimum(acc, (sa[:, :, None] + sb[None]).amin(1))
        parts.append(acc)
    return torch.stack(parts).amin(0)


@pytest.mark.parametrize("shape", EMULATED)
def test_split_k_emulation_equals_plain_version(shape):
    a, b = _inputs(shape)
    want = ref.minplus_ref(a, b)
    got = _emulate_minplus_kernel(a, b)
    assert torch.equal(got, want)
    assert ops._minplus_plan(shape[0], shape[2], shape[1])["splits"] \
        == math.ceil(shape[1] / ops._minplus_plan(
            shape[0], shape[2], shape[1])["kper"])


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_any_split_of_k_gives_the_same_bits(splits):
    """Min is exact and order-free: partial minima over any disjoint cover
    of k, combined, equal the plain version bit for bit."""
    a, b = _inputs((40, 77, 30), seed=splits)
    bounds = np.linspace(0, 77, splits + 1).astype(int)
    parts = [ref.minplus_ref(a[:, lo:hi].contiguous(),
                             b[lo:hi].contiguous())
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    assert torch.equal(torch.stack(parts).amin(0), ref.minplus_ref(a, b))


def test_padding_with_inf_never_wins():
    """The wrapper's padded copy: +inf columns of A (and rows of B) change
    no bit, even where every real candidate is above the repo's INF."""
    a, b = _inputs((9, 13, 11))
    a[0] = 3.0e38  # every candidate of row 0 overflows INF
    pa = ops._aligned(a)
    assert pa.shape == (9, 16) and torch.isinf(pa[:, 13:]).all()
    pb = torch.cat([b, torch.full((3, 11), INF32)])
    assert torch.equal(ref.minplus_ref(pa, pb), ref.minplus_ref(a, b))


def _wrap16(x):
    return ((x + 32768) % 65536) - 32768


def _emulate_hops_kernel(d):
    """csrc/minplus_dpx.cu's combination: C[i, j] = min over k pairs of
    D[i, k] + D[j, k] in two int16 halves (even k, odd k) with int16
    wrap-around, split-K, the halves' min last."""
    n = d.shape[0]
    plan = ops._hops_plan(n)
    d32 = d.to(torch.int32)
    acc = torch.full((n, n), 32767, dtype=torch.int32)
    for z in range(plan["splits"]):
        lo, hi = z * plan["kper"], min(n, (z + 1) * plan["kper"])
        for half in (0, 1):
            ks = torch.arange(lo + half, hi, 2)
            cand = _wrap16(d32[:, None, ks] + d32[None, :, ks]).amin(-1)
            acc = torch.minimum(acc, cand)
    assert (acc >= 0).all()  # no sum wrapped
    return acc.to(torch.int16)


def _emulated_apsp(adj):
    n = adj.shape[0]
    d = ops.apsp_hops0(torch.from_numpy(adj))
    for _ in range(ref.apsp_steps(n)):
        nxt = _emulate_hops_kernel(d)
        assert torch.equal(nxt, ref.minplus_hops_ref(d))
        assert torch.equal(nxt, nxt.T)  # stays symmetric
        d = nxt
    d = d[:n, :n]
    return torch.where(d == ref.HOPS_UNREACHABLE, ref.INF,
                       d.to(torch.float32))


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.2, 0.55])
@pytest.mark.parametrize("q", [5, 13])
def test_integer_route_emulation_equals_apsp_ref(q, frac):
    adj = _damaged(q, frac).adjacency
    got = _emulated_apsp(adj)
    assert torch.equal(got, ref.apsp_ref(torch.from_numpy(adj)))
    out = got.numpy().copy()
    out[out >= ref.INF / 2] = np.inf
    assert np.array_equal(out, r_ops.apsp(adj))


def test_integer_route_with_an_isolated_vertex():
    g = _damaged(13, 0.05)
    v = 3
    cut = g.edge_list[(g.edge_list == v).any(axis=1)]
    g = g.subgraph_without_edges(cut)
    adj = g.adjacency
    assert not adj[v].any()
    got = _emulated_apsp(adj)
    assert torch.equal(got, ref.apsp_ref(torch.from_numpy(adj)))
    assert np.isinf(ops.diameter_from_adj(adj, device="cpu"))
    bfs = all_pairs_distances(g).astype(np.float32)
    bfs[bfs < 0] = np.inf
    assert np.array_equal(ops.apsp(adj, device="cpu"), bfs)


def test_hops0_padding_is_isolated_vertices():
    adj = torch.from_numpy(_damaged(5, 0.2).adjacency)  # n = 31 -> 32
    d = ops.apsp_hops0(adj)
    assert d.dtype == torch.int16 and d.shape == (32, 32)
    assert (torch.diagonal(d) == 0).all()
    assert (d[31, :31] == ref.HOPS_UNREACHABLE).all()
    assert (d[:31, 31] == ref.HOPS_UNREACHABLE).all()
    assert torch.equal(d, d.T)


@pytest.mark.parametrize("n,symmetric,want", [
    (993, True, "hops"), (6321, True, "hops"), (16383, True, "hops"),
    (24807, True, "float"), (993, False, "float")])
def test_apsp_route(n, symmetric, want):
    assert ops._apsp_route(n, symmetric) == want


def test_directed_adjacency_takes_the_float_route():
    rng = np.random.default_rng(0)
    adj = rng.random((30, 30)) < 0.1
    np.fill_diagonal(adj, False)
    assert not np.array_equal(adj, adj.T)
    before = ops.MINPLUS_HOPS_LAUNCHES
    got = ops.apsp(adj, device="cpu")
    want = ref.apsp_ref(torch.from_numpy(adj)).numpy()
    want[want >= ref.INF / 2] = np.inf
    assert np.array_equal(got, want)
    assert np.array_equal(got, r_ops.apsp(adj))
    assert ops.MINPLUS_HOPS_LAUNCHES == before


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.2, 0.4, 0.55])
def test_diameter_is_the_max_of_apsp(frac):
    adj = _damaged(13, frac).adjacency
    diam = ops.diameter_from_adj(adj, device="cpu")
    assert diam == float(ops.apsp(adj, device="cpu").max())
    assert diam == r_ops.diameter_from_adj(adj)


def test_diameter_of_a_disconnected_graph_is_inf():
    adj = _damaged(5, 0.55).adjacency
    assert ops.diameter_from_adj(adj, device="cpu") == np.inf
    assert float(ops.apsp(adj, device="cpu").max()) == np.inf


def test_minplus_hops_rejects_what_the_kernel_does_not_take():
    for bad in (torch.zeros((8, 8), dtype=torch.int32),
                torch.zeros((12, 12), dtype=torch.int16),
                torch.zeros((8, 16), dtype=torch.int16),
                torch.zeros((16, 32), dtype=torch.int16)[:, ::2]):
        with pytest.raises(ValueError):
            ops.minplus_hops(bad)


# --- one case per route on the card -----------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


# (m, k, n): one split aligned, one split ragged k, split aligned, split
# ragged everywhere
CARD_MINPLUS = [(2048, 64, 2048), (2048, 67, 2048), (512, 1000, 512),
                (130, 70, 50)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_MINPLUS)
def test_minplus_route_on_card(shape):
    _card()
    a, b = (x.cuda() for x in _inputs(shape))
    before = ops.MINPLUS_LAUNCHES
    out = ops.minplus(a, b)
    torch.cuda.synchronize()
    assert ops.MINPLUS_LAUNCHES == before + 1
    assert torch.equal(out, ref.minplus_ref(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [184, 2088])
def test_minplus_hops_route_on_card(n):
    """n = 184 splits k, n = 2088 (289 tiles) does not."""
    _card()
    rng = np.random.default_rng(n)
    h = rng.integers(0, 40, (n, n))
    h = np.minimum(h, h.T)
    h[rng.random((n, n)) < 0.2] = ref.HOPS_UNREACHABLE
    h = np.minimum(h, h.T)
    np.fill_diagonal(h, 0)
    d = torch.from_numpy(h.astype(np.int16)).cuda()
    before = ops.MINPLUS_HOPS_LAUNCHES
    out = ops.minplus_hops(d)
    torch.cuda.synchronize()
    assert ops.MINPLUS_HOPS_LAUNCHES == before + 1
    assert torch.equal(out, ref.minplus_hops_ref(d))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [5, 13])
def test_apsp_routes_agree_on_card(q, monkeypatch):
    _card()
    adj = _damaged(q, 0.55).adjacency  # disconnected at q = 5
    hops = ops.apsp(adj, device="cuda")
    monkeypatch.setattr(ops, "_apsp_route", lambda n, symmetric: "float")
    flt = ops.apsp(adj, device="cuda")
    assert np.array_equal(hops, flt)
    assert np.array_equal(hops, ops.apsp(adj, device="cpu"))


# (F, K, L, dtype, base offset in int32s, table entries): the vector rows
# at PF(31)'s and PF(79)'s table sizes, L = 2 and 3, a misaligned base and
# L = 5 (the generic kernel)
CARD_PATH_COSTS = [(1000, 11, 4, "float32", 0, 31777),
                   (1000, 11, 4, "float64", 0, 31777),
                   (1000, 11, 4, "float32", 0, 126401),
                   (999, 3, 2, "float32", 0, 500),
                   (999, 3, 3, "float64", 0, 500),
                   (1000, 11, 4, "float32", 1, 500),
                   (300, 8, 5, "float32", 0, 38)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_PATH_COSTS)
def test_path_costs_route_on_card(case):
    _card()
    f, k, l, dtype, offset, table = case
    rng = np.random.default_rng(f + l)
    delay = np.concatenate([rng.random(table - 1) * 5, np.zeros(1)])
    d = torch.from_numpy(delay).to("cuda", getattr(torch, dtype))
    flat = torch.from_numpy(rng.integers(0, table, f * k * l + offset)
                            .astype(np.int32)).cuda()
    e = flat[offset:].view(f, k, l)
    before = ops.LAUNCHES
    out = ops.path_costs(d, e)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert torch.equal(out, ref.path_costs_ref(d, e))
