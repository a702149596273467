"""The port's blockwise device backend against the JAX package's host engine.

``backend="sharded"`` runs the PyTorch twins of the blocked BFS and the
next-hop column derivation (`_bfs_device_fn`, `_dest_device_fn`) on a
device; here ``device="cpu"``, the same PyTorch code the card runs.  Their
outputs (int16 distances, int32 first hops and next-hop columns) must be
bit-identical to the JAX package's host engine over
tests/test_sparse_engine.py's `TOPOS` grid, intact and damaged, and the
executor must reproduce the host loop on a synthetic function as
tests/test_blockwise.py requires of the reference.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import assert_same  # noqa: E402

from repro.core import routing as r_routing  # noqa: E402
from repro.core import topologies as r_tp  # noqa: E402
from repro.core.polarfly import build_polarfly as r_build_polarfly  # noqa: E402
from repro_torch.core import metrics as t_metrics  # noqa: E402
from repro_torch.core import routing as t_routing  # noqa: E402
from repro_torch.core import topologies as t_tp  # noqa: E402
from repro_torch.core.polarfly import build_polarfly as t_build_polarfly  # noqa: E402
from repro_torch.parallel import blockwise as t_blockwise  # noqa: E402

TOPOS = {
    "pf13": lambda tp, pf: pf(13).graph,
    "sf11": lambda tp, pf: tp.build_slimfly(11),
    "ps5x5": lambda tp, pf: tp.build_polarstar(5, 5),
    "df": lambda tp, pf: tp.build_dragonfly(6, 3),
    "ft": lambda tp, pf: tp.build_fat_tree(6, 3),
    "jf": lambda tp, pf: tp.build_jellyfish(120, 7, seed=0),
}
GRID = [(name, which) for name in sorted(TOPOS)
        for which in ("intact", "damaged")]
SHARDED = {"backend": "sharded", "device": "cpu"}


@functools.lru_cache(maxsize=None)
def _graphs(name, which):
    """(reference graph, port graph), damaged as tests/test_sparse_engine.py
    damages them."""
    r = TOPOS[name](r_tp, r_build_polarfly)
    t = TOPOS[name](t_tp, t_build_polarfly)
    if which == "damaged":
        r = r.subgraph_without_edges(r.edge_list[::5][:8])
        t = t.subgraph_without_edges(t.edge_list[::5][:8])
    return r, t


@pytest.mark.parametrize("name,which", GRID)
def test_device_bfs_bit_identical_to_host_engine(name, which):
    r, t = _graphs(name, which)
    indptr, indices = r.csr
    srcs = np.arange(0, r.n, 3, dtype=np.int64)
    want_d, want_nh = r_routing._bfs_block(indptr, indices, srcs, True)
    dist, nh = t_routing._bfs_device_fn(t, True, "cpu")(torch.from_numpy(srcs))
    assert_same(dist.numpy(), want_d, "dist")
    assert_same(nh.numpy(), want_nh, "first hop")
    (dist_only,) = t_routing._bfs_device_fn(t, False, "cpu")(
        torch.from_numpy(srcs))
    assert_same(dist_only.numpy(), want_d, "dist without first hops")


@pytest.mark.parametrize("name,which", GRID)
def test_sharded_routing_tables_bit_identical(name, which):
    r, t = _graphs(name, which)
    want_d, want_nh = r_routing.sparse_routing_tables(r, block=37)
    got_d, got_nh = t_routing.sparse_routing_tables(t, block=37, **SHARDED)
    assert_same(got_d, want_d, "dist")
    assert_same(got_nh, want_nh, "next hop")


@pytest.mark.parametrize("name,which", GRID)
def test_sharded_destination_columns_bit_identical(name, which):
    r, t = _graphs(name, which)
    dests = np.arange(1, r.n, 2)
    want = list(r_routing.destination_blocks(r, dests, block=11))
    got = list(t_routing.destination_blocks(t, dests, block=11, **SHARDED))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            assert_same(y, x, "destination block")


@pytest.mark.parametrize("name,which", GRID)
def test_sharded_blocked_routing_and_metrics_match_host(name, which):
    _, t = _graphs(name, which)
    host = t_routing.build_blocked_routing(t, backend="host")
    dev = t_routing.build_blocked_routing(t, **SHARDED)
    assert (dev.diameter, dev.block) == (host.diameter, host.block)
    for a, b in zip(host.dest_blocks(block=13), dev.dest_blocks(block=13)):
        for x, y in zip(a, b):
            assert_same(y, x, "blocked routing columns")
    assert (t_metrics.diameter_and_aspl(t, engine="sparse", **SHARDED)
            == t_metrics.diameter_and_aspl(t, engine="sparse",
                                           backend="host"))


def test_sharded_edge_free_graph_falls_back_to_host():
    from repro.core.graph import Graph as RGraph
    from repro_torch.core.graph import Graph

    g = Graph("empty", 4, [np.zeros(0, np.int32)] * 4)
    assert t_routing._bfs_device_fn(g, True, "cpu") is None
    want = r_routing.sparse_routing_tables(
        RGraph("empty", 4, [np.zeros(0, np.int32)] * 4))
    for x, y in zip(want, t_routing.sparse_routing_tables(g, **SHARDED)):
        assert_same(y, x, "edge-free tables")


def test_run_blocks_sharded_matches_host_on_synthetic_fn():
    """Explicit sharded backend: a short tail block must still reproduce
    the host loop bit for bit."""
    items = np.arange(23, dtype=np.int64)  # 5 blocks of 5 -> short tail

    def host_fn(blk):
        return blk * blk + 1, (blk % 3).astype(np.int32)

    def device_fn(blk):
        return blk * blk + 1, (blk % 3).to(torch.int32)

    plan = t_blockwise.plan_blocks(len(items), block=5)
    ref = list(t_blockwise.run_blocks(items, plan, host_fn, backend="host"))
    got = list(t_blockwise.run_blocks(items, plan, host_fn, device_fn,
                                      backend="sharded"))
    assert len(got) == len(ref) == 5
    for (rb, ro), (gb, go) in zip(ref, got):
        np.testing.assert_array_equal(rb, gb)
        for r, g in zip(ro, go):
            assert_same(g, r, "synthetic block")


def test_run_blocks_auto_stays_on_host_without_several_devices():
    calls = []

    def device_fn(blk):
        calls.append(1)
        return blk

    for devices in (1, 4):
        plan = t_blockwise.plan_blocks(10, block=3, devices=devices)
        list(t_blockwise.run_blocks(np.arange(10), plan, lambda b: b,
                                    device_fn, backend="auto"))
    assert calls == [] or t_blockwise.available_devices() > 1
    # a multi-device request on a machine without that many cards stays on
    # the host loop (and does not ask for the card)
    _, t = _graphs("df", "intact")
    if t_blockwise.available_devices() < 2:
        for a, b in zip(t_routing.distance_blocks(t, block=50, devices=2),
                        t_routing.distance_blocks(t, block=50,
                                                  backend="host")):
            assert_same(a[1], b[1], "auto with devices=2")


def test_run_blocks_validation():
    items = np.arange(6)
    with pytest.raises(ValueError):
        list(t_blockwise.run_blocks(items, t_blockwise.plan_blocks(5, block=2),
                                    lambda b: b))
    with pytest.raises(ValueError, match="unknown backend"):
        list(t_blockwise.run_blocks(items, t_blockwise.plan_blocks(6, block=2),
                                    lambda b: b, backend="nope"))
    with pytest.raises(ValueError, match="device_fn"):
        list(t_blockwise.run_blocks(items, t_blockwise.plan_blocks(6, block=2),
                                    lambda b: b, backend="sharded"))
    with pytest.raises(ValueError):
        t_blockwise.plan_blocks(6, block=2, devices=0)
    assert t_blockwise.available_devices() == torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("name,which", [("pf13", "intact"),
                                        ("ps5x5", "damaged")])
def test_sharded_routing_on_card_bit_identical(name, which):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r, t = _graphs(name, which)
    want_d, want_nh = r_routing.sparse_routing_tables(r)
    got_d, got_nh = t_routing.sparse_routing_tables(t, backend="sharded",
                                                    device="cuda")
    assert_same(got_d, want_d, "dist")
    assert_same(got_nh, want_nh, "next hop")
