"""Blockwise rounds spread over several devices.

The port's ``backend="sharded"`` runs round r's blocks r * ndev .. r * ndev
+ ndev - 1 at once, block j of the round on device j, ``ndev =
min(plan.devices, twins)`` -- the reference's ``shard_map`` over
``jax.devices()[:ndev]`` (tests/test_blockwise.py, whose cases this file
mirrors on the port).  Here the devices are explicit lists of several
``torch.device("cpu")`` entries, the counterpart of the reference's forced
host devices: outputs and yield order must equal the host backend's bit
for bit, at plans of 1-4 devices, block counts that the devices do not
divide, and an empty plan; the blocked routing stack at PF(13) and PF(19)
with two and three CPU "devices" must equal the JAX package's host
engine bit for bit.  A ``cuda`` case runs on however many cards there are.
"""
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import FIELDS, assert_same  # noqa: E402

from repro.core import routing as r_routing  # noqa: E402
from repro.core.metrics import diameter_and_aspl as r_diameter_and_aspl  # noqa: E402
from repro.core.polarfly import build_polarfly as r_build_polarfly  # noqa: E402
from repro.simulation import build_flow_paths as r_build_flow_paths  # noqa: E402
from repro.simulation import make_pattern as r_make_pattern  # noqa: E402
from repro_torch.core import routing as t_routing  # noqa: E402
from repro_torch.core.metrics import diameter_and_aspl  # noqa: E402
from repro_torch.core.polarfly import build_polarfly as t_build_polarfly  # noqa: E402
from repro_torch.parallel import blockwise as bw  # noqa: E402
from repro_torch.simulation import build_flow_paths, make_pattern  # noqa: E402

CPU = torch.device("cpu")


def cpus(n):
    return [CPU] * n


# ---------------------------------------------------------------------------
# plan math
# ---------------------------------------------------------------------------

def test_block_plan_rounds_ceil_over_devices():
    plan = bw.BlockPlan(total=100, block=10, devices=4)
    assert plan.num_blocks == 10 and plan.num_rounds == 3
    assert bw.BlockPlan(total=100, block=10).num_rounds == 10
    assert bw.BlockPlan(total=0, block=5, devices=8).num_rounds == 0
    assert bw.plan_blocks(23, block=5, devices=3).num_rounds == 2


# ---------------------------------------------------------------------------
# the executor on explicit device lists
# ---------------------------------------------------------------------------

def _host_fn(blk):
    return blk * blk + 1, (blk % 3).astype(np.int32)


def _twin(device, log=None, tag=None):
    def fn(blk):
        if log is not None:
            log.append(("call", tag, int(blk[0])))
        x = blk.to(device)
        return x * x + 1, (x % 3).to(torch.int32)
    return fn


@pytest.mark.parametrize("ndev", [1, 2, 3, 4])
@pytest.mark.parametrize("total,block", [(23, 5), (20, 5), (7, 3), (1, 4),
                                         (12, 1)])
def test_rounds_match_host_bit_for_bit(ndev, total, block):
    items = np.arange(total, dtype=np.int64) * 7 - 3
    plan = bw.plan_blocks(total, block=block, devices=ndev)
    twins = [_twin(d) for d in cpus(ndev)]
    ref = list(bw.run_blocks(items, plan, _host_fn, backend="host"))
    got = list(bw.run_blocks(items, plan, _host_fn, twins,
                             backend="sharded"))
    assert len(got) == len(ref) == plan.num_blocks
    for (rb, ro), (gb, go) in zip(ref, got):
        assert_same(gb, rb, "block ids")
        for r, g in zip(ro, go):
            assert isinstance(g, np.ndarray)
            assert_same(g, r, "block output")


def test_empty_plan_yields_nothing():
    plan = bw.plan_blocks(0, block=3, devices=3)
    assert list(bw.run_blocks(np.arange(0), plan, _host_fn,
                              [_twin(d) for d in cpus(3)],
                              backend="sharded")) == []


def test_round_j_runs_on_twin_j_and_is_issued_before_it_is_yielded():
    """Block j of round r runs on twin j; every block of a round is
    issued before the round's first block reaches the consumer; blocks
    come out in block order."""
    lock = threading.Lock()

    class Log(list):
        def append(self, x):
            with lock:
                super().append(x)

    log = Log()
    ndev, block, total = 3, 2, 15  # 8 blocks: rounds of 3, 3, 2
    twins = [_twin(CPU, log, j) for j in range(ndev)]
    plan = bw.plan_blocks(total, block=block, devices=ndev)
    items = np.arange(total, dtype=np.int64)
    for blk, _ in bw.run_blocks(items, plan, _host_fn, twins,
                                backend="sharded"):
        log.append(("yield", None, int(blk[0])))
    calls = [(tag, first) for kind, tag, first in log if kind == "call"]
    assert sorted(calls) == sorted(
        (i % ndev, i * block) for i in range(plan.num_blocks))
    assert [first for kind, _, first in log if kind == "yield"] == [
        i * block for i in range(plan.num_blocks)]
    pos = {(kind, first): k for k, (kind, _, first) in enumerate(log)}
    for r in range(plan.num_rounds):
        first_yield = pos["yield", r * ndev * block]
        for i in range(r * ndev, min(r * ndev + ndev, plan.num_blocks)):
            assert pos["call", i * block] < first_yield


def test_round_width_is_the_smaller_of_plan_and_twins():
    log = []
    twins = [_twin(CPU, log, j) for j in range(4)]
    plan = bw.plan_blocks(12, block=2, devices=2)  # 6 blocks, 2 a round
    list(bw.run_blocks(np.arange(12), plan, _host_fn, twins,
                       backend="sharded"))
    assert {tag for _, tag, _ in log} == {0, 1}
    log.clear()
    plan = bw.plan_blocks(12, block=2, devices=8)  # 2 twins: 2 a round
    list(bw.run_blocks(np.arange(12), plan, _host_fn, twins[:2],
                       backend="sharded"))
    assert {tag for _, tag, _ in log} == {0, 1}


def test_auto_rule_and_no_host_fallback():
    log = []
    items = np.arange(10)
    many = [_twin(CPU, log, j) for j in range(2)]
    # auto: several twins, several blocks and a multi-device plan shard
    list(bw.run_blocks(items, bw.plan_blocks(10, block=3, devices=2),
                       _host_fn, many, backend="auto"))
    assert log
    # ... and stays on the host with one device in the plan, one twin, or
    # one block
    for plan, twins in ((bw.plan_blocks(10, block=3, devices=1), many),
                        (bw.plan_blocks(10, block=3, devices=2), many[:1]),
                        (bw.plan_blocks(10, block=10, devices=2), many)):
        log.clear()
        list(bw.run_blocks(items, plan, _host_fn, twins, backend="auto"))
        assert log == []
    # sharded by name never leaves the device: a twin that fails fails
    def broken(blk):
        raise RuntimeError("device run failed")

    with pytest.raises(RuntimeError, match="device run failed"):
        list(bw.run_blocks(items, bw.plan_blocks(10, block=3, devices=2),
                           _host_fn, [broken, broken], backend="sharded"))


def test_resolve_devices():
    assert bw.resolve_devices(cpus(3)) == cpus(3)
    assert bw.resolve_devices(["cpu", "cpu"]) == cpus(2)
    with pytest.raises(ValueError):
        bw.resolve_devices([])
    # device= keeps its meaning for one device
    assert bw.resolve_devices(4, "cpu") == [CPU]
    assert bw.resolve_devices(None, "cpu") == [CPU]
    if bw.available_devices() == 0:
        # a count clamps to the visible cards; without one, a CUDA device
        # raises (the port never falls back to the CPU by itself)
        with pytest.raises(RuntimeError):
            bw.resolve_devices(4, "cuda")
        with pytest.raises(RuntimeError):
            list(t_routing.distance_blocks(t_build_polarfly(7).graph,
                                           backend="sharded"))


# ---------------------------------------------------------------------------
# the blocked routing stack on 2 and 3 CPU "devices" against the JAX
# package's host engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _graphs(q, which):
    r = r_build_polarfly(q).graph
    t = t_build_polarfly(q).graph
    if which == "damaged":
        r = r.subgraph_without_edges(r.edge_list[::5][:8])
        t = t.subgraph_without_edges(t.edge_list[::5][:8])
    return r, t


GRID = [(q, which, ndev) for q in (13, 19) for which in ("intact", "damaged")
        for ndev in (2, 3)]


@pytest.mark.parametrize("q,which,ndev", GRID)
def test_distance_blocks_on_cpu_devices_equal_host_engine(q, which, ndev):
    r, t = _graphs(q, which)
    # block = 17 divides none of these orders (183, 381): short tail block
    # and short tail round
    want = list(r_routing.distance_blocks(r, block=17, next_hop=True))
    got = list(t_routing.distance_blocks(t, block=17, next_hop=True,
                                         backend="sharded",
                                         devices=cpus(ndev)))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            assert_same(y, x, "distance block")


@pytest.mark.parametrize("q,which,ndev", GRID)
def test_destination_blocks_on_cpu_devices_equal_host_engine(q, which, ndev):
    r, t = _graphs(q, which)
    dests = np.arange(1, r.n, 2)
    want = list(r_routing.destination_blocks(r, dests, block=11))
    got = list(t_routing.destination_blocks(t, dests, block=11,
                                            backend="sharded",
                                            devices=cpus(ndev)))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            assert_same(y, x, "destination block")


@pytest.mark.parametrize("q,which,ndev", GRID)
def test_blocked_routing_on_cpu_devices_equals_host_engine(q, which, ndev):
    r, t = _graphs(q, which)
    want = r_routing.build_blocked_routing(r, block=13)
    got = t_routing.build_blocked_routing(t, block=13, backend="sharded",
                                          devices=cpus(ndev))
    assert (got.diameter, got.block) == (want.diameter, want.block)
    for a, b in zip(want.dest_blocks(), got.dest_blocks()):
        for x, y in zip(a, b):
            assert_same(y, x, "blocked routing columns")
    assert (diameter_and_aspl(t, engine="sparse", backend="sharded",
                              devices=cpus(ndev))
            == r_diameter_and_aspl(r, engine="sparse"))


@pytest.mark.parametrize("ndev", [2, 3])
def test_blocked_paths_on_cpu_devices_equal_reference(ndev):
    """tests/test_blockwise.py's blocked-routing paths case on the port:
    FlowPaths through `BlockedRouting` on several CPU devices equal the
    JAX package's blocked engine on its dense tables."""
    r, t = _graphs(13, "damaged")
    rt = r_routing.build_routing(r)
    brt = t_routing.build_blocked_routing(t, block=17, backend="sharded",
                                          devices=cpus(ndev))
    rpat = r_make_pattern("uniform", rt, p=4, seed=3, max_flows=2000)
    tpat = make_pattern("uniform", brt, p=4, seed=3, max_flows=2000)
    assert_same(tpat.src, rpat.src, "pattern")
    for mode in ("min", "ecmp", "ugal_pf"):
        want = r_build_flow_paths(rt, rpat, mode, k_candidates=5, seed=7,
                                  engine="blocked")
        got = build_flow_paths(brt, tpat, mode, k_candidates=5, seed=7,
                               engine="blocked")
        for f in FIELDS:
            assert_same(getattr(got, f), getattr(want, f), (mode, f))


@pytest.mark.cuda
def test_card_rounds_equal_host():
    """On however many cards are visible: source and destination blocks
    spread one a card (`devices=ncard`; None under "sharded" is one card)
    equal the host backend's, and `devices=4` on fewer cards clamps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ncard = bw.available_devices()
    assert len(bw.resolve_devices(None)) == 1
    assert len(bw.resolve_devices(ncard)) == ncard
    assert len(bw.resolve_devices(4)) == min(4, ncard)
    _, t = _graphs(19, "damaged")
    host = list(t_routing.distance_blocks(t, block=17, next_hop=True,
                                          backend="host"))
    for devices in (None, 1, 4):
        got = list(t_routing.distance_blocks(t, block=17, next_hop=True,
                                             backend="sharded",
                                             devices=devices))
        for a, b in zip(host, got):
            for x, y in zip(a, b):
                assert_same(y, x, f"devices={devices}")
    dests = np.arange(0, t.n, 3)
    host = list(t_routing.destination_blocks(t, dests, block=7,
                                             backend="host"))
    got = list(t_routing.destination_blocks(t, dests, block=7,
                                            backend="sharded",
                                            devices=ncard))
    for a, b in zip(host, got):
        for x, y in zip(a, b):
            assert_same(y, x, "destination columns on the cards")
