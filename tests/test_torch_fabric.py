"""The port's fabric (`repro_torch.fabric`) against the JAX package's.

Both are host numpy: placements, spares, routing and every
`CollectiveCost` field must be equal exactly.  The reference's cost
models default their link rate to its `LINK_BW`, a TPU interconnect rate;
the port's take no default (None raises), so these tests pass the
reference's 50e9 bytes/s explicitly, as an input, to both.
"""
import inspect
from dataclasses import astuple

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.fabric as R  # noqa: E402
import repro.fabric.collectives as RC  # noqa: E402
import repro_torch.fabric as T  # noqa: E402
import repro_torch.fabric.collectives as TC  # noqa: E402

BW = 50e9  # the reference's LINK_BW, passed as an input
PODS = [(16, 16, 17), (4, 4, 7), (8, 8, 9), (2, 4, 5)]
_PODS = {}


def pods(shape):
    """(reference placement, port placement) of `shape` (cached)."""
    if shape not in _PODS:
        _PODS[shape] = (R.place_pod(*shape), T.place_pod(*shape))
    return _PODS[shape]


def same_placement(r, t):
    assert np.array_equal(r.node_of, t.node_of)
    assert r.node_of.dtype == t.node_of.dtype
    assert np.array_equal(r.spares, t.spares)
    assert r.spares.dtype == t.spares.dtype
    assert r.coord_of() == t.coord_of()
    assert (r.data_size, r.model_size) == (t.data_size, t.model_size)


@pytest.mark.parametrize("shape", PODS)
def test_place_pod_matches_reference(shape):
    r, t = pods(shape)
    same_placement(r, t)
    assert np.array_equal(r.routing.next_hop, t.routing.next_hop)
    assert np.array_equal(r.routing.dist, t.routing.dist)
    assert np.array_equal(r.layout.cluster_of, t.layout.cluster_of)
    assert np.array_equal(r.layout.centers, t.layout.centers)


def test_remap_failed_chain_matches_reference():
    """Five failures in a row, the same rack twice (its spare is used up
    and the next comes from the first spare of another rack)."""
    r, t = pods((16, 16, 17))
    for d, m in [(5, 7), (5, 3), (5, 9), (0, 0), (15, 15)]:
        r, t = r.remap_failed(d, m), t.remap_failed(d, m)
        same_placement(r, t)


def test_remap_failed_without_spares_raises():
    _, t = pods((2, 4, 5))
    for i in range(len(t.spares)):
        t = t.remap_failed(i % 2, i % 4)
    assert len(t.spares) == 0
    with pytest.raises(RuntimeError, match="no spare"):
        t.remap_failed(0, 0)


def test_place_pod_rejects_what_the_reference_rejects():
    for args in [(18, 16, 17), (16, 18, 17)]:
        with pytest.raises(ValueError):
            R.place_pod(*args)
        with pytest.raises(ValueError):
            T.place_pod(*args)


# (name, positional arguments after the placement, before link_bw)
CASES = [
    ("ring_allreduce", ("model", 1e9, 3)),
    ("ring_allreduce", ("data", 1e9, 3)),
    ("ring_allreduce", ("data", 12345.0, 0)),
    ("rhd_allreduce", ("model", 1e8, 0)),
    ("rhd_allreduce", ("data", 3e7, 5)),
    ("polar2phase_allreduce", (1e9,)),
    ("all_gather", ("model", 1e6, 2)),
    ("all_gather", ("data", 1e6, 7)),
    ("all_to_all", ("model", 1e8, 0)),
    ("all_to_all", ("data", 1e8, 6)),
    ("best_allreduce", ("model", 1e8, 0)),
    ("best_allreduce", ("data", 1e5, 1)),
]


@pytest.mark.parametrize("shape", [(16, 16, 17), (8, 8, 9)])
@pytest.mark.parametrize("name,args", CASES)
def test_collective_costs_match_reference(shape, name, args):
    """Every field equal, link_bw passed by keyword and by position (the
    parameter lists are the reference's, in order)."""
    r, t = pods(shape)
    want = getattr(RC, name)(r, *args, link_bw=BW)
    got = getattr(TC, name)(t, *args, link_bw=BW)
    assert type(got).__name__ == "CollectiveCost"
    assert astuple(got) == astuple(want)
    assert astuple(getattr(TC, name)(t, *args, BW)) == astuple(want)


def test_round_time_matches_reference():
    r, t = pods((16, 16, 17))
    pairs = [(int(a), int(b)) for a, b in zip(r.node_of[:, 0],
                                              r.node_of[::-1, 1])]
    assert TC.round_time(t, pairs, 1e6, BW) == RC.round_time(r, pairs, 1e6,
                                                             BW)
    assert TC.round_time(t, [], 1e6, BW) == RC.round_time(r, [], 1e6, BW)


def test_parameter_lists_are_the_references():
    for name in RC.__all__:
        if name in ("LINK_BW", "CollectiveCost"):
            continue
        rp = inspect.signature(getattr(RC, name)).parameters
        tp = inspect.signature(getattr(TC, name)).parameters
        assert list(rp) == list(tp), name
        for p in rp:
            want = None if p == "link_bw" else rp[p].default
            assert tp[p].default == want, (name, p)


@pytest.mark.parametrize("name,args", CASES[::2] + [("round_time",
                                                      ([(0, 1)], 1e6))])
def test_link_bw_none_raises(name, args):
    _, t = pods((8, 8, 9))
    fn = getattr(TC, name)
    with pytest.raises(ValueError, match="link_bw"):
        fn(t, *args)
    with pytest.raises(ValueError, match="link_bw"):
        fn(t, *args, link_bw=None)
    with pytest.raises(ValueError, match="link_bw"):
        fn(t, *args, link_bw=0.0)


def test_no_tpu_link_rate_in_the_port():
    assert not hasattr(TC, "LINK_BW") and not hasattr(T, "LINK_BW")
    assert "LINK_BW" not in TC.__all__
    for name in ("PodPlacement", "place_pod", "DEFAULT_POD_Q",
                 "CollectiveCost", "ring_allreduce", "rhd_allreduce",
                 "polar2phase_allreduce", "all_gather", "all_to_all",
                 "best_allreduce"):
        assert hasattr(T, name), name
    assert T.DEFAULT_POD_Q == R.DEFAULT_POD_Q


def test_reference_fabric_tests_on_the_port():
    """tests/test_fabric.py's checks on the port's placement, with the
    reference's link rate passed in."""
    _, pod = pods((16, 16, 17))
    for axis in ("model", "data"):
        c = T.ring_allreduce(pod, axis, 1e9, index=3, link_bw=BW)
        assert c.max_link_load == 1.0
        assert abs(c.seconds - 2 * 15 / 16 * 1e9 / BW) < 1e-3
    r = T.ring_allreduce(pod, "model", 1e8, link_bw=BW)
    h = T.rhd_allreduce(pod, "model", 1e8, link_bw=BW)
    assert h.seconds < 2.5 * r.seconds
    assert T.best_allreduce(pod, "model", 1e8, link_bw=BW).seconds <= min(
        r.seconds, h.seconds)
    assert T.all_to_all(pod, "model", 1e8, link_bw=BW).max_link_load <= 2.0
    p2 = pod.remap_failed(5, 7)
    assert len(set(p2.node_of.flatten().tolist())) == 256
    assert int(p2.routing.dist[p2.node_of[5, 7]].max()) <= 2
