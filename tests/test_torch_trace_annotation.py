"""`obs.trace_annotation`, the JAX package's host-interval annotation on
the port: a no-op outside a ``torch.profiler`` capture, a labelled host
interval inside one, and around each round of the blockwise device
backend ("blockwise.round", as the reference's ``parallel/blockwise.py``
labels its rounds)."""
from contextlib import nullcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

from repro_torch import obs  # noqa: E402
from repro_torch.parallel import blockwise  # noqa: E402


def _names(prof):
    return [e.name for e in prof.events()]


def test_no_op_outside_a_capture():
    ann = obs.trace_annotation("outside")
    assert isinstance(ann, nullcontext)
    with ann:
        torch.ones(3).sum()


def test_labelled_interval_inside_a_capture():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.trace_annotation("host.interval"):
            torch.ones(64).cumsum(0)
    events = [e for e in prof.events() if e.name == "host.interval"]
    assert len(events) == 1
    inner = [e for e in prof.events() if e.name == "aten::cumsum"]
    assert inner and events[0].time_range.start <= inner[0].time_range.start
    assert inner[0].time_range.end <= events[0].time_range.end


def test_blockwise_rounds_are_labelled():
    from torch.profiler import ProfilerActivity, profile

    items = np.arange(10)
    plan = blockwise.plan_blocks(10, block=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = list(blockwise.run_blocks(items, plan, lambda b: b * 2,
                                        lambda t: t * 2, backend="sharded"))
    assert [o[1][0].tolist() for o in out] == [[0, 2, 4, 6], [8, 10, 12, 14],
                                               [16, 18]]
    assert _names(prof).count("blockwise.round") == plan.num_blocks == 3
