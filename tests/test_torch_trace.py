"""Convergence traces (`trace=True`) of the port's fluid engines.

tests/test_obs.py's three trace tests, on the port; then:

* a traced result equals the untraced one bit for bit (uncertified
  batched saturation, certified saturation, `latency_curve` both ways,
  `evaluate_load` both ways): tracing only writes samples;
* the uncertified traced `latency_curve` below saturation (0.25, 0.5 and
  0.75 of the reference's saturation, PF(7) ugal, 250 steps) follows the
  reference's trace sample by sample: max_util within 1e-3 relative and
  the gap within 1e-3 * total demand, the adaptive bar below saturation
  (tests/test_torch_fluid.py);
* `probe`, `iters` and `brackets` have the reference's shapes (and, for
  the uncertified saturation, its values).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import flow_paths, ref_saturation, to_port  # noqa: E402

import repro.simulation as R  # noqa: E402
from repro.core.polarfly import build_polarfly  # noqa: E402
from repro.core.routing import build_routing  # noqa: E402

import repro_torch.simulation as T  # noqa: E402
from repro_torch.obs import ConvergenceTrace, Recorder  # noqa: E402

_FP = {}


def _pf7_flow_paths(mode="ugal"):
    """tests/test_obs.py's PF(7) uniform graph: (reference, port)."""
    if ("pf7", mode) not in _FP:
        pf = build_polarfly(7)
        rt = build_routing(pf.graph, pf)
        pat = R.make_pattern("uniform", rt, p=4, seed=0)
        kw = {} if mode == "min" else {"k_candidates": 4}
        fp = R.build_flow_paths(rt, pat, mode, seed=5, **kw)
        _FP["pf7", mode] = (fp, to_port(fp))
    return _FP["pf7", mode]


def _same(a, b):
    """Two results equal bit for bit, their traces aside."""
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    da.pop("trace"), db.pop("trace")
    assert da == db


# ---------------------------------------------------------------------------
# tests/test_obs.py's trace tests, on the port
# ---------------------------------------------------------------------------

def test_certified_trace_matches_certificate_pf13():
    """`ConvergenceTrace.final_gap` equals `Certificate.gap` exactly on a
    PF(13) certified saturation."""
    pf = build_polarfly(13)
    rt = build_routing(pf.graph, pf)
    pat = R.make_pattern("uniform", rt, p=7, seed=0)
    tfp = to_port(R.build_flow_paths(rt, pat, "ugal", k_candidates=4,
                                     seed=5))
    res = T.saturation_throughput(tfp, tol=0.01, certify=True,
                                  cert_iters=512, trace=True, device="cpu")
    tr = res.trace
    assert isinstance(tr, ConvergenceTrace) and tr.kind == res.cert.kind
    assert tr.final_gap == res.cert.gap
    assert tr.num_samples > 0 and np.isfinite(tr.gap).all()
    # one bracket row per probe; the bisection bracket never widens
    assert tr.brackets.shape[0] == tr.num_probes
    widths = tr.brackets[:, 3] - tr.brackets[:, 2]
    assert (np.diff(widths) <= 1e-12).all()
    assert widths[-1] <= 0.01 + 1e-9
    # cumulative iteration counts never decrease, probes are ordered
    assert (np.diff(tr.iters) >= 0).all()
    assert (np.diff(tr.probe) >= 0).all()
    # within each probe the conjugate-FW gap converges: the final sample
    # is the probe's smallest
    for p in range(tr.num_probes):
        g = tr.probe_slice(p).gap
        if len(g) > 1:
            assert g[-1] == g.min()


def test_uncertified_trace_is_free_of_side_effects():
    _, tfp = _pf7_flow_paths("ugal")
    plain = T.saturation_throughput(tfp, tol=0.05, iters=64,
                                    engine="batched", device="cpu")
    res = T.saturation_throughput(tfp, tol=0.05, iters=64, engine="batched",
                                  trace=True, device="cpu")
    assert res.saturation == plain  # tracing must not change the result
    tr = res.trace
    assert tr.kind == "uncertified" and tr.stride == 1
    assert np.isnan(tr.util_lb).all() and np.isnan(tr.util_ub).all()
    assert tr.brackets.shape[0] == tr.num_probes
    assert np.isnan(res.truncation_err)  # only return_info computes it
    with pytest.raises(ValueError, match="trace=True"):
        T.saturation_throughput(tfp, trace=True, engine="scalar",
                                device="cpu")


def test_trace_to_metrics_emits_gauges_and_series():
    _, tfp = _pf7_flow_paths("ugal")
    res = T.saturation_throughput(tfp, tol=0.05, iters=64, engine="batched",
                                  trace=True, device="cpu")
    rec = Recorder()
    res.trace.to_metrics(rec, name="fluid")
    met = rec.metrics()
    assert met["gauges"]["fluid.final_gap"]["last"] == res.trace.final_gap
    names = {ev["name"] for ev in rec.events()}
    assert {"fluid.gap", "fluid.max_util"} <= names


# ---------------------------------------------------------------------------
# tracing changes nothing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["min", "ugal", "ugal_pf"])
def test_traced_results_equal_untraced(mode):
    _, tfp = _pf7_flow_paths(mode)
    kw = dict(tol=0.05, iters=64, device="cpu")
    sat = T.saturation_throughput(tfp, trace=True, **kw)
    assert sat.saturation == T.saturation_throughput(tfp, **kw)
    kw = dict(tol=0.05, certify=True, cert_iters=128, device="cpu")
    a = T.saturation_throughput(tfp, **kw)
    b = T.saturation_throughput(tfp, trace=True, **kw)
    _same(a, b)
    assert a.trace is None and b.trace.final_gap == b.cert.gap
    loads = [0.1, 0.4]
    for kw in (dict(iters=64), dict(certify=True, cert_iters=128)):
        plain = T.latency_curve(tfp, loads, device="cpu", **kw)
        traced = T.latency_curve(tfp, loads, trace=True, device="cpu", **kw)
        for a, b in zip(plain, traced):
            _same(a, b)
            assert b.trace.num_probes == 1
            if "certify" in kw:
                assert b.trace.final_gap == b.cert.gap
        a = T.evaluate_load(tfp, 0.4, device="cpu", **kw)
        b = T.evaluate_load(tfp, 0.4, trace=True, device="cpu", **kw)
        _same(a, b)
    scalar = T.latency_curve(tfp, loads, iters=64, engine="scalar",
                             trace=True, device="cpu")
    assert all(r.trace.kind == "uncertified" for r in scalar)


# ---------------------------------------------------------------------------
# the port's traces against the reference's
# ---------------------------------------------------------------------------

def test_latency_trace_follows_reference():
    fp, tfp = flow_paths(7, "intact", "random_perm", "ugal")
    sat = ref_saturation(7, "intact", "random_perm", "ugal")
    loads = [f * sat for f in (0.25, 0.5, 0.75)]
    ref = R.latency_curve(fp, loads, iters=250, trace=True)
    port = T.latency_curve(tfp, loads, iters=250, trace=True, device="cpu")
    for load, a, b in zip(loads, ref, port):
        ra, rb = a.trace, b.trace
        assert rb.num_samples == ra.num_samples == 250
        np.testing.assert_array_equal(rb.iters, ra.iters)
        np.testing.assert_array_equal(rb.probe, ra.probe)
        np.testing.assert_array_equal(rb.step_size, ra.step_size)
        np.testing.assert_allclose(rb.max_util, ra.max_util, rtol=1e-3)
        total = float(fp.pattern.demand.sum()) * load
        assert np.abs(rb.gap - ra.gap).max() <= 1e-3 * total
        assert rb.brackets.shape == ra.brackets.shape == (0, 4)


@pytest.mark.parametrize("mode", ["ugal", "ugal_pf"])
def test_trace_shapes_match_reference(mode):
    fp, tfp = _pf7_flow_paths(mode)
    kw = dict(tol=0.05, iters=64, trace=True)
    ra = R.saturation_throughput(fp, **kw).trace
    rb = T.saturation_throughput(tfp, device="cpu", **kw).trace
    np.testing.assert_array_equal(rb.probe, ra.probe)
    np.testing.assert_array_equal(rb.iters, ra.iters)
    assert rb.brackets.shape == ra.brackets.shape
    np.testing.assert_array_equal(rb.brackets, ra.brackets)
    kw = dict(tol=0.05, certify=True, cert_iters=128, trace=True)
    ra = R.saturation_throughput(fp, **kw).trace
    rb = T.saturation_throughput(tfp, device="cpu", **kw).trace
    assert (rb.kind, rb.stride, rb.num_probes) == (ra.kind, ra.stride,
                                                   ra.num_probes)
    assert rb.brackets.shape == ra.brackets.shape
    for t in (ra, rb):
        assert t.iters.dtype == np.int64 and t.probe.dtype == np.int64
        assert t.gap.shape == t.util_lb.shape == t.step_size.shape
    ra = R.evaluate_load(fp, 0.3, certify=True, cert_iters=128,
                         trace=True).trace
    rb = T.evaluate_load(tfp, 0.3, certify=True, cert_iters=128,
                         trace=True, device="cpu").trace
    assert rb.brackets.shape == ra.brackets.shape == (0, 4)
    assert rb.num_probes == ra.num_probes == 1


# ---------------------------------------------------------------------------
# the report CLI on the port's recorder
# ---------------------------------------------------------------------------

def test_report_cli_round_trip(tmp_path, capsys):
    """A certified solve's span and its trace's metrics, recorded by the
    port, dumped as JSONL and read back by the port's report (text, JSON,
    Chrome forms); the reference's report reads the same file to the same
    summary."""
    import json

    from repro.obs.report import summarize as r_summarize
    from repro_torch.obs import recording
    from repro_torch.obs.report import load_events, main, summarize

    _, tfp = _pf7_flow_paths("ugal")
    rec = Recorder()
    with recording(rec):
        res = T.evaluate_load(tfp, 0.3, certify=True, cert_iters=64,
                              trace=True, device="cpu")
    res.trace.to_metrics(rec, name="fluid")
    path = tmp_path / "t.trace.jsonl"
    rec.dump(str(path))
    events = load_events(str(path))
    assert len(events) == len(rec.events())
    summ = summarize(events)
    assert summ == r_summarize(events)
    assert summ["spans"]["fluid.evaluate_load"]["count"] == 1
    assert summ["gauges"]["fluid.final_gap"] == res.cert.gap

    assert main([str(path)]) == 0
    assert "fluid.evaluate_load" in capsys.readouterr().out
    assert main([str(path), "--format", "json"]) == 0
    parsed = json.loads(capsys.readouterr().out)
    assert parsed["gauges"]["fluid.probes"] == 1.0
    chrome = tmp_path / "chrome.json"
    assert main([str(path), "--to-chrome", str(chrome)]) == 0
    capsys.readouterr()
    doc = json.loads(chrome.read_text())
    assert doc["traceEvents"][0]["ph"] == "M"
    assert len(doc["traceEvents"]) == len(events) + 1

    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"name": "a", "ph": "X", "ts": 0}\nnot json\n')
    with pytest.raises(ValueError, match="bad.jsonl:2"):
        load_events(str(bad))
