"""The port's fluid solver against the JAX package's, fed identical inputs
(`FlowPaths.from_reference`), on PF(7) and PF(13), intact and damaged.

Tolerances, and why:

* Oblivious modes run no Frank-Wolfe step, so only summation order
  separates the two: link loads within 1e-6 relative; saturations equal.
* Adaptive modes (tests/test_torch_fluid_adaptive_pf*.py): latency curves
  within 1e-3 relative (the bar between the JAX package's own engines)
  below saturation at 1000 Frank-Wolfe steps; saturations within 0.05,
  the reference's adaptive tolerance.  XLA on the CPU fuses a*b + c into
  FMAs where PyTorch rounds twice, so the two differ in the last bits, and
  an unconverged adaptive iterate is chaotic in its last bits past
  saturation or on the UGAL_PF gate plateau: there the reference's own
  result moves by more than 1e-3 when its demand moves by one ulp
  (`scripts/reference_sensitivity.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import (TOL, assert_results_close,  # noqa: E402
                         flow_paths, hot_dst_pattern, ref_routing,
                         ref_saturation, to_port)

import repro.simulation as R  # noqa: E402
from repro.core.polarfly import build_polarfly as r_build_polarfly  # noqa: E402
from repro.core.routing import build_routing as r_build_routing  # noqa: E402
from repro.simulation import fluid as r_fluid  # noqa: E402
from repro.simulation import paths as r_paths  # noqa: E402
from repro.simulation import traffic as r_traffic  # noqa: E402

import repro_torch.simulation as T  # noqa: E402
from repro_torch.core.polarfly import build_polarfly as t_build_polarfly  # noqa: E402
from repro_torch.core.routing import build_routing as t_build_routing  # noqa: E402
from repro_torch.kernels.minplus import ops  # noqa: E402
from repro_torch.simulation import fluid as t_fluid  # noqa: E402
from repro_torch.simulation import paths as t_paths  # noqa: E402

CPU = torch.device("cpu")
OBLIVIOUS = ("min", "ecmp", "valiant", "cvaliant")
ADAPTIVE = ("ugal", "ugal_pf")
GRID = [(q, which, pattern) for q in (7, 13)
        for which in ("intact", "damaged")
        for pattern in ("random_perm", "uniform")]


@pytest.mark.parametrize("q,which,pattern", GRID)
@pytest.mark.parametrize("mode", OBLIVIOUS)
def test_oblivious_evaluate_load_matches(q, which, pattern, mode):
    fp, tfp = flow_paths(q, which, pattern, mode)
    _, rho_r, _ = r_fluid._run(fp, 0.3, 250)
    _, rho_t, _ = t_fluid._solve(tfp, 0.3, 250, CPU)
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_r), rtol=1e-6,
                               atol=0)
    a = R.evaluate_load(fp, 0.3)
    b = T.evaluate_load(tfp, 0.3, device="cpu")
    assert_results_close(a, b, 1e-5)


@pytest.mark.parametrize("q,which,pattern", GRID)
@pytest.mark.parametrize("mode", OBLIVIOUS)
def test_oblivious_saturation_matches(q, which, pattern, mode):
    _, tfp = flow_paths(q, which, pattern, mode)
    sat = T.saturation_throughput(tfp, tol=TOL, iters=250, device="cpu")
    assert sat == ref_saturation(q, which, pattern, mode)


@pytest.mark.parametrize("mode", OBLIVIOUS + ADAPTIVE)
def test_port_engines_agree(mode):
    """The port's scalar reference engine against its batched engine, at
    the bars tests/test_simulation.py sets between the JAX package's:
    oblivious saturations within tol; adaptive ones within 0.05 once
    converged (iters = 3000)."""
    _, tfp = flow_paths(7, "intact", "random_perm", mode)
    sat = ref_saturation(7, "intact", "random_perm", mode)
    loads = [0.3 * sat, 0.7 * sat]
    batched = T.latency_curve(tfp, loads, device="cpu")
    scalar = T.latency_curve(tfp, loads, engine="scalar", device="cpu")
    for a, b in zip(scalar, batched):
        assert_results_close(a, b, 1e-3)
    tol, iters = (TOL, 250) if mode in OBLIVIOUS else (0.05, 3000)
    sats = [T.saturation_throughput(tfp, tol=tol, iters=iters, engine=e,
                                    device="cpu")
            for e in ("scalar", "batched")]
    assert abs(sats[0] - sats[1]) <= tol + 1e-6


@pytest.mark.parametrize("mode", ADAPTIVE)
def test_fw_pieces_match_reference(mode):
    """One Frank-Wolfe step's pieces on an identical split: loads, path
    costs, best-response target (with the UGAL_PF gate) and duality gap."""
    fp, tfp = flow_paths(7, "intact", "uniform", mode)
    eidx, rep, valid, is_min, first_edge, demand, _ = fp.device_arrays()
    rfw = r_fluid._fw_pieces(eidx, rep[1:], rep[0], valid, is_min,
                             first_edge, fp.num_links, mode)
    split, _, _ = r_fluid._run(fp, 0.9, 40)
    d = demand * 0.9
    rho_r = rfw.loads(split, d)
    cost_r = rfw.cost_of(rho_r)
    target_r = rfw.fw_target(split, rho_r)
    gap_r = float(rfw.gap_of(split, target_r, cost_r, d))

    tfw, tdemand, _, _ = t_fluid._pieces(tfp, CPU)
    tsplit, td = torch.from_numpy(np.array(split)), tdemand * 0.9
    rho_t = tfw.loads(tsplit, td)
    cost_t = tfw.cost_of(rho_t)
    target_t = tfw.fw_target(tsplit, rho_t)
    gap_t = float(tfw.gap_of(tsplit, target_t, cost_t, td))
    # loads differ in the last bits (summation order); the M/D/1 delay
    # amplifies a relative error in rho by up to 1 / (1 - _RHO_CAP) = 1000
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_r), rtol=1e-6)
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_r), rtol=1e-3)
    # the UGAL_PF gate's slope in rho reaches ~1e3 near the delay cap
    np.testing.assert_allclose(target_t.numpy(), np.asarray(target_r),
                               atol=1e-3)
    assert gap_t == pytest.approx(gap_r, rel=1e-3)


@pytest.mark.parametrize("mode", ("min",) + ADAPTIVE)
def test_truncation_error_matches(mode):
    """At half the saturation load, below the chaotic regime."""
    fp, tfp = flow_paths(7, "intact", "uniform", mode)
    offered = 0.5 * ref_saturation(7, "intact", "uniform", mode)
    r = R.truncation_error(fp, offered, iters=250)
    t = T.truncation_error(tfp, offered, iters=250, device="cpu")
    if mode == "min":
        assert r == t == 0.0
    else:
        assert t == pytest.approx(r, rel=1e-3, abs=1e-6)
    info = T.saturation_throughput(tfp, tol=0.05, return_info=True,
                                   device="cpu")
    assert isinstance(info, t_fluid.SaturationResult)
    assert info.truncation_err >= 0.0


def test_scatter_fallback_matches_pad(monkeypatch):
    """The ("scatter",) link-load path (`index_add_`) agrees with the pad
    gather and with the reference's scatter path."""
    rt = ref_routing(7, "intact")
    pat = hot_dst_pattern(r_traffic, rt.graph.n)
    fp = r_paths.build_flow_paths(rt, pat, "ugal", k_candidates=6, seed=5)
    pad = T.evaluate_load(to_port(fp), 0.5, iters=60, device="cpu")
    monkeypatch.setattr(r_paths, "_INC_PAD_MAX_ENTRIES", 0)
    monkeypatch.setattr(t_paths, "_INC_PAD_MAX_ENTRIES", 0)
    tfp = to_port(fp)
    assert tfp.device_arrays(CPU)[1] == ("scatter",)
    sc = T.evaluate_load(tfp, 0.5, iters=60, device="cpu")
    assert_results_close(pad, sc, 1e-5)
    assert_results_close(R.evaluate_load(fp, 0.5, iters=60), sc, 1e-5)


def test_slice_end_to_end_in_port():
    """The §VIII path built entirely in the port -- graph, routing,
    traffic, paths, saturation -- against the same chain in the JAX
    package; and the paper's Fig. 8 sanity bound."""
    pf = t_build_polarfly(13)
    rt = t_build_routing(pf.graph, pf)
    pat = T.make_pattern("random_perm", rt, p=7, seed=0)
    rpf = r_build_polarfly(13)
    rrt = r_build_routing(rpf.graph, rpf)
    rpat = R.make_pattern("random_perm", rrt, p=7, seed=0)
    sats = {}
    for mode in ("min",) + ADAPTIVE:
        fp = T.build_flow_paths(rt, pat, mode, k_candidates=10)
        sats[mode] = T.saturation_throughput(fp, tol=TOL, iters=250,
                                             device="cpu")
        rfp = R.build_flow_paths(rrt, rpat, mode, k_candidates=10)
        ref = R.saturation_throughput(rfp, tol=TOL, iters=250)
        assert abs(sats[mode] - ref) <= (TOL if mode == "min" else 0.05)
    assert sats["ugal"] > 3.5 * sats["min"]


def test_cpu_solves_launch_no_kernel():
    _, tfp = flow_paths(7, "intact", "random_perm", "ugal")
    before = ops.LAUNCHES
    T.evaluate_load(tfp, 0.1, iters=5, device="cpu")
    assert ops.LAUNCHES == before


def test_not_ported_options_raise():
    _, tfp = flow_paths(7, "intact", "random_perm", "ugal")
    for fn, args in ((T.evaluate_load, (0.1,)),
                     (T.saturation_throughput, ()),
                     (T.latency_curve, ([0.1],))):
        with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
            fn(tfp, *args, certify=True, device="cpu")
        with pytest.raises(NotImplementedError, match="Queue 1, item 5"):
            fn(tfp, *args, trace=True, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        T.saturation_throughput(tfp, engine="turbo", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        T.latency_curve(tfp, [0.5], engine="turbo", device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("min",) + ADAPTIVE)
def test_card_matches_cpu_and_counts_launches(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, tfp = flow_paths(7, "intact", "uniform", mode)
    before = ops.LAUNCHES
    gpu = T.evaluate_load(tfp, 0.4, iters=100, device="cuda")
    adaptive = mode in ADAPTIVE
    # one launch per Frank-Wolfe step, plus the final cost evaluation
    assert ops.LAUNCHES - before == (101 if adaptive else 1)
    assert_results_close(T.evaluate_load(tfp, 0.4, iters=100, device="cpu"), gpu, 1e-5)
    before = ops.LAUNCHES
    T.saturation_throughput(tfp, tol=TOL, iters=200, device="cuda")
    sched = t_fluid._probe_schedule(200, 7)
    assert ops.LAUNCHES - before == ((200 + sum(sched)) if adaptive else 0)
