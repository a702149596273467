"""The port's certified Frank-Wolfe engine against the JAX package's, fed
identical inputs (`FlowPaths.from_reference`).

What is held, and at which bar:

* The Beckmann helpers (`_queue_delay_prime`, `_w_integral`, `_bregman`,
  `_util_interval`, `_phi_mass_lower_bound`, `_line_search`) against the
  reference's on the same float32 inputs from numpy, links above
  `_RHO_CAP` and a zero gap included.  Both sides run the same float32
  formulas; XLA's `log1p` and PyTorch's differ by an ulp on about one
  input in ten, so `_w_integral` is held at 2 ulp of the log term it is
  computed from (its small-r values are a cancellation) and the bracket
  ends and the step size at 1e-5 relative.  Infinite ends must be
  infinite on both sides.  One exception: where the divergence is flat --
  a link above the cap, whose integrand is linear there, so that
  D(rho, y) is rounding noise for every y above it -- the Bregman upper
  end is wherever the noise first exceeds the gap, in either
  implementation (the reference's docstring: no gap can distinguish
  rho* = 1.001 from rho* = 4 there).  For such links only the side of
  rho and finiteness are held (`test_util_interval_matches_reference`).
* One 32-step chunk of `cert_equilibrate` below saturation on PF(7) and
  PF(13): link loads within 1e-5 of the largest load (a relative 1e-5 on
  the loads that decide the bracket; tiny loads differ more in relative
  terms through summation order) and the gap within 1e-3 * total demand,
  the reference docstring's float32 noise floor.
* Every property tests/test_certified.py proves, on the port: oblivious
  certificates exact, the `decide_at` early exits within the same stride
  bounds, knob validation.  The saturation parity is in
  tests/test_torch_certified_sat_*.py, bound dominance in
  tests/test_torch_certified_bounds.py, the batched solve and the pinned
  near-boundary bracket in tests/test_torch_certified_batch.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import (cert_flow_paths, flow_paths,  # noqa: E402
                         ref_saturation)

import jax.numpy as jnp  # noqa: E402

from repro.simulation import fluid as r_fluid  # noqa: E402

import repro_torch.simulation as T  # noqa: E402
from repro_torch.kernels.minplus import ops  # noqa: E402
from repro_torch.obs import ConvergenceTrace  # noqa: E402
from repro_torch.simulation import fluid as t_fluid  # noqa: E402

CPU = torch.device("cpu")
EPS32 = float(np.finfo(np.float32).eps)
GAPS = [0.0, 1e-4, 1e-2, 1.0, 100.0]


def _loads(seed, n=4000, top=1.2):
    """float32 link loads in [0, top), plus the cap, both sides of it, 0
    and a few small loads."""
    rng = np.random.default_rng(seed)
    extra = [0.0, t_fluid._RHO_CAP, 0.9989, 1.0, 1e-4, 1e-3]
    return np.concatenate([rng.random(n) * top, extra]).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _closure_fn(fn, name):
    """The function `name` that the closure `fn` refers to (the
    reference's `_line_search` lives inside `_fw_pieces`)."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _ref_line_search():
    z = jnp.zeros((1, 1, 1), jnp.int32)
    fw = r_fluid._fw_pieces(z, (jnp.zeros((1, 1), jnp.int32),), "pad",
                            jnp.ones((1, 1), bool), jnp.ones((1, 1), bool),
                            jnp.zeros(1, jnp.int32), 1, "ugal")
    return _closure_fn(fw.cert_equilibrate, "_line_search")


def assert_ends_close(a, b, rel=1e-5):
    a, b = float(a), float(b)
    if np.isinf(a) or np.isinf(b):
        assert a == b, (a, b)
    else:
        assert b == pytest.approx(a, rel=rel, abs=0), (a, b)


# ---------------------------------------------------------------------------
# the Beckmann helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_potential_helpers_match_reference(seed):
    r = _loads(seed)
    y = _loads(seed + 10)
    a = np.asarray(r_fluid._queue_delay_prime(jnp.asarray(r)))
    b = t_fluid._queue_delay_prime(_t(r)).numpy()
    np.testing.assert_array_equal(b, a)
    # W = 0.5 (-log1p(-r) - r): an ulp of log1p is the whole difference
    rc = np.clip(r, 0.0, t_fluid._RHO_CAP)
    ulp = 2 * EPS32 * np.abs(np.log1p(-rc.astype(np.float64)))
    a = np.asarray(r_fluid._w_integral(jnp.asarray(r)))
    b = t_fluid._w_integral(_t(r)).numpy()
    assert b.dtype == np.float32
    assert (np.abs(b - a) <= ulp + 1e-5 * np.abs(a)).all()
    # D(x, y) = W(x) - W(y) - w(y)(x - y): two W's, each an ulp of log1p
    ulp_y = 2 * EPS32 * np.abs(np.log1p(-np.clip(
        y, 0.0, t_fluid._RHO_CAP).astype(np.float64)))
    a = np.asarray(r_fluid._bregman(jnp.asarray(r), jnp.asarray(y)))
    b = t_fluid._bregman(_t(r), _t(y)).numpy()
    assert (np.abs(b - a) <= ulp + ulp_y + 1e-5 * np.abs(a)).all()


@pytest.mark.parametrize("gap", GAPS)
@pytest.mark.parametrize("seed", [0, 1])
def test_util_interval_matches_reference(seed, gap):
    """Below the cap both ends at 1e-5; with links above the cap the lower
    end at 1e-5, the upper end at 1e-5 where it is well defined (gap 0: the
    interval is the point rho; a gap so large that it is +inf) and, in the
    flat region between, on the far side of max(rho) and equally finite."""
    r = _loads(seed)
    g = np.float32(gap)
    for rho, flat in ((r[r < 0.95], False), (r, True)):
        lo_r, up_r = r_fluid._util_interval(jnp.asarray(rho), jnp.asarray(g),
                                            len(rho))
        lo_t, up_t = t_fluid._util_interval(_t(rho), torch.tensor(g),
                                            len(rho))
        assert lo_t.dtype == torch.float32
        assert_ends_close(lo_r, lo_t)
        if flat and 0.0 < gap < 1.0:
            assert float(up_t) >= float(rho.max())
            assert np.isinf(float(up_t)) == np.isinf(float(up_r))
        else:
            assert_ends_close(up_r, up_t)
    z = t_fluid._util_interval(torch.zeros(0), torch.tensor(g), 0)
    assert [float(x) for x in z] == [0.0, 0.0]


@pytest.mark.parametrize("phi_lb,traversals", [
    (1.0, 10.0), (100.0, 10.0), (0.0, 5.0), (1e4, 3.0), (-1.0, 2.0),
    (57.3, 12.5), (3.0e3, 40.0)])
def test_phi_mass_lower_bound_matches_reference(phi_lb, traversals):
    a = r_fluid._phi_mass_lower_bound(jnp.float32(phi_lb),
                                      jnp.float32(traversals))
    b = t_fluid._phi_mass_lower_bound(torch.tensor(phi_lb),
                                      torch.tensor(traversals))
    assert_ends_close(a, b)


def _directions(seed):
    """(rho, drho) pairs: a permutation of the loads (an interior minimum
    of the potential along the segment), above the cap too, and one that
    only sheds load (the derivative at gamma = 1 is negative: gamma = 1)."""
    rng = np.random.default_rng(seed)
    rho = (rng.random(4000) * (1.1 if seed % 2 else 0.9)).astype(np.float32)
    yield rho, (rng.permutation(rho) - rho).astype(np.float32)
    yield rho, (rng.random(4000).astype(np.float32) * 0.5 - rho)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_line_search_matches_reference(seed):
    ref = _ref_line_search()
    for rho, drho in _directions(seed):
        a = float(ref(jnp.asarray(rho), jnp.asarray(drho)))
        b = t_fluid._line_search(_t(rho), _t(drho), 10)
        assert b.dtype == torch.float32 and b.shape == ()
        assert_ends_close(a, b)
    # a batch of loads: each row its own search
    pairs = list(_directions(seed))
    rho = _t(np.stack([p[0] for p in pairs]))
    drho = _t(np.stack([p[1] for p in pairs]))
    batched = t_fluid._line_search(rho, drho, 10)
    for i in range(len(pairs)):
        assert float(batched[i]) == float(
            t_fluid._line_search(rho[i], drho[i], 10))


# ---------------------------------------------------------------------------
# one chunk of cert_equilibrate against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [7, 13])
@pytest.mark.parametrize("mode", ["ugal", "ugal_pf"])
def test_one_stride_matches_reference(q, mode):
    fp, tfp = flow_paths(q, "intact", "random_perm", mode)
    offered = np.float32(0.3 * ref_saturation(q, "intact", "random_perm",
                                              mode))
    eidx, rep, valid, is_min, first_edge, demand, _ = fp.device_arrays()
    rfw = r_fluid._fw_pieces(eidx, rep[1:], rep[0], valid, is_min,
                             first_edge, fp.num_links, mode)
    d = demand * offered
    _, rho_r, gap_r, _, _, it_r, _, _ = rfw.cert_equilibrate(
        rfw.init, d, t_fluid._CERT_STRIDE, 0.0)
    tfw, tdemand, _, _ = t_fluid._pieces(tfp, CPU)
    _, rho_t, gap_t, _, _, it_t, _, _ = tfw.cert_equilibrate(
        tfw.init, tdemand * offered, t_fluid._CERT_STRIDE, 0.0)
    assert int(it_r) == int(it_t) == t_fluid._CERT_STRIDE
    rho_r = np.asarray(rho_r)
    np.testing.assert_allclose(rho_t.numpy(), rho_r, rtol=0,
                               atol=1e-5 * rho_r.max())
    assert abs(float(gap_t) - float(gap_r)) <= 1e-3 * float(d.sum())


# ---------------------------------------------------------------------------
# tests/test_certified.py's properties, on the port
# ---------------------------------------------------------------------------

def test_oblivious_certificate_is_exact():
    _, tfp = cert_flow_paths("min")
    res = T.saturation_throughput(tfp, tol=0.02, certify=True, device="cpu")
    assert isinstance(res, T.CertifiedResult)
    assert res.cert.kind == "exact"
    assert res.cert.gap == 0.0
    assert res.cert.util_err_bound == 0.0
    assert res.cert.converged
    # the oblivious split is its own fixed point: certified == batched
    assert res.value == T.saturation_throughput(tfp, tol=0.02, device="cpu")
    el = T.evaluate_load(tfp, 0.05, certify=True, device="cpu")
    assert el.cert.util_lb == el.cert.util_ub == pytest.approx(
        el.value.max_util, rel=1e-6)
    assert el.cert.iters == 0


def test_decide_at_early_exit_on_clear_probes():
    _, tfp = cert_flow_paths("ugal")
    fw, demand, _, _ = t_fluid._pieces(tfp, CPU)
    # deeply infeasible: the potential-mass bound certifies mu* > 1 in a
    # few strides even though the Bregman bracket never can
    _, _, _, mu_lb, _, it, done, _ = fw.cert_equilibrate(
        fw.init, demand * 0.8, 20000, 0.05, decide_at=1.0)
    assert bool(done)
    assert float(mu_lb) > 1.0
    assert int(it) <= 20 * t_fluid._CERT_STRIDE
    # deeply feasible: the Bregman upper end certifies mu* <= 1 quickly
    _, _, _, _, mu_ub, it2, done2, _ = fw.cert_equilibrate(
        fw.init, demand * 0.05, 20000, 0.05, decide_at=1.0)
    assert bool(done2)
    assert float(mu_ub) <= 1.0
    assert int(it2) <= 40 * t_fluid._CERT_STRIDE


def test_certify_knob_validation():
    _, tfp = cert_flow_paths("ugal")
    with pytest.raises(ValueError, match="dtype"):
        T.evaluate_load(tfp, 0.2, certify=True, dtype="bfloat16",
                        device="cpu")
    with pytest.raises(ValueError, match="return_info"):
        T.saturation_throughput(tfp, certify=True, return_info=True,
                                device="cpu")
    # uncertified calls ignore the knobs, as the reference does
    a = T.evaluate_load(tfp, 0.2, 20, util_tol=0.5, dtype="float64",
                        cert_iters=7, device="cpu")
    b = T.evaluate_load(tfp, 0.2, 20, device="cpu")
    assert a == b


def test_cert_params_defaults():
    assert t_fluid._cert_params("ugal", None, None, 250, None) == (
        "float32", 0.05, 2000, "duality-gap")
    assert t_fluid._cert_params("ugal_pf", None, "float64", 3000, None) == (
        "float64", 0.01, 3000, "gated-residual")
    assert t_fluid._cert_params("min", 0.2, "float32", 250, 64) == (
        "float32", 0.2, 64, "exact")


def test_float64_certifies_in_float64(monkeypatch):
    """No JAX_ENABLE_X64 gate: dtype="float64" runs, records "float64",
    defaults util_tol to 0.01 and computes every path cost in float64
    (the CPU twin of the card's `path_costs_f64`)."""
    _, tfp = cert_flow_paths("ugal")
    seen = []
    real = t_fluid.path_costs

    def spy(delay, eidx):
        seen.append(delay.dtype)
        return real(delay, eidx)

    monkeypatch.setattr(t_fluid, "path_costs", spy)
    res = T.evaluate_load(tfp, 0.2, certify=True, dtype="float64",
                          cert_iters=64, device="cpu")
    assert res.cert.dtype == "float64"
    assert res.cert.util_tol == 0.01
    assert np.isfinite(res.cert.gap)
    # one residual, then 32 steps and a residual per chunk, then metrics
    assert len(seen) == 1 + 33 * (res.cert.iters // 32) + 1
    assert set(seen) == {torch.float64}
    seen.clear()
    T.evaluate_load(tfp, 0.2, certify=True, cert_iters=64, device="cpu")
    assert set(seen) == {torch.float32}


def test_certified_types_are_exported():
    assert T.Certificate.__name__ == "Certificate"
    assert {"gap", "util_lb", "util_ub", "util_err_bound", "kind"} <= set(
        T.Certificate.__dataclass_fields__)
    assert T.CertifiedResult.__dataclass_fields__["trace"].default is None
    assert T.FluidResult.__dataclass_fields__["trace"].default is None
    assert T.SaturationResult.__dataclass_fields__["trace"].default is None
    assert ConvergenceTrace.__name__ == "ConvergenceTrace"


def test_cpu_certified_solves_launch_no_kernel():
    _, tfp = cert_flow_paths("ugal")
    before = ops.LAUNCHES, dict(ops.LAUNCHES_BY_DTYPE)
    T.evaluate_load(tfp, 0.1, certify=True, cert_iters=32, device="cpu")
    assert (ops.LAUNCHES, ops.LAUNCHES_BY_DTYPE) == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _overlap(a, b):
    return max(a.sat_lo, b.sat_lo) <= min(a.sat_hi, b.sat_hi) + 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ugal", "ugal_pf"])
def test_card_certified_matches_cpu(mode):
    """The certified saturation on the card against the same on the CPU
    (values within 0.06, brackets overlapping, the same kind), and a
    float64 `evaluate_load` on both (max_util within 0.06, overlapping
    utilization brackets)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, tfp = cert_flow_paths(mode)
    kw = dict(tol=0.05, certify=True, cert_iters=512)
    cpu = T.saturation_throughput(tfp, device="cpu", **kw)
    card = T.saturation_throughput(tfp, device="cuda", **kw)
    assert abs(card.value - cpu.value) <= 0.06
    assert _overlap(cpu, card)
    assert card.cert.kind == cpu.cert.kind
    kw = dict(certify=True, dtype="float64", cert_iters=256)
    cpu = T.evaluate_load(tfp, 0.2, device="cpu", **kw)
    card = T.evaluate_load(tfp, 0.2, device="cuda", **kw)
    assert abs(card.value.max_util - cpu.value.max_util) <= 0.06
    assert max(cpu.cert.util_lb, card.cert.util_lb) <= min(
        cpu.cert.util_ub, card.cert.util_ub)
    assert card.cert.dtype == "float64"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["min", "ugal", "ugal_pf"])
def test_card_certified_launch_formula(mode):
    """Path-cost launches of the certified engine: a solve launches one
    residual, then 32 steps and one residual per 32-step chunk, then one
    for its metrics (an oblivious one only the metrics'); a saturation
    one residual per probe and 33 a chunk (an oblivious one none).  A
    float64 run launches `path_costs_f64` only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, tfp = cert_flow_paths(mode)
    adaptive = mode != "min"
    for dtype in ("float32", "float64"):
        ops.LAUNCHES = 0
        ops.LAUNCHES_BY_DTYPE.update(float32=0, float64=0)
        res = T.evaluate_load(tfp, 0.2, certify=True, dtype=dtype,
                              cert_iters=128, device="cuda")
        want = 2 + 33 * res.cert.iters // 32 if adaptive else 1
        assert ops.LAUNCHES == want
        assert ops.LAUNCHES_BY_DTYPE == {dtype: want, **{
            d: 0 for d in ("float32", "float64") if d != dtype}}
    ops.LAUNCHES = 0
    res = T.saturation_throughput(tfp, tol=0.05, certify=True,
                                  cert_iters=256, device="cuda")
    probes = int(np.ceil(np.log2(1 / 0.05)))
    assert ops.LAUNCHES == ((probes + 1) + 33 * res.cert.iters // 32
                            if adaptive else 0)
