"""Bound dominance of the port's certificate against the JAX package's
long-budget equilibrium (tests/test_certified.py's load-bearing property).

`mu_star` is the reference's own max utilization at load 0.2 on PF(13)
`ugal` after a 65,536-step certified run (the call tests/test_certified.py
makes), computed once per module; the port never runs that long on the
CPU.  At 4,096 steps the port's bracket must contain it (to 1e-6), its
distance to the port's max_util must be within the two certificates' error
bounds, its iteration count must be the reference's, and its bracket must
overlap the reference's 4,096-step bracket.  In float64 the port's bracket
at the default budget must contain it too.
"""
import functools

import pytest

pytest.importorskip("torch")

from _torch_port import cert_flow_paths  # noqa: E402

import repro.simulation as R  # noqa: E402
import repro_torch.simulation as T  # noqa: E402

LOAD = 0.2


@functools.lru_cache(maxsize=None)
def _reference(cert_iters):
    fp, _ = cert_flow_paths("ugal")
    return R.evaluate_load(fp, LOAD, certify=True, util_tol=1e-6,
                           cert_iters=cert_iters)


def _mu_star():
    ref = _reference(65536)
    assert ref.cert.util_lb - 1e-6 <= ref.value.max_util \
        <= ref.cert.util_ub + 1e-6
    return ref.value.max_util, ref.cert.util_err_bound


def test_certificate_bound_dominates_true_distance():
    mu_star, ref_bound = _mu_star()
    _, tfp = cert_flow_paths("ugal")
    short = T.evaluate_load(tfp, LOAD, certify=True, util_tol=1e-6,
                            cert_iters=4096, device="cpu")
    assert short.cert.util_lb - 1e-6 <= mu_star <= short.cert.util_ub + 1e-6
    true_err = abs(short.value.max_util - mu_star)
    assert true_err <= short.cert.util_err_bound + ref_bound
    assert ref_bound <= short.cert.util_err_bound + 1e-6
    ref_short = _reference(4096)
    assert short.cert.iters == ref_short.cert.iters == 4096
    assert max(short.cert.util_lb, ref_short.cert.util_lb) <= min(
        short.cert.util_ub, ref_short.cert.util_ub)


def test_float64_bracket_contains_mu_star():
    mu_star, _ = _mu_star()
    _, tfp = cert_flow_paths("ugal")
    res = T.evaluate_load(tfp, LOAD, certify=True, dtype="float64",
                          device="cpu")
    assert res.cert.dtype == "float64" and res.cert.util_tol == 0.01
    assert res.cert.util_lb - 1e-6 <= mu_star <= res.cert.util_ub + 1e-6
    assert res.cert.util_lb - 1e-6 <= res.value.max_util \
        <= res.cert.util_ub + 1e-6
