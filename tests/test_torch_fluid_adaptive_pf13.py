"""Adaptive-mode (UGAL, UGAL_PF) parity of the port's fluid solver with the
JAX package's on PF(13), permutation and uniform traffic, intact and
damaged (bars and reasons in `_torch_port.adaptive_parity_tests`)."""
import pytest

pytest.importorskip("torch")

from _torch_port import adaptive_parity_tests  # noqa: E402

GRID = [(13, which, pattern) for which in ("intact", "damaged")
        for pattern in ("random_perm", "uniform")]

(test_adaptive_latency_curve_matches,
 test_adaptive_saturation_matches) = adaptive_parity_tests(GRID)
