"""Certified saturation of the port against the JAX package's, ugal_pf on the
damaged PF(13) graph of tests/test_certified.py (bars and reasons in
`_torch_port.certified_saturation_tests`)."""
import pytest

pytest.importorskip("torch")

from _torch_port import certified_saturation_tests  # noqa: E402

(test_certified_saturation_matches_reference,
 test_certified_saturation_agrees_with_batched) = \
    certified_saturation_tests("ugal_pf", True)
