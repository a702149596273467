"""Fig. 15 (bench_fig15_cost.py) on the card through chip_smoke.py's
``sizes`` helpers: fig8's PF(13), SF(9), DF(6, 3) and FT(8, 3) at uniform
and random_perm, every graph, routing, pattern and FlowPaths equal to
tests/fixtures/torch_port_sizes_reference.json's hashes, the saturations
and cost ratios inside the phase's bars, the path-cost launches those of
the solves.  tests/test_torch_sizes.py holds the same runs on the CPU.
No JAX here."""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_port import smoke_module  # noqa: E402


def test_fig15_grid_is_read_from_the_fixture():
    """The card case's grid on the CPU: four topologies, two traffics."""
    smoke = smoke_module()
    with open(smoke.SIZES_FIXTURE) as fh:
        c = json.load(fh)["config"]["fig15"]
    assert list(c["graphs"]) == ["PF", "SF", "DF1", "FT"]
    assert list(c["patterns"].values()) == ["uniform", "random_perm"]


@pytest.mark.cuda
def test_fig15_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the path-cost kernel has no CPU mode")
    smoke = smoke_module()
    with open(smoke.SIZES_FIXTURE) as fh:
        fixture = json.load(fh)
    problems = []
    out, fps = smoke.sizes_fig15(torch, smoke.checker(problems), fixture,
                                 smoke.sizes_factor())
    assert not problems, problems
    assert len(fps) == 6  # PF, SF, DF1 x two traffics, ugal_pf
    assert all(v["ok"] for t in out["ratios"].values() for v in t.values())
