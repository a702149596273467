"""examples/topology_explorer_torch.py (the port's, `--device cpu`) against
examples/topology_explorer.py (the JAX package's), both in smoke mode
(BENCH_SMOKE=1: PF(7) and DF(4, 2)): the same rows, N, radix, min
saturations under uniform and adversarial traffic, bisection and the
diameter at 20 % failed links equal; the adaptive (UGAL) saturation within
0.05, the reference's adaptive bar (tests/test_torch_fluid.py)."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = ("n", "radix", "unif_min", "adv_min", "adv_ugal", "fw_err",
           "bisect", "diam_20")


def _table(script, *args):
    env = dict(os.environ, BENCH_SMOKE="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                     script), *args],
                       capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].split()[0] == "topology"
    return {name: dict(zip(COLUMNS, map(float, rest)))
            for name, *rest in (line.split() for line in lines[1:])}


@pytest.fixture(scope="module")
def tables():
    return (_table("topology_explorer.py"),
            _table("topology_explorer_torch.py", "--device", "cpu"))


def test_port_example_rows_are_the_reference_examples(tables):
    ref, port = tables
    assert list(port) == list(ref) == ["PolarFly(7)", "Dragonfly(4,2)"]


@pytest.mark.parametrize("column", ["n", "radix", "unif_min", "adv_min",
                                    "bisect", "diam_20"])
def test_port_example_exact_columns_equal(tables, column):
    ref, port = tables
    for name in ref:
        assert port[name][column] == ref[name][column], name


def test_port_example_ugal_within_the_adaptive_bar(tables):
    ref, port = tables
    for name in ref:
        assert 0.0 < port[name]["adv_ugal"] <= 1.0
        assert abs(port[name]["adv_ugal"] - ref[name]["adv_ugal"]) <= 0.05, \
            name


def test_port_example_defaults_to_the_card():
    """Without a card the default device raises: the example never falls
    back to the CPU unasked."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    env = dict(os.environ, BENCH_SMOKE="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(
        ROOT, "examples", "topology_explorer_torch.py")],
        capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
