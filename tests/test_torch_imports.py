"""The port stands alone: importing every `repro_torch` module (and the
repo's `chip_smoke.py`) loads neither `jax` nor anything of `repro`, and
the card-facing entry points refuse to run without CUDA."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, runpy, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
runpy.run_path('chip_smoke.py', run_name='not_main')
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
missing = sorted(set(%r) - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 93 else 0)
""" % (sorted([
    # the analysis slice: the §IX APSP and §IV-D routing-table entry
    # points, their kernels' wrappers, the structural metrics and the
    # blockwise device backend
    "repro_torch.kernels.minplus.ops",
    "repro_torch.kernels.minplus.ref",
    "repro_torch.kernels.gf_crossprod",
    "repro_torch.kernels.gf_crossprod.ops",
    "repro_torch.kernels.gf_crossprod.ref",
    "repro_torch.core.metrics",
    "repro_torch.core.topologies",
    "repro_torch.core.routing",
    "repro_torch.parallel.blockwise",
    # the model slice: the dense transformer's prefill and serve paths,
    # the flash-attention kernel's wrapper and plain version, the copied
    # configs
    "repro_torch.configs",
    "repro_torch.configs.gemma2_9b",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.models",
    "repro_torch.models.api",
    "repro_torch.models.attention",
    "repro_torch.models.common",
    "repro_torch.models.config",
    "repro_torch.models.convert",
    "repro_torch.models.mlp",
    "repro_torch.models.rope",
    "repro_torch.models.transformer",
    "repro_torch.launch",
    "repro_torch.launch.serve",
    # the packet slice: the flit-level packet engine, the Algorithm 1
    # layout and the §VI expansion
    "repro_torch.simulation.packet",
    "repro_torch.core.layout",
    "repro_torch.core.expansion",
    # the MoE / hybrid slice: the Griffin model and the fabric cost models
    "repro_torch.models.griffin",
    "repro_torch.fabric",
    "repro_torch.fabric.placement",
    "repro_torch.fabric.collectives",
    # the SSM / encoder-decoder slice
    "repro_torch.models.mamba",
    "repro_torch.models.whisper",
    # the training slice: train/ and its CLI
    "repro_torch.train",
    "repro_torch.train.checkpoint",
    "repro_torch.train.compress",
    "repro_torch.train.data",
    "repro_torch.train.elastic",
    "repro_torch.train.losses",
    "repro_torch.train.optimizer",
    "repro_torch.train.train_step",
    "repro_torch.launch.train",
    # the sharding slice: rules and DTensor placements, GPipe, meshes
    "repro_torch.parallel.sharding",
    "repro_torch.parallel.pipeline",
    "repro_torch.launch.mesh",
    # the launch tools: planner, roofline, cost trace, dry run, collective
    # breakdown, memory diagnosis
    "repro_torch.launch.cells",
    "repro_torch.launch.roofline",
    "repro_torch.launch.cost",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.collbreak",
    "repro_torch.launch.memdebug",
    # the last slice: the port's linter (stdlib-only) and its torch shim
    "repro_torch.analysis",
    "repro_torch.analysis.lint",
    "repro_torch.analysis.pragmas",
    "repro_torch.analysis.report",
    "repro_torch.analysis.rules",
    "repro_torch.analysis.rules.base",
    "repro_torch.analysis.rules.compat_shim",
    "repro_torch.analysis.rules.dense_square",
    "repro_torch.analysis.rules.host_sync",
    "repro_torch.analysis.rules.naked_clock",
    "repro_torch.analysis.rules.scatter_add",
    "repro_torch.analysis.rules.sentinel",
    "repro_torch.parallel.compat",
]),)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    return env


def test_port_imports_neither_jax_nor_repro():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO_ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", [
    # the obs package and what imports it first on the card's paths, and
    # every module that imports the torch shim (`parallel/__init__`
    # imports blockwise, which imports obs: an import of the shim at
    # obs's import time was a cycle)
    "repro_torch.obs", "repro_torch.obs.profiler",
    "repro_torch.kernels.minplus.ops", "repro_torch.parallel.compat",
    "repro_torch.launch.cost", "repro_torch.launch.memdebug",
    "repro_torch.launch.dryrun", "repro_torch.models.common",
    "repro_torch.analysis.lint"])
def test_module_imports_first(module):
    """Each imports in a fresh interpreter before anything else of the
    port, as chip_smoke.py's phases import them."""
    proc = subprocess.run([sys.executable, "-c", f"import {module}"],
                          cwd=REPO_ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_cuda():
    """Without a card the smoke script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO_ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_cuda_default_raises_without_cuda():
    from repro_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(dev)


def test_packet_engine_needs_cuda_by_default():
    """`simulate_packets` and `simulate_packets_batch` run on the card
    unless the caller passes ``device="cpu"``: without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.simulation import (build_flow_paths, make_pattern,
                                        make_workload, simulate_packets,
                                        simulate_packets_batch)

    pf = build_polarfly(3)
    rt = build_routing(pf.graph, pf)
    fp = build_flow_paths(rt, make_pattern("uniform", rt, p=2), "min")
    wl = make_workload(fp, 0.3, 20)
    assert wl.num_packets > 0
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_packets(wl)
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_packets_batch([wl, wl])
    assert simulate_packets(wl, device="cpu").num_delivered > 0
