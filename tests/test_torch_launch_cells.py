"""The port's cell planner (`repro_torch.launch.cells`) against the JAX
package's (`repro.launch.cells`).

Every (arch, shape, mesh) of `list_archs()` x `SHAPES` x {pod, multipod}:
`cell_supported` agrees, and where the cell runs, every field of
`plan_cell` at the reference's budget (``hbm_per_chip=16e9,
budget=13.5e9``) equals the reference's, as do `batch_specs`.  The
reference gets a stand-in mesh (``devices.shape``, ``shape``,
``axis_names``), so no 512-device JAX runtime is needed; the port gets
`launch.mesh.production_mesh_shape`.  `params_total` and
`params_active` equal the reference's for all 10 configs, and the
budget is an input: at 80 GB qwen2-0.5b's ``train_4k`` on one device
falls back to one sequence a microbatch, as the reference's logic does
at any budget its 32-microbatch candidates miss.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import cells as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.parallel.sharding import MeshShape  # noqa: E402

MESHES = {"pod": False, "multipod": True}
CASES = [(a, s, m) for a in list_archs() for s in cells.SHAPES
         for m in MESHES]


def _stand_in(mesh: MeshShape):
    return types.SimpleNamespace(
        axis_names=mesh.axis_names, devices=np.empty(mesh.axis_sizes),
        shape=dict(zip(mesh.axis_names, mesh.axis_sizes)))


def test_eighty_cells():
    assert len(CASES) == 80
    assert cells.SHAPES == ref.SHAPES
    assert cells.LONG_CONTEXT_OK == ref.LONG_CONTEXT_OK


@pytest.mark.parametrize("arch,shape,mesh_name", CASES)
def test_plan_equals_reference(arch, shape, mesh_name):
    mesh = production_mesh_shape(multi_pod=MESHES[mesh_name])
    cfg, rcfg = get_config(arch), ref_config(arch)
    ok, why = cells.cell_supported(cfg, shape)
    assert (ok, why) == ref.cell_supported(rcfg, shape)
    if not ok:
        return
    got = cells.plan_cell(cfg, shape, mesh, hbm_per_chip=16e9, budget=13.5e9)
    want = ref.plan_cell(rcfg, shape, _stand_in(mesh))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # the default budget leaves the reference's 2.5 GB of headroom
    assert got == cells.plan_cell(cfg, shape, mesh, hbm_per_chip=16e9)
    sds, specs = cells.batch_specs(cfg, shape, mesh)
    rsds, rspecs = ref.batch_specs(rcfg, shape, _stand_in(mesh))
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v) for k, v in rspecs.items()}
    assert {k: (tuple(s), str(d).split(".")[-1]) for k, (s, d)
            in sds.items()} == {k: (tuple(v.shape), str(v.dtype))
                                for k, v in rsds.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert cells._param_count(cfg) == ref._param_count(rcfg)
    assert cells.active_param_count(cfg) == ref.active_param_count(rcfg)
    for shape in cells.SHAPES:
        assert cells._cache_bytes(cfg, 3, 1000) == \
            ref._cache_bytes(rcfg, 3, 1000)


def test_one_card_train_falls_back_to_max_microbatching():
    """qwen2-0.5b train_4k on one 80 GB device: no candidate of 1..32
    microbatches fits (the reference's cap), so one sequence each."""
    cfg = get_config("qwen2-0.5b")
    plan = cells.plan_cell(cfg, "train_4k", MeshShape(("data", "model"),
                                                      (1, 1)),
                           hbm_per_chip=80e9)
    assert plan.num_microbatches == 256 and plan.seq_parallel
    assert "exceeds budget" in plan.note
    decode = cells.plan_cell(cfg, "decode_32k",
                             MeshShape(("data", "model"), (1, 1)),
                             hbm_per_chip=80e9)
    # 0.99 GB of bf16 parameters and the 51.5 GB bf16 KV cache
    assert abs(decode.est_bytes_per_chip - 52.53e9) < 0.01e9


def test_budget_is_an_input():
    cfg = get_config("qwen2-0.5b")
    mesh = production_mesh_shape()
    small = cells.plan_cell(cfg, "train_4k", mesh, hbm_per_chip=16e9)
    large = cells.plan_cell(cfg, "train_4k", mesh, hbm_per_chip=80e9)
    assert small.seq_parallel and not large.seq_parallel
    assert large.num_microbatches == 1
