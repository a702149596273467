"""The port's sharding rules (`repro_torch.parallel.sharding`) against the
JAX package's, in-process and exact.

Every config in configs/ at its published widths: the parameter specs,
the decode cache's (B = 4, max_seq 4096) and AdamW's / Adafactor's state
specs equal the reference's element for element, under each rule profile
on the production meshes (16, 16) ("data", "model") and (2, 16, 16)
("pod", "data", "model") and on (4, 2) and (1, 1).  Nothing is allocated
and no device is made: the reference's spec functions read only a mesh's
``axis_names`` and ``devices.shape`` (a duck-typed mesh stands in), the
port's take a `MeshShape`.  A hypothesis test holds `spec_for` itself
against the reference's over shapes, sizes and every logical name, with
`placements` round-tripping each result.  The DTensor guard of the flash
kernels' wrapper: a CPU test on a world of one, and a `cuda` test of the
`local_map` call against the kernel at the qwen2 train layer's shape.
"""
import os
import types

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as ref_config, list_archs  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
from repro.train.optimizer import (AdamW as RefAdamW,  # noqa: E402
                                   Adafactor as RefAdafactor)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     production_mesh_shape)
from repro_torch.models import (griffin, mamba, transformer,  # noqa: E402
                                whisper)
from repro_torch.models.api import model_parts  # noqa: E402
from repro_torch.models.common import param_specs  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train.optimizer import AdamW, Adafactor  # noqa: E402

MESHES = {"prod": (("data", "model"), (16, 16)),
          "multipod": (("pod", "data", "model"), (2, 16, 16)),
          "4x2": (("data", "model"), (4, 2)),
          "1x1": (("data", "model"), (1, 1))}
CACHE_SPECS = {"dense": transformer.cache_specs,
               "moe": transformer.cache_specs, "ssm": mamba.cache_specs,
               "hybrid": griffin.cache_specs, "encdec": whisper.cache_specs}


def ref_mesh(names, sizes):
    """What the reference's spec functions read of a mesh."""
    return types.SimpleNamespace(axis_names=names, devices=np.empty(sizes),
                                 shape=dict(zip(names, sizes)))


def as_tuples(tree):
    """The reference's spec tree with every PartitionSpec as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, JP))


def port_tuples(tree):
    if isinstance(tree, dict):
        return {k: port_tuples(v) for k, v in tree.items()}
    assert isinstance(tree, sharding.PartitionSpec), tree
    return tuple(tree)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("profile", sorted(sharding.PROFILES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_reference(arch, profile, mesh_name):
    names, sizes = MESHES[mesh_name]
    rmesh, pmesh = ref_mesh(names, sizes), sharding.MeshShape(names, sizes)
    rrules = ref_sharding.PROFILES[profile]
    prules = sharding.PROFILES[profile]
    assert prules.rules == rrules.rules
    rmodel = ref_build(ref_config(arch))
    cfg = get_config(arch)
    table = model_parts(cfg)[0](cfg)

    rparams = rmodel.param_pspecs(rmesh, rrules)
    pparams = param_specs(table, pmesh, prules)
    assert port_tuples(pparams) == as_tuples(rparams)

    rcache = rmodel.cache_pspecs(rmesh, 4, 4096, rrules)
    pcache = CACHE_SPECS[cfg.family](cfg, pmesh, 4, 4096, prules)
    assert port_tuples(pcache) == as_tuples(rcache)

    radam = RefAdamW().state_pspecs(rparams)
    padam = AdamW().state_pspecs(pparams)
    assert port_tuples(padam) == as_tuples(radam)
    rada = RefAdafactor().state_pspecs(rparams, rmodel.defs())
    pada = Adafactor().state_pspecs(pparams, table)
    assert port_tuples(pada) == as_tuples(rada)


def test_rule_tables_and_batch_axes():
    """The tables are the reference's, name for name, and so are
    `batch_axes` and `mesh_axis_sizes` on every test mesh."""
    for name in ("DEFAULT_RULES", "FSDP_RULES", "FSDP_EP_RULES"):
        assert getattr(sharding, name).rules \
            == getattr(ref_sharding, name).rules
    assert sorted(sharding.PROFILES) == sorted(ref_sharding.PROFILES)
    for names, sizes in MESHES.values():
        pm, rm = sharding.MeshShape(names, sizes), ref_mesh(names, sizes)
        assert sharding.batch_axes(pm) == ref_sharding.batch_axes(rm)
        assert sharding.mesh_axis_sizes(pm) \
            == ref_sharding.mesh_axis_sizes(rm)


_LOGICAL = sorted(sharding.DEFAULT_RULES.rules) + [None]
_MESH_AXES = [("data", "model"), ("pod", "data", "model"),
              ("pod", "data"), ("model",)]


@settings(max_examples=300, deadline=None)
@given(st.data())
def test_spec_for_matches_reference(data):
    """`spec_for` over 1-4 dims of 1..2048, axis sizes {1, 2, 4, 16},
    every logical name and every profile equals the reference's; its
    placements round-trip, and reversing a multi-axis entry raises."""
    names = data.draw(st.sampled_from(_MESH_AXES))
    sizes = tuple(data.draw(st.sampled_from([1, 2, 4, 16])) for _ in names)
    ndim = data.draw(st.integers(1, 4))
    shape = tuple(data.draw(st.integers(1, 2048)) for _ in range(ndim))
    logical = tuple(data.draw(st.sampled_from(_LOGICAL))
                    for _ in range(ndim))
    profile = data.draw(st.sampled_from(sorted(sharding.PROFILES)))
    pm = sharding.MeshShape(names, sizes)
    got = sharding.spec_for(shape, logical, pm, sharding.PROFILES[profile])
    want = ref_sharding.spec_for(shape, logical, ref_mesh(names, sizes),
                                 ref_sharding.PROFILES[profile])
    assert tuple(got) == tuple(want)
    places = sharding.placements(got, pm)
    assert len(places) == len(names)
    # a mesh axis of size 1 stays replicated, so the round trip gives the
    # spec without the size-1 axes, whose placements are the same
    size = dict(zip(names, sizes))

    def sharded(entry):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        axes = tuple(a for a in axes if size[a] > 1)
        return None if not axes else axes[0] if len(axes) == 1 else axes

    kept = sharding.P(*(sharded(e) for e in got))
    assert sharding.spec_of_placements(places, pm, ndim) == kept
    assert sharding.placements(kept, pm) == places
    multi = [i for i, e in enumerate(got) if isinstance(e, tuple)]
    if multi:
        bad = list(got)
        bad[multi[0]] = tuple(reversed(got[multi[0]]))
        with pytest.raises(ValueError, match="mesh's order"):
            sharding.placements(sharding.P(*bad), pm)


def test_placements_layout():
    """A spec's entries become Shard placements in mesh order; an axis the
    mesh lacks or named twice raises."""
    from torch.distributed.tensor import Replicate, Shard

    pm = sharding.MeshShape(("pod", "data", "model"), (2, 4, 2))
    P = sharding.P
    assert sharding.placements(P(("pod", "data"), None, "model"), pm) \
        == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements(P(None, None), pm) == (Replicate(),) * 3
    for bad in (P("expert"), P("data", "data")):
        with pytest.raises(ValueError, match="not in the mesh"):
            sharding.placements(bad, pm)


def test_placements_leave_size_one_axes_replicated():
    """A mesh dim of size 1 stays Replicate whatever the spec names there
    (DTensor refuses to view away a dim of 1 sharded over it); its one
    shard is the whole dim.  The order and name checks still hold."""
    from torch.distributed.tensor import Replicate, Shard

    P = sharding.P
    pm = sharding.MeshShape(("data", "model"), (1, 4))
    assert sharding.placements(P("data", None, "model"), pm) \
        == (Replicate(), Shard(2))
    assert sharding.placements(P(("data", "model"), None), pm) \
        == (Replicate(), Shard(0))
    assert sharding.placements(P("data", None), sharding.MeshShape(
        ("data", "model"), (1, 1))) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements(P(("model", "data")), pm)
    with pytest.raises(ValueError, match="not in the mesh"):
        sharding.placements(P("data", "data"), pm)


def test_init_stacked_draws_layer_after_layer():
    """`init_stacked`: one layer's table drawn `num_layers` times from one
    generator and stacked (layer i is the i-th draw), with the stacked
    table's shapes and `param_specs`' leading ``layers`` entry."""
    from repro_torch.models import mlp
    from repro_torch.models.common import init_params, init_stacked

    cfg = get_config("qwen3-4b").scaled_down(dtype="float32")
    one = mlp.mlp_defs(cfg)
    got = init_stacked(one, 3, torch.Generator().manual_seed(5),
                       device="cpu")
    gen = torch.Generator().manual_seed(5)
    for i in range(3):
        layer = init_params(one, gen, device="cpu")
        for k, t in layer.items():
            assert got[k].shape == (3,) + tuple(t.shape)
            assert torch.equal(got[k][i], t)


def test_production_mesh_needs_its_world():
    """The production mesh is built only in a world of its size; the
    message names the shape-only mesh to compute its specs on."""
    for multi in (False, True):
        shape = production_mesh_shape(multi_pod=multi)
        assert shape.axis_sizes == ((2, 16, 16) if multi else (16, 16))
        with pytest.raises(ValueError, match="production_mesh_shape"):
            make_production_mesh(multi_pod=multi)


def _world_of_one(tmp_path, backend="gloo"):
    import torch.distributed as dist

    dist.init_process_group(backend, init_method="file://" + os.path.join(
        tmp_path, "store"), rank=0, world_size=1)


def test_dtensor_never_reaches_the_flash_wrapper(tmp_path):
    """A DTensor passed straight to `ops.attention` raises TypeError on
    the CPU too (never the plain version); the model's call on a mesh
    goes through `local_map` and equals the meshless call."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import _attention_on_mesh

    _world_of_one(tmp_path)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 4, 16, 8, generator=g)
        k = torch.randn(2, 2, 16, 8, generator=g)
        v = torch.randn(2, 2, 16, 8, generator=g)
        dts = [DTensor.from_local(t, mesh, [Replicate()] * 2) for t in
               (q, k, v)]
        with pytest.raises(TypeError, match="local_map"):
            ops.attention(*dts)
        with pytest.raises(TypeError, match="local_map"):
            ops._Attention.apply(*dts, True, None, None, None, "simt")
        out = _attention_on_mesh(*dts, None, causal=True, softcap=None,
                                 window=None)
        assert torch.equal(out.to_local(), ops.attention(q, k, v))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_local_map_attention_on_card_bit_for_bit(tmp_path):
    """On a (1, 1) CUDA mesh (NCCL, a world of one) the `local_map` call
    gives the kernel's output and q/k/v gradients bit for bit at the qwen2
    train layer's shape (bf16, B = 4, 14/2 heads of 64, S = 2048), and a
    DTensor passed straight to the wrapper raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the flash kernels have no CPU "
                    "mode)")
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import _attention_on_mesh

    _world_of_one(tmp_path, "nccl")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        g = torch.Generator(device="cuda").manual_seed(3)
        shapes = [(4, 14, 2048, 64), (4, 2, 2048, 64), (4, 2, 2048, 64)]
        qkv = [torch.randn(s, generator=g, device="cuda",
                           dtype=torch.bfloat16) for s in shapes]
        dout = torch.randn(shapes[0], generator=g, device="cuda",
                           dtype=torch.bfloat16)
        plain = [t.clone().requires_grad_(True) for t in qkv]
        out = ops.attention(*plain, causal=True)
        out.backward(dout)
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        rep = [Replicate(), Replicate()]
        dts = [DTensor.from_local(t, mesh, rep) for t in leaves]
        before = dict(ops.LAUNCHES_BY_KERNEL)
        out_m = _attention_on_mesh(*dts, None, causal=True, softcap=None,
                                   window=None)
        out_m.backward(DTensor.from_local(dout, mesh, rep))
        assert ops.LAUNCHES_BY_KERNEL["sm90"] - before["sm90"] == 1
        assert ops.LAUNCHES_BY_KERNEL["bwd_sm90"] - before["bwd_sm90"] == 1
        assert torch.equal(out_m.to_local(), out)
        for a, b in zip(leaves, plain):
            assert torch.equal(a.grad, b.grad)
        with pytest.raises(TypeError, match="local_map"):
            ops.attention(*dts, causal=True)
    finally:
        dist.destroy_process_group()
