"""``remat="2level"`` (the reference's sqrt-checkpointing) in the port:
its split, and the launch tools' remat.

The reference's ``TransformerLM.forward`` scans its groups of
``len(layer_pattern)`` layers two scans deep under ``remat="2level"``:
outer groups of `inner` groups, both levels under ``jax.checkpoint``.
For every dense and MoE config at its own layer count,
`common.two_level_split` equals the two scan lengths of the reference's
traced forward (``jax.make_jaxpr``), and the port's forward nests its
checkpoints so: `outer` outer ones, each around `inner` group ones
(deepseek's ``layer0`` one more, alone).  `launch.dryrun._cell_call`
runs the plan's remat.  The values are held in
test_torch_remat_2level_grads.py, the other families in
test_torch_remat_2level_families.py.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

from _torch_train import Checkpoints  # noqa: E402

TRANSFORMERS = ["qwen2-0.5b", "qwen2-moe-a2.7b", "qwen2-vl-72b", "qwen3-4b",
                "deepseek-moe-16b", "gemma2-9b", "nemotron-4-340b"]


def _scan_lengths(jaxpr, depth=0, out=None):
    """[(nesting depth, length)] of every ``scan`` in a jaxpr."""
    out = [] if out is None else out
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "scan":
            out.append((depth, eqn.params["length"]))
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    _scan_lengths(sub, depth + 1, out)
    return out


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_split_is_the_references(arch, monkeypatch):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as r_get_config
    from repro.models import build_model as r_build_model
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items, two_level_split

    full = r_get_config(arch)
    rcfg = full.scaled_down(dtype="float32", num_layers=full.num_layers)
    rmodel = r_build_model(rcfg, use_pallas=False, remat="2level")
    params = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    jaxpr = jax.make_jaxpr(rmodel.forward)(
        params, jax.ShapeDtypeStruct((1, 8), jnp.int32))
    scans = _scan_lengths(jaxpr.jaxpr)
    assert len(scans) == 2 and scans[0][0] < scans[1][0], scans
    stacked = full.num_layers - (1 if full.first_dense_d_ff else 0)
    groups = stacked // len(full.layer_pattern)
    outer, inner = two_level_split(groups)
    assert (outer, inner) == (scans[0][1], scans[1][1])
    assert {"qwen2-0.5b": (6, 4),
            "nemotron-4-340b": (12, 8)}.get(arch, (outer, inner)) \
        == (outer, inner)

    cfg = get_config(arch)
    cfg = cfg.scaled_down(dtype="float32", num_layers=cfg.num_layers)
    model = build_model(cfg, device="cpu", remat="2level")
    count = Checkpoints(monkeypatch)
    leaves = {"params." + ".".join(path): t.detach().requires_grad_(True)
              for path, t in tree_items(model.params.tree())}
    with torch.enable_grad():  # the forward records: its checkpoints run
        torch.func.functional_call(model, leaves, (
            torch.zeros((1, 8), dtype=torch.long),))
    layer0 = 1 if cfg.first_dense_d_ff else 0
    assert count.calls.count(0) == outer + layer0
    assert count.calls.count(1) == groups


def test_cell_call_runs_the_plans_remat():
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import CellPlan
    from repro_torch.launch.dryrun import _cell_call

    cfg = get_config("qwen2-0.5b").scaled_down(num_layers=4)
    for remat in ("2level", "none", "full"):
        plan = CellPlan(arch=cfg.name, shape="train_4k", kind="train",
                        batch=2, seq=4096, remat=remat)
        call, given, ran = _cell_call(cfg, plan, "train_4k", None,
                                      torch.device("meta"), batch=2)
        assert ran == remat


