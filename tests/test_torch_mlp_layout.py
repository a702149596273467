"""The tp2d MLP gathers its weight shards, not its activation (fault F8).

Under the tp2d profile (`parallel.sharding.DEFAULT_RULES`) an FFN weight
is sharded ("data" on ``embed``, "model" on ``ff``) and the activation
batches over "data".  GSPMD gathers the weight shard over "data" before
each product; DTensor's own matmul strategy gathered the [B, S, d]
activation instead.  `models.mlp.mlp_apply` lays each weight out first.

On a fake (2, 2) world (torch's ``fake`` process group, meta tensors) a
SwiGLU MLP at small widths runs forward and backward under
`launch.cost.trace_cost(collectives=True)`: the forward's all-gathers are
the three weight shards' over "data" (result [d, f / 2] for ``wg`` and
``wu``, [f / 2, d] for ``wd``), none of them the activation's, and the
backward reduce-scatters each weight's gradient back to its parameter's
layout.  In a subprocess: a process group lives as long as its process.
The MoE shared expert goes through the same function.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# B, S, d, f: at these widths DTensor's own strategy gathers the flattened
# [B * S, d] activation over "data" (as at nemotron-4-340b's train cell)
SHAPE = (8, 16, 512, 2048)

PROBE = r'''
import json, sys
import torch, torch.distributed as dist
from repro_torch.parallel.compat import fake_store
dist.init_process_group("fake", store=fake_store(), rank=0, world_size=4)
from repro_torch.configs import get_config
from repro_torch.launch.cost import trace_cost
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import param_specs, tree_map
from repro_torch.models.mlp import mlp_apply, mlp_defs, moe_apply, moe_defs
from repro_torch.parallel.sharding import P, constrain

b, s, d, f = map(int, sys.argv[2:6])
mesh = make_mesh((2, 2), ("data", "model"))
which = sys.argv[1]
if which == "mlp":
    cfg = get_config("qwen2-0.5b").with_(d_model=d, d_ff=f)
    defs = mlp_defs(cfg)
else:  # deepseek's shared expert beside 4 routed ones of width 32
    cfg = get_config("deepseek-moe-16b").with_(
        d_model=d, d_ff=32, shared_d_ff=f, num_experts=4,
        num_experts_padded=4, top_k=2)
    defs = moe_defs(cfg)
specs = param_specs(defs, mesh)
def leaf(shape, spec):
    t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    return constrain(t, mesh, spec).detach().requires_grad_()

params = tree_map(lambda dd, sp: leaf(dd.shape, sp), defs, specs)
x = leaf((b, s, d), P("data", None, None))
with trace_cost(collectives=True) as mode:
    if which == "mlp":
        y = mlp_apply(params, x, cfg)
    else:
        y = moe_apply(params, x, cfg, mesh=mesh)
    y.sum().backward()
print(json.dumps({"rows": mode.rows, "shape": list(y.shape),
                  "placements": {k: [str(p) for p in v.placements]
                                 for k, v in (params["shared"]
                                              if which != "mlp" else params
                                              ).items()}}))
'''


def _probe(which):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", PROBE, which, *map(str, SHAPE)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("which", ["mlp", "moe_shared"])
def test_tp2d_mlp_gathers_weight_shards_not_activation(which):
    b, s, d, f = SHAPE
    got = _probe(which)
    assert got["shape"] == [b, s, d]
    # the parameters as tp2d places them: embed over data, ff over model
    assert got["placements"]["wu"] == ["S(0)", "S(1)"]
    assert got["placements"]["wd"] == ["S(1)", "S(0)"]
    rows = got["rows"]
    # no gather of the activation, flattened or not
    for act in ([b, s, d], [b * s, d]):
        assert not any(r[0] == "all-gather" and r[1] == f"bfloat16{act}"
                       for r in rows), rows
    # the forward gathers the three weight shards over "data" (groups of
    # 2; all_gather_into_tensor stacks the shards on dim 0, so wd's
    # [f / 2, d / 2] shards gather to [f, d / 2] before they are laid side
    # by side), and nothing else in the MLP (`moe_apply` lays out its
    # routed experts' weights and its input itself)
    fwd = [r for r in rows if r[4].startswith("fwd:models/mlp.py")
           and r[4].endswith((" _ff_weight", " mlp_apply"))]
    assert sorted((r[0], r[1], r[2]) for r in fwd) == sorted([
        ("all-gather", f"bfloat16[{d}, {f // 2}]", 2),
        ("all-gather", f"bfloat16[{d}, {f // 2}]", 2),
        ("all-gather", f"bfloat16[{f}, {d // 2}]", 2)]), rows
    assert all(r[4].endswith(" _ff_weight") for r in fwd)
    # the backward lays each weight's gradient out as its parameter: one
    # reduce-scatter over "data" a weight, to the local shard (the
    # router's and the routed experts' have other shapes)
    shard = (f"bfloat16[{d // 2}, {f // 2}]", f"bfloat16[{f // 2}, {d // 2}]")
    scatters = sorted(r[1] for r in rows if r[0] == "reduce-scatter"
                      and r[4] == "bwd:RedistributeBackward"
                      and r[1] in shard)
    assert scatters == sorted([shard[0]] * 2 + [shard[1]]), rows
