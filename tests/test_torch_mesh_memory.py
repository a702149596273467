"""What a sharded train step keeps alive (faults F4, F5, F6), on a fake
world.

One step of a scaled-down cell, traced as `launch.dryrun` traces one
(every parameter a meta DTensor on a fake 16-rank world, a (4, 4)
("data", "model") mesh under the tp2d rules, sequence parallelism on;
`launch.memdebug.MemoryTrace` records every buffer the step makes), in a
subprocess (a process group lives as long as its process).  Held:

  * F4, falcon-mamba: no buffer of the global batch's [B, S, d_inner]
    (DTensor had no strategy for softplus's backward and ran it on the
    whole activation on every rank);
  * F5, qwen2 under Adafactor: no buffer the optimizer makes is larger
    than the largest local shard of a parameter in float32 (its factored
    update left the parameter's layout and gathered each factored leaf);
  * F6, qwen2 under AdamW: no ``select_backward`` buffer of a layer
    stack (a zero-filled stack a layer and leaf), and each ``stack`` of
    the layers' gradients has the local shape of a stacked parameter's
    shard (one stacked gradient, in the parameter's layout).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEP = r'''
import json
import logging
import torch
from repro_torch.configs import get_config
from repro_torch.launch.cost import trace_cost
from repro_torch.launch.dryrun import MetaCache, fake_world
from repro_torch.launch.memdebug import MemoryTrace
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import model_parts
from repro_torch.models.common import tree_items, tree_map
from repro_torch.parallel.sharding import P, PROFILES
from repro_torch.train import AdamW, make_train_step
from repro_torch.train.elastic import reshard_state
from repro_torch.train.optimizer import Adafactor

logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
fake_world(16)
mesh = make_mesh((4, 4), ("data", "model"))
meta = torch.device("meta")
B, S = 8, 256


def step(arch, opt, layers):
    cfg = get_config(arch).scaled_down(num_layers=layers)
    defs, cls = model_parts(cfg)
    params = tree_map(lambda d: torch.empty(d.shape, dtype=torch.bfloat16,
                                            device=meta), defs(cfg))
    model = cls(cfg, params, mesh=mesh, sp=True, rules=PROFILES["tp2d"])
    p = tree_map(lambda t: t.detach(), model.params.tree())
    pspecs = model.param_pspecs(mesh)
    state = {"params": p, "opt": opt.init(p),
             "step": torch.zeros((), dtype=torch.int32, device=meta)}
    state = reshard_state(state, {"params": pspecs,
                                  "opt": opt.state_pspecs(pspecs, p),
                                  "step": P()}, mesh)
    tok = torch.zeros((B, S), dtype=torch.int32, device=meta)
    trace = MemoryTrace(record=True)
    trace.track(state)
    call = make_train_step(model, opt, param_specs=pspecs, mesh=mesh)
    with trace_cost(run=MetaCache(), observe=trace.observe):
        call(state, {"tokens": tok, "targets": tok})
    local = {path: list(t.to_local().shape)
             for path, t in tree_items(state["params"])}
    return cfg, local, [list(r) for r in trace._info.values()]


out = {}
cfg, local, bufs = step("falcon-mamba-7b", AdamW(), 2)
out["mamba"] = {"d_inner": cfg.d_inner, "buffers": bufs}
cfg, local, bufs = step("qwen2-0.5b", Adafactor(), 2)
out["adafactor"] = {"local": [v for v in local.values()], "buffers": bufs}
cfg, local, bufs = step("qwen2-0.5b", AdamW(), 3)
out["adamw"] = {"stacked": [v for k, v in local.items()
                            if k[0] == "layers"], "buffers": bufs}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def traced():
    r = subprocess.run([sys.executable, "-c", STEP], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _shape(desc):
    """dtype[a, b] -> [a, b]."""
    return json.loads(desc[desc.index("["):])


def test_mamba_softplus_backward_stays_sharded(traced):
    e = traced["mamba"]["d_inner"]
    whole = [r for r in traced["mamba"]["buffers"]
             if _shape(r[1]) == [8, 256, e]]
    assert not whole, whole[:5]


def test_adafactor_update_stays_in_the_parameters_layout(traced):
    import numpy as np

    biggest = max(int(np.prod(s)) for s in traced["adafactor"]["local"]) * 4
    made = [r for r in traced["adafactor"]["buffers"]
            if "optimizer.py" in r[3]]
    assert made  # the update's buffers are recorded
    over = [r for r in made if r[0] > biggest]
    assert not over, over[:5]


def test_one_stacked_gradient_in_the_parameters_layout(traced):
    bufs = traced["adamw"]["buffers"]
    layers = traced["adamw"]["stacked"][0][0]
    assert not [r for r in bufs if r[2] == "select_backward"
                and _shape(r[1])[:1] == [layers]]
    stacks = [_shape(r[1]) for r in bufs if r[2] == "stack"
              and "UnbindBackward" in r[3]]
    assert stacks and all(s in traced["adamw"]["stacked"] for s in stacks), \
        (stacks, traced["adamw"]["stacked"])
    assert len(stacks) == len(traced["adamw"]["stacked"])
