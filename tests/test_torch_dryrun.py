"""The port's dry run (`repro_torch.launch.dryrun`) on a fake world, and
the tools on it (`collbreak`, `memdebug`).

The reference's three cells (tests/test_dryrun.py) run in a subprocess
(a process group lives as long as its process), marked ``slow`` as
there: qwen2-0.5b ``train_4k`` and ``decode_32k`` on the 256-rank pod
and ``train_4k`` on the 512-rank multi-pod mesh, at ``--hbm-gb 80``;
and qwen2-vl-72b's ``decode_32k`` on the pod (its q heads shard over
``model``, its kv heads cannot, and its q bias is sharded).
Each is ``ok``, with the world's ``n_dev``, positive per-device FLOPs, a
traced peak that fits, the reference's plan at the same budget (its
``_BUDGET`` set to 80 GB less its 2.5 GB of headroom) and its
parameter and model-FLOP counts; decode runs `decode_step` on the mesh.

Also, fast: the two sharded-path faults the dry run found, on the pod's
(16, 16) fake world in a subprocess -- the output projection's gradient
at 14 heads on a 16-way ``model`` axis (DTensor sharded the flattened (h, k)
dim and could not split it back: `attention.merge_heads`), and the
cross entropy's logsumexp over vocab-sharded logits (DTensor gathered
every rank's [B, S, V] block, forward and backward: `losses.
_VocabParallelCE`) -- and the CLIs: a failing cell is written with ``ok:
false`` and its traceback and the CLI exits non-zero; without a card or
``--hbm-gb`` it refuses; `collbreak` and `memdebug` print their rows.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_GB = 80.0


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


def _run(module, args, timeout=120):
    return subprocess.run([sys.executable, "-m", module] + args,
                          capture_output=True, text=True, env=_env(),
                          timeout=timeout)


def _reference_plan(arch, shape, mesh_name, monkeypatch):
    from repro.configs import get_config
    from repro.launch import cells as ref
    from repro_torch.launch.mesh import production_mesh_shape

    monkeypatch.setattr(ref, "_BUDGET", HBM_GB * 1e9 - 2.5e9)
    mesh = production_mesh_shape(multi_pod=mesh_name == "multipod")
    stand_in = types.SimpleNamespace(
        axis_names=mesh.axis_names, devices=np.empty(mesh.axis_sizes),
        shape=dict(zip(mesh.axis_names, mesh.axis_sizes)))
    cfg = get_config(arch)
    plan = ref.plan_cell(cfg, shape, stand_in)
    n = ref.active_param_count(cfg)
    sh = ref.SHAPES[shape]
    tokens = sh["batch"] * (sh["seq"] if plan.kind != "decode" else 1)
    flops = (6.0 if plan.kind == "train" else 2.0) * n * tokens
    return dataclasses.asdict(plan), ref._param_count(cfg), n, flops


@pytest.mark.slow
@pytest.mark.parametrize("arch,shape,mesh_name,n_dev", [
    ("qwen2-0.5b", "train_4k", "pod", 256),
    ("qwen2-0.5b", "decode_32k", "pod", 256),
    ("qwen2-0.5b", "train_4k", "multipod", 512),
    # 64 q heads over model = 16 but 8 kv heads whole, a sharded q bias
    ("qwen2-vl-72b", "decode_32k", "pod", 256)])
def test_dryrun_cell(arch, shape, mesh_name, n_dev, tmp_path, monkeypatch):
    r = _run("repro_torch.launch.dryrun",
             ["--out", str(tmp_path), "--hbm-gb", str(HBM_GB), "--arch", arch,
              "--shape", shape, "--mesh", mesh_name])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    res = json.load(open(tmp_path / f"{arch}__{shape}__{mesh_name}.json"))
    assert res["ok"]
    assert res["roofline"]["n_dev"] == n_dev
    assert res["roofline"]["compute_s"] > 0
    assert res["cost"]["dot_flops"] > 0
    assert res["memory"]["fits_hbm"]
    assert 0 < res["memory"]["peak_bytes_per_device"] < HBM_GB * 1e9
    plan, total, active, flops = _reference_plan(arch, shape, mesh_name,
                                                 monkeypatch)
    assert {k: res["plan"][k] for k in res["plan"] if k != "note"} == \
        {k: plan[k] for k in res["plan"] if k != "note"}
    assert res["plan"]["note"] == plan["note"]
    assert (res["params_total"], res["params_active"]) == (total, active)
    assert res["model_flops"] == flops
    if shape == "train_4k":  # remat: the forward kernel twice a layer
        assert res["cost"]["kernel_calls"] == {"sm90": 48, "bwd_sm90": 24}
    else:  # one-token decode: no flash kernel, a sharded cache
        assert res["cost"]["kernel_calls"] == {}
        assert res["cost"]["collective_counts"]


REPAIRS = r'''
import json
import torch
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.memdebug import MemoryTrace
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import model_parts
from repro_torch.models.common import tree_map
from repro_torch.train import AdamW, make_train_step
from repro_torch.train.losses import cross_entropy
from repro_torch.parallel.sharding import constrain, P

fake_world(256)
mesh = make_mesh((16, 16), ("data", "model"))
cfg = get_config("qwen2-0.5b").with_(num_layers=2)
defs, cls = model_parts(cfg)
meta = torch.device("meta")
params = tree_map(lambda d: torch.empty(d.shape, dtype=torch.bfloat16,
                                        device=meta), defs(cfg))
model = cls(cfg, params, mesh=mesh)
opt = AdamW()
p = tree_map(lambda t: t.detach(), model.params.tree())
state = {"params": p, "opt": opt.init(p),
         "step": torch.zeros((), dtype=torch.int32, device=meta)}
b, s = 16, 256
tok = torch.zeros((b, s), dtype=torch.int32, device=meta)
step = make_train_step(model, opt, param_specs=model.param_pspecs(mesh),
                       mesh=mesh)
new, metrics = step(state, {"tokens": tok, "targets": tok})
out = {"step": list(new["params"]["layers"]["attn"]["wo"].shape)}
# the loss over vocab-sharded logits, forward and backward
v = cfg.vocab_size
logits = constrain(torch.empty((b, s, v), device=meta), mesh,
                   P("data", None, "model")).detach().requires_grad_(True)
trace = MemoryTrace(record=True)
trace.track(logits)
with trace:
    loss = cross_entropy(logits, tok)
    loss.backward()
out["largest"] = max(r[0] for r in trace.top(50))
out["local"] = b // 16 * s * (v // 16) * 4
print(json.dumps(out))
'''


def test_sharded_step_repairs_on_a_fake_world():
    r = subprocess.run([sys.executable, "-c", REPAIRS], capture_output=True,
                       text=True, env=_env(), timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["step"] == [2, 14, 64, 896]
    # no buffer larger than a rank's own float32 [B / 16, S, V / 16] block
    assert got["largest"] <= got["local"]


def test_failing_cell_is_written_and_fails(tmp_path):
    r = _run("repro_torch.launch.dryrun",
             ["--out", str(tmp_path), "--hbm-gb", "80", "--arch",
              "qwen2-0.5b", "--shape", "train_4k", "--mesh", "pod",
              "--microbatches", "3"])
    assert r.returncode != 0
    res = json.load(open(tmp_path / "qwen2-0.5b__train_4k__pod.json"))
    assert res["ok"] is False and "divisible" in res["error"]
    assert "Traceback" in res["traceback"]


def test_budget_needs_a_card_or_hbm_gb(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _run("repro_torch.launch.dryrun",
             ["--out", str(tmp_path), "--arch", "qwen2-0.5b", "--shape",
              "decode_32k", "--mesh", "pod"])
    assert r.returncode != 0 and "--hbm-gb" in r.stderr
    assert not os.listdir(tmp_path)


def test_collbreak_and_memdebug_print_rows():
    args = ["--hbm-gb", "80", "--arch", "qwen2-0.5b", "--shape",
            "decode_32k", "--top", "5"]
    r = _run("repro_torch.launch.collbreak", args)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("total wire bytes/device:")
    assert len(lines) == 6 and " GB " in lines[1] and "g16" in lines[1]
    r = _run("repro_torch.launch.memdebug", args)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("peak ") and len(lines) == 6
    # the sharded KV cache: [layers, B / 16, 2 kv heads, 32768 / 16, 64]
    assert any("[24, 8, 2, 2048, 64]" in ln for ln in lines[1:])


def test_memdebug_card_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _run("repro_torch.launch.memdebug",
             ["--arch", "qwen2-0.5b", "--shape", "train_4k", "--card"])
    assert r.returncode != 0 and "CUDA" in r.stderr


@pytest.mark.cuda
def test_memdebug_card_lists_blocks(capsys):
    """memdebug's card mode on a decode_32k step of 2 sequences (about 2
    GB: the card tests before it in one pytest process leave much of the
    card taken): the peak and 5 blocks with their frames.  chip_smoke.py's
    launch phase runs it on a train step of 8 sequences."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch import memdebug

    memdebug.main(["--card", "--arch", "qwen2-0.5b", "--shape",
                   "decode_32k", "--batch", "2", "--top", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("peak ") and len(lines) == 6
    assert all(" GB " in ln for ln in lines[1:])


def test_card_top_blocks_walks_back_to_the_peak():
    """memdebug's card mode reads the live blocks at the peak from a
    ``torch.cuda.memory._snapshot()``: the blocks allocated at its end,
    walked back through the recorded allocs and frees (a synthetic
    snapshot here)."""
    from repro_torch.launch.memdebug import card_top_blocks

    def fr(line):
        return [{"filename": "/x/src/repro_torch/train/losses.py",
                 "line": line, "name": "cross_entropy"}]

    snap = {"segments": [{"blocks": [
        {"address": 0x10, "size": 100, "state": "active_allocated",
         "frames": fr(1)},
        {"address": 0x20, "size": 7, "state": "inactive", "frames": []}]}],
        "device_traces": [[
            {"action": "alloc", "addr": 0x10, "size": 100, "frames": fr(1)},
            {"action": "alloc", "addr": 0x30, "size": 500, "frames": fr(2)},
            {"action": "alloc", "addr": 0x40, "size": 50, "frames": fr(3)},
            {"action": "free_requested", "addr": 0x30, "size": 500,
             "frames": fr(4)},
            {"action": "free_completed", "addr": 0x30, "size": 500,
             "frames": fr(4)},
            {"action": "free_completed", "addr": 0x40, "size": 50,
             "frames": fr(5)}]]}
    peak, rows = card_top_blocks(snap, 2)
    assert peak == 650
    assert [(s, a) for s, a, _ in rows] == [(500, "0x30"), (100, "0x10")]
    assert [w for _, _, w in rows] == ["train/losses.py:2 cross_entropy",
                                       "train/losses.py:1 cross_entropy"]
