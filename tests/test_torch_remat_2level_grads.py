"""``remat="2level"``'s values, and the dry run's ``--remat 2level``.

A scaled-down qwen2 (dense, 6 layers: 3 outer groups of 2) and
deepseek-moe (MoE with ``layer0``, 4 stacked layers: 2 x 2) under the
port's "2level" against the JAX model's "2level" on the same parameters
(`_torch_train.grads_match_reference`: loss 1e-5, every gradient leaf
2e-5 of its largest magnitude), and bit for bit the port's "full" on
the same parameters and batch, and on the port's own init.  Then the dry
run's ``--remat 2level`` on qwen2-0.5b's ``train_4k`` pod cell (a fake
256-rank world): the plan's remat is what ran, with 66 sm90 forward
launches (each of the 24 layers' forward, again in its outer group's
recompute -- which stops at the group's last input, so 3 of each 4
groups run there -- and again in its own) and 24 backward ones; and
memdebug's ``--remat``.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

from _torch_train import (FAMILIES, data_config,  # noqa: E402
                          grads_match_reference)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_bits(a, b):
    from repro_torch.models.common import tree_items

    for (path, x), (_, y) in zip(tree_items(a), tree_items(b)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), path


@pytest.mark.parametrize("family,over", [("dense", {"num_layers": 6}),
                                         ("moe_layer0", {"num_layers": 5})])
def test_two_level_matches_reference_and_full(family, over):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.api import model_parts
    from repro_torch.train import DataConfig, SyntheticPipeline
    from repro_torch.train.train_step import value_and_grad

    loss2, grads2, port, batch = grads_match_reference(
        family, remat="2level", ref_remat="2level", overrides=over)
    assert port.remat == "2level"
    full = model_parts(port.cfg)[1](port.cfg, port.params.tree(),
                                    remat="full")
    loss, grads = value_and_grad(full, full.params.tree(), batch)
    assert torch.equal(loss2, loss)
    _same_bits(grads2, grads)

    # the port's own init, another batch
    arch, fam_over = FAMILIES[family]
    cfg = get_config(arch).scaled_down(dtype="float32", **fam_over, **over)
    batch = SyntheticPipeline(DataConfig(**data_config(cfg)),
                              device="cpu").batch_at(1)
    out = {}
    for remat in ("full", "2level"):
        model = build_model(cfg, device="cpu", seed=3, remat=remat)
        out[remat] = value_and_grad(model, model.params.tree(), batch)
    assert torch.equal(out["full"][0], out["2level"][0])
    _same_bits(out["full"][1], out["2level"][1])


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


def test_dryrun_remat_2level(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(tmp_path), "--hbm-gb", "80", "--arch", "qwen2-0.5b", "--shape",
         "train_4k", "--mesh", "pod", "--remat", "2level"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    res = json.load(open(tmp_path / "qwen2-0.5b__train_4k__pod.json"))
    assert res["ok"] and res["plan"]["remat"] == "2level"
    assert res["remat_run"] == res["plan"]["remat"]
    assert res["cost"]["kernel_calls"] == {"sm90": 66, "bwd_sm90": 24}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.memdebug", "--hbm-gb",
         "80", "--arch", "qwen2-0.5b", "--shape", "decode_32k", "--top", "3",
         "--remat", "2level"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("peak ")
