"""Adafactor's update on a mesh (fault F5): the factored update keeps
each tensor the size of a parameter in the parameter's layout
(`train.optimizer._factored_update`; the fake-world trace in
tests/test_torch_mesh_memory.py holds the memory), and its values are
the meshless update's.

Scaled-down qwen2-0.5b (float32, 2 layers: its embedding and FFN leaves
are factored, the rest not), random gradients, and a state one meshless
update old (so the moments are not zero); the update on 4 gloo ranks
(`_torch_dist.run_ranks`, a (2, 2) ("data", "model") mesh, tp2d rules,
parameters, gradients and state placed as the sharded step places them)
against the same update without a mesh: every new parameter and moment
within the sharded step's bars (1e-5 of a moment leaf's largest
magnitude, 2e-5 of a parameter leaf's update's).  The row and column
means and the update's RMS sum over shards in another order than the
meshless sums, so the leaves differ in their last bits; an unfactored
leaf's moment is elementwise and equal bit for bit.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

from _torch_dist import (load_tree, rank_adafactor, run_ranks,  # noqa: E402
                         save_tree)


def test_adafactor_update_on_a_mesh_is_the_meshless_one(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.train.optimizer import Adafactor

    cfg = get_config("qwen2-0.5b").scaled_down(dtype="float32", num_layers=2)
    params = build_model(cfg, device="cpu", seed=0).params.tree()
    params = tree_map(lambda t: t.detach().clone(), params)
    rng = np.random.default_rng(0)

    def grads():
        return tree_map(lambda t: torch.from_numpy(rng.standard_normal(
            t.shape).astype(np.float32) * 0.01), params)

    opt = Adafactor(learning_rate=1e-2)
    _, state, _ = opt.update(grads(), opt.init(params), params)
    g = grads()
    save_tree(os.path.join(tmp_path, "inputs.npz"),
              {"params": params, "grads": g, "opt": state})
    want_p, want_s, _ = opt.update(g, state, params)
    run_ranks(rank_adafactor, 4, tmp_path, (2, 2))
    got = load_tree(os.path.join(tmp_path, "mesh.npz"))

    factored = 0
    for path, w in tree_items(want_p):
        step = float((w - _leaf(params, path)).abs().max())
        assert np.abs(_leaf(got["params"], path) - w.numpy()).max() \
            <= 2e-5 * step, path
        factored += opt._factored(w.shape)
    assert factored >= 3  # the embedding and the FFN's stacked leaves
    for name in ("vr", "vc"):
        for path, w in tree_items(want_s[name]):
            have = _leaf(got[name], path)
            assert np.abs(have - w.numpy()).max() \
                <= 1e-5 * float(w.abs().max()), (name, path)
            if not opt._factored(_leaf(params, path).shape):
                assert np.array_equal(have, w.numpy()), (name, path)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree
