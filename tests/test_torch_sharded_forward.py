"""Every model family's forward on a mesh equals its forward without one.

The five families (dense qwen3-4b, MoE deepseek-moe-16b, the Griffin
hybrid, the Mamba SSM, the Whisper encoder-decoder), scaled down in
float32, from `build_model`'s seeded parameters (the JAX package's
parameters go through the mesh in tests/test_torch_sharded_train.py and
test_torch_moe_ep.py): on 4 gloo ranks
(`_torch_dist.run_ranks`) on a (2, 2) ("data", "model") mesh with the
sequence-parallel residual stream (every anchor runs: `sp_boundary` and
`sp_constrain`; tests/test_torch_sharded_train.py runs the dense model
without it too), under ``inference_mode``
(lifted to ``no_grad`` on a mesh: `models.common.mesh_forward`; the
train tests run the mesh forward with grad), the logits within 1e-5 of
the port's meshless
forward on the same parameters (the sharded contractions sum in other
orders; the MoE layers run expert parallelism, whose per-shard capacity
matches the meshless one here: the scaled-down capacity factor drops
nothing).  Also: `checkpoint.save` of the mesh model's DTensor
parameters writes the bytes a meshless save writes.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import (load_tree, rank_forward, run_ranks,  # noqa: E402
                         save_tree)

ARCHS = ["qwen3-4b", "deepseek-moe-16b", "recurrentgemma-9b",
         "falcon-mamba-7b", "whisper-base"]
B, S = 4, 16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.configs import get_config

    tmp = tmp_path_factory.mktemp("sharded_forward")
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch).scaled_down(dtype="float32", num_layers=2)
        rng = np.random.default_rng(i)
        tree = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
                .astype(np.int64)}
        if cfg.family == "encdec":
            tree["frames"] = rng.normal(size=(B, cfg.encoder_frames,
                                              cfg.d_model)) \
                .astype(np.float32)
        save_tree(os.path.join(tmp, f"{arch}.npz"), tree)
    run_ranks(rank_forward, 4, tmp, (2, 2), ARCHS)
    return tmp


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_mesh_matches_meshless(runs, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint as ckpt

    inputs = load_tree(os.path.join(runs, f"{arch}.npz"))
    got = load_tree(os.path.join(runs, f"{arch}_out.npz"))
    cfg = get_config(arch).scaled_down(dtype="float32", num_layers=2)
    model = build_model(cfg, device="cpu", seed=ARCHS.index(arch))
    kw = {"frames": torch.from_numpy(inputs["frames"])} \
        if "frames" in inputs else {}
    with torch.inference_mode():
        want = model.forward(torch.from_numpy(inputs["tokens"]), **kw)
    for name, logits in got.items():
        np.testing.assert_allclose(logits, want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{arch} {name}")
    plain = os.path.join(runs, f"plain_{arch}")
    ckpt.save({"params": model.params.tree()}, plain, 0)
    with np.load(os.path.join(runs, f"ckpt_{arch}", "step_0",
                              "arrays.npz")) as a, \
            np.load(os.path.join(plain, "step_0", "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes(), key
