"""Gradients through the mesh path of the four families the sharded train
tests do not step (tests/test_torch_sharded_train.py holds the dense one
against JAX): deepseek-moe-16b (expert parallelism, whose backward took
each rank's partial gradients as whole ones before this test), the
Griffin hybrid,
the Mamba SSM (its in_proj under ``local_map``) and the Whisper
encoder-decoder (its cross-attention under ``local_map``), scaled down
in float32, on 4 gloo ranks at (2, 2): the loss within 1e-5 and every
gradient leaf within 2e-5 of its largest magnitude of the meshless
model's on the same parameters (the sharded contractions sum in other
orders; the sharded train tests' bars)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import (load_tree, rank_mesh_grads, run_ranks,  # noqa: E402
                         save_tree)

ARCHS = ["deepseek-moe-16b", "recurrentgemma-9b", "falcon-mamba-7b",
         "whisper-base"]
B, S = 4, 16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.configs import get_config

    tmp = tmp_path_factory.mktemp("mesh_grads")
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch).scaled_down(dtype="float32", num_layers=2)
        rng = np.random.default_rng(10 + i)
        tree = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
                for k in ("tokens", "targets")}
        if cfg.family == "encdec":
            tree["frames"] = rng.normal(size=(B, cfg.encoder_frames,
                                              cfg.d_model)) \
                .astype(np.float32)
        save_tree(os.path.join(tmp, f"{arch}.npz"), tree)
    run_ranks(rank_mesh_grads, 4, tmp, (2, 2), ARCHS)
    return tmp


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_gradients_match_meshless(runs, arch):
    got = load_tree(os.path.join(runs, f"{arch}_grads.npz"))
    loss = got["loss"]
    assert abs(loss[1] - loss[0]) <= 1e-5 * abs(loss[0])

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    mesh = dict(leaves(got["mesh"]))
    for path, want in leaves(got["meshless"]):
        if not want.size:  # a stack of no layers (Griffin's empty tail)
            continue
        top = float(np.abs(want).max()) or 1.0
        err = float(np.abs(mesh[path] - want).max())
        assert err <= 2e-5 * top, (arch, "/".join(path), err / top)
