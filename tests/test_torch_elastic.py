"""Elastic scaling in the port: checkpoint on one mesh, restore and
reshard onto another -- tests/test_elastic.py on torch DeviceMesh.

qwen3-4b ``scaled_down(dtype="float32", num_layers=2)``, AdamW(1e-3,
weight_decay 0), the markov pipeline (batch 8, S = 16): on 8 gloo ranks
(`_torch_dist.run_ranks`) a (4, 2) ("data", "model") mesh, the state
placed by `train.elastic.reshard_state`, 3 steps and `checkpoint.save`
(every rank gathers, rank 0 writes; `make_mesh(devices=)` over the first
4 ranks is checked there too), and the live state moved by
`reshard_state` onto a (2, 4) mesh of the same ranks (gathered off the
first; qwen3's 2 kv heads do not divide 4, so attention's heads fall
back to replicated) takes step 4; then "the cluster shrinks": 4 ranks
on a (2, 2) mesh restore the checkpoint with ``shardings`` and take step
4; and the same checkpoint restored without a mesh in this process takes
step 4 too.  The three step-4 losses agree within the reference test's
1e-4.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import (load_tree, rank_elastic_restore,  # noqa: E402
                         rank_elastic_save, run_ranks)


def test_elastic_reshard_across_meshes(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import AdamW, init_state, make_train_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import DataConfig, SyntheticPipeline

    run_ranks(rank_elastic_save, 8, tmp_path, (4, 2), (2, 4))
    out_a = load_tree(os.path.join(tmp_path, "elastic_a.npz"))
    loss_a, loss_regrid = float(out_a["loss"]), float(out_a["loss_regrid"])
    run_ranks(rank_elastic_restore, 4, tmp_path, (2, 2))
    loss_b = float(load_tree(os.path.join(tmp_path, "elastic_b.npz"))["loss"])

    cfg = get_config("qwen3-4b").scaled_down(dtype="float32", num_layers=2)
    model = build_model(cfg, device="cpu", seed=0, remat="none")
    opt = AdamW(learning_rate=1e-3, weight_decay=0.0)
    state = ckpt.restore(init_state(model, opt), os.path.join(
        tmp_path, "ckpt"), 3)
    pipe = SyntheticPipeline(DataConfig(global_batch=8, seq_len=16,
                                        vocab_size=cfg.vocab_size,
                                        kind="markov"), device="cpu")
    _, m = make_train_step(model, opt)(state, pipe.batch_at(3))
    loss_c = float(m["loss"])
    assert np.isfinite([loss_a, loss_b, loss_c]).all()
    assert abs(loss_b - loss_c) < 1e-4, (loss_b, loss_c)
    assert abs(loss_regrid - loss_c) < 1e-4, (loss_regrid, loss_c)
