"""The port's sharded train step (`make_train_step(..., param_specs=,
mesh=)` on DTensor state) against the JAX package's meshless step.

qwen3-4b ``scaled_down(dtype="float32", num_layers=2)``, the reference's
elastic-test config, from the reference's own parameters and one numpy
batch: one JAX step on the CPU without a mesh, and one port step on 4
gloo ranks (`_torch_dist.run_ranks`) on a (2, 2) ("data", "model") mesh,
its state placed by `train.elastic.reshard_state` (every leaf a
DTensor), under `DEFAULT_RULES`, with the sequence-parallel residual
stream (``sp=True``), under `FSDP_RULES`, and with 2 microbatches
(against the reference's microbatched step: the accumulation carry laid
out as the parameters).  The sharded sums (the
one-hot embedding and its gradient, the all-reduces of partial products,
the grad norm over shards) run in other orders than XLA's.  Held: the
loss within 1e-5, every gradient leaf within 2e-5 of its largest
magnitude (tests/test_torch_train_grads.py's bar), and every updated
parameter within 2e-5 where its gradient is at least 100 eps = 1e-6.
AdamW's first step moves a parameter by lr g / (|g| + eps): where |g| is
near eps = 1e-8 that ratio turns float32 rounding of g into a visible
move (the port's own meshless step differs from the JAX step by 3.2e-5
at an element of ffn/wg whose gradient is -9.7e-9 there and -7.4e-9 here,
the leaf's largest 0.043), so there the parameter is held to the step's
bound, lr.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.train import AdamW as RAdamW  # noqa: E402
from repro.train import init_state as r_init_state  # noqa: E402
from repro.train import make_train_step as r_make_train_step  # noqa: E402
from repro.train.losses import model_loss as r_model_loss  # noqa: E402

from _torch_dist import (load_tree, rank_train_step, run_ranks,  # noqa: E402
                         save_tree)

# (name, sp, rule profile, microbatches)
VARIANTS = [("tp2d", False, "tp2d", 1), ("tp2d_sp", True, "tp2d", 1),
            ("fsdp", False, "fsdp", 1), ("tp2d_mb2", False, "tp2d", 2)]
B, S = 4, 16
LR = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    cfg = r_get_config("qwen3-4b").scaled_down(dtype="float32",
                                               num_layers=2)
    model = r_build_model(cfg, remat="none")
    opt = RAdamW(learning_rate=LR, weight_decay=0.0)
    state = r_init_state(model, opt, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    jbatch = jax.tree.map(jnp.asarray, batch)
    steps = {n: jax.jit(r_make_train_step(model, opt, num_microbatches=n))(
        state, jbatch) for n in (1, 2)}
    grads = jax.grad(lambda p: r_model_loss(model, p, jbatch))(
        state["params"])
    save_tree(os.path.join(tmp, "inputs.npz"),
              {"params": jax.tree.map(np.asarray, state["params"]),
               "batch": batch})
    run_ranks(rank_train_step, 4, tmp, (2, 2), VARIANTS)
    ref = {n: {"params": jax.tree.map(np.asarray, new["params"]),
               "grads": jax.tree.map(np.asarray, grads),
               "loss": float(m["loss"])} for n, (new, m) in steps.items()}
    return ref, {name: load_tree(os.path.join(tmp, f"{name}.npz"))
                 for name, *_ in VARIANTS}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_sharded_step_matches_reference(runs, variant):
    ref, got = runs
    ref, got, variant = ref[variant[3]], got[variant[0]], variant[0]
    assert abs(float(got["loss"]) - ref["loss"]) <= 1e-5
    want, have = dict(_leaves(ref["params"])), dict(_leaves(got["params"]))
    grads, got_grads = dict(_leaves(ref["grads"])), dict(_leaves(got["grads"]))
    assert sorted(have) == sorted(want) == sorted(got_grads)
    for key, w in want.items():
        g = grads[key]
        top = np.abs(g).max()
        assert np.abs(got_grads[key] - g).max() <= 2e-5 * top, \
            f"{variant}: gradient {key}"
        bar = np.where(np.abs(g) >= 1e-6, 2e-5, LR)
        err = np.abs(have[key] - w)
        assert (err <= bar).all(), \
            f"{variant}: {key} off by {err.max()} ({(err > 2e-5).sum()} " \
            f"elements past 2e-5, gradients there {g[err > 2e-5]})"
