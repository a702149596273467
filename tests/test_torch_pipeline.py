"""GPipe over a mesh axis in the port (`repro_torch.parallel.pipeline.
gpipe`) == the sequential layer stack of the JAX package's test.

tests/test_pipeline.py's case on the port: L = 8 layers tanh(x @ w_i) of
D = 16, 6 microbatches of 4, 4 stages on a "pod" axis of 4 gloo ranks
(`_torch_dist.run_ranks`), each rank holding its stage's 2 layers; the
reference is the sequential ``lax.scan`` over all 8 layers in JAX on the
CPU, from the same numpy inputs, at the reference test's 2e-5.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_dist import (load_tree, rank_gpipe, run_ranks,  # noqa: E402
                         save_tree)

L, D, N_MB, MB, STAGES = 8, 16, 6, 4, 4


def test_gpipe_matches_sequential(tmp_path):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(N_MB, MB, D)).astype(np.float32)
    save_tree(os.path.join(tmp_path, "gpipe.npz"), {"w": w, "x": x})

    def body(h, wi):
        return jnp.tanh(h @ wi), None

    ref, _ = jax.lax.scan(body, jnp.asarray(x).reshape(N_MB * MB, D),
                          jnp.asarray(w))
    run_ranks(rank_gpipe, STAGES, tmp_path)
    out = load_tree(os.path.join(tmp_path, "gpipe_out.npz"))["y"]
    assert out.shape == x.shape
    np.testing.assert_allclose(out, np.asarray(ref).reshape(N_MB, MB, D),
                               rtol=2e-5, atol=2e-5)
