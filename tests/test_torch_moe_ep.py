"""Expert parallelism in the port (`models.mlp.moe_apply(..., mesh=)`)
against the JAX package's (`shard_map` + `psum` over ``model``).

The reference runs in a subprocess on 4 placeholder CPU devices
(``--xla_force_host_platform_device_count=4``, as tests/test_pipeline.py
does) on a (2, 2) ("data", "model") mesh and writes its parameters (its
own init), input and output; the port runs on 4 gloo ranks
(`_torch_dist.run_ranks`) from the same numbers.  deepseek-moe-16b (2
shared experts) and qwen2-moe-a2.7b (60 experts padded to 64 in the full
config; scaled down here) in float32 at capacity factor 1.0, so tokens
drop: capacity comes from each shard's local tokens, so at data = 2 EP is
not the meshless output (checked) and is held against the reference's EP
at 1e-5 (the sums run in other orders: the router and expert products,
the combine's K terms, the all-reduce over the two model ranks).  With
data = 1 ((1, 4): every rank sees all tokens, 2 experts a rank of the 8)
EP equals the port's meshless `moe_apply` to float32 rounding (1e-6).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import load_tree, rank_moe_ep, run_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["deepseek-moe-16b", "qwen2-moe-a2.7b"]
CAPACITY_FACTOR = 1.0
B, S = 4, 64
TOL = 1e-5

SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import common, mlp
from _torch_dist import save_tree

out_dir, cf, b, s = sys.argv[1], float(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4])
mesh = make_mesh((2, 2), ("data", "model"))
for i, arch in enumerate(sys.argv[5:]):
    cfg = get_config(arch).scaled_down(dtype="float32", num_layers=2,
                                       moe_capacity_factor=cf)
    p = common.init_params(mlp.moe_defs(cfg), jax.random.PRNGKey(i),
                           jnp.float32)
    x = np.random.default_rng(i).normal(size=(b, s, cfg.d_model)) \
        .astype(np.float32)
    with mesh:
        y = jax.jit(lambda p, x: mlp.moe_apply(p, x, cfg, mesh=mesh))(p, x)
    save_tree(os.path.join(out_dir, arch + ".npz"),
              {"params": jax.tree.map(np.asarray, p), "x": x,
               "y": np.asarray(y), "capacity_factor": np.float32(cf)})
print("EP_OK")
'''


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp),
                        str(CAPACITY_FACTOR), str(B), str(S), *ARCHS],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0 and "EP_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-3000:]
    run_ranks(rank_moe_ep, 4, tmp, [(2, 2), (1, 4)], ARCHS)
    return {arch: (load_tree(os.path.join(tmp, f"{arch}.npz")),
                   load_tree(os.path.join(tmp, f"{arch}_out.npz")))
            for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_matches_reference_ep(outputs, arch):
    ref, got = outputs[arch]
    np.testing.assert_allclose(got["ep_2x2"], ref["y"], rtol=TOL, atol=TOL)
    # per-shard capacity: with drops, EP at data = 2 is not the meshless
    # output, so the comparison above is the one that holds it
    assert np.abs(got["ep_2x2"] - got["meshless"]).max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_at_data_1_matches_meshless(outputs, arch):
    _, got = outputs[arch]
    np.testing.assert_allclose(got["ep_1x4"], got["meshless"], rtol=1e-6,
                               atol=1e-6)
