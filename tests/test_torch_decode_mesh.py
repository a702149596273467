"""Decode on a mesh: every family's `decode_step` on a (2, 2) ("data",
"model") mesh against the JAX package's decode on a (2, 2) host mesh.

The reference runs in a subprocess on 4 placeholder CPU devices
(``--xla_force_host_platform_device_count=4``): its own parameters, its
cache laid out per its ``cache_pspecs``, `steps` jitted decode steps; the
port runs on 4 gloo ranks (`_torch_dist.run_ranks`) from the same
parameters, tokens and frames, its cache laid out per its
``cache_pspecs`` (checked), and the logits of every step agree within
1e-5 (float32; the sharded contractions and softmax sum in other
orders).  The five families: dense qwen3-4b (kv heads over ``model``),
MoE deepseek-moe-16b (its dense first layer, then expert parallelism
over ``model``, dropless), the Griffin hybrid at 3 layers (one local
MQA layer: a single kv head leaves ``model`` to the cache's 16 slots,
so each step's key lands in one rank's shard of the rolling window,
which the 20 steps wrap), the Mamba SSM, the Whisper encoder-decoder
(its encoder's memory, computed by `init_cache` on the mesh through
the attention kernel's ``local_map``, in the cache).  A ``cuda`` test
holds a (1, 1) card mesh's decode to the meshless bits.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import load_tree, rank_decode, run_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"qwen3-4b": 2, "deepseek-moe-16b": 2, "recurrentgemma-9b": 3,
         "falcon-mamba-7b": 2, "whisper-base": 2}
B, MAX_SEQ, STEPS = 4, 24, 20
TOL = 1e-5

SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.parallel.sharding import spec_for, tree_specs_to_shardings
from _torch_dist import save_tree

out_dir, b, max_seq, steps = sys.argv[1], int(sys.argv[2]), \
    int(sys.argv[3]), int(sys.argv[4])
mesh = make_mesh((2, 2), ("data", "model"))
for i, spec in enumerate(sys.argv[5:]):
    arch, layers = spec.split(":")
    cfg = get_config(arch).scaled_down(dtype="float32",
                                       num_layers=int(layers))
    model = build_model(cfg, mesh=mesh)
    params = model.init(jax.random.PRNGKey(i))
    rng = np.random.default_rng(i)
    tokens = rng.integers(0, cfg.vocab_size, (b, steps)).astype(np.int32)
    tree = {"tokens": tokens, "num_layers": np.int32(layers),
            "max_seq": np.int32(max_seq)}
    kw = {}
    if cfg.family == "encdec":
        frames = rng.normal(size=(b, cfg.encoder_frames, cfg.d_model)) \
            .astype(np.float32)
        tree["frames"] = frames
        kw = {"frames": frames, "params": params}
    with mesh:
        params = jax.device_put(params, tree_specs_to_shardings(
            model.param_pspecs(mesh), mesh))
        cache = model.init_cache(b, max_seq, **kw)
        cache = jax.device_put(cache, tree_specs_to_shardings(
            model.cache_pspecs(mesh, b, max_seq), mesh))
        tok_sh = NamedSharding(mesh, spec_for((b, 1), ("batch", None), mesh))
        step = jax.jit(model.decode_step)
        out = []
        for t in range(steps):
            tok = jax.device_put(jnp.asarray(tokens[:, t:t + 1]), tok_sh)
            logits, cache = step(params, cache, tok, t)
            out.append(np.asarray(logits))
    tree["params"] = jax.tree.map(np.asarray, params)
    tree["logits"] = np.stack(out)
    save_tree(os.path.join(out_dir, arch + ".npz"), tree)
print("DECODE_OK")
'''


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode_mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp), str(B),
                        str(MAX_SEQ), str(STEPS),
                        *(f"{a}:{n}" for a, n in ARCHS.items())],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0 and "DECODE_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-3000:]
    run_ranks(rank_decode, 4, tmp, (2, 2), list(ARCHS), STEPS, timeout=240)
    return {arch: (load_tree(os.path.join(tmp, f"{arch}.npz")),
                   load_tree(os.path.join(tmp, f"{arch}_out.npz")))
            for arch in ARCHS}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_mesh_decode_matches_reference(outputs, arch):
    ref, got = outputs[arch]
    assert got["logits"].shape == ref["logits"].shape
    assert np.isfinite(got["logits"]).all()
    np.testing.assert_allclose(got["logits"], ref["logits"], rtol=TOL,
                               atol=TOL)
    # the softmax across sequence shards runs where the one kv head
    # leaves "model" to the cache's slots; elsewhere each rank's own
    assert bool(got.get("seq_sharded", 0)) == (arch == "recurrentgemma-9b")


@pytest.mark.cuda
def test_card_mesh_of_one_decodes_the_meshless_bits(tmp_path):
    """On a (1, 1) mesh of one card (NCCL world of one), every family's
    decode logits (scaled down, bf16, ARCHS' depths; whisper's cache
    encoding bf16 frames) equal the meshless decode's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model

    assert not dist.is_initialized()
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for arch, layers in ARCHS.items():
            cfg = get_config(arch).scaled_down(dtype="bfloat16",
                                               num_layers=layers)
            plain = build_model(cfg, device="cuda", seed=3)
            meshed = build_model(cfg, device="cuda", seed=3, mesh=mesh)
            gen = torch.Generator("cuda").manual_seed(0)
            tokens = torch.randint(0, cfg.vocab_size, (4, 6),
                                   device="cuda", generator=gen)
            kw = {}
            if cfg.family == "encdec":
                kw["frames"] = torch.randn(
                    (4, cfg.encoder_frames, cfg.d_model), device="cuda",
                    dtype=torch.bfloat16, generator=gen)
            c0 = plain.init_cache(4, 8, **kw)
            c1 = meshed.init_cache(4, 8, **kw)
            for t in range(6):
                a, c0 = plain.decode_step(c0, tokens[:, t:t + 1], t)
                b, c1 = meshed.decode_step(c1, tokens[:, t:t + 1], t)
                assert torch.equal(a, b.full_tensor()), (arch, t)
    finally:
        dist.destroy_process_group()
