"""The port's data pipeline and checkpoints against the JAX package's.

Data: `SyntheticPipeline.batch_at` draws with numpy exactly as the
reference does, so tokens, targets and the bf16-rounded encoder frames
equal the reference's bit for bit ("random", "markov", "fixed"; frames
for whisper-base's scaled-down config), and `iterate` yields the same
batches.

Checkpoints: the same layout (``step_<N>/manifest.json`` + ``arrays.npz``
keyed by tree path), so a train state written by the reference's
``train.checkpoint.save`` restores into the port bit for bit, float32 and
bf16 (the reference writes bf16 leaves as raw 2-byte voids, '<V2'); a
float32 state the port writes restores through the reference's
``restore`` bit for bit; and the port writes a bf16 leaf as the same
bytes the reference does.  (The reference's own ``restore`` cannot read
a bf16 leaf back: numpy has no cast from '<V2' to ml_dtypes' bfloat16;
ROADMAP Queue 3.)
"""
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)
import jax  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.train import AdamW as RAdamW  # noqa: E402
from repro.train import checkpoint as r_ckpt  # noqa: E402
from repro.train import data as r_data  # noqa: E402
from repro.train import init_state as r_init_state  # noqa: E402
from repro.train import make_train_step as r_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.api import model_parts  # noqa: E402
from repro_torch.models.common import dtype_of, tree_items, tree_map  # noqa: E402
from repro_torch.train import AdamW, DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from _torch_train import data_config  # noqa: E402


def _bits(x):
    """A tensor's or an array's bits as a numpy array (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind", ["random", "markov", "fixed"])
def test_batches_equal_the_reference(kind):
    cfg = dict(global_batch=4, seq_len=48, vocab_size=200, kind=kind,
               seed=7)
    ref = r_data.SyntheticPipeline(r_data.DataConfig(**cfg))
    port = SyntheticPipeline(DataConfig(**cfg), device="cpu")
    for step in (0, 3):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(got) == sorted(want) == ["targets", "tokens"]
        for key in want:
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]))
    assert port.entropy_floor() == ref.entropy_floor()
    it = port.iterate(start_step=2)
    for step in (2, 3):
        np.testing.assert_array_equal(_bits(next(it)["tokens"]),
                                      _bits(ref.batch_at(step)["tokens"]))


def test_frames_equal_the_reference_bit_for_bit():
    """whisper-base's encoder frames: standard normals * 0.1 rounded to
    bf16 (nearest even) from float32, as ``jnp.asarray(.., bfloat16)``."""
    rcfg = r_get_config("whisper-base").scaled_down(dtype="float32")
    ref = r_data.SyntheticPipeline(r_data.DataConfig(**data_config(rcfg)))
    port = SyntheticPipeline(DataConfig(**data_config(rcfg)), device="cpu")
    want, got = ref.batch_at(5), port.batch_at(5)
    assert got["frames"].dtype == torch.bfloat16
    assert tuple(got["frames"].shape) == (2, rcfg.encoder_frames,
                                          rcfg.d_model)
    for key in ("tokens", "targets", "frames"):
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]))


def _reference_state(dtype, state_dtype):
    """The reference's train state after one step: qwen2-0.5b scaled down
    in `dtype`, 2 layers, AdamW with moments in `state_dtype`."""
    rcfg = r_get_config("qwen2-0.5b").scaled_down(dtype=dtype, num_layers=2)
    model = r_build_model(rcfg, remat="none")
    opt = RAdamW(learning_rate=1e-3, state_dtype=state_dtype)
    state = r_init_state(model, opt, jax.random.PRNGKey(0))
    pipe = r_data.SyntheticPipeline(r_data.DataConfig(
        2, 16, rcfg.vocab_size, "random"))
    state, _ = jax.jit(r_make_train_step(model, opt))(state, pipe.batch_at(0))
    return state


def _port_template(dtype, state_dtype):
    """Empty tensors of the port's state tree for `_reference_state`'s."""
    cfg = get_config("qwen2-0.5b").scaled_down(dtype=dtype, num_layers=2)
    table = model_parts(cfg)[0](cfg)
    params = tree_map(lambda d: torch.empty(d.shape, dtype=dtype_of(dtype)),
                      table)
    return {"params": params,
            "opt": AdamW(state_dtype=state_dtype).init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _assert_same_state(port_state, ref_state):
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_state)[0]
    port = dict(tree_items(port_state))
    assert len(port) == len(flat_ref)
    for path, want in flat_ref:
        got = port[tuple(k.key for k in path)]
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), path
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype,state_dtype", [("float32", "float32"),
                                               ("bfloat16", "bfloat16")])
def test_reference_checkpoint_restores_into_the_port(dtype, state_dtype):
    state = _reference_state(dtype, state_dtype)
    with tempfile.TemporaryDirectory() as d:
        r_ckpt.save(state, d, 1)
        assert ckpt.latest_step(d) == 1
        got = ckpt.restore(_port_template(dtype, state_dtype), d, 1)
    _assert_same_state(got, state)


def test_port_checkpoint_restores_through_the_reference():
    state = _reference_state("float32", "float32")
    port_state = tree_map(
        lambda a: torch.from_numpy(np.array(a)),
        jax.tree.map(np.asarray, state))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(port_state, d, 3)
        assert r_ckpt.latest_step(d) == 3
        tmpl = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            state)
        back = r_ckpt.restore(tmpl, d, 3)
    _assert_same_state(port_state, back)


def test_port_writes_bf16_leaves_as_the_reference_does():
    """The same npz entries (dtype '<V2', the same bytes) and manifest
    dtypes as the reference's for a bf16 state."""
    state = _reference_state("bfloat16", "bfloat16")
    with tempfile.TemporaryDirectory() as d:
        ref_dir, port_dir = os.path.join(d, "ref"), os.path.join(d, "port")
        r_ckpt.save(state, ref_dir, 1)
        port_state = ckpt.restore(_port_template("bfloat16", "bfloat16"),
                                  ref_dir, 1)
        ckpt.save(port_state, port_dir, 1)
        with np.load(os.path.join(ref_dir, "step_1", "arrays.npz")) as a, \
                np.load(os.path.join(port_dir, "step_1", "arrays.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype, key
                assert a[key].tobytes() == b[key].tobytes(), key
        manifests = [json.load(open(os.path.join(x, "step_1",
                                                 "manifest.json")))["keys"]
                     for x in (ref_dir, port_dir)]
        assert manifests[0] == manifests[1]
    assert str(port_state["params"]["embedding"].dtype) == "torch.bfloat16"


def test_reference_state_carries_over_and_steps_alike():
    """`convert.params_from_reference` carries the reference's whole train
    state (after two steps, so the moments and the count are not zero) bit
    for bit; one more step from it in each package on the same batch gives the
    same loss (within 1e-5) and gradient norm (within 1e-4), both taken
    before the update.  (The updated parameters are held apart, by
    tests/test_torch_train_optim.py: an Adam step is close to lr sign(g).)"""
    from repro_torch.models.convert import params_from_reference
    from repro_torch.train import make_train_step

    rcfg = r_get_config("qwen2-0.5b").scaled_down(dtype="float32",
                                                  num_layers=2)
    rmodel = r_build_model(rcfg, remat="none")
    ropt = RAdamW(learning_rate=1e-3)
    rstep = jax.jit(r_make_train_step(rmodel, ropt))
    rpipe = r_data.SyntheticPipeline(r_data.DataConfig(
        2, 32, rcfg.vocab_size, "random"))
    rstate = r_init_state(rmodel, ropt, jax.random.PRNGKey(0))
    for i in range(2):
        rstate, _ = rstep(rstate, rpipe.batch_at(i))
    state = params_from_reference(jax.tree.map(np.asarray, rstate), "cpu")
    _assert_same_state(state, rstate)

    cfg = get_config("qwen2-0.5b").scaled_down(dtype="float32", num_layers=2)
    port = model_parts(cfg)[1](cfg, state["params"], remat="none")
    pipe = SyntheticPipeline(DataConfig(2, 32, cfg.vocab_size, "random"),
                             device="cpu")
    _, m = make_train_step(port, AdamW(learning_rate=1e-3))(
        state, pipe.batch_at(2))
    _, rm = rstep(rstate, rpipe.batch_at(2))
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=1e-4)
