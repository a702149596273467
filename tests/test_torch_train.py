"""The port's training substrate: tests/test_train.py's seven tests on
`repro_torch.train` (learning, grad-accumulation equivalence, bit-exact
checkpoint restart, async checkpoint, int8 error feedback, Adafactor,
data determinism), at that file's config (qwen2-0.5b scaled down, float32,
2 layers) and bars, on the CPU; the step's contract (its input state
untouched); `make_serve_step`; the `launch.train` CLI with a resume;
and, on the card (`cuda` marker, skipped here), one train step through
the flash kernels forward and backward against the same step on the CPU.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_items, tree_map  # noqa: E402
from repro_torch.train import (AdamW, DataConfig, SyntheticPipeline,  # noqa: E402
                               init_state, make_serve_step, make_train_step)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import Adafactor  # noqa: E402

CFG = get_config("qwen2-0.5b").scaled_down(dtype="float32", num_layers=2)


def _leaves(tree):
    return [leaf for _, leaf in tree_items(tree)]


@pytest.fixture(scope="module")
def setup():
    model = build_model(CFG, device="cpu", remat="none")
    opt = AdamW(learning_rate=1e-3, weight_decay=0.0)
    state = init_state(model, opt)
    dc = DataConfig(global_batch=8, seq_len=32, vocab_size=CFG.vocab_size,
                    kind="markov")
    return model, opt, state, SyntheticPipeline(dc, device="cpu")


def test_loss_decreases(setup):
    model, opt, state, pipe = setup
    step = make_train_step(model, opt)
    losses = []
    for i in range(25):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


def test_grad_accum_equivalence(setup):
    """num_microbatches=4 must produce (near-)identical grads to 1."""
    model, opt, state, pipe = setup
    batch = pipe.batch_at(0)

    def params_with(n):
        new_state, _ = make_train_step(model, opt, num_microbatches=n)(
            state, batch)
        return new_state["params"]

    for a, b in zip(_leaves(params_with(1)), _leaves(params_with(4))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-4)


def test_checkpoint_restart_bit_exact(setup):
    model, opt, state, pipe = setup
    step = make_train_step(model, opt)
    s, _ = step(state, pipe.batch_at(0))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(s, d, 1)
        assert ckpt.latest_step(d) == 1
        s2 = ckpt.restore(tree_map(torch.empty_like, s), d, 1)
        r1, m1 = step(s, pipe.batch_at(1))
        r2, m2 = step(s2, pipe.batch_at(1))
        assert float(m1["loss"]) == float(m2["loss"])
        for a, b in zip(_leaves(r1), _leaves(r2)):
            assert torch.equal(a, b)


def test_async_checkpoint(setup):
    model, opt, state, pipe = setup
    with tempfile.TemporaryDirectory() as d:
        t = ckpt.save_async(state, d, 5)
        t.join()
        assert ckpt.latest_step(d) == 5


def test_int8_error_feedback_learns(setup):
    model, opt, _, pipe = setup
    state = init_state(model, opt)
    step = make_train_step(model, opt, compress="int8")
    losses = []
    for i in range(20):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5
    assert "ef" in state  # error-feedback residual is carried


def test_adafactor_learns(setup):
    model, _, _, pipe = setup
    opt = Adafactor(learning_rate=2e-2)
    state = init_state(model, opt)
    step = make_train_step(model, opt)
    losses = []
    for i in range(25):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5
    # factored state is tiny relative to Adam
    psize = sum(p.numel() for p in _leaves(state["params"]))
    vsize = sum(p.numel() for p in _leaves(state["opt"]["vr"]))
    assert vsize < 0.2 * psize


def test_data_determinism_and_structure():
    dc = DataConfig(global_batch=4, seq_len=64, vocab_size=128, kind="markov")
    p1 = SyntheticPipeline(dc, device="cpu")
    p2 = SyntheticPipeline(dc, device="cpu")
    b1, b2 = p1.batch_at(7), p2.batch_at(7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(p1.batch_at(7)["tokens"], p1.batch_at(8)["tokens"])
    assert 0 < p1.entropy_floor() < np.log(128)
    it = p1.iterate(start_step=3)
    first = next(it)
    assert torch.equal(first["tokens"], p1.batch_at(3)["tokens"])


def test_step_leaves_its_input_state_untouched(setup):
    """The reference's contract: (state, batch) -> (new_state, metrics) with
    the input as it was, so two calls from one state agree bit for bit;
    the metrics are tensors (nothing read back on the host)."""
    model, opt, state, pipe = setup
    before = [t.clone() for t in _leaves(state)]
    step = make_train_step(model, opt)
    r1, m1 = step(state, pipe.batch_at(2))
    r2, m2 = step(state, pipe.batch_at(2))
    for a, b in zip(before, _leaves(state)):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(r1), _leaves(r2)):
        assert torch.equal(a, b)
    assert all(isinstance(m1[k], torch.Tensor) for k in ("loss", "grad_norm",
                                                         "lr"))
    assert int(r1["step"]) == int(state["step"]) + 1
    assert int(r1["opt"]["count"]) == 1


def test_remat_gives_the_same_step(setup):
    """remat="full" recomputes each layer in the backward: the same
    function, so the same loss and gradients bit for bit on the CPU."""
    model, opt, state, pipe = setup
    full = build_model(CFG, device="cpu", remat="full")
    batch = pipe.batch_at(4)
    r1, m1 = make_train_step(model, opt)(state, batch)
    r2, m2 = make_train_step(full, opt)(state, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(_leaves(r1), _leaves(r2)):
        assert torch.equal(a, b)


def test_serve_step_decodes_with_the_given_params():
    """`make_serve_step(model)(params, cache, tokens, pos)` is one
    `decode_step` with `params` in place of the model's own: with the
    model's own it gives the same logits bit for bit, with another tree
    those of a model built from that tree."""
    model = build_model(CFG, device="cpu", seed=0)
    other = build_model(CFG, device="cpu", seed=1)
    serve_step = make_serve_step(model)
    tokens = torch.tensor([[3], [7]])
    for params, ref in ((model.params.tree(), model),
                        (other.params.tree(), other)):
        got, _ = serve_step(params, model.init_cache(2, 4), tokens, 0)
        want, _ = ref.decode_step(ref.init_cache(2, 4), tokens, 0)
        assert torch.equal(got, want)
    assert not torch.equal(
        serve_step(other.params.tree(), model.init_cache(2, 4), tokens, 0)[0],
        model.decode_step(model.init_cache(2, 4), tokens, 0)[0])


def test_train_cli_runs_and_resumes(capsys):
    """`python -m repro_torch.launch.train --device cpu`: 3 steps, then a
    rerun with --steps 5 resumes from the step-3 checkpoint."""
    from repro_torch.launch import train as cli

    with tempfile.TemporaryDirectory() as d:
        args = ["--device", "cpu", "--batch", "2", "--seq", "16",
                "--data", "random", "--ckpt-dir", d, "--ckpt-every", "3"]
        _, m = cli.main(args + ["--steps", "3"])
        assert np.isfinite(float(m["loss"]))
        assert os.path.isdir(os.path.join(d, CFG.name, "step_3"))
        state, _ = cli.main(args + ["--steps", "5"])
        out = capsys.readouterr().out
        assert "[resume] restored step 3" in out
        assert int(state["step"]) == 5
        assert ckpt.latest_step(os.path.join(d, CFG.name)) == 5


# -- on the card ---------------------------------------------------------

@pytest.mark.cuda
def test_train_step_on_card_matches_cpu():
    """One float32 step (TF32 off) of the scaled-down config on the card,
    through the CUDA-core flash kernel forward and the backward kernel,
    against the same step on the CPU: loss within 1e-5 relative, every
    gradient leaf within 1e-4 of its largest magnitude, and every attention
    weight with a nonzero gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.train.train_step import value_and_grad

    cpu = build_model(CFG, device="cpu", remat="full")
    card = build_model(CFG, device="cuda", remat="full")
    params = tree_map(lambda t: t.detach(), cpu.params.tree())
    batch = SyntheticPipeline(DataConfig(2, 64, CFG.vocab_size, "random"),
                              device="cpu").batch_at(0)
    before = dict(ops.LAUNCHES_BY_KERNEL)
    loss_card, g_card = value_and_grad(
        card, tree_map(lambda t: t.cuda(), params),
        {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    # remat: each layer's forward twice, one backward a layer
    n = CFG.num_layers
    assert ops.LAUNCHES_BY_KERNEL == {**before, "simt": before["simt"] + 2 * n,
                                      "bwd": before["bwd"] + n}
    loss_cpu, g_cpu = value_and_grad(cpu, params, batch)
    assert float(loss_card) == pytest.approx(float(loss_cpu), rel=1e-5)
    for (path, a), (_, b) in zip(tree_items(g_card), tree_items(g_cpu)):
        a = a.cpu()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), \
            path
        if path[-2:-1] == ("attn",):
            assert float(a.abs().max()) > 0, path
