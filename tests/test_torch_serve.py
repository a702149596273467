"""The port's decode path and serving loop against the JAX package's.

Same parameters on both sides (made by the JAX model, carried across by
`params_from_reference`, as in tests/test_torch_models.py), numpy-made
tokens.  `decode_step` is held against the JAX `decode_step` position by
position at 1e-4 (float32; the two differ in the order of float32 sums,
as the forwards do), and against the port's own forward at
tests/test_models.py::test_decode_matches_forward's 2e-3.  The rolling
local cache is held over more positions than its window.  `generate`
(greedy) must return exactly the JAX decode loop's tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import make_serve_step as r_make_serve_step  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from _torch_port import (DENSE, GRIFFIN, frames_for,  # noqa: E402
                         reference_pair, tokens_for)

B = 2


def _decode_all(rmodel, rparams, port, toks, max_seq):
    """(JAX logits, port logits, port forward logits), each [B, S, V]."""
    s = toks.shape[1]
    rstep = jax.jit(rmodel.decode_step)
    rcache = rmodel.init_cache(B, max_seq)
    cache = port.init_cache(B, max_seq)
    t = torch.from_numpy(toks).long()
    want, got = [], []
    for pos in range(s):
        lg, rcache = rstep(rparams, rcache, jnp.asarray(toks[:, pos:pos + 1]),
                           jnp.int32(pos))
        want.append(np.asarray(lg)[:, 0])
        lg, cache = port.decode_step(cache, t[:, pos:pos + 1], pos)
        got.append(lg[:, 0].numpy())
    return np.stack(want, 1), np.stack(got, 1), port.forward(t).numpy()


@pytest.mark.parametrize("name", DENSE)
def test_decode_matches_reference_and_forward(name):
    rmodel, rparams, port = reference_pair(name)
    toks = tokens_for(port.cfg, B, 12, seed=3)
    want, got, full = _decode_all(rmodel, rparams, port, toks, 12)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, full, rtol=2e-3, atol=2e-3)


def test_rolling_window_cache_matches_full():
    """gemma2 scaled down: window 16 over 24 positions, so the local layers'
    16-slot buffers wrap; the global layers keep all 24."""
    rmodel, rparams, port = reference_pair("gemma2-9b")
    assert port.cfg.local_window == 16
    cache = port.init_cache(B, 24)
    assert cache["p0"]["k"].shape[3] == 16  # local
    assert cache["p1"]["k"].shape[3] == 24  # global
    assert (cache["p0"]["slot_pos"] == -1).all()
    toks = tokens_for(port.cfg, B, 24, seed=9)
    want, got, full = _decode_all(rmodel, rparams, port, toks, 24)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, full, rtol=2e-3, atol=2e-3)


def _reference_loop(rmodel, rparams, prompt, tokens, frames=None):
    """The JAX package's serving loop (repro/launch/serve.py), greedy; an
    enc-dec model's cache encodes `frames`, as its ``encdec`` branch
    does."""
    step = jax.jit(r_make_serve_step(rmodel))
    max_seq = prompt.shape[1] + tokens
    if frames is None:
        cache = rmodel.init_cache(prompt.shape[0], max_seq)
    else:
        cache = rmodel.init_cache(prompt.shape[0], max_seq,
                                  frames=jnp.asarray(frames), params=rparams)
    logits = None
    for pos in range(prompt.shape[1]):
        logits, cache = step(rparams, cache, jnp.asarray(prompt[:, pos:pos + 1]),
                             jnp.int32(pos))
    out = []
    for i in range(tokens):
        nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(nxt))
        logits, cache = step(rparams, cache, nxt,
                             jnp.int32(prompt.shape[1] + i))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("name", ["gemma2-9b", "qwen2-vl-72b"])
def test_generate_greedy_matches_reference_loop(name):
    rmodel, rparams, port = reference_pair(name)
    prompt = tokens_for(port.cfg, B, 8, seed=5)
    want = _reference_loop(rmodel, rparams, prompt, 10)
    cache = port.init_cache(B, 18)
    got = serve.generate(port, cache, torch.from_numpy(prompt).long(), 10)
    assert got.dtype == torch.int64 and got.shape == (B, 10)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "recurrentgemma-9b"])
def test_generate_greedy_matches_reference_loop_moe_and_hybrid(name):
    """deepseek-moe (dense layer0, dropless MoE decode) and Griffin at 5
    layers (one (rec, rec, attn) group and 2 tail layers; window 16, so the
    26 steps wrap its rolling cache)."""
    over = GRIFFIN if name == "recurrentgemma-9b" else {}
    rmodel, rparams, port = reference_pair(name, **over)
    prompt = tokens_for(port.cfg, B, 8, seed=5)
    want = _reference_loop(rmodel, rparams, prompt, 18)
    cache = port.init_cache(B, 26)
    got = serve.generate(port, cache, torch.from_numpy(prompt).long(), 18)
    assert got.dtype == torch.int64 and got.shape == (B, 18)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "whisper-base"])
def test_generate_greedy_matches_reference_loop_ssm_and_encdec(name):
    """falcon-mamba (the O(1) conv + ssm state) and whisper-base (its
    memory encoded from numpy frames in init_cache, cross-attention at
    every step), scaled down."""
    rmodel, rparams, port = reference_pair(name)
    cfg = port.cfg
    prompt = tokens_for(cfg, B, 8, seed=5)
    frames = frames_for(cfg, B, seed=5) if cfg.family == "encdec" else None
    want = _reference_loop(rmodel, rparams, prompt, 10, frames)
    if frames is None:
        cache = port.init_cache(B, 18)
    else:
        cache = port.init_cache(B, 18, frames=torch.from_numpy(frames))
    got = serve.generate(port, cache, torch.from_numpy(prompt).long(), 10)
    assert got.dtype == torch.int64 and got.shape == (B, 10)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "recurrentgemma-9b",
                                  "falcon-mamba-7b", "whisper-base"])
def test_serve_cli_moe_and_hybrid_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "4",
                      "--tokens", "3", "--device", "cpu"])
    assert out.shape == (2, 3)
    assert "tok/s" in capsys.readouterr().out


def test_serve_cli_on_cpu(capsys):
    out = serve.main(["--arch", "qwen3-4b", "--batch", "2", "--prompt-len",
                      "4", "--tokens", "3", "--device", "cpu",
                      "--temperature", "0.7"])
    assert out.shape == (2, 3)
    assert "tok/s" in capsys.readouterr().out


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen3-4b", "--tokens", "1"])
