"""The port's Mamba (falcon-mamba-7b) against the JAX package's.

`selective_scan` against the reference's at sequence lengths that take
one chunk (1, 7, 64, 256), one chunk length that is not a multiple of 256
(600 = 2 x 300) and several chunks (768 = 3 x 256) with the state carried
between them, from a zero and from a given state: 1e-5 absolute and
relative on float32 outputs of magnitude up to about 35 (the two sum in
different orders: the port folds the carried state into the chunk's
first element and scans with Hillis-Steele, the reference scans and adds
(prod a) h afterwards; the largest difference here is 4e-6).  S = 1000
splits into 3 unequal chunks, which the reference refuses (an assert) and
the port too (ValueError).

The mixer, one prefill and one decode step, against the reference's
``_mixer`` at 1e-5; then forward and decode of falcon-mamba-7b scaled down
in float32 from the JAX model's own parameters at 1e-4, decode against
forward at 2e-3 (tests/test_models.py's bar), the cache tree, and the
full config's parameter count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.mamba import selective_scan as r_selective_scan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from _torch_port import reference_pair, tokens_for  # noqa: E402

TOL = 1e-4
SCAN_TOL = 1e-5
NAME = "falcon-mamba-7b"
_PAIR = {}


def pair():
    if "p" not in _PAIR:
        _PAIR["p"] = reference_pair(NAME)
    return _PAIR["p"]


def _scan_inputs(s, seed, bsz=2, e=16, n=8):
    """x, dt (softplus-positive), a (negative), b, c, d, h0 as numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((bsz, s, e)).astype(f32)
    dt = (0.5 * np.log1p(np.exp(rng.standard_normal((bsz, s, e))))).astype(f32)
    a = (-np.exp(0.5 * rng.standard_normal((e, n)))).astype(f32)
    b = rng.standard_normal((bsz, s, n)).astype(f32)
    c = rng.standard_normal((bsz, s, n)).astype(f32)
    d = rng.standard_normal(e).astype(f32)
    h0 = rng.standard_normal((bsz, e, n)).astype(f32)
    return x, dt, a, b, c, d, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 7, 64, 256, 600, 768])
def test_selective_scan_matches_reference(s, with_h0):
    x, dt, a, b, c, d, h0 = _scan_inputs(s, s)
    args = (x, dt, a, b, c, d)
    want_y, want_h = r_selective_scan(*map(jnp.asarray, args),
                                      jnp.asarray(h0) if with_h0 else None)
    got_y, got_h = mamba.selective_scan(
        *map(torch.from_numpy, args),
        torch.from_numpy(h0.copy()) if with_h0 else None)
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    if with_h0:  # the port does not write into the caller's state
        assert np.array_equal(h0, _scan_inputs(s, s)[6])


def test_selective_scan_refuses_unequal_chunks():
    """S = 1000: 3 chunks of 333.3; the reference's assert fires."""
    args = _scan_inputs(1000, 0)[:6]
    with pytest.raises(AssertionError):
        r_selective_scan(*map(jnp.asarray, args))
    with pytest.raises(ValueError, match="1000"):
        mamba.selective_scan(*map(torch.from_numpy, args))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("s", [1, 33, 300])
def test_mixer_matches_reference(s):
    """Layer 1's mixer (the in_proj einsum, the k = 4 causal conv, SiLU,
    the dt / B / C split, softplus, a = -exp(a_log)), prefill and one
    decode step from a non-zero state; the new conv and ssm state."""
    rmodel, rparams, port = pair()
    cfg = port.cfg
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    rp = _layer(rparams["layers"], 1)
    tp = {k: torch.from_numpy(np.array(v))
          for k, v in jax.tree.map(np.asarray, rp).items()}
    want, _ = rmodel._mixer(rp, jnp.asarray(h))
    got = port._mixer(tp, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    conv = rng.standard_normal((2, cfg.ssm_conv - 1,
                                cfg.d_inner)).astype(np.float32)
    ssm = rng.standard_normal((2, cfg.d_inner,
                               cfg.ssm_state)).astype(np.float32)
    want, wc = rmodel._mixer(rp, jnp.asarray(h[:, :1]),
                             {"conv": jnp.asarray(conv),
                              "ssm": jnp.asarray(ssm)})
    cache = {"conv": torch.from_numpy(conv.copy()),
             "ssm": torch.from_numpy(ssm.copy())}
    got = port._mixer(tp, torch.from_numpy(h[:, :1]), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(cache["conv"][:, :-1].numpy(), conv[:, 1:])
    np.testing.assert_allclose(cache["conv"].numpy(), np.asarray(wc["conv"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(wc["ssm"]),
                               rtol=1e-5, atol=1e-5)


def test_forward_matches_reference():
    """300 tokens: one chunk of 300 (S // 256 = 1)."""
    rmodel, rparams, port = pair()
    for s in (64, 300):
        toks = tokens_for(port.cfg, 2, s)
        want = np.asarray(rmodel.forward(rparams, jnp.asarray(toks)))
        got = port.forward(torch.from_numpy(toks).long())
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_decode_matches_reference_and_forward():
    rmodel, rparams, port = pair()
    toks = tokens_for(port.cfg, 2, 12, seed=3)
    rstep = jax.jit(rmodel.decode_step)
    rcache = rmodel.init_cache(2, 12)
    cache = port.init_cache(2, 12)
    t = torch.from_numpy(toks).long()
    want, got = [], []
    for pos in range(12):
        lg, rcache = rstep(rparams, rcache, jnp.asarray(toks[:, pos:pos + 1]),
                           jnp.int32(pos))
        want.append(np.asarray(lg)[:, 0])
        lg, cache = port.decode_step(cache, t[:, pos:pos + 1], pos)
        got.append(lg[:, 0].numpy())
    want, got = np.stack(want, 1), np.stack(got, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, port.forward(t).numpy(), rtol=2e-3,
                               atol=2e-3)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_init_cache_matches_reference_tree():
    rmodel, _, port = pair()
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        rmodel.init_cache(3, 20))
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in port.init_cache(3, 20).items()}
    assert got == want


def test_unembeds_with_the_embedding():
    """falcon-mamba leaves tie_embeddings False, yet its table has no
    lm_head: the logits are the embedding's transpose, as the
    reference's."""
    full = get_config(NAME)
    assert not full.tie_embeddings
    assert "lm_head" not in mamba.defs(full)
    _, _, port = pair()
    x = torch.randn(1, 3, port.cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    p = port.params.tree()
    assert torch.equal(port._unembed(p, x, tied=True),
                       (x @ p["embedding"].T).float())


def test_build_model_ssm_on_cpu():
    """`build_model` builds the SSM; the full config's table is the 64
    layers of falcon-mamba-7b, 7.0e9 parameters (14.0 GB in bf16)."""
    cfg = get_config(NAME).scaled_down(dtype="float32")
    model = build_model(cfg, device="cpu", seed=0)
    logits = model.forward(torch.from_numpy(tokens_for(cfg, 1, 20)).long())
    assert logits.shape == (1, 20, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    full = get_config(NAME)
    table = mamba.defs(full)
    assert table["layers"]["in_proj"].shape == (64, 4096, 2, 8192)
    assert table["layers"]["x_proj"].shape == (64, 8192, 256 + 2 * 16)
    assert count_params(table) / 1e9 == pytest.approx(7.0, rel=0.05)


@pytest.mark.cuda
def test_decode_step_on_card_matches_cpu():
    """One decode step of the scaled-down model on the card (float32, TF32
    off) from a non-zero state against the same step on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models.common import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, port = pair()
    card = mamba.MambaLM(port.cfg, tree_map(lambda a: a.detach().cuda(),
                                            port.params.tree()))
    toks = torch.from_numpy(tokens_for(port.cfg, 2, 8, seed=4)).long()
    cpu_cache = port.init_cache(2, 8)
    for pos in range(7):
        port.decode_step(cpu_cache, toks[:, pos:pos + 1], pos)
    card_cache = tree_map(lambda a: a.cuda(), cpu_cache)
    want, _ = port.decode_step(cpu_cache, toks[:, 7:], 7)
    got, _ = card.decode_step(card_cache, toks[:, 7:].cuda(), 7)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(card_cache[k].cpu().numpy(),
                                   cpu_cache[k].numpy(), rtol=1e-4,
                                   atol=1e-5)
