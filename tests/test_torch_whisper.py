"""The port's Whisper encoder-decoder (whisper-base) against the JAX
package's.

Parameters are made by the JAX model (float32, ``scaled_down``: 2 encoder
and 2 decoder layers, d_model 128, 16 frames) and carried across with
`params_from_reference`; frames and tokens are made with numpy from a
seed.  Forward logits within 1e-4 of the JAX model's (which runs its
Pallas kernel in interpret mode, non-causal in the encoder), decode
within 1e-4 of the JAX decode and 2e-3 of the port's forward
(tests/test_models.py's bar).  At whisper-base's published 1500 frames
(1500 is not a multiple of 128: the JAX Pallas kernel asserts
``S % 128 == 0``) the JAX model runs its plain attention
(``use_pallas=False``); the port's plain attention on the CPU, the
kernel on the card.  Also: the sinusoid table, the cache tree, the
refusal without frames, and the dtype promotion JAX applies when the
frames and the parameters differ in dtype.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.whisper import _sinusoid as r_sinusoid  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import whisper  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import count_params, tree_map  # noqa: E402
from _torch_port import frames_for, reference_pair, tokens_for  # noqa: E402

TOL = 1e-4
NAME = "whisper-base"
_PAIR = {}


def pair():
    if "p" not in _PAIR:
        _PAIR["p"] = reference_pair(NAME)
    return _PAIR["p"]


@pytest.mark.parametrize("seq,dim", [(16, 128), (1500, 512), (448, 64)])
def test_sinusoid_matches_reference(seq, dim):
    """The float32 table (sin on even columns, cos on odd), and one row
    from `start`, as decode slices it.  XLA's float32 exp is one ulp off
    PyTorch's at 25 of whisper-base's 256 frequencies; a frequency is at
    most 1, so its ulp is at most 2^-24 and the angle at position p moves
    by up to p * 2^-24: 8.9e-5 at p = 1499, under the bar of 1e-4."""
    want = np.asarray(r_sinusoid(seq, dim, jnp.float32))
    got = whisper._sinusoid(seq, dim, torch.float32, "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    row = whisper._sinusoid(1, dim, torch.float32, "cpu", start=seq - 1)
    assert torch.equal(row[0], got[seq - 1])
    bf = whisper._sinusoid(seq, dim, torch.bfloat16, "cpu")
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.bfloat16())


def test_forward_matches_reference():
    rmodel, rparams, port = pair()
    cfg = port.cfg
    toks, frames = tokens_for(cfg, 2, 64), frames_for(cfg, 2)
    want = np.asarray(rmodel.forward(rparams, jnp.asarray(toks),
                                     jnp.asarray(frames)))
    got = port.forward(torch.from_numpy(toks).long(),
                       torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_forward_at_published_frames():
    """encoder_frames = 1500 (whisper-base's), scaled-down width, against
    the JAX model's plain attention."""
    rmodel, rparams, port = reference_pair(NAME, use_pallas=False,
                                           encoder_frames=1500)
    cfg = port.cfg
    toks, frames = tokens_for(cfg, 1, 24, seed=1), frames_for(cfg, 1, seed=1)
    assert frames.shape == (1, 1500, cfg.d_model)
    want = np.asarray(rmodel.forward(rparams, jnp.asarray(toks),
                                     jnp.asarray(frames)))
    got = port.forward(torch.from_numpy(toks).long(),
                       torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    mem = np.asarray(rmodel.encode(rparams, jnp.asarray(frames)))
    np.testing.assert_allclose(port.encode(torch.from_numpy(frames)).numpy(),
                               mem, rtol=TOL, atol=TOL)


def test_decode_matches_reference_and_forward():
    rmodel, rparams, port = pair()
    cfg = port.cfg
    toks, frames = tokens_for(cfg, 2, 12, seed=3), frames_for(cfg, 2, seed=3)
    rstep = jax.jit(rmodel.decode_step)
    rcache = rmodel.init_cache(2, 12, frames=jnp.asarray(frames),
                               params=rparams)
    cache = port.init_cache(2, 12, frames=torch.from_numpy(frames))
    np.testing.assert_allclose(cache["memory"].numpy(),
                               np.asarray(rcache["memory"]), rtol=TOL,
                               atol=TOL)
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
    full = port.forward(t, torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, full, rtol=2e-3, atol=2e-3)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["self"][k].numpy(),
                                   np.asarray(rcache["self"][k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert np.array_equal(cache["self"]["slot_pos"].numpy(),
                          np.asarray(rcache["self"]["slot_pos"]))


def test_init_cache_matches_reference_tree():
    """The tree, shapes and dtypes of the reference's cache; without
    frames the memory is zeros."""
    rmodel, _, port = pair()
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        rmodel.init_cache(3, 20))
    cache = port.init_cache(3, 20)
    got = tree_map(lambda v: (tuple(v.shape), str(v.dtype).split(".")[-1]),
                   cache)
    assert got == want
    assert not cache["memory"].any()
    assert (cache["self"]["slot_pos"] == -1).all()


def test_forward_needs_frames():
    _, _, port = pair()
    with pytest.raises(ValueError, match="frames"):
        port.forward(torch.zeros((1, 4), dtype=torch.long))


def test_dtype_follows_the_inputs():
    """bf16 parameters: bf16 frames keep the encoder in bf16; float32
    frames promote it to float32, and the cross keys and values with it,
    as JAX's promotion does (float32 memory against the bf16 decoder)."""
    _, _, port = pair()
    cfg = port.cfg
    bf = whisper.WhisperModel(cfg, tree_map(lambda a: a.bfloat16(),
                                            port.params.tree()))
    frames = torch.from_numpy(frames_for(cfg, 1))
    toks = torch.from_numpy(tokens_for(cfg, 1, 6)).long()
    assert bf.encode(frames.bfloat16()).dtype == torch.bfloat16
    assert bf.encode(frames).dtype == torch.float32
    for fr in (frames, frames.bfloat16()):
        logits = bf.forward(toks, fr)
        assert logits.dtype == torch.float32
        assert bool(torch.isfinite(logits).all())
        cache = bf.init_cache(1, 6, frames=fr)
        assert cache["memory"].dtype == fr.dtype
        assert cache["self"]["k"].dtype == torch.bfloat16
        lg, _ = bf.decode_step(cache, toks[:, :1], 0)
        assert lg.shape == (1, 1, cfg.vocab_size)


def test_build_model_encdec_on_cpu():
    """`build_model` builds the encoder-decoder; whisper-base's table has
    6 + 6 layers and 70.7e6 parameters."""
    cfg = get_config(NAME).scaled_down(dtype="float32")
    model = build_model(cfg, device="cpu", seed=0)
    frames = torch.from_numpy(frames_for(cfg, 1))
    logits = model.forward(torch.from_numpy(tokens_for(cfg, 1, 20)).long(),
                           frames)
    assert logits.shape == (1, 20, cfg.vocab_size)
    full = get_config(NAME)
    table = whisper.defs(full)
    assert table["encoder"]["attn"]["wq"].shape == (6, 512, 8, 64)
    assert table["decoder"]["cross"]["wk"].shape == (6, 512, 8, 64)
    assert count_params(table) == 70_664_192


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4])
def test_encoder_attention_on_card(b):
    """Whisper's encoder attention on the card: bf16, 8/8 heads, S = 1500
    (ragged against every tile), D = 64, non-causal, through
    `ops.attention` (the sm90 kernel) and the CUDA-core kernel, against the
    plain version at 2e-2 and within one bf16 rounding element by
    element (tests/test_torch_flash_attention.py's bars)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import ops, ref

    rng = np.random.default_rng(b)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, 8, 1500, 64))
                                * 0.5).to("cuda", torch.bfloat16)
               for _ in range(3))
    assert ops._route(q.dtype, 64) == "sm90"
    want = ref.attention_ref(q, k, v, causal=False).float()
    before = dict(ops.LAUNCHES_BY_KERNEL)
    for got in (ops.attention(q, k, v, causal=False),
                ops._launch(q, k, v, False, None, None, None, "simt")):
        torch.cuda.synchronize()
        g = got.float()
        assert bool(torch.isfinite(g).all())
        assert float((g - want).abs().max()) <= 2e-2
        bar = 1e-5 + 2.0 ** -7 * want.abs()
        assert bool(((g - want).abs() <= bar).all()), \
            float(((g - want).abs() / bar).max())
    assert ops.LAUNCHES_BY_KERNEL == {**before, "sm90": before["sm90"] + 1,
                                      "simt": before["simt"] + 1}
