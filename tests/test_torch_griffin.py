"""The port's Griffin hybrid (recurrentgemma) against the JAX package's.

The RG-LRU scan (`lru_scan`, a Hillis-Steele scan) against
``jax.lax.associative_scan`` of the reference's `_lru_assoc`, at sequence
lengths that are and are not powers of two: 2e-6 absolute and relative
(|h| up to ~7 here; the two sum in different orders, float32).  The
recurrent mixer, one prefill and one decode step, against the reference's
`_rec_mixer` at 1e-5.  Then forward and decode of recurrentgemma-9b scaled
down to 5 layers -- `scaled_down` gives the hybrid 2 layers, which is no
(rec, rec, attn) group and so no attention at all; 5 layers are one group
and 2 tail layers -- against the JAX model at 1e-4, decode against
forward at the reference's 2e-3, and the rolling window cache over 40
positions, past 2 x its 16 slots (tests/test_models.py::
test_rolling_window_cache_matches_full on the port).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.griffin import _lru_assoc  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import griffin  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from _torch_port import GRIFFIN, reference_pair, tokens_for  # noqa: E402

TOL = 1e-4
NAME = "recurrentgemma-9b"
_PAIR = {}


def pair():
    if "p" not in _PAIR:
        _PAIR["p"] = reference_pair(NAME, **GRIFFIN)
    return _PAIR["p"]


@pytest.mark.parametrize("s", [1, 2, 3, 7, 64, 100, 257, 1000])
def test_lru_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.3, 1.0, (2, s, 24)).astype(np.float32)
    b = rng.standard_normal((2, s, 24)).astype(np.float32)
    _, want = jax.lax.associative_scan(_lru_assoc, (jnp.asarray(a),
                                                    jnp.asarray(b)), axis=1)
    got = griffin.lru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)
    # against the recurrence itself, step by step in float64
    h, ref = np.zeros((2, 24)), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        ref.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(ref, 1), rtol=1e-5,
                               atol=1e-5)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("s", [1, 33, 100])
def test_rec_mixer_matches_reference(s):
    """The RG-LRU mixer of recurrent layer 1 (gelu-tanh gate, the k = 4
    causal conv, the block-diagonal gates cast to float32 before the
    sigmoid, sqrt(max(1 - a^2, 1e-12))), prefill and one decode step
    from a non-zero state."""
    rmodel, rparams, port = pair()
    cfg = port.cfg
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    rp = _layer(rparams["rec"], 1)
    tp = {k: torch.from_numpy(np.array(v)) if not isinstance(v, dict)
          else {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
          for k, v in jax.tree.map(np.asarray, rp).items()}
    want, _ = rmodel._rec_mixer(rp, jnp.asarray(h))
    got = port._rec_mixer(tp, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    conv = rng.standard_normal((2, 3, cfg.lru_width)).astype(np.float32)
    hs = rng.standard_normal((2, cfg.lru_width)).astype(np.float32)
    want, wc = rmodel._rec_mixer(rp, jnp.asarray(h[:, :1]),
                                 {"conv": jnp.asarray(conv),
                                  "h": jnp.asarray(hs)})
    cache = {"conv": torch.from_numpy(conv.copy()),
             "h": torch.from_numpy(hs.copy())}
    got = port._rec_mixer(tp, torch.from_numpy(h[:, :1]), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the conv state: the two kept inputs as they were, the new one (a
    # matmul output) within float32 rounding
    assert np.array_equal(cache["conv"][:, :2].numpy(), conv[:, 1:])
    np.testing.assert_allclose(cache["conv"].numpy(), np.asarray(wc["conv"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache["h"].numpy(), np.asarray(wc["h"]),
                               rtol=1e-6, atol=1e-6)


def test_forward_matches_reference():
    rmodel, rparams, port = pair()
    assert (griffin._groups(port.cfg), griffin._tail(port.cfg)) == (1, 2)
    toks = tokens_for(port.cfg, 2, 64)
    want = np.asarray(rmodel.forward(rparams, jnp.asarray(toks)))
    got = port.forward(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _decode_all(s, seed):
    rmodel, rparams, port = pair()
    b = 2 if s < 20 else 1
    toks = tokens_for(port.cfg, b, s, seed=seed)
    rstep = jax.jit(rmodel.decode_step)
    rcache = rmodel.init_cache(b, s)
    cache = port.init_cache(b, s)
    t = torch.from_numpy(toks).long()
    want, got = [], []
    for pos in range(s):
        lg, rcache = rstep(rparams, rcache, jnp.asarray(toks[:, pos:pos + 1]),
                           jnp.int32(pos))
        want.append(np.asarray(lg)[:, 0])
        lg, cache = port.decode_step(cache, t[:, pos:pos + 1], pos)
        got.append(lg[:, 0].numpy())
    return (np.stack(want, 1), np.stack(got, 1), port.forward(t).numpy(),
            cache, rcache)


def test_decode_matches_reference_and_forward():
    want, got, full, cache, rcache = _decode_all(12, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, full, rtol=2e-3, atol=2e-3)
    # the carried state, leaf by leaf
    for grp in ("rec", "att", "tail"):
        for k, v in rcache[grp].items():
            np.testing.assert_allclose(cache[grp][k].numpy(), np.asarray(v),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{grp}.{k}")


def test_rolling_window_past_local_window():
    """40 positions through a 16-slot window: the attention layer's cache
    wraps twice and still agrees with the full-sequence forward."""
    _, _, port = pair()
    assert port.cfg.local_window == 16
    cache = port.init_cache(1, 40)
    assert cache["att"]["k"].shape == (1, 1, port.cfg.num_kv_heads, 16,
                                       port.cfg.head_dim)
    want, got, full, cache, _ = _decode_all(40, 9)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, full, rtol=2e-3, atol=2e-3)
    assert sorted(cache["att"]["slot_pos"][0].tolist()) == list(range(24, 40))


def test_init_cache_matches_reference_tree():
    rmodel, _, port = pair()
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        rmodel.init_cache(3, 20))
    got = {g: {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in c.items()}
           for g, c in port.init_cache(3, 20).items()}
    assert got == want


def test_build_model_hybrid_on_cpu():
    """`build_model` draws `lambda_` from the "normal" init (std 1.0,
    truncated at 2) and the model runs; the full config's table has its 38
    layers as 12 groups and 2 tail layers."""
    cfg = get_config(NAME).scaled_down(dtype="float32", **GRIFFIN)
    model = build_model(cfg, device="cpu", seed=0)
    lam = model.params.tree()["rec"]["lambda_"]
    assert lam.abs().max().item() <= 2.0 * (1 + 1e-6)
    assert lam.std().item() == pytest.approx(0.88, rel=0.1)
    logits = model.forward(torch.from_numpy(tokens_for(cfg, 1, 20)).long())
    assert logits.shape == (1, 20, cfg.vocab_size)
    full = get_config(NAME)
    table = griffin.defs(full)
    assert table["rec"]["w_x"].shape[0] == 24
    assert table["att"]["attn"]["wq"].shape[0] == 12
    assert table["tail"]["w_x"].shape[0] == 2
    assert count_params(table) == 8_578_306_048  # 17.2 GB in bf16


@pytest.mark.cuda
def test_forward_and_decode_on_card_match_cpu():
    """The 5-layer model on the card (float32, TF32 off; the attention
    layer on the CUDA-core kernel) against the same model on the CPU, and
    its decode against its forward past the window, at 2e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.common import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, port = pair()
    card = griffin.GriffinLM(port.cfg, tree_map(lambda a: a.detach().cuda(),
                                                port.params.tree()))
    toks = torch.from_numpy(tokens_for(port.cfg, 1, 40, seed=9)).long()
    before = ops.LAUNCHES_BY_KERNEL["simt"]
    full = card.forward(toks.cuda())
    assert ops.LAUNCHES_BY_KERNEL["simt"] == before + 1
    np.testing.assert_allclose(full.cpu().numpy(), port.forward(toks).numpy(),
                               rtol=2e-3, atol=2e-3)
    cache = card.init_cache(1, 40)
    for pos in range(40):
        lg, cache = card.decode_step(cache, toks[:, pos:pos + 1].cuda(), pos)
        np.testing.assert_allclose(lg[:, 0].cpu().numpy(),
                                   full[:, pos].cpu().numpy(), rtol=2e-3,
                                   atol=2e-3)
