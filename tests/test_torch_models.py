"""The port's dense transformer against the JAX package's.

Parameters are made once by the JAX model (``model.init``, float32,
``scaled_down`` configs) and carried across with
`repro_torch.models.convert.params_from_reference`; inputs are made with
numpy from a seed.  On the CPU the port's forward runs the plain attention
(`attention_ref`), the JAX forward its Pallas kernel in interpret mode
(``use_pallas=True``).  Tolerance 1e-4 (absolute and relative) on float32
logits of magnitude up to about 5: the two differ only in the order of
float32 sums (matmuls, means, attention), which moves the logits by at
most 4e-6 here.

Also: the layer functions one by one (RMSNorm's rounding steps in
bfloat16, the tanh-approximate GELU, RoPE and M-RoPE, the bfloat16-rounded
embedding scale), the parameter tables of every full config (dense, MoE,
SSM, hybrid, encoder-decoder) against the JAX tables without allocating,
and the init statistics.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models import common as r_common  # noqa: E402
from repro.models import mlp as r_mlp  # noqa: E402
from repro.models import rope as r_rope  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import build_model, common, mlp, rope  # noqa: E402
from repro_torch.models.api import model_parts  # noqa: E402
from repro_torch.models.transformer import defs  # noqa: E402
from _torch_port import DENSE, reference_pair, tokens_for  # noqa: E402

TOL = 1e-4


def test_configs_are_the_references():
    assert list_archs() == sorted(
        __import__("repro.configs", fromlist=["list_archs"]).list_archs())
    for name in list_archs():
        assert get_config(name).__dict__ == r_get_config(name).__dict__
        assert (get_config(name).scaled_down().__dict__
                == r_get_config(name).scaled_down().__dict__)


@pytest.mark.parametrize("name", DENSE)
def test_forward_matches_reference(name):
    rmodel, rparams, port = reference_pair(name)
    toks = tokens_for(port.cfg, 2, 64)
    want = np.asarray(rmodel.forward(rparams, jnp.asarray(toks)))
    got = port.forward(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list_archs())
def test_parameter_tables_match_reference(name):
    """Shapes and counts of every full config's table, all five families,
    nothing allocated."""
    cfg, rcfg = get_config(name), r_get_config(name)
    rdefs = r_build_model(rcfg).defs()
    is_def = lambda x: isinstance(x, r_common.ParamDef)  # noqa: E731
    want = jax.tree.map(lambda d: (d.shape, d.logical, d.init, d.fan_dims,
                                   d.scale), rdefs, is_leaf=is_def)
    table = model_parts(cfg)[0](cfg)
    got = common.tree_map(lambda d: (d.shape, d.logical, d.init, d.fan_dims,
                                     d.scale), table)
    assert got == want
    assert common.count_params(table) == r_common.count_params(
        jax.tree.leaves(rdefs, is_leaf=is_def))


def test_unknown_family_raises():
    cfg = get_config("qwen3-4b").with_(family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        model_parts(cfg)
    with pytest.raises(ValueError, match="rnn"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("name,billions", [("deepseek-moe-16b", 16.4),
                                            ("qwen2-moe-a2.7b", 15.2),
                                            ("recurrentgemma-9b", 8.58)])
def test_moe_and_hybrid_full_width_counts(name, billions):
    """The two MoE configs and the hybrid at their published widths (the
    MoE counts are tests/test_models.py's): 32.8, 30.4 and 17.2 GB in
    bfloat16, the sizes the card holds in turn."""
    cfg = get_config(name)
    n = common.count_params(model_parts(cfg)[0](cfg))
    assert n / 1e9 == pytest.approx(billions, rel=0.01)


def test_gemma2_full_width_counts():
    """Gemma2-9B at its published widths: 9.24 B parameters, 18.5 GB in
    bfloat16 (the size the card holds)."""
    n = common.count_params(defs(get_config("gemma2-9b")))
    assert n == 9_241_705_984
    assert 2 * n / 1e9 == pytest.approx(18.48, abs=0.01)


TRUNC_STD = 0.8796256610342398  # std of N(0, 1) truncated to [-2, 2]


def test_init_statistics():
    """Zeros stay zeros; each fan-in leaf has std ~ 0.88 / sqrt(fan) (a
    normal truncated at 2 std, as the JAX init's) and nothing beyond 2
    std."""
    cfg = get_config("gemma2-9b").scaled_down(dtype="float32")
    table = defs(cfg)
    gen = torch.Generator().manual_seed(0)
    params = common.init_params(table, gen, torch.float32, device="cpu")
    rparams = r_build_model(r_get_config("gemma2-9b").scaled_down(
        dtype="float32"), remat="none").init(jax.random.PRNGKey(0))
    flat_defs, flat, flat_ref = [], [], []
    for key in ("embedding", "final_norm"):
        flat_defs.append(table[key])
        flat.append(params[key])
        flat_ref.append(np.asarray(rparams[key]))
    for grp in ("attn", "ffn"):
        for key in table["layers"][grp]:
            flat_defs.append(table["layers"][grp][key])
            flat.append(params["layers"][grp][key])
            flat_ref.append(np.asarray(rparams["layers"][grp][key]))
    for d, t, r in zip(flat_defs, flat, flat_ref):
        assert tuple(t.shape) == d.shape == r.shape
        if d.init == "zeros":
            assert not t.any()
            continue
        fan = np.prod([d.shape[i] for i in d.fan_dims])
        std = d.scale / np.sqrt(fan)
        assert t.abs().max().item() <= 2 * std * (1 + 1e-6)
        assert t.std().item() == pytest.approx(TRUNC_STD * std, rel=0.03)
        assert float(r.std()) == pytest.approx(TRUNC_STD * std, rel=0.03)
    again = common.init_params(table, torch.Generator().manual_seed(0),
                               torch.float32, device="cpu")
    assert torch.equal(again["embedding"], params["embedding"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rounding_steps(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)) * 3
    s = rng.standard_normal(64) * 0.1
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(r_common.rms_norm(jnp.asarray(x, jd),
                                        jnp.asarray(s, jnp.float32)),
                      np.float32)
    got = common.rms_norm(torch.from_numpy(x).to(td),
                          torch.from_numpy(s).float())
    assert got.dtype == td
    tol = 1e-6 if dtype == "float32" else 2 ** -7  # one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_matches_reference(kind):
    """GeLU is the tanh approximation in both (erf would differ by up to
    about 1e-3 here)."""
    cfg = get_config("gemma2-9b").scaled_down(dtype="float32", mlp=kind)
    rng = np.random.default_rng(1)
    p = {k: rng.standard_normal(d.shape) * 0.2
         for k, d in mlp.mlp_defs(cfg).items()}
    x = rng.standard_normal((2, 7, cfg.d_model))
    want = np.asarray(r_mlp.mlp_apply({k: jnp.asarray(v, jnp.float32)
                                       for k, v in p.items()},
                                      jnp.asarray(x, jnp.float32), cfg))
    got = mlp.mlp_apply({k: torch.from_numpy(v).float() for k, v in p.items()},
                        torch.from_numpy(x).float(), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rope_and_mrope_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 40, 32))
    pos = rng.integers(0, 9000, (2, 40)).astype(np.int32)
    pos3 = rng.integers(0, 9000, (3, 2, 40)).astype(np.int32)
    want = np.asarray(r_rope.apply_rope(jnp.asarray(x, jnp.float32),
                                        jnp.asarray(pos), 1e6))
    got = rope.apply_rope(torch.from_numpy(x).float(),
                          torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    want = np.asarray(r_rope.apply_mrope(jnp.asarray(x, jnp.float32),
                                         jnp.asarray(pos3), (4, 6, 6), 1e6))
    got = rope.apply_mrope(torch.from_numpy(x).float(),
                           torch.from_numpy(pos3), (4, 6, 6), 1e6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert np.array_equal(rope.mrope_positions(2, 5, 3, device="cpu").numpy(),
                          np.asarray(r_rope.mrope_positions(2, 5, 3)))
    with pytest.raises(TypeError):  # no default device: the caller names it
        rope.default_positions(2, 5)


def test_bf16_embedding_scale_is_rounded_first():
    """sqrt(3584) = 59.87 is 59.75 in bfloat16, in both packages."""
    assert torch.tensor(3584 ** 0.5, dtype=torch.bfloat16).item() == 59.75
    assert float(jnp.asarray(3584 ** 0.5, jnp.bfloat16)) == 59.75
    _, rparams, port = reference_pair("gemma2-9b")
    cfg = port.cfg
    toks = tokens_for(cfg, 2, 9)
    table = np.array(rparams["embedding"])
    want = np.asarray(jnp.asarray(table, jnp.bfloat16)[toks]
                      * jnp.asarray(cfg.d_model ** 0.5, jnp.bfloat16),
                      np.float32)
    got = port._embed({"embedding": torch.from_numpy(table).bfloat16()},
                      torch.from_numpy(toks).long())
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


def test_entry_points_default_to_the_card():
    """build_model, init_params and params_from_reference default to
    device="cuda" and raise without it."""
    from repro_torch.models.convert import params_from_reference

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("qwen3-4b").scaled_down(dtype="float32")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        common.init_params(defs(cfg), torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_reference({"w": np.zeros(3, np.float32)})
