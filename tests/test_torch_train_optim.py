"""The port's optimizers and gradient compression against the JAX
package's, on identical numpy parameters and gradients.

Held apart from the gradient parity (tests/test_torch_train_grads*.py):
a first Adam step is about ``lr * sign(g)``, so there a one-ulp
difference in a gradient near 0 could move a parameter by 2 lr.  Here
both packages get the same gradients, three steps in a row (bias
correction, the cosine schedule's warm-up, clipping by the global norm
summed over the leaves in the JAX tree order), on a tree whose keys are
not in sorted order and whose leaves are factored and unfactored for
Adafactor.

Bars: float32 results within 1e-6 relative plus 1e-6 of the leaf's
largest magnitude (XLA contracts ``a * b + c`` into fused multiply-adds,
PyTorch rounds twice, so entries near 0 differ most); bf16 moments and
parameters within two bf16 roundings (2^-7 relative) of the reference's
plus one rounding of the leaf's largest entry (where a moment cancels,
the rounding of its earlier, larger value stays), and equal in at least
99 % of the entries; float32 parameters updated
from bf16 moments within 3 lr 2^-8 (a moment one rounding apart moves a
step of about lr by 2^-8 of it) and 99 % of them at the float32 bar;
int8 error feedback equal bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import compress as r_compress  # noqa: E402
from repro.train import optimizer as r_opt  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.train import compress, optimizer  # noqa: E402

SHAPES = {"z_last": {"w": (256, 160), "bias": (160,)},
          "a_first": (3, 130, 140), "m": {"scale": (7,), "k": (128, 128)}}


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    return fn(shapes)


def _draws(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return _tree(SHAPES, lambda s: (rng.standard_normal(s) * scale).astype(
        np.float32))


def _to_jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_port(tree, dtype=torch.float32):
    return _tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


LR = 1e-2  # the schedules' peak
# float32: relative, plus absolute of the leaf's largest magnitude
F32 = {"rtol": 1e-6, "atol_of_max": 1e-6}
# bf16: two roundings of the value plus one of the leaf's largest
# magnitude (where a moment cancels, the rounding of its earlier, larger
# value stays); at least 99 % of the entries bit for bit
BF16 = {"rtol": 2.0 ** -7, "atol_of_max": 2.0 ** -8, "equal_share": 0.99}
# float32 parameters after bf16 moments: a moment one bf16 rounding apart
# moves a step of about lr by 2^-8 of it, three steps in a row
AFTER_BF16 = {"atol": 3 * LR * 2.0 ** -8, "close_share": 0.99}


def _compare(port, ref, bar=F32):
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_port = {"/".join(path): leaf for path, leaf in tree_items(port)}
    assert list(flat_port) == list(flat_ref)  # the same paths, same order
    for key, want in flat_ref.items():
        got, want = _np(flat_port[key]), _np(want)
        assert got.shape == want.shape, key
        err = np.abs(got - want)
        f32 = F32["rtol"] * np.abs(want) + F32["atol_of_max"] * np.abs(
            want).max()
        if bar is F32:
            assert (err <= f32).all(), (key, err.max())
        elif bar is BF16:
            assert (err <= bar["rtol"] * np.abs(want) + bar["atol_of_max"]
                    * np.abs(want).max()).all(), (key, err.max())
            assert np.mean(got == want) >= bar["equal_share"], key
        else:
            assert (err <= bar["atol"]).all(), (key, err.max())
            assert np.mean(err <= f32) >= bar["close_share"], key


def _run(r_optimizer, t_optimizer, param_dtype="float32"):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    params0 = _draws(0, 0.1)
    rp, tp = _to_jax(params0, jd), _to_port(params0, td)
    rs, ts = r_optimizer.init(rp), t_optimizer.init(tp)
    for step in range(3):
        g = _draws(step + 1, 10.0 ** (-step))  # clipped, then not
        rp, rs, rm = r_optimizer.update(_to_jax(g), rs, rp)
        tp, ts, tm = t_optimizer.update(_to_port(g), ts, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(tm[k]), _np(rm[k]), rtol=1e-6)
    return (rp, rs), (tp, ts)


@pytest.mark.parametrize("state_dtype,param_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_adamw_matches_reference(state_dtype, param_dtype):
    kw = dict(learning_rate=None, weight_decay=0.1, clip_norm=1.0,
              state_dtype=state_dtype)
    ref_opt = r_opt.AdamW(**dict(kw, learning_rate=r_opt.cosine_schedule(
        LR, 2, 10)))
    port_opt = optimizer.AdamW(**dict(kw, learning_rate=optimizer.
                                      cosine_schedule(LR, 2, 10)))
    (rp, rs), (tp, ts) = _run(ref_opt, port_opt, param_dtype)
    if param_dtype == "bfloat16":
        _compare(tp, rp, BF16)
    else:
        _compare(tp, rp, AFTER_BF16 if state_dtype == "bfloat16" else F32)
    moments = BF16 if state_dtype == "bfloat16" else F32
    _compare(ts["mu"], rs["mu"], moments)
    _compare(ts["nu"], rs["nu"], moments)
    assert int(ts["count"]) == int(rs["count"]) == 3
    assert ts["mu"]["m"]["k"].dtype == getattr(torch, state_dtype)


def test_adafactor_matches_reference():
    (rp, rs), (tp, ts) = _run(r_opt.Adafactor(learning_rate=2e-2,
                                              weight_decay=0.01),
                              optimizer.Adafactor(learning_rate=2e-2,
                                                  weight_decay=0.01))
    _compare(tp, rp)
    _compare(ts["vr"], rs["vr"])
    _compare(ts["vc"], rs["vc"])
    # factored where both trailing dims reach 128, else a full vc
    assert tuple(ts["vr"]["z_last"]["w"].shape) == (256,)
    assert tuple(ts["vc"]["a_first"].shape) == (3, 140)
    assert tuple(ts["vr"]["m"]["scale"].shape) == (1,)


def test_cosine_schedule_matches_reference():
    ref = r_opt.cosine_schedule(3e-4, 10, 100)
    port = optimizer.cosine_schedule(3e-4, 10, 100)
    steps = np.arange(0, 120, 7)
    np.testing.assert_allclose(port(torch.from_numpy(steps)).numpy(),
                               np.asarray(ref(jnp.asarray(steps))),
                               rtol=1e-6)


def test_int8_error_feedback_matches_reference():
    """Quantize, dequantize and carry the residual, twice: bit for bit."""
    r_ef = t_ef = None
    for step in range(2):
        g = _draws(10 + step)
        r_deq, r_ef = r_compress.compress_decompress(_to_jax(g), r_ef)
        t_deq, t_ef = compress.compress_decompress(_to_port(g), t_ef)
        for port, ref in ((t_deq, r_deq), (t_ef, r_ef)):
            flat = jax.tree_util.tree_flatten_with_path(ref)[0]
            for path, want in flat:
                got = port
                for k in path:
                    got = got[k.key]
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
