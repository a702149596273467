"""The port's attention against the JAX package's.

On the CPU `repro_torch.kernels.flash_attention.ops.attention` runs its
plain PyTorch version (`ref.attention_ref`, and `attention_chunked` from
S = 4096 on).  It is held against the JAX package's `attention_ref` and
its Pallas kernel in interpret mode (`attention(use_pallas=True)`) at the
five CASES of tests/test_kernels.py::test_flash_attention_vs_ref, in
float32 and bfloat16, at that test's own tolerances (2e-6 and 2e-2), and
at a ragged S = 200 against `attention_ref` (the Pallas kernel asserts
that S divides its tile, so it cannot take one).

The CUDA kernels themselves run only on the card: their tests carry the
`cuda` marker and skip here.  There each is held against the plain version
on the same card at the same cases, a ragged S, head dims 32 to 256 and
both dtypes: the tensor-core kernel (`csrc/flash_attention_sm90.cu`, bf16 at
D in {64, 128, 192, 256}) and the CUDA-core one (`csrc/flash_attention.cu`,
float32, and bf16 at any head dim).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import attention as r_attention  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_chunked as r_attention_chunked, attention_ref as r_attention_ref)
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

CASES = [
    # b, hq, hkv, s, d, causal, softcap, window
    (2, 4, 2, 128, 64, True, None, None),
    (1, 4, 4, 256, 64, True, 50.0, None),
    (1, 8, 2, 256, 128, True, None, 128),
    (1, 2, 1, 128, 64, False, None, None),
    (1, 2, 2, 128, 256, True, 30.0, 64),
]
RAGGED = (1, 4, 2, 200, 64, True, 50.0, 48)
TOL = {"float32": 2e-6, "bfloat16": 2e-2}  # tests/test_kernels.py's
# bf16 on the card: within one bf16 rounding of the plain version, element
# by element (chip_smoke.FLASH_BF16_BAR)
BF16_BAR = {"atol": 1e-5, "rtol": 2.0 ** -7}


def _inputs(case, seed=0):
    b, hq, hkv, s, d = case[:5]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)) * 0.5,
            rng.standard_normal((b, hkv, s, d)) * 0.5,
            rng.standard_normal((b, hkv, s, d)) * 0.5)


def _jax(arrays, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return [jnp.asarray(a, jd) for a in arrays]


def _torch(arrays, dtype, device="cpu"):
    td = getattr(torch, dtype)
    return [torch.from_numpy(a).to(device, td) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_attention_matches_reference_and_pallas(case, dtype):
    b, hq, hkv, s, d, causal, cap, win = case
    arrays = _inputs(case)
    jq, jk, jv = _jax(arrays, dtype)
    want = r_attention_ref(jq, jk, jv, causal=causal, softcap=cap, window=win)
    pallas = r_attention(jq, jk, jv, causal=causal, softcap=cap, window=win,
                         use_pallas=True, bq=64, bk=64)
    q, k, v = _torch(arrays, dtype)
    plain = ref.attention_ref(q, k, v, causal=causal, softcap=cap, window=win)
    dispatched = ops.attention(q, k, v, causal=causal, softcap=cap,
                               window=win)
    assert plain.dtype == q.dtype and plain.shape == q.shape
    assert torch.equal(plain, dispatched)
    for other in (want, pallas):
        np.testing.assert_allclose(_np(plain), _np(other), rtol=0,
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_ragged_s_matches_reference(dtype):
    b, hq, hkv, s, d, causal, cap, win = RAGGED
    arrays = _inputs(RAGGED, seed=1)
    want = r_attention_ref(*_jax(arrays, dtype), causal=causal, softcap=cap,
                           window=win)
    got = ops.attention(*_torch(arrays, dtype), causal=causal, softcap=cap,
                        window=win)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("cap,win", [(50.0, 256), (None, None)])
def test_chunked_attention_matches_reference(cap, win):
    """tests/test_kernels.py::test_chunked_attention_exact's shapes: the
    chunked plain version equals the port's dense one and the JAX
    package's chunked one."""
    rng = np.random.default_rng(1)
    arrays = (rng.standard_normal((1, 4, 1024, 64)),
              rng.standard_normal((1, 2, 1024, 64)),
              rng.standard_normal((1, 2, 1024, 64)))
    q, k, v = _torch(arrays, "float32")
    dense = ref.attention_ref(q, k, v, True, cap, win)
    chunked = ref.attention_chunked(q, k, v, True, cap, win, block_q=128)
    want = r_attention_chunked(*_jax(arrays, "float32"), True, cap, win,
                               block_q=128)
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(chunked.numpy(), _np(want), rtol=0, atol=1e-5)


def test_cpu_dispatch_takes_chunked_version_at_threshold(monkeypatch):
    arrays = _inputs((1, 2, 1, 1024, 32))
    q, k, v = _torch(arrays, "float32")
    monkeypatch.setattr(ops, "_CHUNK_THRESHOLD", 1024)
    before = ops.LAUNCHES
    got = ops.attention(q, k, v, softcap=50.0, window=300)
    assert ops.LAUNCHES == before
    assert torch.equal(got, ref.attention_chunked(q, k, v, softcap=50.0,
                                                  window=300))


def test_masked_rows_use_finite_neg_inf():
    """A window shorter than the kv tile leaves rows whose visible keys all
    come after masked ones; with the finite -1e30 the result stays finite
    and equals the reference's."""
    case = (1, 2, 1, 96, 32, True, None, 3)
    arrays = _inputs(case, seed=2)
    got = ops.attention(*_torch(arrays, "float32"), window=3)
    want = r_attention_ref(*_jax(arrays, "float32"), window=3)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=2e-6)


@pytest.mark.parametrize("bad", ["int_q", "mixed_dtype", "hq_not_multiple",
                                 "bad_window", "bad_softcap", "3d"])
def test_attention_rejects_what_it_does_not_take(bad):
    q, k, v = _torch(_inputs((1, 4, 2, 16, 8)), "float32")
    kw, err = {}, ValueError
    if bad == "int_q":
        q, err = q.int(), TypeError
    elif bad == "mixed_dtype":
        k, err = k.bfloat16(), TypeError
    elif bad == "hq_not_multiple":
        k, v = k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1)
    elif bad == "bad_window":
        kw["window"] = 0
    elif bad == "bad_softcap":
        kw["softcap"] = 0.0
    else:
        q = q[0]
    with pytest.raises(err):
        ops.attention(q, k, v, **kw)


# -- on the card ---------------------------------------------------------

CARD_CASES = CASES + [
    RAGGED,
    (2, 6, 3, 333, 32, True, None, None),
    (1, 4, 1, 129, 192, False, 20.0, 50),
    (1, 2, 1, 1, 256, True, 50.0, 4096),
    (1, 16, 8, 1024, 256, True, 50.0, 512),
    (1, 4, 2, 333, 256, True, 50.0, None),
]


def _hold_on_card(got, want, dtype):
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])
    if dtype == "bfloat16":
        g, w = got.float(), want.float()
        bar = BF16_BAR["atol"] + BF16_BAR["rtol"] * w.abs()
        assert bool(((g - w).abs() <= bar).all()), \
            float(((g - w).abs() / bar).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_version_on_card(case, dtype):
    """The kernel `attention` routes the case to against the plain version
    on the same card, at the JAX test's tolerances and, in bf16, within one
    bf16 rounding element by element (the kernels sum D and the keys in
    another order than cuBLAS; all three compute in float32 and round
    once).  bf16 goes to the tensor-core kernel except at D = 32; float32
    always goes to the CUDA-core one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, hq, hkv, s, d, causal, cap, win = case
    q, k, v = _torch(_inputs(case), dtype, "cuda")
    route = "simt" if dtype == "float32" or d == 32 else "sm90"
    assert ops._route(q.dtype, d) == route
    before, by_kernel = ops.LAUNCHES, dict(ops.LAUNCHES_BY_KERNEL)
    got = ops.attention(q, k, v, causal=causal, softcap=cap, window=win)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert ops.LAUNCHES_BY_KERNEL == {**by_kernel,
                                      route: by_kernel[route] + 1}
    want = ref.attention_ref(q, k, v, causal=causal, softcap=cap, window=win)
    assert got.dtype == q.dtype and got.shape == q.shape
    _hold_on_card(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_cuda_core_kernel_bf16_on_card(case):
    """The CUDA-core kernel in bf16 at every case, also where `attention`
    sends bf16 to the tensor-core kernel: the route bf16 takes at any other
    head dim, held at the same bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, hq, hkv, s, d, causal, cap, win = case
    q, k, v = _torch(_inputs(case), "bfloat16", "cuda")
    before = ops.LAUNCHES_BY_KERNEL["simt"]
    got = ops._launch(q, k, v, causal, cap, win, None, "simt")
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_KERNEL["simt"] == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, softcap=cap, window=win)
    _hold_on_card(got, want, "bfloat16")


@pytest.mark.cuda
def test_kernel_takes_permuted_views_on_card():
    """q, k, v as the model's einsums give them (permuted views) are made
    contiguous by the wrapper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _torch(_inputs((1, 4, 2, 64, 32)), "float32", "cuda")
    qp, kp, vp = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    assert not qp.is_contiguous()
    got = ops.attention(qp, kp, vp, softcap=50.0)
    np.testing.assert_allclose(_np(got), _np(ref.attention_ref(
        q, k, v, softcap=50.0)), rtol=0, atol=2e-6)
