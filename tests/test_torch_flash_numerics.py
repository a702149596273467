"""Why the tensor-core flash-attention kernel splits P, and where `attention`
sends each call.

`csrc/flash_attention_sm90.cu` runs bf16 attention on the tensor cores:
bf16 operands, exact products summed in float32, an online softmax in
float32 over 64-key tiles, o rounded to bf16 once.  The softmax numerator
p goes into the P V product as a bf16 operand; rounding it there is a
second rounding the plain version (float32 throughout) does not make.
`_emulate_sm90` repeats the kernel's arithmetic on the CPU, tile by tile,
and holds it within one bf16 rounding of the plain version
(chip_smoke.py's FLASH_BF16_BAR, 2^-7 |ref| + 1e-5, element by element)
at Gemma2-9B's head shape (D = 256, softcap 50): with p split into
p_hi = bf16(p) and p_lo = bf16(p - p_hi), two bf16 products summed in
float32, it meets the bar; with p rounded to bf16 once (the textbook
FlashAttention choice) it does not.  The kernel itself runs only on the
card (tests/test_torch_flash_attention.py, chip_smoke.py).
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_chunked as r_attention_chunked)
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

BF16_BAR = {"atol": 1e-5, "rtol": 2.0 ** -7}  # chip_smoke.FLASH_BF16_BAR
BQ, BK = 128, 64  # the kernel's q rows a block and keys a kv tile
LOG2E = 1.4426950408889634
SHAPE = (1, 2, 1, 1024, 256)  # b, hq, hkv, s, d
SOFTCAP = 50.0
WINDOWS = [None, 300]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _emulate_sm90(q, k, v, causal=True, softcap=None, window=None,
                  split=True):
    """The sm90 kernel's rounding on the CPU: per 128-row q block the same
    kv tiles (kt_lo .. kt_hi), scores in log2 units, online softmax in
    float32, P V as bf16 operands (p_hi and, with `split`, p_lo) summed in
    float32, o = acc / l rounded to bf16."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    scale = d ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(b, hq, s, d)
    nk = -(-s // BK)
    for h in range(hq):
        kh, vh = kf[:, h // g], vf[:, h // g]
        for q0 in range(0, s, BQ):
            rows = torch.arange(q0, min(q0 + BQ, s))
            qb = qf[:, h, q0:q0 + BQ]
            kt_lo = max(0, q0 - window + 1) // BK if window else 0
            kt_hi = min(nk - 1, (q0 + BQ - 1) // BK) if causal else nk - 1
            m = torch.full((b, len(rows), 1), -1e30)
            l = torch.zeros(b, len(rows), 1)
            acc = torch.zeros(b, len(rows), d)
            for kt in range(kt_lo, kt_hi + 1):
                keys = torch.arange(kt * BK, min(kt * BK + BK, s))
                dot = qb @ kh[:, keys].transpose(1, 2)
                if softcap:
                    z = (softcap * LOG2E) * torch.tanh(dot * (scale / softcap))
                else:
                    z = dot * (scale * LOG2E)
                ok = torch.ones(len(rows), len(keys), dtype=torch.bool)
                if causal:
                    ok &= keys[None, :] <= rows[:, None]
                if window:
                    ok &= keys[None, :] > rows[:, None] - window
                z = z.masked_fill(~ok, -1e30)
                m_new = torch.maximum(m, z.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(z - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                hi = _bf16(p)
                pv = hi @ vh[:, keys]
                if split:
                    pv = pv + _bf16(p - hi) @ vh[:, keys]
                acc = acc * alpha + pv
                m = m_new
            out[:, h, q0:q0 + BQ] = acc / torch.where(l > 0, l, 1.0)
    return out.to(torch.bfloat16)


def _inputs(seed=0):
    b, hq, hkv, s, d = SHAPE
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)) * 0.5,
            rng.standard_normal((b, hkv, s, d)) * 0.5,
            rng.standard_normal((b, hkv, s, d)) * 0.5)


def _share_of_bar(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    bar = BF16_BAR["atol"] + BF16_BAR["rtol"] * w.abs()
    return float(((g - w).abs() / bar).max())


def test_bar_is_chip_smokes():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.FLASH_BF16_BAR == BF16_BAR


@pytest.mark.parametrize("window", WINDOWS)
def test_split_p_meets_one_rounding_bar(window):
    """Split P: within one bf16 rounding of the port's plain version and of
    the JAX package's chunked attention, element by element."""
    arrays = _inputs()
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = _emulate_sm90(q, k, v, softcap=SOFTCAP, window=window)
    plain = ref.attention_chunked(q, k, v, softcap=SOFTCAP, window=window)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    jax_out = torch.from_numpy(np.asarray(
        r_attention_chunked(jq, jk, jv, True, SOFTCAP, window),
        np.float32))
    assert torch.isfinite(got.float()).all()
    assert _share_of_bar(got, plain) <= 1.0
    assert _share_of_bar(got, jax_out) <= 1.0


@pytest.mark.parametrize("window", WINDOWS)
def test_plain_bf16_p_misses_the_bar(window):
    """P rounded to bf16 once: the same inputs miss the bar, which is why the
    kernel splits P."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs())
    got = _emulate_sm90(q, k, v, softcap=SOFTCAP, window=window, split=False)
    plain = ref.attention_chunked(q, k, v, softcap=SOFTCAP, window=window)
    assert _share_of_bar(got, plain) > 1.0


def test_emulation_is_the_plain_version_in_float32():
    """The emulation's tiling, masks and online softmax (not its bf16
    operands) agree with the plain version in float32: a ragged S, a
    window narrower than a tile, GQA, no softcap."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape) * 0.5).float()
               for shape in ((1, 4, 200, 64), (1, 2, 200, 64),
                             (1, 2, 200, 64)))
    for window in (None, 3):
        got = _emulate_sm90(q, k, v, window=window, split=True).float()
        want = ref.attention_ref(q, k, v, window=window)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2 ** -7,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list_archs())
def test_route_of_every_config(arch, dtype):
    """bf16 at D in {64, 128, 192, 256} (every in-repo config's head dim)
    goes to the tensor-core kernel; float32 to the CUDA-core one."""
    d = get_config(arch).head_dim
    want = "sm90" if dtype == "bfloat16" else "simt"
    assert d in (64, 128, 192, 256)
    assert ops._route(getattr(torch, dtype), d) == want


@pytest.mark.parametrize("d", [4, 32, 96, 100, 252])
def test_route_of_other_head_dims(d):
    assert ops._route(torch.bfloat16, d) == "simt"
    assert ops._route(torch.float32, d) == "simt"


@pytest.mark.parametrize("dtype,d", [("float32", 64), ("bfloat16", 32),
                                     ("bfloat16", 96)])
def test_sm90_launch_rejects_what_it_does_not_take(dtype, d):
    """The sm90 kernel is never asked for float32 or another head dim; the
    check comes before any launch, so it runs on the CPU."""
    q = torch.zeros(1, 2, 8, d, dtype=getattr(torch, dtype))
    before = dict(ops.LAUNCHES_BY_KERNEL)
    with pytest.raises(ValueError, match="sm90"):
        ops._launch(q, q, q, True, None, None, None, "sm90")
    assert ops.LAUNCHES_BY_KERNEL == before
