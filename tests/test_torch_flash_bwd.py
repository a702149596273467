"""The flash-attention backward: the plain version against JAX autodiff,
the kernel's tiling emulated on the CPU, and the CUDA kernel on the card.

The JAX package never differentiates its Pallas kernel: its train paths
take XLA autodiff through ``attention_ref``.  The port's plain backward
(`ref.attention_backward_ref`, autograd through `attention_ref`) is held
against ``jax.vjp`` of that function at tests/test_kernels.py's five cases
and a ragged S (causal, window, softcap, GQA, non-causal), in float32, to
2e-6 of each gradient's largest magnitude (the two sum in other orders;
the largest difference seen is 9e-7 of it).

`_emulate` repeats, in PyTorch on the CPU, what the two kernels of
`csrc/flash_attention_bwd.cu` compute tile by tile: the 32-row tiles, the
ranges of tiles each block visits, the recomputed log-sum-exp and
``Dsum = do . o``, the masks and the softcap factor.  It is held against the
plain version to 2e-6 of each gradient's largest magnitude, so a tile
range that drops a key, or a mask off by one, fails here and not only on
the card.

On the card (`cuda` marker; they skip here) the kernel is held against the
plain version on the same card: float32 within 1e-5 of each gradient's
largest magnitude plus 1e-7 (the kernel sums keys, heads and D in another
order than cuBLAS), bf16 within 2e-2 of it (the plain version computes from the
float32 output, the kernel from the bf16 one the forward returns, and each
rounds once).  Through autograd: one forward and one backward launch a
call, the same bits twice, and the inference forward unchanged.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as r_attention_ref)
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

CASES = [
    # b, hq, hkv, s, d, causal, softcap, window (tests/test_kernels.py's)
    (2, 4, 2, 128, 64, True, None, None),
    (1, 4, 4, 256, 64, True, 50.0, None),
    (1, 8, 2, 256, 128, True, None, 128),
    (1, 2, 1, 128, 64, False, None, None),
    (1, 2, 2, 128, 256, True, 30.0, 64),
    (1, 4, 2, 200, 64, True, 50.0, 48),  # ragged S against every tile
]
# the emulation: ragged S, windows shorter than a tile and spanning
# several, non-causal with a window, GQA 3:1, D not a multiple of 64
EMULATED = CASES + [
    (1, 3, 1, 77, 36, True, None, 5),
    (2, 2, 2, 70, 20, False, 10.0, 33),
    (1, 6, 2, 97, 8, False, None, None),
]
REL = 2e-6  # the plain and emulated gradients' bar, of the largest |g|
CARD_REL = {"float32": 1e-5, "bfloat16": 2e-2}
# where a gradient is exactly 0 (one key a row: dq = p (do.v - do.o) with
# p = 1, o = v) the kernel's do.v and do.o, summed in two orders, leave
# float32 rounding of about 1e-8
CARD_ATOL = 1e-7
T = 32  # the kernel's tile (kT)


def _inputs(case, seed=0):
    b, hq, hkv, s, d = case[:5]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)) * 0.5,
            rng.standard_normal((b, hkv, s, d)) * 0.5,
            rng.standard_normal((b, hkv, s, d)) * 0.5,
            rng.standard_normal((b, hq, s, d)))


def _torch(arrays, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(a).to(device, dtype) for a in arrays]


def _assert_close(got, want, rel, what="", atol=0.0):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(g).all(), what
    bar = rel * np.abs(w).max() + atol
    err = np.abs(g - w).max()
    assert err <= bar, (what, err, bar, err / np.abs(w).max())


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_autodiff(case):
    b, hq, hkv, s, d, causal, cap, win = case
    q, k, v, do = _inputs(case)
    f = lambda q_, k_, v_: r_attention_ref(  # noqa: E731
        q_, k_, v_, causal=causal, softcap=cap, window=win)
    _, vjp = jax.vjp(f, *(jnp.asarray(a, jnp.float32) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.float32))
    got = ref.attention_backward_ref(*_torch((q, k, v, do)), causal=causal,
                                     softcap=cap, window=win)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _assert_close(g.numpy(), np.asarray(w), REL, "d" + name)


def test_cpu_autograd_through_attention_is_the_plain_backward():
    """On the CPU `ops.attention` is the plain version, so autograd through
    it gives `attention_backward_ref`'s gradients bit for bit, and launches
    nothing."""
    case = CASES[1]
    q, k, v, do = _torch(_inputs(case))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(ops.LAUNCHES_BY_KERNEL)
    out = ops.attention(*leaves, softcap=50.0)
    got = torch.autograd.grad(out, leaves, do)
    assert ops.LAUNCHES_BY_KERNEL == before
    want = ref.attention_backward_ref(q, k, v, do, softcap=50.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _keep(qpos, kpos, s, causal, window):
    keep = (qpos[:, None] < s) & (kpos[None, :] < s)
    if causal:
        keep &= kpos[None, :] <= qpos[:, None]
    if window:
        keep &= kpos[None, :] > qpos[:, None] - window
    return keep


def _tile(x, t0, s):
    """Rows t0 .. t0 + T - 1 of [..., S, D], zero past S (the staging)."""
    out = x.new_zeros(x.shape[:-2] + (T, x.shape[-1]))
    n = max(0, min(T, s - t0))
    out[..., :n, :] = x[..., t0:t0 + n, :]
    return out


def _emulate(q, k, v, o, do, causal, cap, window, scale):
    """dq, dk, dv as the two kernels compute them, tile by tile (float32)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    nt = -(-s // T)
    ar = torch.arange(T)

    def entries(qs, ks, dos, vs, q0, k0, lse, dsum):
        x = qs @ ks.transpose(-1, -2)
        if cap:
            t = torch.tanh(x / cap)
            sc, dsdx = cap * t, 1.0 - t * t
        else:
            sc, dsdx = x, 1.0
        keep = _keep(q0 + ar, k0 + ar, s, causal, window)
        p = torch.where(keep, torch.exp(sc - lse[..., None]), 0.0)
        dx = p * (dos @ vs.transpose(-1, -2) - dsum[..., None]) * dsdx
        return sc, keep, p, dx

    # kernel 1: dq, and each row's lse and Dsum, one 32-row q tile a block
    dq = torch.zeros_like(q)
    lse_all = torch.zeros((b, hq, nt * T))
    dsum_all = torch.zeros((b, hq, nt * T))
    for it in range(nt):
        q0 = it * T
        qs, dos = _tile(q, q0, s) * scale, _tile(do, q0, s)
        dsum = (_tile(o, q0, s) * dos).sum(-1)
        kt_lo = max(0, q0 - window + 1) // T if window else 0
        kt_hi = min(nt - 1, (q0 + T - 1) // T) if causal else nt - 1
        rows = []
        for kt in range(kt_lo, kt_hi + 1):
            ks = _tile(k, kt * T, s).repeat_interleave(g, dim=1)
            sc, keep, _, _ = entries(qs, ks, dos, ks, q0, kt * T,
                                     torch.zeros(qs.shape[:-1]),
                                     torch.zeros(qs.shape[:-1]))
            rows.append(torch.where(keep, sc, -torch.inf))
        lse = torch.logsumexp(torch.cat(rows, -1), -1)
        lse = torch.where(torch.isfinite(lse), lse, 0.0)
        lse_all[..., q0:q0 + T], dsum_all[..., q0:q0 + T] = lse, dsum
        acc = torch.zeros_like(qs)
        for kt in range(kt_lo, kt_hi + 1):
            ks = _tile(k, kt * T, s).repeat_interleave(g, dim=1)
            vs = _tile(v, kt * T, s).repeat_interleave(g, dim=1)
            acc += entries(qs, ks, dos, vs, q0, kt * T, lse, dsum)[3] @ ks
        n = min(T, s - q0)
        dq[..., q0:q0 + n, :] = (acc * scale)[..., :n, :]
    # kernel 2: dk, dv, one 32-key tile of a kv head a block, its group's
    # q heads and the q tiles that see its keys in a loop
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for kt in range(nt):
        k0 = kt * T
        ks, vs = _tile(k, k0, s), _tile(v, k0, s)
        qt_lo = k0 // T if causal else 0
        qt_hi = min(nt - 1, (k0 + T + window - 2) // T) if window else nt - 1
        gk, gv = torch.zeros_like(ks), torch.zeros_like(vs)
        for hh in range(g):
            heads = slice(hh, hq, g)  # head hk * g + hh of every kv head
            for qt in range(qt_lo, qt_hi + 1):
                q0 = qt * T
                qs = _tile(q[:, heads], q0, s) * scale
                dos = _tile(do[:, heads], q0, s)
                lse = lse_all[:, heads, q0:q0 + T]
                dsum = dsum_all[:, heads, q0:q0 + T]
                _, _, p, dx = entries(qs, ks, dos, vs, q0, k0, lse, dsum)
                gv += p.transpose(-1, -2) @ dos
                gk += dx.transpose(-1, -2) @ qs
        n = min(T, s - k0)
        dk[..., k0:k0 + n, :], dv[..., k0:k0 + n, :] = gk[..., :n, :], \
            gv[..., :n, :]
    return dq, dk, dv


@pytest.mark.parametrize("case", EMULATED)
def test_kernel_tiling_emulated_matches_plain_backward(case):
    b, hq, hkv, s, d, causal, cap, win = case
    q, k, v, do = _torch(_inputs(case, seed=1))
    o = ref.attention_ref(q, k, v, causal=causal, softcap=cap, window=win)
    got = _emulate(q, k, v, o, do, causal, cap, win, d ** -0.5)
    want = ref.attention_backward_ref(q, k, v, do, causal=causal,
                                      softcap=cap, window=win)
    for name, g_, w in zip("qkv", got, want):
        _assert_close(g_.numpy(), w.numpy(), REL, "d" + name)


# -- on the card ---------------------------------------------------------

CARD_CASES = EMULATED + [
    (1, 12, 1, 256, 192, True, None, None),
    (1, 4, 2, 333, 256, True, 50.0, None),
    (1, 2, 1, 1, 256, True, 50.0, 4096),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_backward_kernel_matches_plain_version_on_card(case, dtype):
    """Autograd through `ops.attention` on the card: one forward launch of
    the routed kernel and one backward launch, gradients against the plain
    backward on the same card."""
    _card()
    b, hq, hkv, s, d, causal, cap, win = case
    td = getattr(torch, dtype)
    q, k, v, do = _torch(_inputs(case, seed=2), td, "cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    route, bwd = ops._route(td, d), ops._bwd_route(td, d)
    before = dict(ops.LAUNCHES_BY_KERNEL)
    out = ops.attention(*leaves, causal=causal, softcap=cap, window=win)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_KERNEL == {**before, route: before[route] + 1,
                                      bwd: before[bwd] + 1}
    want = ref.attention_backward_ref(q, k, v, do, causal=causal,
                                      softcap=cap, window=win)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == td and g.shape == w.shape
        _assert_close(g.float().cpu().numpy(), w.float().cpu().numpy(),
                      CARD_REL[dtype], f"d{name} {case} {dtype}", CARD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_is_deterministic_on_card(dtype):
    """No atomics: the same inputs give the same gradient bits."""
    _card()
    case = (2, 14, 2, 300, 64, True, None, None)
    td = getattr(torch, dtype)
    q, k, v, do = _torch(_inputs(case, seed=3), td, "cuda")
    if ops._bwd_route(td, 64) == "bwd_sm90":  # it reads the forward's lse
        o, lse = ops._launch(q, k, v, True, None, None, None, "sm90",
                             with_lse=True)
    else:
        o, lse = ops.attention(q, k, v), None
    first = ops._launch_bwd(q, k, v, o, do, True, None, None, None, lse=lse)
    for _ in range(3):
        again = ops._launch_bwd(q, k, v, o, do, True, None, None, None,
                                lse=lse)
        for a, b_ in zip(first, again):
            assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_bits_do_not_depend_on_grad_mode_on_card(dtype):
    """Serve is unchanged: the forward under inference_mode, without grad,
    through the autograd Function and (sm90) with its lse pointer set gives
    the same bits."""
    _card()
    case = (1, 16, 8, 256, 256, True, 50.0, 128)
    td = getattr(torch, dtype)
    q, k, v, _ = _torch(_inputs(case, seed=4), td, "cuda")
    kw = {"softcap": 50.0, "window": 128}
    with torch.inference_mode():
        served = ops.attention(q, k, v, **kw)
    plain = ops.attention(q, k, v, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    graded = ops.attention(*leaves, **kw)
    assert graded.grad_fn is not None and plain.grad_fn is None
    assert torch.equal(served, plain) and torch.equal(served, graded.detach())
    if ops._route(td, 256) == "sm90":
        with_lse, _ = ops._launch(q, k, v, True, 50.0, 128, None, "sm90",
                                  with_lse=True)
        assert torch.equal(served, with_lse)
