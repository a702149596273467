"""The tensor-core flash-attention backward (`csrc/flash_attention_bwd_sm90.cu`):
its tiling and bf16 roundings emulated on the CPU, its route, its contract
with the forward's logsumexp, the build's header hash, and on the card
(`cuda` marker; they skip here) the kernel itself.

`_emulate` repeats, in PyTorch on the CPU, what the kernel's passes compute
tile by tile: the dq pass (128-row q tiles over the 64-key tiles
kt_lo .. kt_hi, the forward's range), the dk/dv pass (one q head's
128-key tiles over the 64-row q tiles qt_lo .. qt_hi that see them, as
float32 partials summed over the group in head order), the masks of both,
the scores in log2 units against the forward's logsumexp, ``Dsum = do . o``
from the bf16 output, and the textbook roundings: P (for dV) and dS (for dQ
and dK) rounded to bf16 once.

- Without the roundings, in float32, it is held to the plain backward
  (`ref.attention_backward_ref`) within 2e-6 of each gradient's largest
  magnitude (tests/test_torch_flash_bwd.py's bar for the CUDA-core
  kernel's emulation): a tile range that drops a key or a mask off by one
  fails here, not only on the card.
- With them, from bf16 inputs, it is held to the plain version at the bar
  the card holds the kernel to (chip_smoke.py's FLASH_BWD_TOL["bfloat16"],
  2e-2 of each gradient's largest magnitude) with room to spare: the
  worst share of that bar must stay at most 0.5, the rule under which the
  kernel keeps the textbook roundings instead of splitting P and dS into
  hi + lo as the forward splits P.  Worst shares: 0.33 (GQA 3:1, S = 77,
  window 5), 0.26 at the qwen2-0.5b head group, 0.20 at whisper's encoder
  heads.
"""
import importlib.util
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_port  # noqa: E402,F401  (one PyTorch thread per worker)

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

BQ, BKQ = 128, 64  # dq pass: q rows a block, keys a kv tile
BKV, BQK = 128, 64  # dk/dv pass: keys a block, q rows a q tile
LOG2E = 1.4426950408889634
REL = 2e-6  # the float32 emulation's bar, of the largest |g|
CARD_REL = 2e-2  # chip_smoke.FLASH_BWD_TOL["bfloat16"]
SHARE_LIMIT = 0.5  # textbook roundings are kept while the worst share is here
# tests/test_torch_flash_bwd.py's CARD_ATOL: where a gradient is exactly 0
# (one key a row: dq = p (do.v - do.o) with p = 1, o = v) do.v and do.o,
# summed in two orders, leave float32 rounding of about 1e-8
ATOL = 1e-7

# b, hq, hkv, s, d, causal, softcap, window: chip_smoke.py's FLASH_CASES at
# the kernel's head dims, then a window shorter than a tile, GQA 3:1 and
# 7:1, non-causal with a window and a softcap, ragged S against every tile
CASES = [
    (2, 4, 2, 128, 64, True, None, None),
    (1, 4, 4, 256, 64, True, 50.0, None),
    (1, 8, 2, 256, 128, True, None, 128),
    (1, 2, 1, 128, 64, False, None, None),
    (1, 4, 2, 200, 64, True, 50.0, 48),
    (1, 3, 1, 77, 64, True, None, 5),
    (2, 2, 2, 70, 128, False, 10.0, 33),
    (1, 6, 2, 97, 64, False, None, None),
    (1, 7, 1, 333, 128, True, 30.0, 200),
    (1, 2, 2, 1, 64, True, 50.0, 4096),
]
# a qwen2-0.5b head group (7 q heads on one kv head, D = 64, S = 2048,
# causal) and whisper-base's encoder heads (non-causal, ragged S = 1500)
BIG = [(1, 7, 1, 2048, 64, True, None, None),
       (1, 2, 2, 1500, 64, False, None, None)]


def _inputs(case, seed=0):
    b, hq, hkv, s, d = case[:5]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)) * 0.5,
            rng.standard_normal((b, hkv, s, d)) * 0.5,
            rng.standard_normal((b, hkv, s, d)) * 0.5,
            rng.standard_normal((b, hq, s, d)))


def _torch(arrays, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(a).to(device, dtype) for a in arrays]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _rows(x, r0, n):
    """Rows r0 .. r0 + n - 1 of [..., S, D] (or [..., S]), zero past S: what
    TMA's out-of-bounds fill gives the kernel."""
    s = x.shape[-2] if x.dim() == 4 else x.shape[-1]
    m = max(0, min(n, s - r0))
    if x.dim() == 4:
        out = x.new_zeros(x.shape[:-2] + (n, x.shape[-1]))
        out[..., :m, :] = x[..., r0:r0 + m, :]
    else:
        out = x.new_zeros(x.shape[:-1] + (n,))
        out[..., :m] = x[..., r0:r0 + m]
    return out


def _keep(qpos, kpos, s, causal, window):
    keep = (qpos[:, None] < s) & (kpos[None, :] < s)
    if causal:
        keep &= kpos[None, :] <= qpos[:, None]
    if window:
        keep &= kpos[None, :] > qpos[:, None] - window
    return keep


def _z(x, scale, cap):
    """Scores in log2 units and d s / d x from the products x = q . k, as
    the kernels compute them (zs, zc folded on the host)."""
    if cap:
        t = torch.tanh(x * (scale / cap))
        return (cap * LOG2E) * t, 1.0 - t * t
    return x * (scale * LOG2E), 1.0


def _lse2(q, k, causal, cap, window):
    """Each row's logsumexp in log2 units, as the sm90 forward writes it."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    z, _ = _z(q @ k.repeat_interleave(g, 1).transpose(-1, -2), d ** -0.5, cap)
    pos = torch.arange(s)
    z = z.masked_fill(~_keep(pos, pos, s, causal, window), -torch.inf)
    return torch.logsumexp(z.double() / LOG2E, -1).float() * LOG2E


def _emulate(q, k, v, o, do, lse2, causal, cap, window, rounded=True):
    """dq, dk, dv as the kernel's passes compute them, tile by tile, from
    float32 tensors (holding bf16 values when `rounded`)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = d ** -0.5
    rnd = _bf16 if rounded else (lambda x: x)
    kg, vg = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    dsum = (o * do).sum(-1)
    # 1. dq pass: one 128-row q tile a block over its 64-key tiles
    dq = torch.zeros_like(q)
    nk = -(-s // BKQ)
    for q0 in range(0, s, BQ):
        rows = torch.arange(q0, q0 + BQ)
        kt_lo = max(0, q0 - window + 1) // BKQ if window else 0
        kt_hi = min(nk - 1, (q0 + BQ - 1) // BKQ) if causal else nk - 1
        qt, dot = _rows(q, q0, BQ), _rows(do, q0, BQ)
        lse, ds_ = _rows(lse2, q0, BQ)[..., None], _rows(dsum, q0, BQ)[..., None]
        acc = torch.zeros_like(qt)
        for kt in range(kt_lo, kt_hi + 1):
            k0 = kt * BKQ
            kt_, vt = _rows(kg, k0, BKQ), _rows(vg, k0, BKQ)
            z, dsdx = _z(qt @ kt_.transpose(-1, -2), scale, cap)
            keep = _keep(rows, torch.arange(k0, k0 + BKQ), s, causal, window)
            p = torch.where(keep, torch.exp2(z - lse), 0.0)
            dx = p * (dot @ vt.transpose(-1, -2) - ds_) * dsdx
            acc += rnd(dx) @ kt_
        n = min(BQ, s - q0)
        dq[..., q0:q0 + n, :] = (acc * scale)[..., :n, :]
    # 2. dk/dv pass: one q head's 128-key tile a block over the 64-row q
    # tiles that see it, float32 partials a q head
    part_k, part_v = torch.zeros_like(q), torch.zeros_like(q)
    nqt = -(-s // BQK)
    for k0 in range(0, s, BKV):
        keys = torch.arange(k0, k0 + BKV)
        qt_lo = k0 // BQK if causal else 0
        qt_hi = min(nqt - 1, (k0 + BKV + window - 2) // BQK) if window \
            else nqt - 1
        kt_, vt = _rows(kg, k0, BKV), _rows(vg, k0, BKV)
        gk, gv = torch.zeros_like(kt_), torch.zeros_like(vt)
        for qt in range(qt_lo, qt_hi + 1):
            q0 = qt * BQK
            qq, dd = _rows(q, q0, BQK), _rows(do, q0, BQK)
            lse = _rows(lse2, q0, BQK)[..., None, :]
            ds_ = _rows(dsum, q0, BQK)[..., None, :]
            z, dsdx = _z(kt_ @ qq.transpose(-1, -2), scale, cap)
            keep = _keep(torch.arange(q0, q0 + BQK), keys, s, causal,
                         window).T
            pt = torch.where(keep, torch.exp2(z - lse), 0.0)
            dxt = pt * (vt @ dd.transpose(-1, -2) - ds_) * dsdx
            gv += rnd(pt) @ dd
            gk += rnd(dxt) @ qq
        n = min(BKV, s - k0)
        part_k[..., k0:k0 + n, :] = (gk * scale)[..., :n, :]
        part_v[..., k0:k0 + n, :] = gv[..., :n, :]
    # 3. the group's partials summed in head order
    part_k, part_v = (x.reshape(b, hkv, g, s, d) for x in (part_k, part_v))
    dk, dv = part_k[:, :, 0].clone(), part_v[:, :, 0].clone()
    for hh in range(1, g):
        dk += part_k[:, :, hh]
        dv += part_v[:, :, hh]
    out = (dq, dk, dv)
    return tuple(x.to(torch.bfloat16) for x in out) if rounded else out


def _share(got, want, rel):
    """max |got - want| over rel * max |want| + ATOL (1 = at the bar)."""
    g, w = got.double(), want.double()
    assert torch.isfinite(g).all()
    return float((g - w).abs().max() / (rel * w.abs().max() + ATOL))


@pytest.mark.parametrize("case", CASES)
def test_kernel_tiling_emulated_matches_plain_backward(case):
    """float32, no roundings: the passes' tile ranges and masks drop no
    pair and add none."""
    b, hq, hkv, s, d, causal, cap, win = case
    q, k, v, do = _torch(_inputs(case, seed=1))
    o = ref.attention_ref(q, k, v, causal=causal, softcap=cap, window=win)
    got = _emulate(q, k, v, o, do, _lse2(q, k, causal, cap, win), causal,
                   cap, win, rounded=False)
    want = ref.attention_backward_ref(q, k, v, do, causal=causal,
                                      softcap=cap, window=win)
    for name, g_, w in zip("qkv", got, want):
        assert _share(g_, w, REL) <= 1.0, ("d" + name, case)


def _worst_share(case, seed):
    b, hq, hkv, s, d, causal, cap, win = case
    q, k, v, do = _torch(_inputs(case, seed=seed), torch.bfloat16)
    o = ref.attention_ref(q, k, v, causal=causal, softcap=cap, window=win)
    got = _emulate(*(x.float() for x in (q, k, v, o, do)),
                   _lse2(q.float(), k.float(), causal, cap, win), causal,
                   cap, win)
    want = ref.attention_backward_ref(q, k, v, do, causal=causal,
                                      softcap=cap, window=win)
    return max(_share(g_.float(), w.float(), CARD_REL)
               for g_, w in zip(got, want))


@pytest.mark.parametrize("case", CASES + BIG)
def test_textbook_roundings_keep_half_the_bar(case):
    """bf16 inputs, P and dS rounded to bf16 once: within half the card's
    bar of the plain version (which computes in float32 from the float32
    output), so the kernel needs no hi + lo split."""
    share = _worst_share(case, seed=2)
    assert share <= SHARE_LIMIT, (case, share)


def test_bar_is_chip_smokes():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.FLASH_BWD_TOL["bfloat16"] == CARD_REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list_archs())
def test_backward_route_of_every_config(arch, dtype):
    """bf16 at D in {64, 128} goes to the tensor-core backward; bf16 at
    D in {192, 256} and every float32 call to the CUDA-core one."""
    d = get_config(arch).head_dim
    want = "bwd_sm90" if dtype == "bfloat16" and d in (64, 128) else "bwd"
    assert ops._bwd_route(getattr(torch, dtype), d) == want


@pytest.mark.parametrize("d", [4, 32, 96, 192, 256])
def test_backward_route_of_other_head_dims(d):
    assert ops._bwd_route(torch.bfloat16, d) == "bwd"
    assert ops._bwd_route(torch.float32, d) == "bwd"


def test_sm90_backward_without_lse_raises():
    """The tensor-core backward reads the forward's logsumexp: without it
    the call raises before any launch (no recompute, no other kernel)."""
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    before = dict(ops.LAUNCHES_BY_KERNEL)
    with pytest.raises(ValueError, match="logsumexp"):
        ops._launch_bwd(q, q, q, q, q, True, None, None, None)
    with pytest.raises(ValueError, match="lse must be"):
        ops._launch_bwd(q, q, q, q, q, True, None, None, None,
                        lse=torch.zeros(1, 2, 8, dtype=torch.bfloat16))
    assert ops.LAUNCHES_BY_KERNEL == before


@pytest.mark.parametrize("dtype,d,route,kw", [
    ("float32", 64, None, {"lse": torch.zeros(1, 2, 8)}),
    ("bfloat16", 256, None, {"lse": torch.zeros(1, 2, 8)}),
    ("bfloat16", 192, "bwd_sm90", {}),
    ("float32", 64, "bwd_sm90", {}),
])
def test_backward_launch_rejects_what_it_does_not_take(dtype, d, route, kw):
    """lse on the CUDA-core route, or the tensor-core route at a dtype or
    head dim it is not built for: raised before any launch."""
    q = torch.zeros(1, 2, 8, d, dtype=getattr(torch, dtype))
    before = dict(ops.LAUNCHES_BY_KERNEL)
    with pytest.raises(ValueError):
        ops._launch_bwd(q, q, q, q, q, True, None, None, None, route=route,
                        **kw)
    assert ops.LAUNCHES_BY_KERNEL == before


def test_lse_only_from_the_sm90_forward():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="lse"):
        ops._launch(q, q, q, True, None, None, None, "simt", with_lse=True)


def test_build_target_follows_its_headers(monkeypatch, tmp_path):
    """An edited header gives the library another name, so a stale build
    is never loaded; the sources' own bytes count as before."""
    csrc = tmp_path / "lib" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "a.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "_KERNELS", tmp_path)
    monkeypatch.setattr(_build, "LIBRARIES", {"lib": ("lib/csrc/a.cu",)})
    first, sources = _build._target("lib")
    assert sources == [csrc / "a.cu"]
    assert _build._target("lib")[0] == first
    (csrc / "h.cuh").write_text("// two\n")
    second = _build._target("lib")[0]
    assert second != first and second.parent == first.parent
    (csrc / "b.cuh").write_text("")
    assert _build._target("lib")[0] not in (first, second)


def test_flash_library_lists_the_backward_and_its_header():
    srcs = _build.LIBRARIES["flash_attention"]
    assert "flash_attention/csrc/flash_attention_bwd_sm90.cu" in srcs
    csrc = os.path.dirname(os.path.abspath(ops.__file__))
    assert os.path.exists(os.path.join(csrc, "csrc", "sm90.cuh"))


# -- on the card ---------------------------------------------------------

QWEN2_LAYER = (4, 14, 2, 2048, 64, True, None, None)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _assert_close(got, want, what):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all(), what
    err, top = float((g - w).abs().max()), float(w.abs().max())
    bar = CARD_REL * top + ATOL
    assert err <= bar, (what, err, top, err / bar)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + BIG[1:] + [QWEN2_LAYER])
def test_sm90_backward_matches_plain_version_on_card(case):
    """Autograd through `ops.attention` in bf16: one sm90 forward (with
    lse) and one bwd_sm90 launch, gradients within 2e-2 of each one's
    largest magnitude of the plain backward on the same card."""
    _card()
    b, hq, hkv, s, d, causal, cap, win = case
    q, k, v, do = _torch(_inputs(case, seed=2), torch.bfloat16, "cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(ops.LAUNCHES_BY_KERNEL)
    out = ops.attention(*leaves, causal=causal, softcap=cap, window=win)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_KERNEL == {**before, "sm90": before["sm90"] + 1,
                                      "bwd_sm90": before["bwd_sm90"] + 1}
    want = ref.attention_backward_ref(q, k, v, do, causal=causal,
                                      softcap=cap, window=win)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _assert_close(g, w, f"d{name} {case}")


@pytest.mark.cuda
def test_sm90_backward_is_deterministic_on_card():
    """No atomics: three calls on the same inputs give the same bits."""
    _card()
    case = (2, 14, 2, 300, 64, True, None, None)
    q, k, v, do = _torch(_inputs(case, seed=3), torch.bfloat16, "cuda")
    o, lse = ops._launch(q, k, v, True, None, None, None, "sm90",
                         with_lse=True)
    first = ops._launch_bwd(q, k, v, o, do, True, None, None, None, lse=lse)
    for _ in range(3):
        again = ops._launch_bwd(q, k, v, o, do, True, None, None, None,
                                lse=lse)
        for a, b_ in zip(first, again):
            assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CASES[1], CASES[4], CASES[8],
                                  (1, 16, 8, 300, 256, True, 50.0, 128)])
def test_forward_lse_is_the_rows_logsumexp_on_card(case):
    """The forward's lse (log2 units) times ln 2 against torch.logsumexp of
    the plain version's scores (float32, masked pairs left out)."""
    _card()
    b, hq, hkv, s, d, causal, cap, win = case
    q, k, v, _ = _torch(_inputs(case, seed=4), torch.bfloat16, "cuda")
    _, lse = ops._launch(q, k, v, causal, cap, win, None, "sm90",
                         with_lse=True)
    g = hq // hkv
    x = (q.float() * d ** -0.5) @ k.float().repeat_interleave(
        g, 1).transpose(-1, -2)
    if cap:
        x = cap * torch.tanh(x / cap)
    pos = torch.arange(s, device="cuda")
    x = x.masked_fill(~ref._mask(pos, pos, causal, win), -torch.inf)
    want = torch.logsumexp(x, -1)
    got = lse * math.log(2.0)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max()) + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_forward_bits_do_not_depend_on_lse_on_card(d):
    """Asking the sm90 forward for lse leaves its output's bits as they
    were, so serve (which never asks) is unchanged."""
    _card()
    case = (1, 4, 2, 333, d, True, 50.0, 128)
    q, k, v, _ = _torch(_inputs(case, seed=5), torch.bfloat16, "cuda")
    plain = ops._launch(q, k, v, True, 50.0, 128, None, "sm90")
    with_lse, _ = ops._launch(q, k, v, True, 50.0, 128, None, "sm90",
                              with_lse=True)
    assert torch.equal(plain, with_lse)
