"""The port's GF(q) cross product and §IV-D intermediate table against the
JAX package's.

On the CPU `repro_torch.kernels.gf_crossprod.ops.crossprod_normalized`
runs its plain PyTorch version; integer arithmetic, so it must equal
(tolerance 0) the JAX package's `crossprod_normalized_ref` and its Pallas
kernel in interpret mode, at sizes that do not fill the kernel's
256 x 256 tiles.  `intermediate_table` (``device="cpu"``) must equal the
JAX package's and the host `PolarFly.intermediates_all_pairs()` off the
diagonal.

The CUDA kernel itself runs only on the card: its tests carry the `cuda`
marker and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gf_crossprod.kernel import crossprod_normalized_pallas  # noqa: E402
from repro.kernels.gf_crossprod.ops import intermediate_table as r_table  # noqa: E402
from repro.kernels.gf_crossprod.ref import crossprod_normalized_ref as r_ref  # noqa: E402
from repro_torch.core.polarfly import build_polarfly  # noqa: E402
from repro_torch.kernels.gf_crossprod import ops  # noqa: E402
from repro_torch.kernels.gf_crossprod.ref import crossprod_normalized_ref  # noqa: E402

SIZES = [(1, 1), (5, 7), (300, 257)]


def _inputs(n, m, q):
    rng = np.random.default_rng(n * 1000 + m * 10 + q)
    s = rng.integers(0, q, size=(n, 3)).astype(np.int32)
    d = rng.integers(0, q, size=(m, 3)).astype(np.int32)
    d[: min(n, m) // 2] = s[: min(n, m) // 2]  # parallel pairs -> zero
    return s, d


@pytest.mark.parametrize("q", [2, 7, 31])
@pytest.mark.parametrize("n,m", SIZES)
def test_crossprod_bit_identical_to_reference(n, m, q):
    s, d = _inputs(n, m, q)
    want = np.asarray(r_ref(jnp.asarray(s), jnp.asarray(d), q))
    pal = np.asarray(crossprod_normalized_pallas(jnp.asarray(s),
                                                 jnp.asarray(d), q,
                                                 interpret=True))
    ts, td = torch.from_numpy(s), torch.from_numpy(d)
    before = ops.LAUNCHES
    for out in (crossprod_normalized_ref(ts, td, q).numpy(),
                ops.crossprod_normalized(ts, td, q).numpy()):
        assert out.dtype == np.int32 and out.shape == (n, m, 3)
        assert np.array_equal(out, want)
        assert np.array_equal(out, pal)
    assert ops.LAUNCHES == before  # the CPU launches no kernel


@pytest.mark.parametrize("q", [3, 5, 7, 11, 13, 31])
def test_intermediate_table_matches_reference_and_host(q):
    pf = build_polarfly(q)
    got = ops.intermediate_table(pf.vertices, q, device="cpu")
    assert got.dtype == np.int32 and got.shape == (pf.n, pf.n)
    assert np.array_equal(got, r_table(pf.vertices, q))
    off = ~np.eye(pf.n, dtype=bool)
    assert np.array_equal(got[off], pf.intermediates_all_pairs()[off])
    assert (np.diag(got) == -1).all()  # parallel pairs have no midpoint


@pytest.mark.parametrize("bad", ["int64", "two_columns", "strided", "q_big",
                                 "q_small"])
def test_crossprod_rejects_what_the_kernel_does_not_take(bad):
    s, d = (torch.from_numpy(x) for x in _inputs(6, 5, 7))
    q, err = 7, ValueError
    if bad == "int64":
        s, err = s.long(), TypeError
    elif bad == "two_columns":
        s = s[:, :2].contiguous()
    elif bad == "strided":
        s = s[::2]
    elif bad == "q_big":
        q = 1 << 16
    else:
        q = 1
    with pytest.raises(err):
        ops.crossprod_normalized(s, d, q)


def test_intermediate_table_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    pf = build_polarfly(3)
    with pytest.raises(RuntimeError, match="cuda"):
        ops.intermediate_table(pf.vertices, 3)


# -- the Hopper kernel's arithmetic and schedule, emulated in numpy ---------
#
# csrc/crossprod.cu reduces by a reciprocal multiply, looks the Fermat
# inverse up in a per-block power table, and walks the pairs four a lane,
# 128 a warp, staged through shared memory into 16-byte stores, with a
# scalar tail.  The emulation below follows it step for step in uint32
# arithmetic, so what makes it exact is checked here; the card tests run
# the kernel itself.

U32 = np.uint64(0xFFFFFFFF)
CHUNK = 128  # pairs a warp handles at a time
WARPS_PER_BLOCK = 8


def _mod_q(x, q):
    """The kernel's mod_q on uint32 values (held in uint64): t = umulhi(x,
    floor(2^32 / q)), r = x - t q, then min(r, r - q) with uint32 wrap."""
    x = np.asarray(x, dtype=np.uint64)
    q = np.uint64(q)
    t = (x * (np.uint64(1 << 32) // q)) >> np.uint64(32)
    r = x - t * q
    assert (r < 2 * q).all()  # the one-subtraction window
    return np.minimum(r, (r - q) & U32)


def _power_table(q):
    """x^(q-2) mod q for x in [0, q), square and multiply as the kernel's
    prologue builds it."""
    x = np.arange(q, dtype=np.uint64)
    r, b, e = np.ones_like(x), x, q - 2
    while e > 0:
        if e & 1:
            r = _mod_q(r * b, q)
        b = _mod_q(b * b, q)
        e >>= 1
    assert r.max(initial=0) < 1 << 16  # fits the uint16 table
    return r


def _pairs(s, d, ii, jj, q, table):
    """Normalised cross products of s[ii] x d[jj] (uint32 arithmetic)."""
    q2 = np.uint64(q * q)
    s0, s1, s2 = (s[ii, k].astype(np.uint64) for k in range(3))
    d0, d1, d2 = (d[jj, k].astype(np.uint64) for k in range(3))
    c0 = _mod_q((q2 + s1 * d2 - s2 * d1) & U32, q)
    c1 = _mod_q((q2 + s2 * d0 - s0 * d2) & U32, q)
    c2 = _mod_q((q2 + s0 * d1 - s1 * d0) & U32, q)
    lead = np.where(c0 != 0, c0, np.where(c1 != 0, c1, c2))
    inv = table[lead.astype(np.int64)]
    return [_mod_q(c * inv, q) for c in (c0, c1, c2)]


def _emulate_kernel(s, d, q, warps):
    """The kernel's output with `warps` warps in the grid: the persistent
    chunk walk with its precomputed stride, the row change inside a lane's
    four pairs, the staged 16-byte stores and the scalar tail."""
    n, m = len(s), len(d)
    table = _power_table(q)
    pairs = n * m
    chunks = pairs // CHUNK
    out = np.full(3 * pairs, -7, dtype=np.int64)  # -7: never written
    lane = np.arange(32)
    w = np.arange(warps)[:, None]
    p0 = w * CHUNK + 4 * lane  # [warps, 32]
    i, j = p0 // m, p0 % m
    stride = warps * CHUNK
    step_i, step_j = stride // m, stride % m
    c = np.broadcast_to(w, p0.shape).copy()
    while (c < chunks).any():
        live = c < chunks
        ii, jj = i.copy(), j.copy()
        words = []
        for k in range(4):
            words += _pairs(s, d, np.where(live, ii, 0),
                            np.where(live, jj, 0), q, table)
            if k < 3:
                jj = jj + 1
                wrap = jj == m
                jj = np.where(wrap, 0, jj)
                ii = ii + wrap
        # lane L's 12 words at 12 L + t of the warp's staging buffer, read
        # back as 16-byte vector 32 k + L and stored at the chunk's base
        buf = np.stack(words, axis=-1).reshape(warps, 32 * 12)
        for k in range(3):
            vec = 32 * k + lane  # [32]
            for r in range(4):
                word = 4 * vec + r
                dst = c * (3 * CHUNK) + word[None, :]
                out[dst[live]] = buf[:, word][live]
        c = c + warps
        i, j = i + step_i, j + step_j
        wrap = j >= m
        j = np.where(wrap, j - m, j)
        i = i + wrap
    for p in range(chunks * CHUNK, pairs):  # the tail, one pair a thread
        o = _pairs(s, d, np.array([p // m]), np.array([p % m]), q, table)
        out[3 * p:3 * p + 3] = [int(x[0]) for x in o]
    assert (out >= 0).all()  # every word written
    return out.reshape(n, m, 3).astype(np.int32)


def _wave_warps(n, m, q, regs=40, sms=132):
    """The launcher's grid on an H100, in warps: one wave of persistent
    blocks, no more than the chunks need.  Blocks an SM as the occupancy
    query finds them: 2048 threads, 64K registers (the kernel's 40 a
    thread, as ptxas reports them for sm_90a) and 228 KB of shared memory
    (the staging buffers and the power table, 1 KB reserved a block)."""
    smem = WARPS_PER_BLOCK * 3 * CHUNK * 4 + (2 * q + 15) // 16 * 16
    threads = 32 * WARPS_PER_BLOCK
    per_sm = min(2048 // threads, 65536 // (regs * threads),
                 (228 << 10) // (smem + 1024))
    chunks = n * m // CHUNK
    need = -(-chunks // WARPS_PER_BLOCK) if chunks else 1
    return min(need, sms * per_sm) * WARPS_PER_BLOCK


def test_remainder_exhaustive_below_300():
    """mod_q equals x mod q for every x in [0, 2 q^2), every q < 300: the
    whole range a biased cross-product term can take."""
    for q in range(2, 300):
        x = np.arange(2 * q * q, dtype=np.uint64)
        assert np.array_equal(_mod_q(x, q), x % np.uint64(q)), q


@pytest.mark.parametrize("q", [46337, 46340])
def test_remainder_at_the_largest_q(q):
    """At the largest q the wrapper takes: every multiple of q in [0, 2 q^2)
    and its neighbours, 10^6 seeded samples, and the ends of uint32."""
    k = np.arange(2 * q, dtype=np.uint64) * np.uint64(q)
    x = np.concatenate([k, k + 1, k[1:] - 1,
                        np.array([2 * q * q - 1, 0xFFFFFFFF], np.uint64),
                        np.random.default_rng(q).integers(
                            0, 2 * q * q, 10 ** 6, dtype=np.uint64)])
    assert 2 * q * q - 1 <= 0xFFFFFFFF
    assert np.array_equal(_mod_q(x, q), x % np.uint64(q))


@pytest.mark.parametrize("q", [2, 3, 4, 9, 12, 31, 79, 46337, 46340])
def test_power_table_matches_plain_power(q):
    """The table equals the plain version's Fermat power, 0 -> 0 and, at
    q = 2 (exponent 0), 0 -> 1, composite q included."""
    from repro_torch.kernels.gf_crossprod.ref import _pow_mod

    want = _pow_mod(torch.arange(q, dtype=torch.int32), q - 2, q).numpy()
    got = _power_table(q)
    assert np.array_equal(got, want)
    assert got[0] == (1 if q == 2 else 0)


# (n, m): up to (11, 3) fewer than 128 pairs, all scalar tail (n m mod 4 =
# 1, 3, 3, 2, 1); (1300, 1) to (1299, 3) 10 to 30 128-pair chunks with
# m < 4, so rows change inside a lane's four pairs and, on the 8-warp
# grid, the stride step wraps rows (n m mod 4 = 0, 2, 3, 1); then two wide
# shapes
EMULATED = [(1, 1), (5, 7), (7, 1), (9, 2), (11, 3), (1300, 1), (1001, 2),
            (1001, 3), (1299, 3), (300, 257), (993, 993)]


@pytest.mark.parametrize("q", [2, 9, 12, 31, 79, 46337])
@pytest.mark.parametrize("n,m", EMULATED)
def test_kernel_emulation_equals_plain_version(n, m, q):
    """The emulated kernel, on grids of one block (8 warps) and of 37 warps
    (so the stride walk wraps rows many times) and on the launcher's own
    wave, bit for bit equal to `crossprod_normalized_ref`, prime and
    composite q."""
    s, d = _inputs(n, m, q)
    want = crossprod_normalized_ref(torch.from_numpy(s), torch.from_numpy(d),
                                    q).numpy()
    for warps in {WARPS_PER_BLOCK, 37, _wave_warps(n, m, q)}:
        assert np.array_equal(_emulate_kernel(s, d, q, warps), want), warps


def test_kernel_emulation_on_pf31_vertices():
    """PF(31)'s vertex list against itself, as `intermediate_table` calls
    the kernel, equal to the JAX package's plain version."""
    pf = build_polarfly(31)
    v = np.asarray(pf.vertices, dtype=np.int32)
    want = np.asarray(r_ref(jnp.asarray(v), jnp.asarray(v), 31))
    assert np.array_equal(_emulate_kernel(v, v, 31, _wave_warps(pf.n, pf.n, 31)),
                          want)


@pytest.mark.parametrize("q", [2, 31, 1290, 1291, 46340])
def test_vector_code_width(q):
    """`intermediate_table`'s code (w0 q + w1) q + w2: int32 up to q = 1290
    (q^3 < 2^31), int64 above, equal to the int64 formula either way, at
    the largest entries and at random ones."""
    rng = np.random.default_rng(q)
    w = rng.integers(0, q, (64, 5, 3)).astype(np.int32)
    w[0, 0] = q - 1
    got = ops._vector_code(torch.from_numpy(w), q)
    want = (w[..., 0].astype(np.int64) * q + w[..., 1]) * q + w[..., 2]
    assert got.dtype == (torch.int32 if q <= 1290 else torch.int64)
    assert np.array_equal(got.numpy(), want)


def test_intermediate_table_rejects_entries_outside_the_field():
    with pytest.raises(ValueError, match=r"\[0, 7\)"):
        ops.intermediate_table(np.array([[0, 1, 7]]), 7, device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 7\)"):
        ops.intermediate_table(np.array([[0, -1, 2]]), 7, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 7, 9, 12, 31, 79])
@pytest.mark.parametrize("n,m", SIZES + [(993, 993)])
def test_crossprod_kernel_bit_identical_on_card(n, m, q):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    s, d = _inputs(n, m, q)
    ts, td = torch.from_numpy(s).cuda(), torch.from_numpy(d).cuda()
    before = ops.LAUNCHES
    out = ops.crossprod_normalized(ts, td, q)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert torch.equal(out, crossprod_normalized_ref(ts, td, q))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [7, 31])
def test_intermediate_table_on_card_matches_host(q):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pf = build_polarfly(q)
    got = ops.intermediate_table(pf.vertices, q, device="cuda")
    off = ~np.eye(pf.n, dtype=bool)
    assert np.array_equal(got[off], pf.intermediates_all_pairs()[off])


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 9, 12, 46337, 46340])
@pytest.mark.parametrize("n,m", [(7, 1), (9, 2), (11, 3), (5, 7), (37, 41),
                                 (129, 131), (300, 1), (97, 2), (131, 3),
                                 (129, 3), (900001, 1), (500001, 2),
                                 (300001, 3)])
def test_crossprod_kernel_edges_on_card(n, m, q):
    """The largest q (a 92.7 KB power table: dynamic shared memory above
    48 KB), composite q, q = 2, n m = 1, 2, 3 mod 4 in the scalar tail, and
    with m < 4 over whole 128-pair chunks, where rows change inside a
    lane's four pairs -- the last three with more chunks than the
    launcher's wave has warps, so the stride step runs too -- bit for bit
    against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    s, d = _inputs(n, m, q)
    ts, td = torch.from_numpy(s).cuda(), torch.from_numpy(d).cuda()
    out = ops.crossprod_normalized(ts, td, q)
    torch.cuda.synchronize()
    assert torch.equal(out, crossprod_normalized_ref(ts, td, q))
