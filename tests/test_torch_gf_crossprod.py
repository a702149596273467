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


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 7, 31, 79])
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
