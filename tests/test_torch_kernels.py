"""The port's path-cost reduction against the JAX package's.

On the CPU `repro_torch.kernels.minplus.ops.path_costs` runs its plain
PyTorch version; it must be bit-identical (tolerance 0) to the JAX
package's Pallas kernel in interpret mode and to its jnp reference, at the
shapes of tests/test_kernels.py::test_path_costs_pallas_matches_ref.  Both
sum the L axis in order, so this holds in float32.  In float64 the port is
held bit for bit against a numpy float64 sum in the same order (the JAX
package would need JAX_ENABLE_X64 process-wide for float64).

The CUDA kernel itself runs only on the card: its tests carry the `cuda`
marker and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.minplus.kernel import path_costs_pallas  # noqa: E402
from repro.kernels.minplus.ref import path_costs_ref as r_path_costs_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.minplus import ops  # noqa: E402
from repro_torch.kernels.minplus.ref import path_costs_ref  # noqa: E402

SHAPES = [(5, 3, 4), (300, 8, 5), (1, 1, 1)]


def _inputs(shape, dtype=np.float32):
    f, k, l = shape
    rng = np.random.default_rng(f * 7 + k * 3 + l)
    e = 37
    delay = np.concatenate([rng.random(e).astype(dtype) * 5,
                            np.zeros(1, dtype)])
    eidx = rng.integers(0, e + 1, size=(f, k, l)).astype(np.int32)
    return delay, eidx


@pytest.mark.parametrize("shape", SHAPES)
def test_path_costs_fp32_bit_identical_to_reference(shape):
    delay, eidx = _inputs(shape)
    pal = np.asarray(path_costs_pallas(jnp.asarray(delay), jnp.asarray(eidx),
                                       bf=256, interpret=True))
    ref = np.asarray(r_path_costs_ref(jnp.asarray(delay), jnp.asarray(eidx)))
    d, e = torch.from_numpy(delay), torch.from_numpy(eidx)
    plain = path_costs_ref(d, e).numpy()
    dispatched = ops.path_costs(d, e).numpy()
    for out in (plain, dispatched):
        assert out.dtype == np.float32 and out.shape == shape[:2]
        assert np.array_equal(out, pal)
        assert np.array_equal(out, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_path_costs_fp64_bit_identical_to_ordered_sum(shape):
    delay, eidx = _inputs(shape, np.float64)
    want = np.zeros(shape[:2], np.float64)
    for l in range(shape[2]):
        want = want + delay[eidx[..., l]]
    out = ops.path_costs(torch.from_numpy(delay), torch.from_numpy(eidx))
    assert out.dtype == torch.float64
    assert np.array_equal(out.numpy(), want)


def test_path_costs_cpu_does_not_count_launches():
    delay, eidx = _inputs((5, 3, 4))
    before = ops.LAUNCHES
    ops.path_costs(torch.from_numpy(delay), torch.from_numpy(eidx))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("bad", ["int64_eidx", "half_delay", "2d_delay",
                                 "strided_eidx"])
def test_path_costs_rejects_what_the_kernel_does_not_take(bad):
    delay, eidx = _inputs((6, 3, 4))
    d, e = torch.from_numpy(delay), torch.from_numpy(eidx)
    if bad == "int64_eidx":
        e, err = e.long(), TypeError
    elif bad == "half_delay":
        d, err = d.half(), TypeError
    elif bad == "2d_delay":
        d, err = d[None], ValueError
    else:
        e, err = e[::2], ValueError
    with pytest.raises(err):
        ops.path_costs(d, e)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A build that cannot run raises; it never falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("minplus")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def test_build_failure_raises_with_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="no such target"):
        _build.load("minplus")
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES + [(113040, 11, 4)])
def test_path_costs_kernel_bit_identical_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    delay, eidx = _inputs(shape, np.float64)
    d = torch.from_numpy(delay).to("cuda", dtype)
    e = torch.from_numpy(eidx).cuda()
    before = ops.LAUNCHES
    out = ops.path_costs(d, e)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert torch.equal(out, path_costs_ref(d, e))
