"""The generic path-cost kernel (L > 4) at the Table V competitors' path
widths on the card: DF(4, 2)'s adaptive flows [F, 11, 6] and FT(4, 3)'s
ecmp flows [F, 10, 8] (uniform traffic, bench_fig8_saturation.py's p and
hosts), built by the port alone (`_torch_port.long_path_inputs`, which
tests/test_torch_table5.py holds against the JAX package on the CPU), held
bit for bit against the plain version in float32 and float64.  At the
paper's sizes chip_smoke.py's ``table5`` phase does the same at
[112,651, 11, 6].  No JAX here."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port import long_path_inputs  # noqa: E402

CASES = {"DF(4,2) ugal": ("DF1", "ugal", (11, 6)),
         "FT(4,3) ecmp": ("FT", "ecmp", (10, 8))}


def _inputs(case):
    name, mode, shape = CASES[case]
    delay, eidx = long_path_inputs(name, mode)
    assert eidx.shape[1:] == shape
    return delay, eidx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_table5_path_costs_kernel_at_long_paths_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import path_costs_ref

    delay, eidx = _inputs(case)
    d = torch.from_numpy(delay).to("cuda", dtype)
    e = torch.from_numpy(eidx).cuda()
    assert ops._path_costs_plan(e.shape[0] * e.shape[1], e.shape[2],
                                e.data_ptr())["rows"] == 0  # generic route
    before = ops.LAUNCHES
    out = ops.path_costs(d, e)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert torch.equal(out, path_costs_ref(d, e))


def test_table5_card_inputs_are_the_long_path_widths():
    """The card case's inputs on the CPU: the widths and a pad slot of 0."""
    for case in CASES:
        delay, eidx = _inputs(case)
        assert delay[-1] == 0.0 and eidx.dtype == np.int32
        assert 0 <= eidx.min() and eidx.max() == len(delay) - 1
