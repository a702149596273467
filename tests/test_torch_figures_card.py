"""The generic path-cost kernel (L > 4) at an expanded PolarFly's path
width on the card: the non-quadric x2 PF(13)'s uniform ugal_pf flows
[F, 9, 6] (bench_fig11_expansion.py's replication; diameter 3), built by
the port alone (tests/test_torch_figures.py holds the same graph, routing
and FlowPaths bit for bit against the JAX package on the CPU), held bit
for bit against the plain version in float32 and float64.  At the paper's
size chip_smoke.py's ``figures`` phase does the same at [114,329, 9, 6].
No JAX here."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

Q, P, STEPS = 13, 14, 2  # tests/test_torch_figures.py's Fig. 11 graph
_INPUTS = []


def expanded_inputs():
    """(delay table with its pad slot, edge ids) of the non-quadric x2
    PF(13)'s uniform ugal_pf flows (k_candidates 8, seed 0), cached."""
    if not _INPUTS:
        from repro_torch.core.expansion import expand
        from repro_torch.core.layout import build_layout
        from repro_torch.core.polarfly import build_polarfly
        from repro_torch.core.routing import build_routing
        from repro_torch.simulation import build_flow_paths, make_pattern

        g = expand(build_layout(build_polarfly(Q)), STEPS,
                   "nonquadric").graph
        rt = build_routing(g)
        pat = make_pattern("uniform", rt, p=P, seed=0)
        fp = build_flow_paths(rt, pat, "ugal_pf", k_candidates=8, seed=0)
        delay = np.random.default_rng(0).uniform(
            1.0, 4.0, fp.num_links + 1).astype(np.float32)
        delay[-1] = 0.0
        eidx = np.where(fp.edges >= 0, fp.edges,
                        fp.num_links).astype(np.int32)
        _INPUTS.append((delay, eidx))
    return _INPUTS[0]


def test_expanded_inputs_are_the_generic_kernel_width():
    """The card case's inputs on the CPU: L = 6, a pad slot of 0 that
    some paths use."""
    delay, eidx = expanded_inputs()
    assert eidx.shape[1:] == (9, 6) and eidx.dtype == np.int32
    assert delay[-1] == 0.0 and 0 <= eidx.min()
    assert eidx.max() == len(delay) - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_expanded_path_costs_kernel_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import path_costs_ref

    delay, eidx = expanded_inputs()
    d = torch.from_numpy(delay).to("cuda", dtype)
    e = torch.from_numpy(eidx).cuda()
    assert ops._path_costs_plan(e.shape[0] * e.shape[1], e.shape[2],
                                e.data_ptr())["rows"] == 0  # generic route
    before = ops.LAUNCHES
    out = ops.path_costs(d, e)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert torch.equal(out, path_costs_ref(d, e))
