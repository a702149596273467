"""Shared helpers of the tests that hold the PyTorch port (`repro_torch`)
against the JAX package (`repro`)."""
import numpy as np
import pytest

FIELDS = ("edges", "hops", "valid", "is_min", "first_edge")


def to_port(fp):
    """The port's FlowPaths built from a `repro` FlowPaths' arrays, so both
    solvers see identical inputs."""
    from repro_torch.simulation.paths import FlowPaths

    arrays = {k: getattr(fp, k) for k in FIELDS}
    arrays["src"], arrays["dst"] = fp.pattern.src, fp.pattern.dst
    return FlowPaths.from_reference(arrays, fp.num_links, fp.mode,
                                    fp.pattern.demand)


def damage(g, q):
    """The damaged graphs of tests/test_simulation.py: a few edges removed,
    still connected, longer paths."""
    removed = g.edge_list[::9][:4] if q == 7 else g.edge_list[::11][:8]
    return g.subgraph_without_edges(removed)


def assert_same(a, b, ctx=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (ctx, a.dtype, b.dtype)
    assert np.array_equal(a, b), ctx


def hot_dst_pattern(traffic_mod, n):
    """Every other router sends to router 0: the incidence skew that makes
    `device_arrays` fall back to ("scatter",) once the padded-incidence cap
    is 0 (the pattern of tests/test_scatter_fallback.py)."""
    src = np.arange(1, n, dtype=np.int32)
    return traffic_mod.TrafficPattern("hot_dst", src,
                                      np.zeros(len(src), np.int32),
                                      np.ones(len(src), np.float32), 1)


TOL = 0.01  # bisection tolerance of the parity saturations
LATENCY_ITERS = 1000  # Frank-Wolfe steps of the adaptive latency parity
_RT, _FP, _SAT = {}, {}, {}


def ref_routing(q, which):
    """The JAX package's routing on PF(q), intact or damaged (cached)."""
    from repro.core.polarfly import build_polarfly
    from repro.core.routing import build_routing

    if (q, which) not in _RT:
        pf = build_polarfly(q)
        g = pf.graph if which == "intact" else damage(pf.graph, q)
        _RT[q, which] = build_routing(g, pf if which == "intact" else None)
    return _RT[q, which]


# Uniform traffic samples this many pairs (aggregating repeats), the
# branch the PF(31) main path takes, at a size the CPU suite can afford
# next to the JAX reference's own solves.  The exact all-pairs branch is
# held bit for bit by tests/test_torch_paths.py; the solver does not see
# which branch made its flows.
UNIFORM_MAX_FLOWS = 1000


def flow_paths(q, which, pattern, mode):
    """(reference FlowPaths, port FlowPaths) on identical arrays (cached):
    p = (q + 1) / 2 endpoints per router, seed 0, 8 candidates."""
    from repro.simulation import build_flow_paths, make_pattern

    key = (q, which, pattern, mode)
    if key not in _FP:
        rt = ref_routing(q, which)
        pat = make_pattern(pattern, rt, p=(q + 1) // 2, seed=0,
                           max_flows=UNIFORM_MAX_FLOWS)
        fp = build_flow_paths(rt, pat, mode, k_candidates=8, seed=0)
        _FP[key] = (fp, to_port(fp))
    return _FP[key]


def ref_saturation(q, which, pattern, mode):
    """The JAX package's batched saturation at `TOL`, iters = 250 (cached)."""
    from repro.simulation import saturation_throughput

    key = (q, which, pattern, mode)
    if key not in _SAT:
        _SAT[key] = saturation_throughput(flow_paths(*key)[0], tol=TOL,
                                          iters=250)
    return _SAT[key]


def assert_results_close(a, b, rel):
    """FluidResult fields of `b` within `rel` of `a`'s."""
    for f in ("accepted", "max_util", "mean_latency", "mean_hops"):
        assert getattr(b, f) == pytest.approx(getattr(a, f), rel=rel), f


def adaptive_parity_tests(grid):
    """The adaptive-mode parity tests over `grid`, a list of (q, which,
    pattern).  Test files take a slice each, so that pytest-xdist's
    per-file distribution spreads the solves.

    Latency curves within 1e-3 relative at loads below saturation (0.25,
    0.5 and 0.75 of the reference's saturation) with 1000 Frank-Wolfe
    steps; saturations within 0.05.  Why 1000 steps and not 250: a
    250-step iterate is still chaotic in its last bits wherever the
    UGAL_PF gate or the capped M/D/1 delay is active -- below saturation
    the reference's own max_util and mean_latency move by up to 4.5e-3 and
    1.8e-2 when its demand moves by one ulp
    (`scripts/reference_sensitivity.py`) -- while at 1000 steps the port
    stays within 5.5e-4 of the reference on this grid.
    """
    import repro.simulation as R
    import repro_torch.simulation as T

    params = [(q, which, pattern, mode) for q, which, pattern in grid
              for mode in ("ugal", "ugal_pf")]

    @pytest.mark.parametrize("q,which,pattern,mode", params)
    def latency_curve_matches(q, which, pattern, mode):
        fp, tfp = flow_paths(q, which, pattern, mode)
        sat = ref_saturation(q, which, pattern, mode)
        loads = [f * sat for f in (0.25, 0.5, 0.75)]
        ref = R.latency_curve(fp, loads, iters=LATENCY_ITERS)
        port = T.latency_curve(tfp, loads, iters=LATENCY_ITERS, device="cpu")
        for a, b in zip(ref, port):
            assert b.offered == a.offered
            assert_results_close(a, b, 1e-3)

    @pytest.mark.parametrize("q,which,pattern,mode", params)
    def saturation_matches(q, which, pattern, mode):
        _, tfp = flow_paths(q, which, pattern, mode)
        sat = T.saturation_throughput(tfp, tol=TOL, iters=250, device="cpu")
        assert abs(sat - ref_saturation(q, which, pattern, mode)) <= 0.05

    return latency_curve_matches, saturation_matches


# -- the certified engine -------------------------------------------------

_CERT_FP, _CERT_SAT = {}, {}
CERT_TOL = 0.02  # bisection tolerance of the certified saturation parity
CERT_ITERS = 3000  # their certified budget (tests/test_certified.py's)


def cert_flow_paths(mode, damaged=False):
    """(reference FlowPaths, port FlowPaths) on the graphs of
    tests/test_certified.py (cached): PF(13), intact or with every 7th of
    its first 42 links removed, random_perm traffic, p = 7, seed 0,
    6 candidates from seed 5."""
    from repro.core.polarfly import build_polarfly
    from repro.core.routing import build_routing
    from repro.simulation import build_flow_paths, make_pattern

    key = (mode, damaged)
    if key not in _CERT_FP:
        pf = build_polarfly(13)
        if damaged:
            g = pf.graph.subgraph_without_edges(pf.graph.edge_list[::7][:6])
            rt = build_routing(g)
        else:
            rt = build_routing(pf.graph, pf)
        pat = make_pattern("random_perm", rt, p=7, seed=0)
        kw = {} if mode == "min" else dict(k_candidates=6, seed=5)
        fp = build_flow_paths(rt, pat, mode, **kw)
        _CERT_FP[key] = (fp, to_port(fp))
    return _CERT_FP[key]


def cert_saturations(mode, damaged):
    """(reference, port) certified saturations at `CERT_TOL` and
    `CERT_ITERS` on `cert_flow_paths(mode, damaged)` (cached)."""
    from repro.simulation import saturation_throughput as r_sat
    from repro_torch.simulation import saturation_throughput as t_sat

    key = (mode, damaged)
    if key not in _CERT_SAT:
        fp, tfp = cert_flow_paths(mode, damaged)
        _CERT_SAT[key] = (
            r_sat(fp, tol=CERT_TOL, certify=True, cert_iters=CERT_ITERS),
            t_sat(tfp, tol=CERT_TOL, certify=True, cert_iters=CERT_ITERS,
                  device="cpu"))
    return _CERT_SAT[key]


def certified_saturation_tests(mode, damaged):
    """The certified-saturation tests on one graph of
    `cert_flow_paths`.  Test files take one case each, so that
    pytest-xdist's per-file distribution spreads the solves (a PF(13) ugal
    certified saturation is ~11,000 eager steps, ~35 s on one CPU core).

    Port against reference: values within 0.06 (the bar between
    tests/test_certified.py's certified and batched engines), `sat_lo` and
    `sat_hi` each within one bisection step (`CERT_TOL`), the same `kind`.
    Port's certified against port's batched saturation at iters = 3000:
    within 0.06, with tests/test_certified.py's checks of the certificate
    and the bracket."""
    from repro_torch.simulation import CertifiedResult, saturation_throughput

    def port_matches_reference():
        ref, port = cert_saturations(mode, damaged)
        assert isinstance(port, CertifiedResult)
        assert abs(port.value - ref.value) <= 0.06
        assert abs(port.sat_lo - ref.sat_lo) <= CERT_TOL + 1e-9
        assert abs(port.sat_hi - ref.sat_hi) <= CERT_TOL + 1e-9
        assert port.cert.kind == ref.cert.kind
        assert port.cert.dtype == ref.cert.dtype == "float32"

    def certified_agrees_with_batched():
        _, tfp = cert_flow_paths(mode, damaged)
        _, res = cert_saturations(mode, damaged)
        sat_b = saturation_throughput(tfp, tol=CERT_TOL, iters=CERT_ITERS,
                                      device="cpu")
        assert abs(res.value - sat_b) <= 0.06
        assert res.cert.kind == ("duality-gap" if mode == "ugal"
                                 else "gated-residual")
        assert np.isfinite(res.cert.gap)
        assert res.cert.iters > 0
        assert res.sat_lo <= res.value + 1e-6
        assert res.sat_lo <= res.sat_hi + 1e-6

    return port_matches_reference, certified_agrees_with_batched


# -- the model slice ------------------------------------------------------

DENSE = ["gemma2-9b", "qwen2-0.5b", "qwen3-4b", "nemotron-4-340b",
         "qwen2-vl-72b"]
MOE = ["deepseek-moe-16b", "qwen2-moe-a2.7b"]
# scaled_down gives the hybrid 2 layers: no (rec, rec, attn) group, so no
# attention.  5 layers are one group and 2 tail layers.
GRIFFIN = {"num_layers": 5}


def reference_pair(name, use_pallas=True, **overrides):
    """(JAX model, its float32 params, the port's model on the CPU with the
    same params) for `name` scaled down (then `overrides`); the JAX forward
    runs its Pallas kernel in interpret mode (`use_pallas`), else its plain
    attention."""
    import jax

    from repro.configs import get_config as r_get_config
    from repro.models import build_model as r_build_model
    from repro_torch.configs import get_config
    from repro_torch.models.api import model_parts
    from repro_torch.models.convert import params_from_reference

    rcfg = r_get_config(name).scaled_down(dtype="float32", **overrides)
    rmodel = r_build_model(rcfg, use_pallas=use_pallas, remat="none")
    rparams = rmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(name).scaled_down(dtype="float32", **overrides)
    port = model_parts(cfg)[1](cfg, params_from_reference(
        jax.tree.map(np.asarray, rparams), device="cpu"))
    return rmodel, rparams, port


def frames_for(cfg, b, seed=0):
    """[b, encoder_frames, d_model] float32 encoder frames (an enc-dec
    model's input) from numpy, seeded, at the serve CLI's scale 0.1."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.encoder_frames, cfg.d_model))
            * 0.1).astype(np.float32)


def tokens_for(cfg, b, s, seed=0):
    """[b, s] int32 token ids from numpy, seeded."""
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


# Table V's competitors at small sizes, (constructor, arguments), the same
# in both packages: SF(5), DF(4, 2) (adaptive paths of L = 6, as at the
# paper's sizes), JF(60, 6, seed 0), FT(4, 3) (ecmp paths of L = 8)
TABLE5_SMALL = {"SF": ("build_slimfly", (5,)),
                "DF1": ("build_dragonfly", (4, 2)),
                "JF": ("build_jellyfish", (60, 6, 0)),
                "FT": ("build_fat_tree", (4, 3))}


def smoke_module():
    """chip_smoke.py as a module (loaded once)."""
    import importlib.util
    import os
    import sys

    if "chip_smoke" not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py")
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["chip_smoke"] = mod
    return sys.modules["chip_smoke"]


def long_path_inputs(name, mode):
    """(delay [E + 1] float64 with the pad slot 0, eidx [F, K, L] int32)
    on the port's flows of `TABLE5_SMALL[name]`'s uniform traffic in
    `mode` (bench_fig8_saturation.py's, `chip_smoke.table5_traffic`), pads
    remapped to E; the delays in [1, 5) from default_rng(L)."""
    from repro_torch.core import topologies
    from repro_torch.core.routing import build_routing
    from repro_torch.simulation import build_flow_paths, make_pattern

    fn, args = TABLE5_SMALL[name]
    rt = build_routing(getattr(topologies, fn)(*args))
    p, hosts = smoke_module().table5_traffic(rt.graph)
    fp = build_flow_paths(rt, make_pattern("uniform", rt, p=p, hosts=hosts,
                                           seed=0),
                          mode, k_candidates=10, seed=0)
    eidx = fp.device_arrays("cpu")[0].numpy()
    rng = np.random.default_rng(eidx.shape[-1])
    delay = np.concatenate([1.0 + rng.random(fp.num_links) * 4,
                            np.zeros(1)])
    return delay, eidx


def _one_thread_per_worker():
    # pytest-xdist runs about one worker per core, and each would start one
    # PyTorch (OpenMP) intra-op thread per core: oversubscribed, spinning
    # threads made these tests a hundred times slower
    import torch

    torch.set_num_threads(1)


_one_thread_per_worker()
