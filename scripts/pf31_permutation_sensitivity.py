"""How far do the PF(31) random_perm adaptive saturations move under a
one-ulp change of demand, in the JAX reference and in the PyTorch port?

The main path's PF(31) random_perm cells (992 flows, p = 16, seed 0,
`k_candidates=10`, `tol=0.01`) are where the port's adaptive saturations
sit furthest from the JAX package's recorded values.  This script measures,
for modes `ugal` and `ugal_pf`, the batched saturation with every demand
as built, moved up by one float32 ulp and moved down by one, at each
Frank-Wolfe budget given (the main path's is 1500):

  reference  -- `repro` (JAX), on the CPU (skipped with --no-reference);
  port       -- `repro_torch` on --device, its flow paths built by the
                port itself and checked equal to the reference's when the
                reference runs.

A spread across the three demands as wide as the port-reference gap says
that gap is the step-limited iterate's chaos in its last bits, not a port
fault.  The port on the CPU and on the card should agree with each other
whenever the reference is not needed to explain them.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/pf31_permutation_sensitivity.py
    PYTHONPATH=src python scripts/pf31_permutation_sensitivity.py --device cuda --no-reference

Prints one CSV row per saturation.
"""
import argparse
import copy
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

Q, P, SEED, K_CANDIDATES, TOL = 31, 16, 0, 10, 0.01
MODES = ("ugal", "ugal_pf")
FIELDS = ("edges", "hops", "valid", "is_min", "first_edge")
NUDGES = {"as_built": 0, "+1ulp": 1, "-1ulp": -1}


def nudge(fp, pattern_type, step):
    """A shallow copy of `fp` with every demand moved `step` float32 ulps."""
    out = copy.copy(fp)
    out._device = type(fp._device)() if isinstance(fp._device, dict) else None
    p = fp.pattern
    demand = p.demand
    if step:
        demand = np.nextafter(demand, np.float32(np.inf * step))
    out.pattern = pattern_type(p.name, p.src, p.dst, demand,
                               p.endpoints_per_router)
    return out


def build(pkg):
    """FlowPaths per mode for PF(31) random_perm, built by `pkg`."""
    import importlib

    polarfly = importlib.import_module(pkg + ".core.polarfly")
    routing = importlib.import_module(pkg + ".core.routing")
    sim = importlib.import_module(pkg + ".simulation")
    pf = polarfly.build_polarfly(Q)
    rt = routing.build_routing(pf.graph, pf)
    pat = sim.make_pattern("random_perm", rt, p=P, seed=SEED)
    return {m: sim.build_flow_paths(rt, pat, m, k_candidates=K_CANDIDATES,
                                    seed=SEED) for m in MODES}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--no-reference", action="store_true")
    ap.add_argument("--iters", type=int, nargs="+", default=[1500, 3000])
    args = ap.parse_args()

    import repro_torch.simulation as T
    from repro_torch.simulation.traffic import TrafficPattern as TPat

    runs = [("port", args.device, T.saturation_throughput, TPat,
             build("repro_torch"), {"device": args.device})]
    if not args.no_reference:
        import repro.simulation as R
        from repro.simulation.traffic import TrafficPattern as RPat

        ref = build("repro")
        for mode in MODES:
            for f in FIELDS:
                assert np.array_equal(getattr(ref[mode], f),
                                      getattr(runs[0][4][mode], f)), (mode, f)
            assert np.array_equal(ref[mode].pattern.demand,
                                  runs[0][4][mode].pattern.demand), mode
        runs.insert(0, ("reference", "cpu", R.saturation_throughput, RPat,
                        ref, {}))

    print("impl,device,mode,iters,demand,saturation,wall_s", flush=True)
    for impl, dev, sat_fn, pat_type, fps, kw in runs:
        for mode in MODES:
            for iters in args.iters:
                for name, step in NUDGES.items():
                    fp = nudge(fps[mode], pat_type, step)
                    t0 = time.perf_counter()
                    sat = sat_fn(fp, tol=TOL, iters=iters, **kw)
                    wall = time.perf_counter() - t0
                    print(f"{impl},{dev},{mode},{iters},{name},{sat!r},"
                          f"{wall:.3f}", flush=True)


if __name__ == "__main__":
    main()
