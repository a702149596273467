"""How far can a correct port sit from the JAX reference's fluid solver?

For adaptive modes the Frank-Wolfe iterate after a fixed step budget is
not converged, and in places it is chaotic in its last bits: which of two
nearly tied candidates a flow picks at some step decides the rest of the
trajectory.  This script measures that on the CPU, with the reference
alone and then with the port:

  nudged  -- the reference against itself with every demand moved up by
             one float32 ulp;
  port    -- the port (`repro_torch`, on the CPU) against the reference on
             identical inputs;

as the largest relative difference of max_util and mean_latency over a
latency curve, at loads below saturation (0.25, 0.5, 0.75 of the
reference's saturation) and past it (1.5, 2, 3 times), at 250 and 1000
Frank-Wolfe steps.  A bar tighter than the `nudged` column cannot be met by
any implementation that is not bit-identical to the reference.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_sensitivity.py
"""
import copy
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro.simulation as R  # noqa: E402
import repro_torch.simulation as T  # noqa: E402
from _torch_port import flow_paths, ref_saturation  # noqa: E402
from repro.simulation.traffic import TrafficPattern  # noqa: E402

CASES = [(q, which, pattern, mode) for q in (7, 13)
         for which in ("intact", "damaged")
         for pattern in ("random_perm", "uniform")
         for mode in ("ugal", "ugal_pf")]
REGIMES = {"below": (0.25, 0.5, 0.75), "past": (1.5, 2.0, 3.0)}


def nudged(fp):
    out = copy.copy(fp)
    out._device = None
    p = fp.pattern
    out.pattern = TrafficPattern(p.name, p.src, p.dst,
                                 np.nextafter(p.demand, np.float32(np.inf)),
                                 p.endpoints_per_router)
    return out


def spread(a, b, field):
    return max(abs(getattr(x, field) - getattr(y, field))
               / abs(getattr(x, field)) for x, y in zip(a, b))


def main():
    print("case,regime,iters,nudged_max_util,nudged_latency,"
          "port_max_util,port_latency")
    for case in CASES:
        fp, tfp = flow_paths(*case)
        sat = ref_saturation(*case)
        for regime, fracs in REGIMES.items():
            loads = [min(f * sat, 1.0) for f in fracs]
            for iters in (250, 1000):
                ref = R.latency_curve(fp, loads, iters=iters)
                nud = R.latency_curve(nudged(fp), loads, iters=iters)
                port = T.latency_curve(tfp, loads, iters=iters, device="cpu")
                name = "PF({}) {} {} {}".format(*case)
                print(f"{name},{regime},{iters},"
                      f"{spread(ref, nud, 'max_util'):.2e},"
                      f"{spread(ref, nud, 'mean_latency'):.2e},"
                      f"{spread(ref, port, 'max_util'):.2e},"
                      f"{spread(ref, port, 'mean_latency'):.2e}",
                      flush=True)


if __name__ == "__main__":
    main()
