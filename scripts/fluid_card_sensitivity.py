"""How far does the fluid solver on the card sit from the same solver on the
CPU, and is that difference the solver's own last-bit chaos?

For PF(7) uniform (p = 4, seed 0, 8 candidates, the inputs of
tests/test_torch_fluid.py::test_card_matches_cpu_and_counts_launches) and
each routing mode, prints one JSON line with:

  saturation     the port's saturation on the CPU (tol 0.01, 1000 steps),
                 and whether load 0.4 lies past it;
  at_0.4         max_util at load 0.4 after 100 and 1000 Frank-Wolfe steps:
                 card against CPU, and CPU against CPU with every demand
                 moved up by one float32 ulp (`nudged`, the method of
                 scripts/reference_sensitivity.py): a card-vs-CPU gap no
                 larger than the nudged one is last-bit chaos, not a fault;
  below          the same relative differences of max_util and mean
                 latency at 0.25, 0.5 and 0.75 of the saturation, 1000
                 steps (the loads the adaptive CPU parity tests use).

Needs a CUDA card and the JAX package (the reference builds the paths):

    PYTHONPATH=src:tests python scripts/fluid_card_sensitivity.py
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch  # noqa: E402

import repro_torch.simulation as T  # noqa: E402
from _torch_port import FIELDS, flow_paths  # noqa: E402


def nudged(fp):
    """The port's FlowPaths of reference `fp` with every demand one ulp up."""
    arrays = {k: getattr(fp, k) for k in FIELDS}
    arrays["src"], arrays["dst"] = fp.pattern.src, fp.pattern.dst
    demand = np.nextafter(np.asarray(fp.pattern.demand, np.float32),
                          np.float32(np.inf))
    return T.FlowPaths.from_reference(arrays, fp.num_links, fp.mode, demand)


def rel(a, b, field):
    return abs(getattr(a, field) - getattr(b, field)) / abs(getattr(a, field))


def main():
    if not torch.cuda.is_available():
        print("fluid_card_sensitivity: needs a CUDA card", file=sys.stderr)
        return 2
    for mode in ("min", "ugal", "ugal_pf"):
        fp, tfp = flow_paths(7, "intact", "uniform", mode)
        nfp = nudged(fp)
        sat = T.saturation_throughput(tfp, tol=0.01, iters=1000,
                                      device="cpu")
        row = {"case": "PF(7) uniform", "mode": mode, "saturation_cpu": sat,
               "load_0.4_past_saturation": 0.4 > sat, "at_0.4": {}}
        for iters in (100, 1000):
            cpu = T.evaluate_load(tfp, 0.4, iters=iters, device="cpu")
            gpu = T.evaluate_load(tfp, 0.4, iters=iters, device="cuda")
            nud = T.evaluate_load(nfp, 0.4, iters=iters, device="cpu")
            row["at_0.4"][iters] = {
                "max_util_cpu": cpu.max_util, "max_util_card": gpu.max_util,
                "card_vs_cpu": rel(cpu, gpu, "max_util"),
                "nudged_vs_cpu": rel(cpu, nud, "max_util")}
        loads = [f * sat for f in (0.25, 0.5, 0.75)]
        cpu = T.latency_curve(tfp, loads, iters=1000, device="cpu")
        gpu = T.latency_curve(tfp, loads, iters=1000, device="cuda")
        row["below"] = {
            "loads": loads,
            "max_util": max(rel(a, b, "max_util") for a, b in zip(cpu, gpu)),
            "mean_latency": max(rel(a, b, "mean_latency")
                                for a, b in zip(cpu, gpu))}
        print(json.dumps(row), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
