"""Compare PolarFly against Slim Fly / Dragonfly / Jellyfish on the
PyTorch port: saturation under uniform + adversarial traffic, bisection,
and resilience -- the table of examples/topology_explorer.py, with the
fluid solver on the card.

  PYTHONPATH=src python examples/topology_explorer_torch.py
  PYTHONPATH=src python examples/topology_explorer_torch.py --device cpu

Under BENCH_SMOKE=1 the table shrinks to PF(7)/DF(4,2) and a reduced
Frank-Wolfe budget, as the JAX example's does.  Graphs, routing and paths
are built on the host (numpy); the saturations run on `--device` (the
card by default: without one the script raises, and `--device cpu` runs
the plain PyTorch path).  The adaptive column also reports the solver's
truncation-error estimate (`SaturationResult.truncation_err`).
"""
import argparse
import os

from repro_torch.core import topologies as tp
from repro_torch.core.metrics import bisection_fraction, resilience_sweep
from repro_torch.core.polarfly import build_polarfly
from repro_torch.core.routing import build_routing
from repro_torch.simulation import (build_flow_paths, make_pattern,
                                    saturation_throughput)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the fluid solver runs (cuda or cpu)")
    device = ap.parse_args().device
    smoke = os.environ.get("BENCH_SMOKE", "0") not in ("", "0")
    if smoke:
        graphs = {
            "PolarFly(7)": (build_polarfly(7).graph, build_polarfly(7)),
            "Dragonfly(4,2)": (tp.build_dragonfly(4, 2), None),
        }
        iters = 300
    else:
        graphs = {
            "PolarFly(13)": (build_polarfly(13).graph, build_polarfly(13)),
            "SlimFly(9)": (tp.build_slimfly(9), None),
            "Dragonfly(6,3)": (tp.build_dragonfly(6, 3), None),
            "Jellyfish(183,14)": (tp.build_jellyfish(183, 14, seed=0), None),
        }
        iters = 1500  # the JAX example's convergence-grade budget
    print(f"{'topology':20s} {'N':>5s} {'radix':>5s} {'unif(min)':>9s} "
          f"{'adv(min)':>8s} {'adv(UGAL)':>9s} {'fw_err':>7s} "
          f"{'bisect':>7s} {'diam@20%fail':>12s}")
    for name, (g, pf) in graphs.items():
        rt = build_routing(g, pf)
        p = max(2, g.params.get("radix", 8) // 2)
        uni = make_pattern("uniform", rt, p=p, seed=0)
        adv = make_pattern("random_perm", rt, p=p, seed=0)
        s_uni = saturation_throughput(build_flow_paths(rt, uni, "min"),
                                      tol=0.02, device=device)
        s_adv = saturation_throughput(build_flow_paths(rt, adv, "min"),
                                      tol=0.02, device=device)
        res_ug = saturation_throughput(
            build_flow_paths(rt, adv, "ugal", k_candidates=10), tol=0.02,
            iters=iters, return_info=True, device=device)
        bis = bisection_fraction(g)
        res = resilience_sweep(g, [0.2], seed=0)[0].diameter
        print(f"{name:20s} {g.n:5d} {g.params.get('radix','?'):>5} "
              f"{s_uni:9.3f} {s_adv:8.3f} {res_ug.saturation:9.3f} "
              f"{res_ug.truncation_err:7.4f} {bis:7.3f} {res:12d}")


if __name__ == "__main__":
    main()
