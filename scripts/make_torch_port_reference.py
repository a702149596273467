"""Record the JAX package's PF(31) saturations that `chip_smoke.py` holds the
PyTorch port against.

Runs the reference (`repro`, JAX on the CPU) over the same grid the smoke
script's `main_path` phase drives: PolarFly PF(31), p = 16 endpoints per
router, `seed=0`, `uniform` and `random_perm` traffic, modes `min`, `ugal`
and `ugal_pf` with `k_candidates=10`, `saturation_throughput(tol=0.01)` on
the batched engine with 250 Frank-Wolfe iterations for `min` and 1500 for
the adaptive modes.  Writes `tests/fixtures/torch_port_pf31_reference.json`.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py
"""
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from repro.core.polarfly import build_polarfly  # noqa: E402
from repro.core.routing import build_routing  # noqa: E402
from repro.simulation import (build_flow_paths, make_pattern,  # noqa: E402
                              saturation_throughput)

Q, P, SEED, K_CANDIDATES, TOL = 31, 16, 0, 10, 0.01
ITERS = {"min": 250, "ugal": 1500, "ugal_pf": 1500}
PATTERNS = ("uniform", "random_perm")
OUT = os.path.join(ROOT, "tests", "fixtures",
                   "torch_port_pf31_reference.json")


def main():
    pf = build_polarfly(Q)
    rt = build_routing(pf.graph, pf)
    rows = []
    for pattern in PATTERNS:
        pat = make_pattern(pattern, rt, p=P, seed=SEED)
        for mode, iters in ITERS.items():
            fp = build_flow_paths(rt, pat, mode, k_candidates=K_CANDIDATES,
                                  seed=SEED)
            t0 = time.perf_counter()
            sat = saturation_throughput(fp, tol=TOL, iters=iters)
            wall = time.perf_counter() - t0
            f, k, l = fp.edges.shape
            rows.append({"pattern": pattern, "mode": mode, "iters": iters,
                         "saturation": float(sat), "flows": f,
                         "candidates": k, "path_len": l,
                         "num_links": fp.num_links,
                         "cpu_wall_s": round(wall, 1)})
            print(json.dumps(rows[-1]), flush=True)
    doc = {"source": "repro (JAX package), batched engine, CPU",
           "script": "scripts/make_torch_port_reference.py",
           "jax": jax.__version__,
           "config": {"q": Q, "p": P, "seed": SEED,
                      "k_candidates": K_CANDIDATES, "tol": TOL},
           "saturations": rows}
    with open(OUT, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
