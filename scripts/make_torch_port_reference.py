"""Record the JAX package's PF(31) saturations that `chip_smoke.py` holds the
PyTorch port against.

Runs the reference (`repro`, JAX on the CPU) over the same grid the smoke
script's `main_path` phase drives: PolarFly PF(31), p = 16 endpoints per
router, `seed=0`, `uniform` and `random_perm` traffic, modes `min`, `ugal`
and `ugal_pf` with `k_candidates=10`, `saturation_throughput(tol=0.01)` on
the batched engine with 250 Frank-Wolfe iterations for `min` and 1500 for
the adaptive modes.  Writes `tests/fixtures/torch_port_pf31_reference.json`.

With `--certified` it records instead the certified saturations that the
smoke script's `certified` phase holds the port against:
`saturation_throughput(tol=0.01, certify=True)` at the default budget in
float32 for `random_perm` ugal and ugal_pf and `uniform` ugal, each with
its certificate and certified bracket, and each again with every demand
moved one float32 ulp up and one down (`ulp_runs`): the certified iterate
is chaotic in its last bits, and a bracket end the reference itself moves
by a bisection step under a one-ulp change of its input is no sharper
than that.  About 8 minutes of JAX on the CPU (uniform's 1.24M paths take
most of it).  Writes `tests/fixtures/torch_port_pf31_certified.json`.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py --certified
"""
import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.polarfly import build_polarfly  # noqa: E402
from repro.core.routing import build_routing  # noqa: E402
from repro.simulation import (build_flow_paths, make_pattern,  # noqa: E402
                              saturation_throughput)

Q, P, SEED, K_CANDIDATES, TOL = 31, 16, 0, 10, 0.01
ITERS = {"min": 250, "ugal": 1500, "ugal_pf": 1500}
PATTERNS = ("uniform", "random_perm")
OUT = os.path.join(ROOT, "tests", "fixtures",
                   "torch_port_pf31_reference.json")
CERT_RUNS = (("random_perm", "ugal"), ("random_perm", "ugal_pf"),
             ("uniform", "ugal"))
CERT_OUT = os.path.join(ROOT, "tests", "fixtures",
                        "torch_port_pf31_certified.json")


def write(path, doc):
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"wrote {path}")


def _certified_row(fp):
    t0 = time.perf_counter()
    res = saturation_throughput(fp, tol=TOL, certify=True)
    return {"value": float(res.value), "sat_lo": float(res.sat_lo),
            "sat_hi": float(res.sat_hi), "cert": dataclasses.asdict(res.cert),
            "cpu_wall_s": round(time.perf_counter() - t0, 1)}


def certified():
    pf = build_polarfly(Q)
    rt = build_routing(pf.graph, pf)
    rows = []
    for pattern, mode in CERT_RUNS:
        pat = make_pattern(pattern, rt, p=P, seed=SEED)
        fp = build_flow_paths(rt, pat, mode, k_candidates=K_CANDIDATES,
                              seed=SEED)
        row = {"pattern": pattern, "mode": mode, **_certified_row(fp),
               "ulp_runs": []}
        demand = fp.pattern.demand.astype(np.float32)
        for name, toward in (("+1ulp", np.inf), ("-1ulp", -np.inf)):
            fp.pattern.demand = np.nextafter(demand, np.float32(toward))
            fp._device = None  # the cached device arrays hold the demand
            run = _certified_row(fp)
            row["ulp_runs"].append({"demand": name, **{
                k: run[k] for k in ("value", "sat_lo", "sat_hi")},
                "iters": run["cert"]["iters"]})
        fp.pattern.demand, fp._device = demand, None
        rows.append(row)
        print(json.dumps(rows[-1]), flush=True)
    write(CERT_OUT, {
        "source": "repro (JAX package), certified engine, CPU",
        "script": "scripts/make_torch_port_reference.py --certified",
        "jax": jax.__version__,
        "config": {"q": Q, "p": P, "seed": SEED,
                   "k_candidates": K_CANDIDATES, "tol": TOL,
                   "certify": True, "dtype": "float32",
                   "cert_iters": "default"},
        "saturations": rows})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--certified", action="store_true",
                    help="record the certified saturations instead")
    if ap.parse_args().certified:
        return certified()
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
    write(OUT, doc)


if __name__ == "__main__":
    main()
