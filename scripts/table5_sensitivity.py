"""How far apart may a correct port and the JAX reference put Table V's
adaptive random-permutation saturations?

For each competitor of `paper_table5_configs` with adaptive modes (Slim
Fly, the two Dragonflies, Jellyfish), on the grid in the `config` of
tests/fixtures/torch_port_table5_reference.json (seed, k_candidates, tol,
iterations and engine; random_perm traffic, p = max(2, radix // 2)), this
prints, for each adaptive mode, one JSON line with the reference's
saturation at its demand and with every demand moved one float32 ulp up
and one down, and the port's on the CPU (`device="cpu"`) on the same
FlowPaths arrays.  The adaptive iterate after a fixed budget is chaotic
in its last bits on the UGAL_PF gate plateau, so the spread of the
reference's own three values is the resolution of any parity bar there.
Uniform traffic is left out: its 1500-step reference solves take minutes
each on the CPU.

With `--write` each measured run of the fixture gains `ulp_runs` (the two
moved saturations) and `ulp_band` ([least, greatest] of the three), which
chip_smoke.py's ``table5`` phase widens its one-bisection-step bar by.
Run it again after `scripts/make_torch_port_reference.py --table5`.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/table5_sensitivity.py \
        [--write]
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro.simulation as R  # noqa: E402
import repro_torch.simulation as T  # noqa: E402
from _torch_port import to_port  # noqa: E402
from chip_smoke import TABLE5_FIXTURE, table5_traffic  # noqa: E402
from repro.core.routing import build_routing  # noqa: E402
from repro.core.topologies import paper_table5_configs  # noqa: E402

PATTERN = "random_perm"
ADAPTIVE = ("ugal", "ugal_pf")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true",
                    help="store each run's ulp_runs and ulp_band in the "
                         "fixture")
    args = ap.parse_args(argv)
    with open(TABLE5_FIXTURE) as fh:
        fixture = json.load(fh)
    c = fixture["config"]
    graphs = paper_table5_configs(seed=c["seed"])
    for name in c["topologies"]:
        modes = [m for m in c["modes"][name] if m in ADAPTIVE]
        if not modes:
            continue
        g = graphs[name]
        rt = build_routing(g)
        p, hosts = table5_traffic(g)
        pat = R.make_pattern(PATTERN, rt, p=p, hosts=hosts, seed=c["seed"])
        runs = {(r["pattern"], r["mode"]): r
                for r in fixture["topologies"][name]["runs"]}
        for mode in modes:
            it = c["iters"][mode]
            demand = pat.demand.astype(np.float32)
            row = {"topology": name, "mode": mode}
            for key, toward in (("reference", None), ("plus_1ulp", np.inf),
                                ("minus_1ulp", -np.inf)):
                moved = dataclasses.replace(
                    pat, demand=demand if toward is None else
                    np.nextafter(demand, np.float32(toward)))
                fp = R.build_flow_paths(rt, moved, mode,
                                        k_candidates=c["k_candidates"],
                                        seed=c["seed"])
                t = time.perf_counter()
                row[key] = float(R.saturation_throughput(
                    fp, tol=c["tol"], iters=it, engine=c["engine"]))
                row[f"{key}_s"] = round(time.perf_counter() - t, 1)
                if toward is None:
                    base = fp
            t = time.perf_counter()
            row["port_cpu"] = float(T.saturation_throughput(
                to_port(base), tol=c["tol"], iters=it, engine=c["engine"],
                device="cpu"))
            row["port_cpu_s"] = round(time.perf_counter() - t, 1)
            print(json.dumps(row), flush=True)
            want = runs[PATTERN, mode]
            if row["reference"] != want["saturation"]:
                raise SystemExit(f"{name} {mode}: {row['reference']} is not "
                                 f"the fixture's {want['saturation']}")
            three = [row[k] for k in ("reference", "plus_1ulp",
                                      "minus_1ulp")]
            want["ulp_runs"] = {k: row[k] for k in ("plus_1ulp",
                                                    "minus_1ulp")}
            want["ulp_band"] = [min(three), max(three)]
    if args.write:
        fixture["ulp_script"] = "scripts/table5_sensitivity.py --write"
        with open(TABLE5_FIXTURE, "w") as fh:
            json.dump(fixture, fh, indent=1)
            fh.write("\n")
        print(f"wrote {TABLE5_FIXTURE}")


if __name__ == "__main__":
    main()
