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

With `--packet` it records the flit-level packet engine's PF(31) runs that
the smoke script's `packet` phase holds the port against, at
`benchmarks/bench_fig_tail.py`'s settings (p = 16, `k_candidates=8`,
seed 0, 600 cycles, 4-flit packets, 32-packet queues): uniform min and
ugal_pf at offered 0.3, steady and on-off bursts (`BurstSchedule(20,
60)`); random_perm min, ugal and valiant at 0.1; and uniform ugal at 0.3
with 3 links failed (`default_rng(0)`) at cycle 250.  Each row holds the
sha256 of the workload's arrays and of the run's integer outputs
(`delivered`, `dropped`, `deliver_t[delivered]`, `occ_sum`, `occ_max`),
its counts and its tails.  About 2 minutes of JAX on the CPU.  Writes
`tests/fixtures/torch_port_pf31_packet.json`.

With `--scale` it records the three scale points that the smoke script's
`scale` phase holds the port against, each through the destination-blocked
stack that never holds an [n, n] table (`build_blocked_routing`):

* PF(79) adaptive, `benchmarks/bench_fig10_sizes.py`'s scale tier: 6321
  routers, p = 40, uniform, 60,000 sampled flows, seed 0, ugal_pf with
  `k_candidates=8`, `saturation_throughput(tol=0.02, engine="batched")` at
  3000 Frank-Wolfe iterations (the adaptive bar's budget in
  tests/test_simulation.py) and at fig10's 1500;
* PF(157) oblivious, `benchmarks/bench_blockwise_scaling.py`'s LARGE tier:
  24,807 routers, `block=8`, `diameter=2`, p = 79, 60,000 flows, min,
  `tol=0.005`, 250 iterations; and the sweep of 24 blocks of 8
  destinations drawn with `default_rng(0)` (the hashes of its distance and
  next-hop columns, concatenated in block order);
* the PF(79) packet point, `benchmarks/bench_fig_tail.py`'s `_run_large`:
  the routing of the first point, p = 8, ugal_pf, offered 0.3, 400 cycles,
  `flow_sample=8000`, `max_packets=1_500_000`.

Each point holds the sha256 of its pattern's and FlowPaths' arrays
(`src`, `dst`, `demand`, `edges`, `hops`, `valid`, `is_min`,
`first_edge`), not the arrays, and the seconds each stage took.  The
hashes and the sweep's destinations come from `chip_smoke.py`'s own
`flow_hashes` and `sweep_dests`; `SCALE` here is the one source of the
points' settings, which the phase reads back from the fixture's `config`.  PF(79)'s
columns come from the host engine.  PF(157)'s path build sweeps its
columns with the reference's `backend="sharded"` on XLA's CPU device: the
host loop takes more than 14 minutes there, and the sharded backend is bit
for bit the host one by the reference's own tests
(tests/test_blockwise.py); the 24-block sweep is hashed from the host
engine.  About 15 minutes of JAX on the CPU.  Writes
`tests/fixtures/torch_port_scale_reference.json`.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py --certified
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py --packet
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py --scale
"""
import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import flow_hashes, sweep_dests  # noqa: E402

from repro.core.polarfly import build_polarfly  # noqa: E402
from repro.core.routing import (build_blocked_routing,  # noqa: E402
                                build_routing, destination_blocks)
from repro.simulation import (BurstSchedule,  # noqa: E402
                              build_failure_workload, build_flow_paths,
                              make_pattern, make_workload,
                              saturation_throughput, simulate_packets)

Q, P, SEED, K_CANDIDATES, TOL = 31, 16, 0, 10, 0.01
ITERS = {"min": 250, "ugal": 1500, "ugal_pf": 1500}
PATTERNS = ("uniform", "random_perm")
OUT = os.path.join(ROOT, "tests", "fixtures",
                   "torch_port_pf31_reference.json")
CERT_RUNS = (("random_perm", "ugal"), ("random_perm", "ugal_pf"),
             ("uniform", "ugal"))
CERT_OUT = os.path.join(ROOT, "tests", "fixtures",
                        "torch_port_pf31_certified.json")
PACKET = {"p": 16, "k_candidates": 8, "seed": 0, "cycles": 600,
          "size": 4, "capacity": 32, "burst": [20, 60], "failed_links": 3,
          "switch_cycle": 250, "max_packets": 1_000_000}
# (pattern, mode, offered, scenario): scenario is steady, burst or failure
PACKET_RUNS = (("uniform", "min", 0.3, "steady"),
               ("uniform", "min", 0.3, "burst"),
               ("uniform", "ugal_pf", 0.3, "steady"),
               ("uniform", "ugal_pf", 0.3, "burst"),
               ("random_perm", "min", 0.1, "steady"),
               ("random_perm", "ugal", 0.1, "steady"),
               ("random_perm", "valiant", 0.1, "steady"),
               ("uniform", "ugal", 0.3, "failure"))
PACKET_OUT = os.path.join(ROOT, "tests", "fixtures",
                          "torch_port_pf31_packet.json")
# the scale tier: fig10's PF(79) adaptive point, the blockwise-scaling
# LARGE tier at PF(157), fig_tail's PF(79) packet point
SCALE = {
    "pf79_ugal_pf": {"q": 79, "p": 40, "max_flows": 60_000, "seed": 0,
                     "mode": "ugal_pf", "k_candidates": 8, "tol": 0.02,
                     "iters": 3000, "fig10_iters": 1500},
    "pf157_min": {"q": 157, "block": 8, "diameter": 2, "p": 79,
                  "max_flows": 60_000, "seed": 0, "mode": "min",
                  "k_candidates": 8, "tol": 0.005, "iters": 250,
                  "sweep_blocks": 24},
    "pf79_packet": {"q": 79, "p": 8, "max_flows": 60_000, "seed": 0,
                    "mode": "ugal_pf", "k_candidates": 8, "offered": 0.3,
                    "cycles": 400, "flow_sample": 8_000,
                    "max_packets": 1_500_000},
}
SCALE_OUT = os.path.join(ROOT, "tests", "fixtures",
                         "torch_port_scale_reference.json")


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


def sha(a):
    """sha256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def packet():
    pf = build_polarfly(Q)
    rt = build_routing(pf.graph, pf)
    c = PACKET
    kw = dict(size=c["size"], capacity=c["capacity"],
              max_packets=c["max_packets"])
    rng = np.random.default_rng(0)  # bench_fig_tail.py's failed links
    el = pf.graph.edge_list
    rt2 = build_routing(pf.graph.subgraph_without_edges(
        el[rng.choice(len(el), c["failed_links"], replace=False)]))
    pats = {p: make_pattern(p, rt, p=c["p"], seed=c["seed"])
            for p in ("uniform", "random_perm")}
    rows = []
    for pattern, mode, offered, scenario in PACKET_RUNS:
        t0 = time.perf_counter()
        if scenario == "failure":
            wl = build_failure_workload(
                rt, rt2, pats[pattern], mode, offered, c["cycles"],
                c["switch_cycle"], k_candidates=c["k_candidates"],
                seed=c["seed"], **kw)
        else:
            fp = build_flow_paths(rt, pats[pattern], mode,
                                  k_candidates=c["k_candidates"],
                                  seed=c["seed"])
            burst = (BurstSchedule(*c["burst"]) if scenario == "burst"
                     else None)
            wl = make_workload(fp, offered, c["cycles"], burst=burst,
                               seed=c["seed"], **kw)
        t1 = time.perf_counter()
        res = simulate_packets(wl)
        t2 = time.perf_counter()
        rows.append({
            "pattern": pattern, "mode": mode, "offered": offered,
            "scenario": scenario, "packets": wl.num_packets,
            "flows": wl.num_flows, "num_links": wl.num_links,
            "delivered": res.num_delivered, "dropped": res.num_dropped,
            "tails": res.tails(),
            "workload_sha256": {k: sha(getattr(wl, k)) for k in (
                "pkt_flow", "pkt_t", "pkt_cand", "eidx", "fail_hop")},
            "result_sha256": {
                "delivered": sha(res.delivered), "dropped": sha(res.dropped),
                "deliver_t_delivered": sha(res.deliver_t[res.delivered]),
                "occ_sum": sha(res.occ_sum), "occ_max": sha(res.occ_max)},
            "cpu_workload_s": round(t1 - t0, 1),
            "cpu_wall_s": round(t2 - t1, 1)})
        print(json.dumps(rows[-1]), flush=True)
    write(PACKET_OUT, {
        "source": "repro (JAX package), batched packet engine, CPU",
        "script": "scripts/make_torch_port_reference.py --packet",
        "jax": jax.__version__, "config": {"q": Q, **c},
        "runs": rows})


def _paths(rt, c):
    t0 = time.perf_counter()
    pat = make_pattern("uniform", rt, p=c["p"], seed=c["seed"],
                       max_flows=c["max_flows"])
    fp = build_flow_paths(rt, pat, c["mode"], k_candidates=c["k_candidates"],
                          seed=c["seed"])
    f, k, l = fp.edges.shape
    return fp, {"flows": f, "candidates": k, "path_len": l,
                "num_links": fp.num_links, "sha256": flow_hashes(fp),
                "cpu_paths_s": round(time.perf_counter() - t0, 1)}


def scale():
    points = {}
    c = SCALE["pf79_ugal_pf"]
    t0 = time.perf_counter()
    g79 = build_polarfly(c["q"]).graph
    rt79 = build_blocked_routing(g79)  # fig10: the n-source sweep on the host
    row = {"routers": g79.n, "diameter": rt79.diameter,
           "cpu_routing_s": round(time.perf_counter() - t0, 1)}
    fp, paths = _paths(rt79, c)
    row.update(paths)
    for key, iters in (("saturation", c["iters"]),
                       ("saturation_fig10", c["fig10_iters"])):
        t0 = time.perf_counter()
        row[key] = float(saturation_throughput(fp, tol=c["tol"], iters=iters,
                                               engine="batched"))
        row[f"cpu_{key}_s"] = round(time.perf_counter() - t0, 1)
    del fp
    points["pf79_ugal_pf"] = row
    print(json.dumps(row), flush=True)

    c = SCALE["pf79_packet"]
    fp, row = _paths(rt79, c)
    t0 = time.perf_counter()
    wl = make_workload(fp, c["offered"], c["cycles"], seed=c["seed"],
                       flow_sample=c["flow_sample"],
                       max_packets=c["max_packets"])
    t1 = time.perf_counter()
    res = simulate_packets(wl)
    row.update({
        "packets": wl.num_packets, "workload_flows": wl.num_flows,
        "delivered": res.num_delivered, "dropped": res.num_dropped,
        "tails": res.tails(),
        "workload_sha256": {k: sha(getattr(wl, k)) for k in (
            "pkt_flow", "pkt_t", "pkt_cand", "eidx", "fail_hop")},
        "result_sha256": {
            "delivered": sha(res.delivered), "dropped": sha(res.dropped),
            "deliver_t_delivered": sha(res.deliver_t[res.delivered]),
            "occ_sum": sha(res.occ_sum), "occ_max": sha(res.occ_max)},
        "cpu_workload_s": round(t1 - t0, 1),
        "cpu_wall_s": round(time.perf_counter() - t1, 1)})
    del fp, wl, res, rt79, g79
    points["pf79_packet"] = row
    print(json.dumps(row), flush=True)

    c = SCALE["pf157_min"]
    t0 = time.perf_counter()
    g = build_polarfly(c["q"]).graph
    row = {"routers": g.n, "cpu_graph_s": round(time.perf_counter() - t0, 1)}
    dests = sweep_dests(g.n, c["block"], c["sweep_blocks"])
    t0 = time.perf_counter()
    cols = list(destination_blocks(g, dests=dests, block=c["block"],
                                   backend="host"))
    row["sweep_sha256"] = {
        "dests": sha(dests),
        "dist_cols": sha(np.concatenate([d for _, d, _ in cols], axis=1)),
        "nh_cols": sha(np.concatenate([h for _, _, h in cols], axis=1))}
    row["cpu_sweep_host_s"] = round(time.perf_counter() - t0, 1)
    del cols
    t0 = time.perf_counter()
    rt = build_blocked_routing(g, block=c["block"], diameter=c["diameter"],
                               backend="sharded")
    row["cpu_routing_s"] = round(time.perf_counter() - t0, 1)
    row["diameter"] = rt.diameter
    row["columns_backend"] = f"sharded on {len(jax.devices())} XLA CPU device"
    fp, paths = _paths(rt, c)
    row.update(paths)
    t0 = time.perf_counter()
    row["saturation"] = float(saturation_throughput(
        fp, tol=c["tol"], iters=c["iters"], engine="batched"))
    row["cpu_saturation_s"] = round(time.perf_counter() - t0, 1)
    points["pf157_min"] = row
    print(json.dumps(row), flush=True)
    write(SCALE_OUT, {
        "source": "repro (JAX package), blocked routing stack, CPU",
        "script": "scripts/make_torch_port_reference.py --scale",
        "jax": jax.__version__, "numpy": np.__version__,
        "config": SCALE, "points": points})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--certified", action="store_true",
                    help="record the certified saturations instead")
    ap.add_argument("--packet", action="store_true",
                    help="record the packet engine's runs instead")
    ap.add_argument("--scale", action="store_true",
                    help="record the PF(79) / PF(157) scale tier instead")
    args = ap.parse_args()
    if args.scale:
        return scale()
    if args.certified:
        return certified()
    if args.packet:
        return packet()
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
