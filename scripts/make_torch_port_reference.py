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

With `--table5` it records the paper's Table V comparison that the smoke
script's `table5` phase holds the port against: `benchmarks/
bench_fig8_saturation.py`'s `run()` grid on Slim Fly, the two Dragonflies,
Jellyfish and the fat tree of `paper_table5_configs(seed=0)` (1058, 876,
978, 993 routers and 972 switches; PolarFly's row is the PF(31) fixture):
`uniform` and `random_perm` traffic at seed 0, p = max(2, radix // 2)
endpoints a router (on the fat tree only on its leaf switches), modes
`min`, `ugal` and `ugal_pf` (the fat tree `ecmp` alone) with
`k_candidates=10`, `saturation_throughput(tol=0.01, engine="batched")` at
250 Frank-Wolfe iterations for the oblivious modes and 1500 for the
adaptive ones.  Each topology holds the sha256 of its routing tables, each
run the saturation, the [F, K, L] shape, the link count and the sha256 of
its pattern's and FlowPaths' arrays (`chip_smoke.py`'s `flow_hashes`);
`TABLE5` here is the one source of the grid, which the phase reads back
from the fixture's `config`.  About 20 minutes of JAX on the CPU.  Writes
`tests/fixtures/torch_port_table5_reference.json`; then
`scripts/table5_sensitivity.py --write` adds each random_perm adaptive
run's ±1-ulp band, which the phase's bar widens by.

With `--figures` it records the paper's remaining fluid figures that the
smoke script's `figures` phase holds the port against, the grid in
`FIGURES` (the one source, read back from the fixture's `config`):

* Fig. 9, `benchmarks/bench_fig9_adaptive.py` at PF(31): perm1hop,
  perm2hop and tornado traffic (p = 16, seed 0) under min, ugal and
  ugal_pf (`k_candidates=10`), each run's saturation
  (`saturation_throughput(tol=0.01, engine="batched")`, 250 / 1500
  Frank-Wolfe steps), its `latency_curve` mean latency at
  `chip_smoke.fig9_load(sat)` and, adaptive, its `truncation_error` at the
  saturation; random_perm's latency and truncation rows at the saturations
  of tests/fixtures/torch_port_pf31_reference.json;
* Fig. 11, `benchmarks/bench_fig11_expansion.py` at PF(31): the base graph
  (routed with its PolarFly, as the benchmark) and `expand(layout, 2 | 4,
  "quadric" | "nonquadric")` (routed by `build_routing(g)` alone), uniform
  p = 16 at seed 0, ugal_pf with `k_candidates=8`, tol 0.02, 1500 steps;
  each graph's size, diameter, degrees and hashes;
* Fig. 14, `benchmarks/bench_fig14_resilience.py`: `resilience_sweep(g,
  fractions, seed=1)`'s diameter and ASPL on PF(13), SF(9), JF(183, 14)
  and DF(6, 3) at 0.05 / 0.2 / 0.4 / 0.55 and on PS(9, 61) and
  JF(5551, 40) at 0.05 / 0.2; and `_run_large_fluid`'s point, PS(9, 61)
  less `default_rng(1)`'s 5 % of its links through `build_blocked_routing`,
  512 host routers, p = 20, min, tol 0.02.

About 25 minutes of JAX on the CPU.  Writes
`tests/fixtures/torch_port_figures_reference.json`; then
`scripts/table5_sensitivity.py --figures --write` adds each adaptive
saturation's, latency point's and truncation gap's band over the
reference's runs with the demand moved up to `ulp_moves` ulps each way.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py --certified
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py --packet
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py --scale
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py --table5
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py --figures
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py --collectives

With `--collectives` it records the collectives of the reference's
compiled four-card train step that tests/test_torch_collectives.py holds
the port's traced step against: qwen3-4b `train_4k` on a (2, 2) ("data",
"model") mesh of 4 forced CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, in a subprocess a
run: XLA fixes its device count when it first starts), the plan
`repro.launch.cells.plan_cell` gives there with the port's four-card plan
fields set on it (`COLLECTIVES`: tp2d, remat "full", 16 microbatches,
AdamW with float32 state and accumulation), once without and once with
sequence parallelism.  `repro.launch.dryrun._lower_cell` lowers the step,
``.compile()`` compiles it, and `repro.launch.collbreak.breakdown` counts
its collectives with their loop trip counts.  Each row keeps the kind,
the result's dims and dtype, the group size, fwd / bwd / opt, the op, the
calls and the wire bytes of the whole step; the dims, not the dtype, are
what the test matches, since XLA's CPU backend carries bf16 collectives
in float32.  About half a minute.  Writes
`tests/fixtures/torch_port_collectives_reference.json`.
"""
import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import (fig9_load, figure_graph,  # noqa: E402
                        flow_hashes, graph_hash, routing_hashes,
                        sweep_dests, table5_traffic)

from repro.core import topologies  # noqa: E402
from repro.core.expansion import expand  # noqa: E402
from repro.core.layout import build_layout  # noqa: E402
from repro.core.metrics import resilience_sweep  # noqa: E402
from repro.core.polarfly import build_polarfly  # noqa: E402
from repro.core.topologies import paper_table5_configs  # noqa: E402
from repro.core.routing import (build_blocked_routing,  # noqa: E402
                                build_routing, destination_blocks)
from repro.simulation import (BurstSchedule,  # noqa: E402
                              build_failure_workload, build_flow_paths,
                              latency_curve, make_pattern, make_workload,
                              saturation_throughput, simulate_packets,
                              truncation_error)

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
# Table V: fig8's run() on the five competitors at the paper's sizes
TABLE5 = {"seed": 0, "topologies": ["SF", "DF1", "DF2", "JF", "FT"],
          "patterns": ["uniform", "random_perm"],
          "modes": {"SF": ["min", "ugal", "ugal_pf"],
                    "DF1": ["min", "ugal", "ugal_pf"],
                    "DF2": ["min", "ugal", "ugal_pf"],
                    "JF": ["min", "ugal", "ugal_pf"], "FT": ["ecmp"]},
          "k_candidates": 10, "tol": 0.01,
          "engine": "batched",
          "iters": {"min": 250, "ecmp": 250, "ugal": 1500, "ugal_pf": 1500}}
TABLE5_OUT = os.path.join(ROOT, "tests", "fixtures",
                          "torch_port_table5_reference.json")
# the paper's remaining fluid figures: fig9's, fig11's and fig14's run()
# (fig14's BENCH_LARGE tier and its `_run_large_fluid` point; PF(31) and
# PF(79)'s sweeps are the smoke script's analysis phase)
FIGURES = {
    "fig9": {"q": 31, "p": 16, "seed": 0, "k_candidates": 10, "tol": 0.01,
             "engine": "batched",
             "patterns": ["perm1hop", "perm2hop", "tornado", "random_perm"],
             "modes": ["min", "ugal", "ugal_pf"],
             "iters": {"min": 250, "ugal": 1500, "ugal_pf": 1500},
             # random_perm's saturations are the PF(31) fixture's
             "saturations_from": "torch_port_pf31_reference.json",
             # the sensitivity runs' demand moves: 1 and 2 ulps each way
             # (the reference's own tornado ugal saturation reads 0.21875,
             # 0.2265625 and 0.25 at -1, 0 and -2 ulps)
             "ulp_moves": 2},
    "fig11": {"q": 31, "p": 16, "seed": 0, "k_candidates": 8, "tol": 0.02,
              "iters": 1500, "engine": "batched", "mode": "ugal_pf",
              "ulp_moves": 1,
              # (name, method, steps); the base is routed with its PolarFly
              "graphs": [["base", None, 0], ["quadric_x2", "quadric", 2],
                         ["quadric_x4", "quadric", 4],
                         ["nonquadric_x2", "nonquadric", 2],
                         ["nonquadric_x4", "nonquadric", 4]]},
    "fig14": {"seed": 1,
              # name: [builder, arguments, fractions]
              "graphs": {
                  "PF13": ["build_polarfly", [13], [0.05, 0.2, 0.4, 0.55]],
                  "SF9": ["build_slimfly", [9], [0.05, 0.2, 0.4, 0.55]],
                  "JF": ["build_jellyfish", [183, 14, 0],
                         [0.05, 0.2, 0.4, 0.55]],
                  "DF1": ["build_dragonfly", [6, 3], [0.05, 0.2, 0.4, 0.55]],
                  "PS9x61": ["build_polarstar", [9, 61], [0.05, 0.2]],
                  "JF5551": ["build_jellyfish", [5551, 40, 0], [0.05, 0.2]]},
              "point": {"graph": ["build_polarstar", [9, 61]],
                        "drop": 0.05, "drop_seed": 1, "hosts": 512,
                        "p": 20, "seed": 0, "mode": "min",
                        "k_candidates": 8, "tol": 0.02, "iters": 250,
                        "engine": "batched"}},
}
FIGURES_OUT = os.path.join(ROOT, "tests", "fixtures",
                           "torch_port_figures_reference.json")
# the four-card train step: qwen3-4b train_4k on (2, 2) at the port's
# four-card plan (launch.cells.plan_cell at 80 GB a card), without and
# with sequence parallelism
COLLECTIVES = {"arch": "qwen3-4b", "shape": "train_4k",
               "mesh": [2, 2], "axes": ["data", "model"],
               "plan": {"profile": "tp2d", "remat": "full",
                        "num_microbatches": 16, "optimizer": "adamw",
                        "opt_dtype": "float32", "accum_dtype": "float32"},
               # run name: seq_parallel
               "runs": {"tp2d": False, "tp2d_sp": True}}
COLLECTIVES_OUT = os.path.join(ROOT, "tests", "fixtures",
                               "torch_port_collectives_reference.json")


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


def table5():
    c = TABLE5
    graphs = paper_table5_configs(seed=c["seed"])
    tops = {}
    for name in c["topologies"]:
        g = graphs[name]
        t0 = time.perf_counter()
        rt = build_routing(g)
        p, hosts = table5_traffic(g)
        top = {"routers": g.n, "radix": g.params["radix"], "p": p,
               "hosts": g.n if hosts is None else len(hosts),
               "diameter": int(rt.diameter),
               "routing_sha256": routing_hashes(rt),
               "cpu_routing_s": round(time.perf_counter() - t0, 1),
               "runs": []}
        for pattern in c["patterns"]:
            pat = make_pattern(pattern, rt, p=p, hosts=hosts, seed=c["seed"])
            for mode in c["modes"][name]:
                t0 = time.perf_counter()
                fp = build_flow_paths(rt, pat, mode,
                                      k_candidates=c["k_candidates"],
                                      seed=c["seed"])
                t1 = time.perf_counter()
                sat = saturation_throughput(fp, tol=c["tol"],
                                            iters=c["iters"][mode],
                                            engine=c["engine"])
                f, k, l = fp.edges.shape
                top["runs"].append({
                    "pattern": pattern, "mode": mode,
                    "iters": c["iters"][mode], "saturation": float(sat),
                    "flows": f, "candidates": k, "path_len": l,
                    "num_links": fp.num_links, "sha256": flow_hashes(fp),
                    "cpu_paths_s": round(t1 - t0, 1),
                    "cpu_wall_s": round(time.perf_counter() - t1, 1)})
                print(json.dumps({"topology": name, **top["runs"][-1]}),
                      flush=True)
        tops[name] = top
    write(TABLE5_OUT, {
        "source": "repro (JAX package), batched engine, CPU",
        "script": "scripts/make_torch_port_reference.py --table5",
        "jax": jax.__version__, "numpy": np.__version__,
        "config": TABLE5, "topologies": tops})


def _fig9():
    c = FIGURES["fig9"]
    with open(os.path.join(ROOT, "tests", "fixtures",
                           c["saturations_from"])) as fh:
        pf31 = {(r["pattern"], r["mode"]): r["saturation"]
                for r in json.load(fh)["saturations"]}
    pf = build_polarfly(c["q"])
    rt = build_routing(pf.graph, pf)
    out = {"routers": pf.n, "diameter": int(rt.diameter),
           "routing_sha256": routing_hashes(rt), "runs": []}
    for pattern in c["patterns"]:
        pat = make_pattern(pattern, rt, p=c["p"], seed=c["seed"])
        for mode in c["modes"]:
            it = c["iters"][mode]
            t0 = time.perf_counter()
            fp = build_flow_paths(rt, pat, mode,
                                  k_candidates=c["k_candidates"],
                                  seed=c["seed"])
            t1 = time.perf_counter()
            if pattern == "random_perm":
                sat, sat_s = pf31[pattern, mode], None
            else:
                sat = float(saturation_throughput(
                    fp, tol=c["tol"], iters=it, engine=c["engine"]))
                sat_s = round(time.perf_counter() - t1, 1)
            t2 = time.perf_counter()
            load = fig9_load(sat)
            lat = float(latency_curve(fp, [load], iters=it,
                                      engine=c["engine"])[0].mean_latency)
            t3 = time.perf_counter()
            f, k, l = fp.edges.shape
            row = {"pattern": pattern, "mode": mode, "iters": it,
                   "saturation": sat,
                   "saturation_source": ("pf31" if sat_s is None
                                         else "this run"),
                   "latency_load": load, "mean_latency": lat,
                   "flows": f, "candidates": k, "path_len": l,
                   "num_links": fp.num_links, "sha256": flow_hashes(fp),
                   "cpu_paths_s": round(t1 - t0, 1),
                   "cpu_saturation_s": sat_s,
                   "cpu_latency_s": round(t3 - t2, 1)}
            if mode in ("ugal", "ugal_pf"):
                row["truncation_error"] = float(truncation_error(fp, sat,
                                                                 it))
                row["cpu_truncation_s"] = round(time.perf_counter() - t3, 1)
            out["runs"].append(row)
            print(json.dumps({"figure": "fig9", **row}), flush=True)
    return out


def _fig11():
    c = FIGURES["fig11"]
    pf = build_polarfly(c["q"])
    lay = build_layout(pf)
    out = {}
    for name, method, steps in c["graphs"]:
        t0 = time.perf_counter()
        g = pf.graph if method is None else expand(lay, steps, method).graph
        rt = build_routing(g, pf) if method is None else build_routing(g)
        t1 = time.perf_counter()
        pat = make_pattern("uniform", rt, p=c["p"], seed=c["seed"])
        fp = build_flow_paths(rt, pat, c["mode"],
                              k_candidates=c["k_candidates"], seed=c["seed"])
        t2 = time.perf_counter()
        sat = float(saturation_throughput(fp, tol=c["tol"], iters=c["iters"],
                                          engine=c["engine"]))
        f, k, l = fp.edges.shape
        deg = g.degrees
        out[name] = {
            "method": method, "steps": steps, "routers": g.n,
            "links": g.num_edges, "diameter": int(rt.diameter),
            "degree_min": int(deg.min()), "degree_max": int(deg.max()),
            "graph_sha256": graph_hash(g),
            "routing_sha256": routing_hashes(rt), "saturation": sat,
            "flows": f, "candidates": k, "path_len": l,
            "num_links": fp.num_links, "sha256": flow_hashes(fp),
            "cpu_routing_s": round(t1 - t0, 1),
            "cpu_paths_s": round(t2 - t1, 1),
            "cpu_wall_s": round(time.perf_counter() - t2, 1)}
        print(json.dumps({"figure": "fig11", "graph": name, **out[name]}),
              flush=True)
    return out


def _fig14():
    c = FIGURES["fig14"]
    sweeps = {}
    for name, (builder, args, fractions) in c["graphs"].items():
        t0 = time.perf_counter()
        g = figure_graph(builder, args, topologies, build_polarfly)
        t1 = time.perf_counter()
        pts = resilience_sweep(g, fractions, seed=c["seed"])
        sweeps[name] = {
            "routers": g.n, "links": g.num_edges,
            "graph_sha256": graph_hash(g),
            "points": [{"fraction": p.fail_fraction, "diameter": p.diameter,
                        "aspl": p.aspl} for p in pts],
            "cpu_graph_s": round(t1 - t0, 1),
            "cpu_sweep_s": round(time.perf_counter() - t1, 1)}
        print(json.dumps({"figure": "fig14", "graph": name,
                          **sweeps[name]}), flush=True)
    c = c["point"]
    t0 = time.perf_counter()
    g = figure_graph(*c["graph"], topologies, build_polarfly)
    edges = g.edge_list
    rng = np.random.default_rng(c["drop_seed"])
    dg = g.subgraph_without_edges(edges[rng.choice(
        len(edges), int(c["drop"] * len(edges)), replace=False)])
    t1 = time.perf_counter()
    rt = build_blocked_routing(dg)
    t2 = time.perf_counter()
    pat = make_pattern("uniform", rt, p=c["p"], seed=c["seed"],
                       hosts=np.arange(c["hosts"], dtype=np.int32))
    fp = build_flow_paths(rt, pat, c["mode"], k_candidates=c["k_candidates"],
                          seed=c["seed"])
    t3 = time.perf_counter()
    sat = float(saturation_throughput(fp, tol=c["tol"], iters=c["iters"],
                                      engine=c["engine"]))
    f, k, l = fp.edges.shape
    point = {"routers": dg.n, "links": dg.num_edges,
             "graph_sha256": graph_hash(dg), "diameter": int(rt.diameter),
             "dest_block": int(rt.block), "saturation": sat, "flows": f,
             "candidates": k, "path_len": l, "num_links": fp.num_links,
             "sha256": flow_hashes(fp),
             "cpu_graph_s": round(t1 - t0, 1),
             "cpu_routing_s": round(t2 - t1, 1),
             "cpu_paths_s": round(t3 - t2, 1),
             "cpu_wall_s": round(time.perf_counter() - t3, 1)}
    print(json.dumps({"figure": "fig14", "point": "PS9x61_f5", **point}),
          flush=True)
    return {"sweeps": sweeps, "point": point}


def figures():
    doc = {"source": "repro (JAX package), batched engine, CPU",
           "script": "scripts/make_torch_port_reference.py --figures",
           "jax": jax.__version__, "numpy": np.__version__,
           "config": FIGURES}
    for key, fn in (("fig9", _fig9), ("fig11", _fig11), ("fig14", _fig14)):
        doc[key] = fn()
    write(FIGURES_OUT, doc)


def _collectives_run(name):
    """One compiled step's collectives (run `name` of `COLLECTIVES`), in
    a process whose XLA_FLAGS force 4 host devices."""
    devices = jax.devices()  # XLA starts here, before repro.launch's
    # modules add their 512 devices to XLA_FLAGS
    assert len(devices) == 4, devices
    from repro.configs import get_config
    from repro.launch import collbreak, dryrun
    from repro.launch.cells import plan_cell
    from repro.launch.mesh import make_mesh

    c = COLLECTIVES
    cfg = get_config(c["arch"])
    mesh = make_mesh(tuple(c["mesh"]), tuple(c["axes"]))
    plan = plan_cell(cfg, c["shape"], mesh)
    for k, v in c["plan"].items():
        setattr(plan, k, v)
    plan.seq_parallel = c["runs"][name]
    t0 = time.perf_counter()
    lowered, _ = dryrun._lower_cell(cfg, plan, c["shape"], mesh)
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0
    top, counts, total = collbreak.breakdown(compiled.as_text(),
                                             top=1 << 30)
    rows = []
    for (kind, what, g, region), wire in top:
        dtype, dims = what.split("[", 1)
        phase, op = region.split(":", 1)
        rows.append({"kind": kind, "dtype": dtype,
                     "dims": [int(d) for d in dims.rstrip("]").split(",")
                              if d],
                     "g": int(g[1:]), "phase": phase, "op": op,
                     "calls": counts[(kind, what, g, region)],
                     "wire_bytes": wire})
    return {"seq_parallel": plan.seq_parallel,
            "layers": cfg.num_layers,
            "microbatches": plan.num_microbatches,
            "wire_bytes": total,
            "wire_bytes_a_microbatch": total / plan.num_microbatches,
            "compile_s": round(compile_s, 1), "rows": rows}


def collectives():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    doc = {"source": "repro (JAX package), the compiled train step's "
                     "collectives on 4 forced CPU devices",
           "script": "scripts/make_torch_port_reference.py --collectives",
           "jax": jax.__version__, "config": COLLECTIVES, "runs": {}}
    for name in COLLECTIVES["runs"]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--collectives-run", name], env=env,
                           capture_output=True, text=True, timeout=1800)
        if r.returncode != 0:
            raise SystemExit(r.stdout[-2000:] + r.stderr[-4000:])
        run = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({k: v for k, v in run.items() if k != "rows"}),
              flush=True)
        doc["runs"][name] = run
    write(COLLECTIVES_OUT, doc)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--certified", action="store_true",
                    help="record the certified saturations instead")
    ap.add_argument("--packet", action="store_true",
                    help="record the packet engine's runs instead")
    ap.add_argument("--scale", action="store_true",
                    help="record the PF(79) / PF(157) scale tier instead")
    ap.add_argument("--table5", action="store_true",
                    help="record the Table V competitors' saturations "
                         "instead")
    ap.add_argument("--figures", action="store_true",
                    help="record Fig. 9, Fig. 11 and Fig. 14's runs "
                         "instead")
    ap.add_argument("--collectives", action="store_true",
                    help="record the compiled four-card train step's "
                         "collectives instead")
    ap.add_argument("--collectives-run", choices=list(COLLECTIVES["runs"]),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.collectives_run:
        print(json.dumps(_collectives_run(args.collectives_run)))
        return None
    if args.collectives:
        return collectives()
    if args.figures:
        return figures()
    if args.table5:
        return table5()
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
