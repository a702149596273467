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

With `--figures` it does the same for tests/fixtures/
torch_port_figures_reference.json, on the grid in that fixture's
`config`: each Fig. 9 adaptive run at PF(31) (the saturation, the
latency point at the fixture's load and the truncation gap at the
fixture's saturation; random_perm's saturation is the PF(31) fixture's,
held by the smoke script's main path, so only its latency and gap are
moved) and each Fig. 11 ugal_pf saturation, with the demand moved every
whole number of ulps up to the figure's `ulp_moves` each way (2 for Fig.
9, where the reference's own tornado ugal saturation reads 0.21875,
0.2265625 and 0.25 at moves of -1, 0 and -2 ulps; 1 for Fig. 11's
minute-long uniform solves).  `--write` stores
each run's `ulp_runs` and `ulp_band` ({quantity: [least, greatest]} over
the moves and the unmoved run), the port's CPU readings beside them
(`port_cpu`), and `truncation_factor` (`truncation_factor()` below),
which the phase widens a gap's band by.  About 30 minutes.

With `--sizes CARD_JSON` it bands the runs of tests/fixtures/
torch_port_sizes_reference.json that need it, on the grid in that
fixture's `config`: the adaptive runs whose first card reading
(`CARD_JSON`, the records scripts/sizes_cards.py writes) has its
saturation more than one bisection step from the reference's, or its
truncation gap outside the reference's value widened by the figures
fixture's `truncation_factor` each way.  Each such run gets the
reference's saturation and truncation gap with the demand moved one ulp
up and one down (two more reference solves each), as `ulp_runs`,
`ulp_band` and `port_cpu` in the figures fixture's form, and `ulp_why`:
the card reading that called for the band.  Each oblivious run the card
read otherwise gets `max_util_at`, the reference's max link utilization
at its saturation and one bisection step above, the same with the
demand moved one ulp each way (`tie_ulp_runs`), and `tie_why` (`tie()`).  Runs the card held get neither.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/table5_sensitivity.py \
        [--figures | --sizes CARD_JSON] [--write]
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
from chip_smoke import (FIGURES_FIXTURE, SIZES_FIXTURE,  # noqa: E402
                        TABLE5_FIXTURE, bisection_step, fig10_max_flows,
                        fig10_p, sizes_factor, sizes_graph, table5_traffic)
from repro.core import topologies  # noqa: E402
from repro.core.expansion import expand  # noqa: E402
from repro.core.layout import build_layout  # noqa: E402
from repro.core.polarfly import build_polarfly  # noqa: E402
from repro.core.routing import build_blocked_routing  # noqa: E402
from repro.core.routing import build_routing  # noqa: E402
from repro.core.topologies import paper_table5_configs  # noqa: E402

PATTERN = "random_perm"
ADAPTIVE = ("ugal", "ugal_pf")


def moves(k):
    """(name, signed ulps) of the unmoved run and of every move of 1 .. k
    ulps up and down."""
    out = [("reference", 0)]
    for i in range(1, k + 1):
        out += [(f"plus_{i}ulp", i), (f"minus_{i}ulp", -i)]
    return out


def moved_paths(rt, pat, mode, ulps, c):
    """The reference's FlowPaths of `pat` with every demand moved `ulps`
    float32 ulps (up where positive)."""
    demand = pat.demand.astype(np.float32)
    toward = np.float32(np.inf if ulps > 0 else -np.inf)
    for _ in range(abs(ulps)):
        demand = np.nextafter(demand, toward)
    return R.build_flow_paths(rt, dataclasses.replace(pat, demand=demand),
                              mode, k_candidates=c["k_candidates"],
                              seed=c["seed"])


def readings(pkg, fp, c, it, row, saturation, **kw):
    """{quantity: value} of one run: the saturation (when `saturation`),
    the latency at `row`'s load and the truncation gap at `row`'s
    saturation, in package `pkg` (R or T; `kw` passes the port's
    device)."""
    out = {}
    if saturation:
        out["saturation"] = float(pkg.saturation_throughput(
            fp, tol=c["tol"], iters=it, engine=c["engine"], **kw))
    if "latency_load" in row:
        out["mean_latency"] = float(pkg.latency_curve(
            fp, [row["latency_load"]], iters=it, engine=c["engine"],
            **kw)[0].mean_latency)
        out["truncation_error"] = float(pkg.truncation_error(
            fp, row["saturation"], it, **kw))
    return out


def banded(row, rt, pat, mode, c, it, saturation):
    """Measure `row`'s reference runs at every demand move of
    `c["ulp_moves"]` and the port's CPU run; store `ulp_runs`, `ulp_band`
    and `port_cpu` in `row`; return the log line."""
    runs = {}
    for key, ulps in moves(c["ulp_moves"]):
        fp = moved_paths(rt, pat, mode, ulps, c)
        runs[key] = readings(R, fp, c, it, row, saturation)
        if ulps == 0:
            base = fp
    t = time.perf_counter()
    port = readings(T, to_port(base), c, it, row, saturation, device="cpu")
    port["s"] = round(time.perf_counter() - t, 1)
    quantities = list(runs["reference"])
    for q in quantities:
        if runs["reference"][q] != row[q]:
            raise SystemExit(f"{mode}: {q} {runs['reference'][q]} is not "
                             f"the fixture's {row[q]}")
    row["ulp_runs"] = {k: v for k, v in runs.items() if k != "reference"}
    row["ulp_band"] = {q: [min(v[q] for v in runs.values()),
                           max(v[q] for v in runs.values())]
                       for q in quantities}
    row["port_cpu"] = {q: port[q] for q in quantities}
    return {"mode": mode, "ulp_band": row["ulp_band"], "port_cpu": port}


def truncation_factor(rows):
    """The largest ratio between the greatest and the least truncation gap
    of the reference's runs at its demand and one ulp up and down, over
    `rows`: how far a one-ulp change of the input alone moves the gap, the
    margin the phase adds to each end of a gap's band."""
    worst = 1.0
    for r in rows:
        three = [r["truncation_error"]] + [
            r["ulp_runs"][k]["truncation_error"]
            for k in ("plus_1ulp", "minus_1ulp")]
        worst = max(worst, max(three) / min(three))
    return worst


def figures(write):
    with open(FIGURES_FIXTURE) as fh:
        fixture = json.load(fh)
    c = fixture["config"]["fig9"]
    pf = build_polarfly(c["q"])
    rt = build_routing(pf.graph, pf)
    rows = []
    for pattern in c["patterns"]:
        pat = R.make_pattern(pattern, rt, p=c["p"], seed=c["seed"])
        for r in fixture["fig9"]["runs"]:
            if r["pattern"] != pattern or r["mode"] not in ADAPTIVE:
                continue
            line = banded(r, rt, pat, r["mode"], c, r["iters"],
                          r["saturation_source"] != "pf31")
            rows.append(r)
            print(json.dumps({"figure": "fig9", "pattern": pattern,
                              **line}), flush=True)
    factor = truncation_factor(rows)
    print(json.dumps({"truncation_factor": factor}), flush=True)
    c = fixture["config"]["fig11"]
    pf = build_polarfly(c["q"])
    lay = build_layout(pf)
    for name, method, steps in c["graphs"]:
        g = pf.graph if method is None else expand(lay, steps, method).graph
        rt = build_routing(g, pf) if method is None else build_routing(g)
        pat = R.make_pattern("uniform", rt, p=c["p"], seed=c["seed"])
        line = banded(fixture["fig11"][name], rt, pat, c["mode"], c,
                      c["iters"], True)
        print(json.dumps({"figure": "fig11", "graph": name, **line}),
              flush=True)
    if write:
        fixture["truncation_factor"] = factor
        fixture["ulp_script"] = \
            "scripts/table5_sensitivity.py --figures --write"
        with open(FIGURES_FIXTURE, "w") as fh:
            json.dump(fixture, fh, indent=1)
            fh.write("\n")
        print(f"wrote {FIGURES_FIXTURE}")


def sized_runs(fixture):
    """(label, config, fixture row, rebuild) of each run of the sizes
    fixture; `rebuild()` gives the reference's (routing, pattern)."""
    def routed(builder, args, blocked):
        g, pf = sizes_graph(builder, args, topologies, build_polarfly)
        return g, (build_blocked_routing(g) if blocked
                   else build_routing(g, pf))

    c = fixture["config"]["fig15"]
    for name, (builder, args) in c["graphs"].items():
        for r in fixture["fig15"]["topologies"][name]["runs"]:
            def rebuild(builder=builder, args=args, r=r, c=c):
                g, rt = routed(builder, args, False)
                p, hosts = table5_traffic(g)
                return rt, R.make_pattern(r["pattern"], rt, p=p,
                                          hosts=hosts, seed=c["seed"])
            yield f"fig15.{name}.{r['traffic']}", c, r, rebuild
    c = fixture["config"]["fig8_large"]
    for r in fixture["fig8_large"]["runs"]:
        def rebuild(r=r, c=c):
            g, rt = routed(*c["graph"], True)
            return rt, R.make_pattern(
                r["pattern"], rt, p=g.params.get("radix", 80) // 2,
                seed=c["seed"], max_flows=c["max_flows"])
        yield f"fig8_large.{r['pattern']}.{r['mode']}", c, r, rebuild
    c = fixture["config"]["fig10"]
    for name, (builder, args, blocked) in c["points"].items():
        for r in fixture["fig10"][name]["runs"]:
            def rebuild(builder=builder, args=args, blocked=blocked, r=r,
                        c=c):
                g, rt = routed(builder, args, blocked)
                return rt, R.make_pattern(
                    "uniform", rt, p=fig10_p(builder, args, g, blocked),
                    seed=c["seed"],
                    max_flows=fig10_max_flows(c, r["mode"], g.n))
            yield f"fig10.{name}.{r['mode']}", c, r, rebuild


def card_rows(card):
    """{label: row} of the card's runs in scripts/sizes_cards.py's
    records, labelled as `sized_runs` labels them."""
    out = {}
    for part, rec in card["records"].items():
        tops = rec["topologies"] if "topologies" in rec else {"": rec}
        for top in tops.values():
            for r in top["runs"]:
                key = {"fig15": lambda: f"fig15.{r['topology']}."
                                        f"{r['traffic']}",
                       "fig8_large": lambda: f"fig8_large.{r['pattern']}."
                                             f"{r['mode']}"}.get(
                    part, lambda: f"fig10.{r['point']}.{r['mode']}")()
                out[key] = r
    return out


def sizes(card_json, write):
    with open(SIZES_FIXTURE) as fh:
        fixture = json.load(fh)
    with open(card_json) as fh:
        card = card_rows(json.load(fh))
    factor = sizes_factor()
    for label, c, row, rebuild in sized_runs(fixture):
        got = card.get(label)
        if got is None:
            continue
        step = bisection_step(c["tol"])
        if row["mode"] not in ADAPTIVE:
            if got["saturation"] != row["saturation"]:
                tie(label, row, rebuild, c, step, got["saturation"])
            continue
        why = []
        if abs(got["saturation"] - row["saturation"]) > step:
            why.append(f"card saturation {got['saturation']} against "
                       f"{row['saturation']}, bisection step {step}")
        if "truncation_error" in row:
            gap, ref = got["truncation"]["gap"], row["truncation_error"]
            if not ref / factor <= gap <= ref * factor:
                why.append(f"card truncation gap {gap} against {ref} "
                           f"x/÷ {factor}")
        if not why:
            continue
        rt, pat = rebuild()
        runs = {}
        for key, ulps in moves(1):
            fp = moved_paths(rt, pat, row["mode"], ulps, c)
            runs[key] = sized_readings(R, fp, c, row)
            if ulps == 0:
                base = fp
        for q, v in runs["reference"].items():
            if v != row[q]:
                raise SystemExit(f"{label}: {q} {v} is not the fixture's "
                                 f"{row[q]}")
        row["ulp_runs"] = {k: v for k, v in runs.items() if k != "reference"}
        row["ulp_band"] = {q: [min(v[q] for v in runs.values()),
                               max(v[q] for v in runs.values())]
                           for q in runs["reference"]}
        row["port_cpu"] = sized_readings(T, to_port(base), c, row,
                                         device="cpu")
        row["ulp_why"] = "; ".join(why)
        print(json.dumps({"run": label, "ulp_band": row["ulp_band"],
                          "port_cpu": row["port_cpu"],
                          "why": row["ulp_why"]}), flush=True)
    if write:
        fixture["ulp_script"] = "scripts/table5_sensitivity.py --sizes"
        with open(SIZES_FIXTURE, "w") as fh:
            json.dump(fixture, fh, indent=1)
            fh.write("\n")
        print(f"wrote {SIZES_FIXTURE}")


def tie(label, row, rebuild, c, step, card):
    """Record, on an oblivious run the card read otherwise, the
    reference's max link utilization at its saturation and one bisection
    step above it (`max_util_at`, [[load, utilization], ...]), the same
    readings and the saturation with every demand moved one ulp up and one
    down (`tie_ulp_runs`), and why (`tie_why`): `chip_smoke.oblivious_bar`
    lets the card's reading move to the neighbouring step where that
    utilization is within TIE_REL of 1 (a link filled to capacity up to
    float32 summation order)."""
    it = c["iters"][row["mode"]]
    loads = sorted({row["saturation"], min(row["saturation"] + step, 1.0)})
    rt, pat = rebuild()
    runs = {}
    for key, ulps in moves(1):
        fp = moved_paths(rt, pat, row["mode"], ulps, c)
        runs[key] = {
            "saturation": float(R.saturation_throughput(
                fp, tol=c["tol"], iters=it, engine=c["engine"])),
            "max_util_at": [[x, float(R.evaluate_load(fp, x, it).max_util)]
                            for x in loads]}
    ref = runs.pop("reference")
    if ref["saturation"] != row["saturation"]:
        raise SystemExit(f"{label}: {ref['saturation']} is not the "
                         f"fixture's {row['saturation']}")
    row["max_util_at"] = ref["max_util_at"]
    row["tie_ulp_runs"] = runs
    moved = ", ".join(f"{k} {v['saturation']}" for k, v in runs.items())
    row["tie_why"] = (f"card saturation {card} against {row['saturation']}, "
                      f"bisection step {step}; the reference with the "
                      f"demand moved one ulp: {moved} (`tie_ulp_runs`)")
    print(json.dumps({"run": label, "max_util_at": row["max_util_at"],
                      "tie_ulp_runs": runs, "why": row["tie_why"]}),
          flush=True)


def sized_readings(pkg, fp, c, row, **kw):
    """{quantity: value} of a sizes run in package `pkg`: the saturation
    and, where the fixture has one, the truncation gap at the row's
    saturation."""
    it = c["iters"][row["mode"]]
    out = {"saturation": float(pkg.saturation_throughput(
        fp, tol=c["tol"], iters=it, engine=c["engine"], **kw))}
    if "truncation_error" in row:
        out["truncation_error"] = float(pkg.truncation_error(
            fp, row["saturation"], it, **kw))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true",
                    help="store each run's ulp_runs and ulp_band in the "
                         "fixture")
    ap.add_argument("--figures", action="store_true",
                    help="the figures fixture's adaptive runs instead of "
                         "Table V's")
    ap.add_argument("--sizes", metavar="CARD_JSON",
                    help="band the sizes fixture's runs that the card "
                         "readings in CARD_JSON (scripts/sizes_cards.py's "
                         "records) call for")
    args = ap.parse_args(argv)
    if args.sizes:
        return sizes(args.sizes, args.write)
    if args.figures:
        return figures(args.write)
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
            row = {"topology": name, "mode": mode}
            for key, ulps in moves(1):
                fp = moved_paths(rt, pat, mode, ulps, c)
                t = time.perf_counter()
                row[key] = float(R.saturation_throughput(
                    fp, tol=c["tol"], iters=it, engine=c["engine"]))
                row[f"{key}_s"] = round(time.perf_counter() - t, 1)
                if ulps == 0:
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
