#!/usr/bin/env python3
"""Every run of the paper's last device figures on one card, uncut: Fig.
10's size sweep (PF(13) .. PF(43), SF(23), SF(27), PS(7, 49), and the
large tier PS(9, 61), SF(43), PF(79), JF(6321, 80) through the blocked
routing stack), Fig. 8's PF(79) point and Fig. 15's cost ratios, each
held against tests/fixtures/torch_port_sizes_reference.json (the JAX
package's run) by the helpers of chip_smoke.py's ``sizes`` phase, which
runs the part of this grid that fits its time.

    python3 scripts/sizes_cards.py [--out FILE]

Prints one JSON line a run (stage seconds, the link-load route `loads`,
the kernel's row plan, [F, K, L], path-cost launches, the saturation and
truncation gap beside the reference's and their bars), one a point (graph
and routing seconds), one a timed path_costs shape (each adaptive run's
[F, K, L] against its plain version and `embedding_bag`, beside its bytes
bound), then the card's name and power limit, and writes every record to
FILE (default build/sizes_cards.json).  Exits 2 without a card, 1 if any
run misses its bar.
"""
import argparse
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def parts(fixture):
    """Every part, in the order they run."""
    return (["fig15", "fig8_large"]
            + [f"fig10.{n}" for n in fixture["config"]["fig10"]["points"]])


def tops(rec):
    """{graph: record} of a part's record (Fig. 15's four, else one)."""
    return rec["topologies"] if "topologies" in rec else {"": rec}


def main(argv=None):
    with open(cs.SIZES_FIXTURE) as fh:
        fixture = json.load(fh)
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "sizes_cards.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sizes_cards: needs a CUDA card", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    factor = cs.sizes_factor()
    problems, fps, records = [], {}, {}
    check = cs.checker(problems)
    modes = fixture["config"]["fig10"]["modes"]
    pf79 = None  # Fig. 8's routing, shared with Fig. 10's PF(79)
    t0 = time.perf_counter()
    for part in parts(fixture):
        t = time.perf_counter()
        try:
            if part == "fig15":
                rec, got = cs.sizes_fig15(torch, check, fixture, factor)
            elif part == "fig8_large":
                pf79 = cs.sizes_routing(torch, *fixture["config"][
                    "fig8_large"]["graph"], True)
                rec, got = cs.sizes_fig8_large(torch, check, fixture,
                                               factor, pf79)
            else:
                name = part.split(".", 1)[1]
                rec, got, _ = cs.sizes_fig10_point(
                    torch, check, fixture, name, modes, factor,
                    pf79 if name == "pf79" else None)
        except Exception:  # report every part, fail the run at the end
            traceback.print_exc()
            problems.append(f"{part}: {traceback.format_exc(limit=3)}")
            continue
        fps.update(got)
        records[part] = rec
        cs.emit({"phase": "sizes.point", "part": part,
                 "seconds": time.perf_counter() - t,
                 "graphs": {k: {f: v for f, v in top.items() if f != "runs"}
                            for k, top in tops(rec).items()}})
    del pf79
    runs = [r for rec in records.values() for top in tops(rec).values()
            for r in top["runs"]]
    shapes = []
    for label, fp in fps.items():
        shapes.append(cs.kernel_path_costs_at(
            torch, label, fp,
            cs.sizes_shape_launches(runs, list(fp.edges.shape))))
        cs.emit({"phase": "sizes.path_costs", **shapes[-1]})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"nvidia_smi": smi, "records": records,
                   "path_costs": shapes, "problems": problems,
                   "seconds": time.perf_counter() - t0}, fh, indent=1)
    cs.emit({"phase": "sizes_cards", "ok": not problems,
             "seconds": time.perf_counter() - t0, "problems": problems})
    print(smi, flush=True)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
