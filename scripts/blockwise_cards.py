"""Blockwise rounds on one card against rounds spread over every visible
card, at the scale tier's device-BFS stages.

`run_blocks(backend="sharded")` runs `ndev` blocks a round, one a card.
This script times the stages of `chip_smoke.py`'s `scale` and `analysis`
phases that sweep blocks on the card, through the port's entry points,
with `devices=1` and with `devices=N` (N = every visible card):

* pf79_nsource: `build_blocked_routing(PF(79))`, the n-source BFS sweep
  that gives the diameter (6321 sources);
* pf79_distance: `diameter_and_aspl(PF(79), backend="sharded")`, the
  analysis phase's all-pairs sweep (there on the graph at Fig. 14's
  failure fractions, here intact);
* pf157_sweep: `destination_blocks` over bench_blockwise_scaling.py's 24
  blocks of 8 destinations;
* pf157_paths: `build_blocked_routing(PF(157), block=8, diameter=2)`,
  then the uniform p = 79, 60,000-flow `min` path build (~2830 column
  blocks of 8).

Before anything is timed, every card's context is made and each setting
runs one untimed sweep, so no timed stage holds set-up.  Each stage runs
in the order 1, N, N, 1 card(s), and every N-card result is held equal to
the one-card result.  Then one more run of each of the three BFS stages
at each setting runs under torch.profiler: the device time of each card
(its kernels and copies, overlaps merged) and that time's share of the
run's wall.  One JSON line a run, then the cards' names and power limits.

    PYTHONPATH=src python3 scripts/blockwise_cards.py   # on a host with several cards
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import flow_hashes, sweep_dests  # noqa: E402
from repro_torch.core.metrics import diameter_and_aspl  # noqa: E402
from repro_torch.core.polarfly import build_polarfly  # noqa: E402
from repro_torch.core.routing import (build_blocked_routing,  # noqa: E402
                                      destination_blocks)
from repro_torch.simulation import build_flow_paths, make_pattern  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "torch_port_scale_reference.json")


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed(fn):
    sync_all()
    t = time.perf_counter()
    out = fn()
    sync_all()
    return out, time.perf_counter() - t


def busy_ms_by_card(events):
    """{card: ms its kernels and copies kept it busy}, overlaps merged."""
    spans = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    out = {}
    for card, runs in sorted(spans.items()):
        runs.sort()
        total, (lo, hi) = 0, runs[0]
        for a, b in runs[1:]:
            if a > hi:
                total, lo, hi = total + hi - lo, a, b
            else:
                hi = max(hi, b)
        out[card] = (total + hi - lo) / 1e3
    return out


def main():
    if not torch.cuda.is_available():
        print("blockwise_cards: no CUDA card", file=sys.stderr)
        return 2
    ncard = torch.cuda.device_count()
    settings = [1, ncard] if ncard > 1 else [1]
    for i in range(ncard):  # every card's context, before anything is timed
        torch.empty(1, device=f"cuda:{i}")
    sync_all()
    with open(FIXTURE) as fh:
        c157 = json.load(fh)["config"]["pf157_min"]
    g79, graph79_s = timed(lambda: build_polarfly(79).graph)
    g157, graph157_s = timed(lambda: build_polarfly(c157["q"]).graph)
    print(json.dumps({"cards": ncard, "graph79_s": graph79_s,
                      "graph157_s": graph157_s}), flush=True)
    dests = sweep_dests(g157.n, c157["block"], c157["sweep_blocks"])

    def pf157_paths(k):
        rt = build_blocked_routing(g157, block=c157["block"],
                                   diameter=c157["diameter"],
                                   backend="sharded", devices=k)
        pat = make_pattern("uniform", rt, p=c157["p"], seed=c157["seed"],
                           max_flows=c157["max_flows"])
        return flow_hashes(build_flow_paths(
            rt, pat, c157["mode"], k_candidates=c157["k_candidates"],
            seed=c157["seed"]))

    stages = {
        "pf79_nsource": lambda k: build_blocked_routing(
            g79, backend="sharded", devices=k).diameter,
        "pf79_distance": lambda k: diameter_and_aspl(
            g79, backend="sharded", devices=k),
        "pf157_sweep": lambda k: [
            tuple(np.asarray(a) for a in blk) for blk in destination_blocks(
                g157, dests=dests, block=c157["block"], backend="sharded",
                devices=k)],
        "pf157_paths": pf157_paths,
    }
    for k in settings:  # one untimed sweep a setting: modules, allocator
        list(destination_blocks(g157, dests=dests[:8 * k],
                                block=c157["block"], backend="sharded",
                                devices=k))
    problems = []

    def same(a, b):
        if isinstance(a, list):
            return len(a) == len(b) and all(
                all(np.array_equal(x, y) for x, y in zip(p, q))
                for p, q in zip(a, b))
        return a == b

    for name, fn in stages.items():
        ref = None
        for k in settings + settings[::-1] if ncard > 1 else settings * 2:
            out, wall = timed(lambda: fn(k))
            if ref is None:
                ref = out
            equal = same(ref, out)
            if not equal:
                problems.append(f"{name} on {k} card(s)")
            print(json.dumps({"stage": name, "cards": k, "wall_s": wall,
                              "equal_to_one_card": equal}), flush=True)
            del out
    for name in ("pf79_nsource", "pf79_distance", "pf157_sweep"):
        for k in settings:
            sync_all()
            t = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                stages[name](k)
                sync_all()
            wall_ms = 1e3 * (time.perf_counter() - t)
            busy = busy_ms_by_card(prof.events())
            print(json.dumps({
                "stage": name, "cards": k, "profiled_wall_ms": wall_ms,
                "device_ms_by_card": busy or "not measured",
                "busy_share_by_card": {c: ms / wall_ms
                                       for c, ms in busy.items()}}),
                flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    if problems:
        print(f"blockwise_cards: results differ: {problems}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
