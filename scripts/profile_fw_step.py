"""Where a Frank-Wolfe step of the PyTorch port spends its time on the card.

Builds the PF(31) uniform ugal_pf main-path input (993 routers, p = 16,
seed 0, 10 Valiant candidates), warms up, then runs `evaluate_load` at
offered load 0.5 for `--iters` Frank-Wolfe steps, once without and once
under `torch.profiler`, and prints one JSON object (also written to
build/profile_fw_step.json): wall ms per step with and without the
profiler, device-busy ms per step (the sum of kernel times; the result's
final device-to-host copies are reported apart), the device's idle share
against the unprofiled wall time, kernel launches per step, and device
time per kernel, largest first.  Needs a CUDA card.

    PYTHONPATH=src python scripts/profile_fw_step.py [--iters 200]
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.simulation import (build_flow_paths, evaluate_load,
                                        make_pattern)

    if not torch.cuda.is_available():
        sys.exit("profile_fw_step: needs a CUDA card")
    pf = build_polarfly(31)
    rt = build_routing(pf.graph, pf)
    pat = make_pattern("uniform", rt, p=16, seed=0)
    fp = build_flow_paths(rt, pat, "ugal_pf", k_candidates=10, seed=0)
    evaluate_load(fp, 0.5, iters=20, device="cuda")  # build, warm, cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate_load(fp, 0.5, iters=args.iters, device="cuda")
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate_load(fp, 0.5, iters=args.iters, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, copies_us = {}, 0.0
    for ev in prof.key_averages():
        dev_us = ev.self_device_time_total
        # record_function ranges (minplus.path_costs) also carry device
        # time: the kernel they enclose, which is counted on its own
        if not dev_us or ev.device_type.name != "CUDA" \
                or getattr(ev, "is_user_annotation", False):
            continue
        if ev.key.startswith(("Memcpy", "Memset")):
            copies_us += dev_us
            continue
        count, us = kernels.get(ev.key, (0, 0.0))
        kernels[ev.key] = (count + ev.count, us + dev_us)
    busy_us = sum(t for _, t in kernels.values())
    launches = sum(c for c, _ in kernels.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"config": "PF(31) uniform ugal_pf p=16 seed 0 k=10, offered 0.5",
           "card": smi, "iters": args.iters,
           "wall_ms_per_step": plain_wall * 1e3 / args.iters,
           "profiled_wall_ms_per_step": wall * 1e3 / args.iters,
           "device_busy_ms_per_step": busy_us / 1e3 / args.iters,
           "device_idle_share": 1.0 - busy_us / 1e6 / plain_wall,
           "copies_us_total": copies_us,
           "kernels_per_step": launches / args.iters,
           "device_us_by_kernel": {
               k: {"count": c, "us": t} for k, (c, t) in
               sorted(kernels.items(), key=lambda kv: -kv[1][1])}}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "profile_fw_step.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
