"""Where a Frank-Wolfe step of the PyTorch port spends its time on the card.

Builds a PF(31) main-path input (993 routers, p = 16, seed 0, 10 Valiant
candidates; `--pattern`, uniform by default), warms up, then profiles at
offered load 0.5 and prints one JSON object (also written to
build/profile_fw_step.json).  Needs a CUDA card.

Default: `evaluate_load` (mode ugal_pf unless `--mode`) for `--iters`
Frank-Wolfe steps, once without and once under `torch.profiler`: wall ms
per step with and without the profiler, device-busy ms per step (the sum
of kernel times; the result's final device-to-host copies are reported
apart), the device's idle share against the unprofiled wall time, kernel
launches per step, and device time per kernel, largest first.

`--certified`: the certified engine's `cert_equilibrate` (mode ugal
unless `--mode`) with `util_tol` 0, so that no chunk ends the run early.
Runs of 0 chunks (the opening residual and bracket, which is what every
chunk boundary repeats) and of 4 chunks of 32 steps, each once without
and once under the profiler, give kernels and wall ms per certified step
and per chunk boundary (a chunk is 32 steps and one boundary), and the
device's busy and idle share over the chunked run, whose exit test reads
one flag back on the host per chunk.

    PYTHONPATH=src python scripts/profile_fw_step.py [--iters 200]
    PYTHONPATH=src python scripts/profile_fw_step.py --certified \
        [--pattern random_perm] [--mode ugal_pf]
"""
import argparse
import json
import os
import subprocess
import sys
import time

CHUNKS = 4
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def profiled(torch, fn):
    """(unprofiled wall s, profiled wall s, {kernel: (count, device us)},
    copies us) of one call of `fn`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    return plain_wall, wall, kernels, copies_us


def by_kernel(kernels):
    return {k: {"count": c, "us": t} for k, (c, t) in
            sorted(kernels.items(), key=lambda kv: -kv[1][1])}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--certified", action="store_true",
                    help="profile the certified engine's chunks instead")
    ap.add_argument("--pattern", default="uniform",
                    choices=("uniform", "random_perm"))
    ap.add_argument("--mode", default=None, choices=("ugal", "ugal_pf"))
    args = ap.parse_args()
    mode = args.mode or ("ugal" if args.certified else "ugal_pf")

    import torch

    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.simulation import (build_flow_paths, evaluate_load,
                                        make_pattern)
    from repro_torch.simulation import fluid

    if not torch.cuda.is_available():
        sys.exit("profile_fw_step: needs a CUDA card")
    pf = build_polarfly(31)
    rt = build_routing(pf.graph, pf)
    pat = make_pattern(args.pattern, rt, p=16, seed=0)
    fp = build_flow_paths(rt, pat, mode, k_candidates=10, seed=0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    config = f"PF(31) {args.pattern} {mode} p=16 seed 0 k=10, offered 0.5"
    if args.certified:
        fw, demand, _, _ = fluid._pieces(fp, torch.device("cuda"))
        d = demand * 0.5

        def run(chunks):
            return lambda: fw.cert_equilibrate(
                fw.init, d, chunks * fluid._CERT_STRIDE, 0.0)

        run(1)()  # build, warm, cache
        b_wall, b_pwall, b_k, _ = profiled(torch, run(0))
        c_wall, c_pwall, c_k, copies_us = profiled(torch, run(CHUNKS))
        n = CHUNKS
        steps = n * fluid._CERT_STRIDE
        b_launch = sum(c for c, _ in b_k.values())
        c_launch = sum(c for c, _ in c_k.values())
        busy_us = sum(t for _, t in c_k.values())
        out = {"config": config, "card": smi, "certified": True,
               "chunks": n, "steps": steps,
               "kernels_per_boundary": b_launch,
               "kernels_per_step": (c_launch - (n + 1) * b_launch) / steps,
               "kernels_per_chunk": (c_launch - b_launch) / n,
               "wall_ms_per_boundary": b_wall * 1e3,
               "wall_ms_per_chunk": (c_wall - b_wall) * 1e3 / n,
               "wall_ms_per_step": (c_wall - (n + 1) * b_wall) * 1e3 / steps,
               "profiled_wall_ms_per_chunk": (c_pwall - b_pwall) * 1e3 / n,
               "device_busy_ms_per_chunk":
                   (busy_us - sum(t for _, t in b_k.values())) / 1e3 / n,
               "device_idle_share": 1.0 - busy_us / 1e6 / c_wall,
               "copies_us_total": copies_us,
               "device_us_by_kernel": by_kernel(c_k)}
    else:
        evaluate_load(fp, 0.5, iters=20, device="cuda")  # build, warm
        plain_wall, wall, kernels, copies_us = profiled(
            torch, lambda: evaluate_load(fp, 0.5, iters=args.iters,
                                         device="cuda"))
        busy_us = sum(t for _, t in kernels.values())
        launches = sum(c for c, _ in kernels.values())
        out = {"config": config, "card": smi, "iters": args.iters,
               "wall_ms_per_step": plain_wall * 1e3 / args.iters,
               "profiled_wall_ms_per_step": wall * 1e3 / args.iters,
               "device_busy_ms_per_step": busy_us / 1e3 / args.iters,
               "device_idle_share": 1.0 - busy_us / 1e6 / plain_wall,
               "copies_us_total": copies_us,
               "kernels_per_step": launches / args.iters,
               "device_us_by_kernel": by_kernel(kernels)}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    name = "profile_fw_step_certified.json" if args.certified \
        else "profile_fw_step.json"
    with open(os.path.join(ROOT, "build", name), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
