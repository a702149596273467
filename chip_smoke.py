#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(nvcc, at first use), holds each kernel against its plain PyTorch version
on the card, checks the port on the card against the port on the CPU, and
drives the paper's §VIII saturation path at PolarFly PF(31) (993 routers,
p = 16 endpoints each, about 16k endpoints) through the public entry
points.  Phases, one JSON line each:

  device     the card's name and power limit
  build      the nvcc build and its seconds
  kernels    each kernel against its plain version, bit for bit, at the
             test shapes and at the main path's shape, in fp32 and fp64;
             kernel, plain and library times (CUDA events, median of 30,
             L2 emptied of the inputs before each sample) beside the
             bytes bound
  parity     PF(13), p = 7, random_perm: the port on the card against the
             port on the CPU
  main_path  PF(31), p = 16, seed 0: uniform and random_perm x {min, ugal,
             ugal_pf} saturations (tol 0.01; iters 250 for min, 1500 for
             the adaptive modes), each with its wall seconds and kernel
             launches, against the JAX package's values recorded in
             tests/fixtures/torch_port_pf31_reference.json

Then the kernel table, the card's `nvidia-smi` name and power limit, and
last the result line.  Any failed phase makes the exit code non-zero and
suppresses the result line; so does a missing card or a checkout without
`src/repro_torch`.  A full record goes to build/chip_smoke.json.
"""
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "torch_port_pf31_reference.json")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
TEST_SHAPES = [(5, 3, 4), (300, 8, 5), (1, 1, 1)]


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def gpu_ms(torch, fn, samples=30, flush_bytes=128 << 20):
    """Median device time of `fn()` in ms: CUDA events around one call,
    right after a read of `flush_bytes`, which leaves the 50 MB L2 holding
    none of `fn`'s inputs (and no dirty lines), and a 1 ms device-side
    spin that keeps the stream busy while the host enqueues the timed call,
    so host launch cost stays out of the window."""
    scratch = torch.ones(flush_bytes // 4, dtype=torch.float32,
                         device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        scratch.sum()
        torch.cuda._sleep(2_000_000)  # about 1 ms of clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


class Smoke:
    def __init__(self):
        self.record = {"phases": {}}
        self.failed = []

    def phase(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
            ok = True
        except Exception:  # report every phase, fail the run at the end
            traceback.print_exc()
            out, ok = {"error": traceback.format_exc(limit=3)}, False
            self.failed.append(name)
        line = {"phase": name, "ok": ok,
                "seconds": round(time.perf_counter() - t0, 3), **out}
        self.record["phases"][name] = line
        emit(line)
        return ok


def phase_device(torch):
    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}


def phase_build():
    from repro_torch.kernels import _build

    _build.build_all()
    logs = _build.build_logs()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    return {"libraries": sorted(_build.LIBRARIES), "ptxas": ptxas}


def main_path_inputs(torch):
    """The PF(31) uniform ugal_pf path-cost inputs the main path gives the
    kernel: its edge ids and a delay table from a real load vector."""
    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.simulation import build_flow_paths, make_pattern
    from repro_torch.simulation import fluid

    pf = build_polarfly(31)
    rt = build_routing(pf.graph, pf)
    pat = make_pattern("uniform", rt, p=16, seed=0)
    fp = build_flow_paths(rt, pat, "ugal_pf", k_candidates=10, seed=0)
    fw, demand, _, _ = fluid._pieces(fp, torch.device("cuda"))
    rho = fw.loads(fw.init, demand * 0.5)
    delay = torch.cat([1.0 + fluid._queue_delay(rho),
                       rho.new_zeros(1)]).contiguous()
    return fp.device_arrays("cuda")[0], delay


def phase_kernels(torch, state):
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import path_costs_ref

    checks = []
    rng = np.random.default_rng(0)
    for shape in TEST_SHAPES:
        e = 37
        delay = np.concatenate([rng.random(e) * 5, np.zeros(1)])
        eidx = rng.integers(0, e + 1, size=shape).astype(np.int32)
        for dtype in (torch.float32, torch.float64):
            d = torch.from_numpy(delay).to("cuda", dtype)
            x = torch.from_numpy(eidx).cuda()
            checks.append((f"{shape}", dtype, d, x))
    eidx, delay = main_path_inputs(torch)
    for dtype in (torch.float32, torch.float64):
        checks.append(("pf31_uniform_ugal_pf", dtype, delay.to(dtype), eidx))
    rows, worst = [], 0.0
    for label, dtype, d, x in checks:
        out = ops.path_costs(d, x)
        ref = path_costs_ref(d, x)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max()) if out.numel() else 0.0
        same = bool(torch.equal(out, ref))
        worst = max(worst, err)
        rows.append({"shape": label, "dtype": str(dtype).split(".")[-1],
                     "bit_identical": same, "max_abs_err": err})
        if not same:
            raise AssertionError(f"path_costs differs from its plain version "
                                 f"at {label} {dtype}: max abs err {err}")
    f, k, l = eidx.shape
    n_out = f * k
    bytes_moved = n_out * l * 4 + n_out * 4 + delay.numel() * 4
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S,
                   n_out * l / FP32_OPS_PER_S) * 1e3
    flat = eidx.view(-1, l)
    table = delay.view(-1, 1)
    ms = gpu_ms(torch, lambda: ops.path_costs(delay, eidx))
    plain_ms = gpu_ms(torch, lambda: path_costs_ref(delay, eidx))
    library_ms = gpu_ms(torch, lambda: F.embedding_bag(flat, table,
                                                       mode="sum"))
    lib = F.embedding_bag(flat, table, mode="sum").view(f, k)
    lib_err = float((lib - ops.path_costs(delay, eidx)).abs().max())
    state["path_costs"] = {
        "name": "path_costs", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/path_costs.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:50",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms}
    return {"checks": rows, "shape": [f, k, l], "table": delay.numel(),
            "bytes": bytes_moved, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bound_us": bound_ms * 1e3, "bound_share": bound_ms / ms}


def phase_parity(torch):
    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.simulation import (build_flow_paths, latency_curve,
                                        make_pattern, saturation_throughput)

    pf = build_polarfly(13)
    rt = build_routing(pf.graph, pf)
    pat = make_pattern("random_perm", rt, p=7, seed=0)
    rows = []
    for mode in ("min", "ugal", "ugal_pf"):
        fp = build_flow_paths(rt, pat, mode, k_candidates=10, seed=0)
        sat_cpu = saturation_throughput(fp, tol=0.01, device="cpu")
        sat_gpu = saturation_throughput(fp, tol=0.01, device="cuda")
        # below saturation: past it the 250-step iterate is chaotic in its
        # last bits and no two arithmetics agree to 1e-3 (see
        # tests/test_torch_fluid.py)
        loads = [f * sat_cpu for f in (0.25, 0.5, 0.75)]
        cpu = latency_curve(fp, loads, iters=250, device="cpu")
        gpu = latency_curve(fp, loads, iters=250, device="cuda")
        rel = max(abs(g.max_util - c.max_util) / c.max_util
                  for c, g in zip(cpu, gpu))
        lat = max(abs(g.mean_latency - c.mean_latency) / c.mean_latency
                  for c, g in zip(cpu, gpu))
        sat_tol = 0.01 if mode == "min" else 0.05
        rows.append({"mode": mode, "sat_cpu": sat_cpu, "sat_gpu": sat_gpu,
                     "max_util_rel": rel, "latency_rel": lat})
        if rel > 1e-3 or abs(sat_gpu - sat_cpu) > sat_tol + 1e-9:
            raise AssertionError(f"card and CPU disagree: {rows[-1]}")
    return {"config": "PF(13) p=7 random_perm seed 0", "runs": rows}


def phase_main_path(torch, state):
    import numpy as np

    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.kernels.minplus import ops
    from repro_torch.simulation import (build_flow_paths, make_pattern,
                                        saturation_throughput)
    from repro_torch.simulation.fluid import _probe_schedule

    with open(FIXTURE) as fh:
        ref = {(r["pattern"], r["mode"]): r["saturation"]
               for r in json.load(fh)["saturations"]}
    tol, probes = 0.01, 7
    iters = {"min": 250, "ugal": 1500, "ugal_pf": 1500}
    t0 = time.perf_counter()
    pf = build_polarfly(31)
    rt = build_routing(pf.graph, pf)
    setup_s = time.perf_counter() - t0
    rows, problems = [], []
    ops.LAUNCHES = 0  # the main path's count starts here
    for pattern in ("uniform", "random_perm"):
        pat = make_pattern(pattern, rt, p=16, seed=0)
        for mode, it in iters.items():
            fp = build_flow_paths(rt, pat, mode, k_candidates=10, seed=0)
            fp.device_arrays("cuda")
            torch.cuda.synchronize()
            before = ops.LAUNCHES
            t = time.perf_counter()
            sat = saturation_throughput(fp, tol=tol, iters=it, device="cuda")
            wall = time.perf_counter() - t
            launches = ops.LAUNCHES - before
            want = it + sum(_probe_schedule(it, probes)) \
                if mode != "min" else 0
            diff = abs(sat - ref[pattern, mode])
            ok = (np.isfinite(sat) and 0.0 <= sat <= 1.0
                  and launches == want
                  and (diff == 0.0 if mode == "min" else diff <= 0.05))
            f, k, l = fp.edges.shape
            rows.append({"pattern": pattern, "mode": mode, "iters": it,
                         "flows": f, "candidates": k, "path_len": l,
                         "saturation": sat, "reference": ref[pattern, mode],
                         "wall_s": wall, "launches": launches,
                         "launches_expected": want, "ok": bool(ok)})
            emit({"phase": "main_path.run", **rows[-1]})
            if not ok:
                problems.append(rows[-1])
    state["launches"] = ops.LAUNCHES
    sats = {(r["pattern"], r["mode"]): r["saturation"] for r in rows}
    ratio = sats["random_perm", "ugal"] / max(sats["random_perm", "min"],
                                              1e-9)
    if ratio < 3.5:
        problems.append({"sanity": "ugal < 3.5 x min on random_perm",
                         "ratio": ratio})
    if problems:
        raise AssertionError(f"main path failed its checks: {problems}")
    return {"config": "PF(31) p=16 seed 0 k_candidates 10 tol 0.01",
            "routing_setup_s": setup_s, "ugal_over_min_random_perm": ratio,
            "kernel_launches": state["launches"], "runs": rows}


def main():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: src/repro_torch is not next to this script",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke, state = Smoke(), {}
    smoke.phase("device", phase_device, torch)
    if smoke.phase("build", phase_build):
        smoke.phase("kernels", phase_kernels, torch, state)
        smoke.phase("parity", phase_parity, torch)
        smoke.phase("main_path", phase_main_path, torch, state)
    kernels = []
    if "path_costs" in state:
        kernels.append({**state["path_costs"],
                        "launches": state.get("launches", 0)})
    smoke.record["kernels"] = kernels
    smi = nvidia_smi()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as fh:
        json.dump({**smoke.record, "nvidia_smi": smi,
                   "failed": smoke.failed}, fh, indent=1)
    emit({"kernels": kernels})
    print(smi, flush=True)
    if smoke.failed or not kernels or not state.get("launches"):
        print(f"chip_smoke: failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
