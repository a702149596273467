#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(nvcc, at first use), holds each kernel against its plain PyTorch version
on the card, checks the port on the card against the port on the CPU, and
drives three paths through the public entry points: the paper's §VIII
saturation path at PolarFly PF(31) (993 routers, p = 16 endpoints each,
about 16k endpoints), the structural-analysis path (the §IV-D routing
table, the §IX diameters under link failure, the blocked routing on the
device BFS) at PF(31) and at the repo's PF(79) scale tier (6321
routers), and the dense transformer's prefill and serve paths at
Gemma2-9B's full width.  Each path's kernel counts are set to 0 just
before it and read just after.  Phases, one JSON line each:

  device     the card's name and power limit
  build      the nvcc build and its seconds
  kernels    each kernel against its plain version (the first four bit
             for bit, tolerance 0), at the test shapes, at one shape per
             route its launch plan can choose, and at the paths' shapes:
             path_costs in fp32 and fp64 (L = 1..5, a misaligned base,
             PF(31) uniform ugal_pf); minplus (float) with INF entries, at
             one and several k ranges, with and without the wrapper's
             padded copy, on APSP's first two squarings of damaged PF(31)
             (padded 996 x 996 and 993 x 993) and a 256-row slice of
             PF(79)'s; minplus_hops (the int16 DPX route `apsp` takes) on
             the same squarings and whole damaged PF(31) and PF(79) APSPs
             against the float route's and PF(31)'s against the plain
             float APSP; gf_crossprod at every q in 2..79, composite
             and prime, at 121, 1290, 46337 and 46340 (the largest q the
             wrapper takes), at n m = 0, 1, 2, 3 mod 4, and on PF(31)'s
             and PF(79)'s full vertex lists.  Kernel, plain and library times
             (CUDA events, median of 30 (3 for a plain version slower than
             0.1 s), L2 emptied of the inputs before each sample) beside
             the bound
  parity     PF(13), p = 7, random_perm: the port on the card against the
             port on the CPU; certified saturations too (ugal, ugal_pf; tol
             0.05, cert_iters 512: values within 0.06, brackets
             overlapping, the same kind)
  main_path  PF(31), p = 16, seed 0: uniform and random_perm x {min, ugal,
             ugal_pf} saturations (tol 0.01; iters 250 for min, 1500 for
             the adaptive modes), each with its wall seconds and kernel
             launches, against the JAX package's values recorded in
             tests/fixtures/torch_port_pf31_reference.json
  certified  the same PF(31) flows through the certified engine
             (`certify=True`, tol 0.01, the default budget): random_perm
             ugal and ugal_pf and uniform ugal (the kernel at full width)
             against the JAX package's certified saturations in
             tests/fixtures/torch_port_pf31_certified.json: value within
             0.06, sat_lo and sat_hi each within one tol step of the
             range the reference's own bracket end spans when its demand
             moves one ulp up or down (its `ulp_runs`), sat_lo <= value,
             the same kind, the uncertified fixture value within [sat_lo
             - 0.06, sat_hi + 0.06]; path-cost launches equal to (probes
             + 1) + 33 * iters / 32 in each; one float64 certified
             `evaluate_load` on uniform ugal at half its saturation,
             512 steps (path_costs_f64 launches only, 2 + 33 * iters /
             32 of them).  Tracing: the random_perm
             ugal certified saturation again with trace=True, bit-identical
             and with trace.final_gap == cert.gap; the main path's
             random_perm ugal uncertified saturation with trace=True,
             bit-identical to main_path's value, its solve run under
             torch.cuda.set_sync_debug_mode("error") (it reads nothing
             back on the host)
  analysis   §IV-D: `intermediate_table` at PF(31) against the host
             `intermediates_all_pairs()` off the diagonal, and at PF(79)
             on 4096 seeded random pairs against the host
             `intermediate(s, d)`.  §IX, Fig. 14's failure fractions in
             `resilience_sweep`'s cumulative order, seed 1: PF(31)
             `diameter_from_adj` at 0.05/0.2/0.4/0.55 against the host
             sweep's diameters (-1 <-> inf); PF(79) at 0.05/0.2, the APSP
             distance matrix against the device BFS
             (`distance_blocks(backend="sharded")`) over all pairs, and
             `diameter_and_aspl(backend="sharded")` against it.  Blocked
             routing: PF(31) `build_blocked_routing(backend="sharded")`
             next-hop columns against the host backend's.  Wall seconds
             and launches for each (10 minplus_hops launches per PF(31)
             APSP, 13 per PF(79) one, none of the float minplus kernel, 1
             gf_crossprod launch per table)
  model      Gemma2-9B at its published widths (d_model 3584, 16/8 heads
             of 256, d_ff 14336, vocab 256000, window 4096, softcaps
             50/30), bf16, random parameters from seed 0, all 42 layers
             (no depth cut): the prefill (`forward` on B = 1, S = 8192)
             with its wall seconds, flash-attention launches (one a
             layer, all of them the sm90 tensor-core kernel: 42) and
             finite logits, and a torch.profiler breakdown of one more
             prefill; `launch.serve.generate` answering 4
             greedy requests (prompt 16, 32 new tokens) after one warm-up
             run, three timed runs and their median tokens/s (a smoke
             reading, not a serve rate), and one profiled decode step;
             then float32 at full width with 4 layers (two local/global
             pairs), B = 2, 48 tokens, TF32 off: step-by-step
             `decode_step` logits against the kernel-backed `forward`
             (4 launches, all of them the CUDA-core kernel),
             and the card's `forward` against the port's on the CPU from
             the same parameters, both at rtol = atol = 2e-3
             (tests/test_models.py's decode-vs-forward bar)

The kernels phase also holds both flash-attention kernels against their
plain version: the sm90 tensor-core kernel (csrc/flash_attention_sm90.cu,
where `ops.attention` sends bf16 at D = 64, 128, 192, 256) and the
CUDA-core kernel (csrc/flash_attention.cu, where it sends float32, and in
bf16 through `ops._launch`, the route bf16 takes at other head dims), at
tests/test_kernels.py's five cases, a ragged S = 200, nemotron's head dim
(D = 192, 12 q heads a kv head) and a ragged S = 333 at D = 256, and at the
prefill's shapes (B = 1, 16/8 heads, S = 8192, D = 256, softcap 50,
causal, window 4096 and none).  fp32 is held at 2e-6, the JAX test's bar.
bf16 is held at the JAX test's 2e-2 and, element by element, within one
bf16 rounding of the plain version (2^-7 |ref| + 1e-5): the kernels and
the plain version compute in fp32 (the sm90 kernel with p split into two
bf16 operands) and round once, and at the prefill's shapes, where |out|
is about 0.01, 2e-2 alone would pass a kernel that drops a key.  Both
kernels' times (bf16), the plain version's and the bound at the prefill's
shapes and, at the same shape without softcap, the kernels' beside
`scaled_dot_product_attention`'s (the library time; the port never calls
it).  In the kernel table the sm90 kernel's launches are the bf16
prefill's, the CUDA-core kernel's those of the float32 consistency run.

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
CERT_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                            "torch_port_pf31_certified.json")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# Issue rates in lane-instructions a second, 132 SMs x lanes x 1.98 GHz.
# fp32 add (67 TFLOP/s counts an FMA as two) and int32 add at 128 lanes;
# fp32 min (FMNMX) and int32 multiply at 64 (scripts/fp32_issue_rate.py
# measures all four on the card).  A (min,+) candidate is one FADD and one
# FMNMX: 2 instructions at 128 lanes or one FMNMX at 64 give the same
# least time.
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2
INT32_ALU_PER_S = 132 * 128 * 1.98e9
INT32_MUL_PER_S = 132 * 64 * 1.98e9
TEST_SHAPES = [(5, 3, 4), (300, 8, 5), (1, 1, 1)]
# path_costs' other vector-row widths (L = 2, 3) beside TEST_SHAPES' L = 4,
# 5 (the generic kernel) and 1
PATH_COST_ROUTE_SHAPES = [(999, 3, 2), (999, 3, 3)]
MINPLUS_SHAPES = [(1, 1, 1), (130, 70, 50), (257, 129, 65)]
# (m, k, n) for minplus' other plans: one k range (289 tiles) with rows
# aligned and with a padded copy of a, and k split with rows aligned
MINPLUS_ROUTE_SHAPES = [(2048, 64, 2048), (2048, 67, 2048), (512, 1000, 512)]
# Hopper's DPX add-then-min on int16 pairs (VIADDMNMX): 64 lanes a clock
# on each of 132 SMs at 1.98 GHz, two candidates a lane
# (scripts/fp32_issue_rate.py measures it on the card)
DPX_S16X2_CANDIDATES_PER_S = 132 * 64 * 1.98e9 * 2
GF_SIZES = [(1, 1), (5, 7), (300, 257)]
FIG14_FRACTIONS = {31: [0.05, 0.2, 0.4, 0.55], 79: [0.05, 0.2]}
NO_LIBRARY = "no single PyTorch call computes it"
BF16_TC_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
# tests/test_kernels.py's flash-attention CASES, then a ragged S, then
# nemotron's head dim (192, 12 q heads a kv head) and a ragged S at D = 256:
# b, hq, hkv, s, d, causal, softcap, window
FLASH_CASES = [(2, 4, 2, 128, 64, True, None, None),
               (1, 4, 4, 256, 64, True, 50.0, None),
               (1, 8, 2, 256, 128, True, None, 128),
               (1, 2, 1, 128, 64, False, None, None),
               (1, 2, 2, 128, 256, True, 30.0, 64),
               (1, 4, 2, 200, 64, True, 50.0, 48),
               (1, 12, 1, 256, 192, True, None, None),
               (1, 4, 2, 333, 256, True, 50.0, None)]
# the JAX test's own bars; the kernel and cuBLAS sum in other orders
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
# bf16 is also held element by element within one bf16 rounding of the
# plain version, 2^-7 |ref| + 1e-5: kernel and plain version both compute
# in float32 and round once at the end, so one unit in the last place (at
# most 2^-7 of the value) is all they may differ by.  At the prefill's
# shapes |out| is about 0.01 and 2e-2 would pass a wrong kernel; a key
# dropped from a 4096-key window moves outputs by about 1e-4, ten times
# this bar
FLASH_BF16_BAR = {"atol": 1e-5, "rtol": 2.0 ** -7}
GEMMA = "gemma2-9b"
PREFILL_S = 8192
SERVE = {"batch": 4, "prompt": 16, "tokens": 32, "runs": 3}
# fp32 consistency at full width: two local/global pairs, B = 2, 48 tokens
CONSISTENCY = {"layers": 4, "batch": 2, "seq": 48, "tol": 2e-3}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def gpu_ms(torch, fn, samples=30, flush_bytes=128 << 20, warmup=3):
    """Median device time of `fn()` in ms: CUDA events around one call,
    right after a read of `flush_bytes`, which leaves the 50 MB L2 holding
    none of `fn`'s inputs (and no dirty lines), and a 1 ms device-side
    spin that keeps the stream busy while the host enqueues the timed call,
    so host launch cost stays out of the window."""
    scratch = torch.ones(flush_bytes // 4, dtype=torch.float32,
                         device="cuda")
    for _ in range(warmup):
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


def kernel_name(mangled):
    """The kernel's own name in an Itanium-mangled nested name, with its
    template arguments as mangled (e.g. "flash_attention_sm90_kernelILi256")."""
    i, names = 3 if mangled.startswith("_ZN") else 0, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        names.append(mangled[j:j + n])
        i = j + n
    if not names:
        return mangled[:48]
    return names[-1] + mangled[i:].split("Ev")[0].rstrip("E")[:24]


def phase_build():
    from repro_torch.kernels import _build

    _build.build_all()
    ptxas = {}
    for name, log in _build.build_logs().items():
        rows, kernel = [], ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln and "'" in ln:
                kernel = kernel_name(ln.split("'")[1])
            elif "registers" in ln or "spill" in ln:
                rows.append(f"{kernel}: {ln.strip()}")
            elif "C7512" in ln:  # wgmma serialised for want of registers
                rows.append(ln.strip())
        ptxas[name] = rows
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


def kernel_path_costs(torch, state):
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import path_costs_ref

    checks = []
    rng = np.random.default_rng(0)
    for shape in TEST_SHAPES + PATH_COST_ROUTE_SHAPES:
        e = 37
        delay = np.concatenate([rng.random(e) * 5, np.zeros(1)])
        eidx = rng.integers(0, e + 1, size=shape).astype(np.int32)
        for dtype in (torch.float32, torch.float64):
            d = torch.from_numpy(delay).to("cuda", dtype)
            x = torch.from_numpy(eidx).cuda()
            checks.append((f"{shape}", dtype, d, x))
    # a base 4 bytes past 16-byte alignment: the generic kernel at L = 4
    x = torch.from_numpy(rng.integers(0, 38, 1 + 999 * 4).astype(
        np.int32)).cuda()[1:].view(333, 3, 4)
    checks.append(("(333, 3, 4) misaligned base", torch.float32,
                   checks[0][2], x))
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
        plan = ops._path_costs_plan(out.numel(), x.shape[-1], x.data_ptr())
        rows.append({"shape": label, "dtype": str(dtype).split(".")[-1],
                     **plan, "bit_identical": same, "max_abs_err": err})
        if not same:
            raise AssertionError(f"path_costs differs from its plain version "
                                 f"at {label} {dtype}: max abs err {err}")
    f, k, l = eidx.shape
    n_out = f * k
    times = {}
    for dtype in (torch.float32, torch.float64):
        d = delay.to(dtype)
        size = d.element_size()
        bytes_moved = n_out * l * 4 + n_out * size + d.numel() * size
        bound = max(bytes_moved / HBM_BYTES_PER_S,
                    n_out * l / FP32_OPS_PER_S) * 1e3
        ms = gpu_ms(torch, lambda: ops.path_costs(d, eidx))
        times[str(dtype).split(".")[-1]] = {
            "kernel_ms": ms, "bound_ms": bound, "bound_share": bound / ms,
            "bytes": bytes_moved,
            "plan": ops._path_costs_plan(n_out, l, eidx.data_ptr())}
    t32 = times["float32"]
    flat = eidx.view(-1, l)
    table = delay.view(-1, 1)
    plain_ms = gpu_ms(torch, lambda: path_costs_ref(delay, eidx))
    library_ms = gpu_ms(torch, lambda: F.embedding_bag(flat, table,
                                                       mode="sum"))
    lib = F.embedding_bag(flat, table, mode="sum").view(f, k)
    lib_err = float((lib - ops.path_costs(delay, eidx)).abs().max())
    state["path_costs"] = {
        "name": "path_costs", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/path_costs.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:50",
        "max_abs_err": worst, "ms": t32["kernel_ms"], "plain_ms": plain_ms,
        "bound_ms": t32["bound_ms"], "bound_by": "bytes",
        "library_ms": library_ms}
    return {"checks": rows, "shape": [f, k, l], "table": delay.numel(),
            "times": times, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err}


def damaged(g, fractions, seed=1):
    """`g` with each of `fractions` of its links removed, in
    `resilience_sweep`'s cumulative shuffled order (Fig. 14)."""
    import numpy as np

    edges = g.edge_list.copy()
    np.random.default_rng(seed).shuffle(edges)
    return [g.subgraph_without_edges(edges[:int(round(f * len(edges)))])
            for f in fractions]


def graphs(state):
    """PF(31) and PF(79) (built once) and their damaged copies."""
    from repro_torch.core.polarfly import build_polarfly

    if "pf" not in state:
        t0 = time.perf_counter()
        state["pf"] = {q: build_polarfly(q) for q in (31, 79)}
        state["pf_build_s"] = time.perf_counter() - t0
        state["damaged"] = {q: damaged(state["pf"][q].graph, fr)
                            for q, fr in FIG14_FRACTIONS.items()}
    return state["pf"], state["damaged"]


def held(torch, label, out, ref):
    torch.cuda.synchronize()
    same = bool(torch.equal(out, ref))
    err = float((out.double() - ref.double()).abs().max()) \
        if out.numel() else 0.0
    if not same:
        raise AssertionError(f"kernel differs from its plain version at "
                             f"{label}: max abs err {err}")
    return {"shape": label, "bit_identical": same, "max_abs_err": err}


def squarings(torch, dmg, dist0, square):
    """The damaged (0.05) PF(31) and PF(79) matrices of APSP's first two
    squarings, as `apsp` builds them (`dist0`) and squares them."""
    mats = {}
    for q in (31, 79):
        d0 = dist0(torch.from_numpy(dmg[q][0].adjacency).cuda())
        mats[q] = (d0, square(d0))
    return mats


def kernel_minplus(torch, state):
    import numpy as np

    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import INF, minplus_ref

    _, dmg = graphs(state)
    rng = np.random.default_rng(0)
    rows = []
    for m, k, n in MINPLUS_SHAPES + MINPLUS_ROUTE_SHAPES:
        a = rng.random((m, k), dtype=np.float32) * 10
        b = rng.random((k, n), dtype=np.float32) * 10
        a[rng.random((m, k)) < 0.3] = INF
        b[rng.random((k, n)) < 0.3] = INF
        a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        rows.append({**held(torch, f"{(m, k, n)} with INF",
                            ops.minplus(a, b), minplus_ref(a, b)),
                     "plan": ops._minplus_plan(m, n, k),
                     "padded_copy": k % 4 != 0 or n % 4 != 0})
    # APSP's first two squarings on damaged PF(31) and PF(79) (0.05), on
    # the padded matrices `apsp`'s float route squares, and PF(31)'s on the
    # n x n matrix (the wrapper's padded copy)
    mats = squarings(torch, dmg, ops.apsp_dist0, lambda d: ops.minplus(d, d))
    for step in (0, 1):
        d = mats[31][step]
        rows.append(held(torch, f"pf31 damaged 0.05, squaring {step + 1}",
                         ops.minplus(d, d), minplus_ref(d, d)))
        d = d[:993, :993].contiguous()
        rows.append(held(torch, f"pf31 damaged 0.05, squaring {step + 1}, "
                         f"993 x 993", ops.minplus(d, d), minplus_ref(d, d)))
        d = mats[79][step]
        a = d[:256].contiguous()
        rows.append(held(torch, f"pf79 damaged 0.05, squaring {step + 1}, "
                         f"rows 0-255", ops.minplus(a, d),
                         minplus_ref(a, d)))
    times = {}
    for q in (31, 79):
        d = mats[q][1]
        n = d.shape[0]
        ms = gpu_ms(torch, lambda: ops.minplus(d, d))
        plain = gpu_ms(torch, lambda: minplus_ref(d, d),
                       samples=30 if q == 31 else 3,
                       warmup=3 if q == 31 else 1)
        bytes_moved = 3 * n * n * 4
        ops_count = 2 * n ** 3
        bound = max(bytes_moved / HBM_BYTES_PER_S,
                    ops_count / FP32_INSTR_PER_S) * 1e3
        times[f"pf{q}"] = {"n": n, "plan": ops._minplus_plan(n, n, n),
                           "kernel_ms": ms, "plain_ms": plain,
                           "bound_ms": bound, "bound_share": bound / ms,
                           "bytes": bytes_moved, "lane_instructions":
                           ops_count}
    worst = max(r["max_abs_err"] for r in rows)
    t79 = times["pf79"]
    state["minplus"] = {
        "name": "minplus", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/minplus.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:80",
        "max_abs_err": worst, "ms": t79["kernel_ms"],
        "plain_ms": t79["plain_ms"], "bound_ms": t79["bound_ms"],
        "bound_by": "operations", "library_ms": None}
    return {"checks": rows, "times": times, "timed_at": "pf79",
            "library": None, "library_reason": NO_LIBRARY}


def kernel_minplus_hops(torch, state):
    """The integer (DPX) route `apsp` takes: each squaring held against its
    plain version, whole damaged PF(31) and PF(79) APSPs against the float
    route's (float kernel) and PF(31)'s against the plain float APSP."""
    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import (apsp_ref, apsp_steps,
                                                 minplus_hops_ref,
                                                 minplus_ref)

    _, dmg = graphs(state)
    rows = []
    mats = squarings(torch, dmg, ops.apsp_hops0, ops.minplus_hops)
    for step in (0, 1):
        d = mats[31][step]
        rows.append(held(torch, f"pf31 damaged 0.05, squaring {step + 1}",
                         ops.minplus_hops(d), minplus_hops_ref(d)))
        d = mats[79][step]
        out = ops.minplus_hops(d)[:256].float()
        rows.append(held(torch, f"pf79 damaged 0.05, squaring {step + 1}, "
                         f"rows 0-255", out,
                         minplus_ref(d[:256].float().contiguous(),
                                     d.float())))
    apsps = []
    for q in (31, 79):
        for f, g in zip(FIG14_FRACTIONS[q][:2], dmg[q][:2]):
            adj = torch.from_numpy(g.adjacency).cuda()
            n = g.n
            hops = ops._apsp_device(g.adjacency, "cuda")
            d = ops.apsp_dist0(adj)
            for _ in range(apsp_steps(n)):
                d = ops.minplus(d, d)
            flt = d[:n, :n]
            rows.append(held(torch, f"pf{q} damaged {f} apsp, float route",
                             hops, flt))
            if q == 31:
                rows.append(held(torch, f"pf31 damaged {f} apsp, plain",
                                 hops, apsp_ref(adj)))
            apsps.append({"q": q, "fraction": f, "route": ops._apsp_route(
                n, bool(torch.equal(adj, adj.T)))})
    times = {}
    for q in (31, 79):
        d = mats[q][1]
        n = d.shape[0]
        ms = gpu_ms(torch, lambda: ops.minplus_hops(d))
        plain = gpu_ms(torch, lambda: minplus_hops_ref(d),
                       samples=30 if q == 31 else 3,
                       warmup=3 if q == 31 else 1)
        bytes_moved = 2 * n * n * 2
        by_ops = n ** 3 / DPX_S16X2_CANDIDATES_PER_S * 1e3
        bound = max(bytes_moved / HBM_BYTES_PER_S * 1e3, by_ops)
        times[f"pf{q}"] = {"n": n, "plan": ops._hops_plan(n),
                           "kernel_ms": ms, "plain_ms": plain,
                           "bound_ms": bound, "bound_share": bound / ms,
                           "float_bound_ms": 2 * n ** 3 / FP32_INSTR_PER_S
                           * 1e3, "bytes": bytes_moved, "candidates": n ** 3}
    t79 = times["pf79"]
    state["minplus_hops"] = {
        "name": "minplus_hops", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/minplus_dpx.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:80",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": t79["kernel_ms"], "plain_ms": t79["plain_ms"],
        "bound_ms": t79["bound_ms"], "bound_by": "operations",
        "library_ms": None}
    return {"checks": rows, "apsp_routes": apsps, "times": times,
            "timed_at": "pf79", "library": None,
            "library_reason": NO_LIBRARY}


def gf_ops_per_pair():
    """(int32 multiplies, all integer instructions) of one (i, j) pair in
    csrc/crossprod.cu, counted from its code.  A remainder (mod_q) is the
    four instructions it compiles to: umulhi, multiply-add, subtract, min
    (two of them multiplies); a cross-product term is two multiply-adds
    and its remainder; the inverse one index and one shared-memory load.
    The power table's prologue (q entries a block, 2 log2 q remainders
    each) is left out: it is not work of the function, and at PF(79) it is
    under 0.3 % of the pair work."""
    mod = (2, 4)  # (multiplies, instructions)
    cross = (3 * (2 + mod[0]), 3 * (2 + mod[1]))  # 3 terms
    lead = (0, 4)  # two compares, two selects
    inverse = (0, 2)  # index, LDS.U16
    normalise = (3 * (1 + mod[0]), 3 * (1 + mod[1]))
    loads = (1, 4)  # the d row's index and its three loads
    walk = (0, 2)  # next column, compare
    store = (0, 3)  # 3 STS.128 + 3 LDS.128 + 3 STG.128 for 4 pairs
    parts = (cross, lead, inverse, normalise, loads, walk, store)
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


# q the kernel is held at besides 2..79: a prime (46337) and a composite
# (46340) at the top of the range the wrapper takes (a 92.7 KB power
# table).  Shapes: n m = 1, 2, 3 mod 4 in the scalar tail ((7, 1) to
# (129, 131)); m < 4 over whole 128-pair chunks, where rows change inside
# a lane's four pairs ((300, 1) on); and, at GF_STRIDE_Q, m < 4 with more
# chunks than the launcher's wave has warps, so the stride step runs
GF_LARGE_Q = [46337, 46340]
GF_EDGE_SIZES = [(7, 1), (9, 2), (11, 3), (129, 131), (300, 1), (97, 2),
                 (131, 3), (129, 3)]
GF_STRIDE_Q = [2, 9, 79, 46337]
GF_STRIDE_SIZES = [(900001, 1), (500001, 2), (300001, 3)]


def kernel_gf_crossprod(torch, state):
    import numpy as np

    from repro_torch.kernels.gf_crossprod import ops
    from repro_torch.kernels.gf_crossprod.ref import crossprod_normalized_ref

    pf, _ = graphs(state)
    rng = np.random.default_rng(0)
    rows = []
    for q in list(range(2, 80)) + [121, 1290] + GF_LARGE_Q:
        for n, m in GF_SIZES + GF_EDGE_SIZES:
            s = torch.from_numpy(rng.integers(0, q, (n, 3)).astype(
                np.int32)).cuda()
            d = torch.from_numpy(rng.integers(0, q, (m, 3)).astype(
                np.int32)).cuda()
            d[: min(n, m) // 2] = s[: min(n, m) // 2]  # parallel -> zero
            rows.append(held(torch, f"q={q} {(n, m)}",
                             ops.crossprod_normalized(s, d, q),
                             crossprod_normalized_ref(s, d, q)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for q in GF_STRIDE_Q:
        for n, m in GF_STRIDE_SIZES:
            s = torch.randint(0, q, (n, 3), generator=gen, device="cuda",
                              dtype=torch.int32)
            d = torch.randint(0, q, (m, 3), generator=gen, device="cuda",
                              dtype=torch.int32)
            d[: m // 2] = s[: m // 2]  # parallel -> zero
            rows.append(held(torch, f"q={q} {(n, m)}",
                             ops.crossprod_normalized(s, d, q),
                             crossprod_normalized_ref(s, d, q)))
    # every check above raised unless bit-identical; keep a few in the record
    checked = {"count": len(rows), "q": "2..79, 121, 1290, 46337, 46340",
               "sizes": GF_SIZES + GF_EDGE_SIZES,
               "stride_sizes": {"q": GF_STRIDE_Q, "sizes": GF_STRIDE_SIZES},
               "max_abs_err": max(r["max_abs_err"] for r in rows)}
    rows = [r for r in rows if r["shape"].startswith(("q=2 ", "q=9 ",
                                                      "q=79 ", "q=4634"))]
    times = {}
    for q in (31, 79):
        v = torch.from_numpy(pf[q].vertices.astype(np.int32)).cuda()
        rows.append(held(torch, f"pf{q} vertices x vertices",
                         ops.crossprod_normalized(v, v, q),
                         crossprod_normalized_ref(v, v, q)))
        n = v.shape[0]
        ms = gpu_ms(torch, lambda: ops.crossprod_normalized(v, v, q))
        plain = gpu_ms(torch, lambda: crossprod_normalized_ref(v, v, q))
        bytes_moved = 12 * n * n + 2 * 12 * n
        muls, int_ops = gf_ops_per_pair()
        by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        by_ops = max(muls / INT32_MUL_PER_S,
                     int_ops / INT32_ALU_PER_S) * n * n * 1e3
        times[f"pf{q}"] = {"n": n, "kernel_ms": ms, "plain_ms": plain,
                           "bound_ms": max(by_bytes, by_ops),
                           "bytes_ms": by_bytes, "ops_ms": by_ops,
                           "ops_per_pair": int_ops,
                           "multiplies_per_pair": muls,
                           "bound_share": max(by_bytes, by_ops) / ms}
    t79 = times["pf79"]
    state["gf_crossprod"] = {
        "name": "gf_crossprod", "route": "cuda",
        "source": "src/repro_torch/kernels/gf_crossprod/csrc/crossprod.cu",
        "replaces": "src/repro/kernels/gf_crossprod/kernel.py:52",
        "max_abs_err": max([checked["max_abs_err"]]
                           + [r["max_abs_err"] for r in rows]),
        "ms": t79["kernel_ms"], "plain_ms": t79["plain_ms"],
        "bound_ms": t79["bound_ms"],
        "bound_by": ("bytes" if t79["bytes_ms"] >= t79["ops_ms"]
                     else "operations"),
        "library_ms": None}
    return {"checked": checked, "checks": rows, "times": times,
            "timed_at": "pf79", "library": None,
            "library_reason": NO_LIBRARY}


def attention_pairs(s, causal, window):
    """Unmasked (query, key) pairs of one head at sequence length s."""
    total = 0
    for i in range(s):
        hi = i if causal else s - 1
        lo = max(0, i - window + 1) if window else 0
        total += hi - lo + 1
    return total


def flash_bound_ms(b, hq, hkv, s, d, causal, window, itemsize):
    """(bound ms, flop-bound ms, byte-bound ms): 4 D flops per unmasked
    pair and head at the dense bf16 tensor-core rate; q, k, v, o read or
    written once at HBM rate."""
    flops = 4 * d * attention_pairs(s, causal, window) * hq * b
    nbytes = (2 * hq + 2 * hkv) * b * s * d * itemsize
    by_ops = flops / BF16_TC_FLOPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), by_ops, by_bytes


def gemma_attention_shape():
    """(B, Hq, Hkv, S, D, softcap, window) of one Gemma2-9B prefill layer."""
    from repro_torch.configs import get_config

    cfg = get_config(GEMMA)
    return (1, cfg.num_heads, cfg.num_kv_heads, PREFILL_S, cfg.head_dim,
            cfg.attn_softcap, cfg.local_window)


def kernel_flash_attention(torch, state):
    """Both flash-attention kernels against the plain version: the sm90
    tensor-core kernel (bf16 at D in {64, 128, 192, 256}, where
    `ops.attention` sends bf16) and the CUDA-core kernel in float32 (where
    `ops.attention` sends float32) and in bf16 (`ops._launch`, the route
    bf16 takes at other head dims), at FLASH_CASES and at the Gemma2-9B
    prefill shapes; then both kernels' times at those shapes beside the
    plain version's, the bound and SDPA's."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_chunked,
                                                         attention_ref)

    def inputs(b, hq, hkv, s, d, dtype, seed=0):
        rng = np.random.default_rng(seed)
        return [torch.from_numpy(rng.standard_normal(shape) * 0.5).to(
            "cuda", dtype) for shape in ((b, hq, s, d), (b, hkv, s, d),
                                         (b, hkv, s, d))]

    rows = []
    worst = {"sm90": {"bfloat16": 0.0},
             "simt": {"float32": 0.0, "bfloat16": 0.0}}

    def hold(label, route, out, want):
        """Every element within the dtype's bar of the plain version: the
        JAX test's (FLASH_TOL) and, in bf16, one rounding (FLASH_BF16_BAR)."""
        torch.cuda.synchronize()
        name = str(out.dtype).split(".")[-1]
        o, w = out.float(), want.float()
        diff = (o - w).abs()
        err = float(diff.max())
        bar = FLASH_BF16_BAR if name == "bfloat16" else \
            {"atol": FLASH_TOL[name], "rtol": 0.0}
        share = float((diff / (bar["atol"] + bar["rtol"] * w.abs())).max())
        ok = bool(torch.isfinite(o).all()) and err <= FLASH_TOL[name] \
            and share <= 1.0
        worst[route][name] = max(worst[route][name], err)
        rows.append({"case": label, "kernel": route, "dtype": name,
                     "max_abs_err": err, "tol": FLASH_TOL[name], **bar,
                     "worst_share_of_bar": share, "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention differs from its plain "
                                 f"version at {label} {name}: {rows[-1]}")

    def routed(x, **kw):
        """`ops.attention` and the kernel its launch went through."""
        before = dict(ops.LAUNCHES_BY_KERNEL)
        out = ops.attention(*x, **kw)
        used = [k for k, n in ops.LAUNCHES_BY_KERNEL.items()
                if n != before[k]]
        if len(used) != 1 or used[0] != ops._route(x[0].dtype,
                                                    x[0].shape[3]):
            raise AssertionError(f"attention launched {used} for "
                                 f"{x[0].dtype} at D = {x[0].shape[3]}")
        return used[0], out

    def simt(x, causal=True, softcap=None, window=None):
        return ops._launch(*x, causal, softcap, window, None, "simt")

    for case in FLASH_CASES:
        b, hq, hkv, s, d, causal, cap, win = case
        kw = {"causal": causal, "softcap": cap, "window": win}
        for dtype in (torch.float32, torch.bfloat16):
            x = inputs(b, hq, hkv, s, d, dtype)
            want = attention_ref(*x, **kw)
            hold(str(case), *routed(x, **kw), want)
            if dtype == torch.bfloat16:
                hold(str(case), "simt", simt(x, **kw), want)
    # the prefill's shapes: Gemma2-9B, local (window) and global, in bf16
    # (both kernels) and in float32 on the same (bf16-exact) inputs
    b, hq, hkv, s, d, cap, win = gemma_attention_shape()
    q, k, v = inputs(b, hq, hkv, s, d, torch.bfloat16, seed=1)
    times = {}
    for layer, window in (("local", win), ("global", None)):
        label = f"{GEMMA} {layer} {(b, hq, hkv, s, d)} softcap {cap}"
        want = attention_chunked(q, k, v, softcap=cap, window=window)
        hold(label, *routed((q, k, v), softcap=cap, window=window), want)
        hold(label, "simt", simt((q, k, v), softcap=cap, window=window),
             want)
        x32 = (q.float(), k.float(), v.float())
        hold(label, *routed(x32, softcap=cap, window=window),
             attention_chunked(*x32, softcap=cap, window=window))
        del x32, want
        bound, by_ops, by_bytes = flash_bound_ms(b, hq, hkv, s, d, True,
                                                 window, 2)
        sm90_ms = gpu_ms(torch, lambda: ops.attention(
            q, k, v, softcap=cap, window=window), samples=10)
        simt_ms = gpu_ms(torch, lambda: simt((q, k, v), softcap=cap,
                                             window=window), samples=10)
        plain = gpu_ms(torch, lambda: attention_chunked(
            q, k, v, softcap=cap, window=window), samples=3, warmup=1)
        times[layer] = {"window": window, "sm90_ms": sm90_ms,
                        "simt_bf16_ms": simt_ms, "plain_ms": plain,
                        "bound_ms": bound, "flops_ms": by_ops,
                        "bytes_ms": by_bytes,
                        "sm90_bound_share": bound / sm90_ms,
                        "simt_bound_share": bound / simt_ms}
    # where SDPA computes the same function: causal, no softcap, no window
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    lib_err = float((sdpa().float() - ops.attention(q, k, v).float()
                     ).abs().max())
    times["causal_no_softcap"] = {
        "sm90_ms": gpu_ms(torch, lambda: ops.attention(q, k, v),
                          samples=10),
        "simt_bf16_ms": gpu_ms(torch, lambda: simt((q, k, v)), samples=10),
        "library_ms": gpu_ms(torch, sdpa, samples=10),
        "library_max_abs_err": lib_err,
        "bound_ms": flash_bound_ms(b, hq, hkv, s, d, True, None, 2)[0]}
    library_ms = times["causal_no_softcap"]["library_ms"]
    g = times["global"]
    common = {
        "route": "cuda",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:92",
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": "operations" if g["flops_ms"] >= g["bytes_ms"]
        else "bytes",
        "library_ms": library_ms,
        "library_computes": "scaled_dot_product_attention(is_causal=True, "
                            "enable_gqa=True) at the same shape: causal "
                            "attention without the softcap (less than the "
                            "kernels do)"}
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    state["flash_attention_sm90"] = {
        "name": "flash_attention_sm90", **common,
        "source": src + "flash_attention_sm90.cu",
        "max_abs_err": worst["sm90"]["bfloat16"], "ms": g["sm90_ms"],
        "timed_at": f"{GEMMA} global layer, bf16"}
    state["flash_attention"] = {
        "name": "flash_attention", **common,
        "source": src + "flash_attention.cu",
        "max_abs_err": max(worst["simt"].values()), "ms": g["simt_bf16_ms"],
        "timed_at": f"{GEMMA} global layer, bf16 (the prefill runs float32 "
                    f"through it only in the consistency run)"}
    return {"checks": rows, "max_abs_err": worst, "times": times,
            "timed_at": f"{GEMMA} prefill layer, S={s}, bf16",
            "smem_bytes_d256": {"sm90": ops.smem_bytes(d, "sm90"),
                                "simt": ops.smem_bytes(d)}}


def phase_kernels(torch, state):
    return {"path_costs": kernel_path_costs(torch, state),
            "minplus": kernel_minplus(torch, state),
            "minplus_hops": kernel_minplus_hops(torch, state),
            "gf_crossprod": kernel_gf_crossprod(torch, state),
            "flash_attention": kernel_flash_attention(torch, state)}


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
        if mode == "min":
            continue
        # the certified engine, held as tests/test_torch_certified.py's
        # card test holds it
        kw = {"tol": 0.05, "certify": True, "cert_iters": 512}
        cpu = saturation_throughput(fp, device="cpu", **kw)
        gpu = saturation_throughput(fp, device="cuda", **kw)
        overlap = max(cpu.sat_lo, gpu.sat_lo) <= min(cpu.sat_hi,
                                                      gpu.sat_hi) + 1e-9
        rows.append({"mode": mode, "certified": True,
                     "value_cpu": cpu.value, "value_gpu": gpu.value,
                     "bracket_cpu": [cpu.sat_lo, cpu.sat_hi],
                     "bracket_gpu": [gpu.sat_lo, gpu.sat_hi],
                     "iters_cpu": cpu.cert.iters, "iters_gpu": gpu.cert.iters,
                     "kind": gpu.cert.kind})
        if (abs(gpu.value - cpu.value) > 0.06 or not overlap
                or gpu.cert.kind != cpu.cert.kind):
            raise AssertionError(f"certified card and CPU disagree: "
                                 f"{rows[-1]}")
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
    state["pf31_routing"], state["main_sats"] = rt, sats
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


def phase_certified(torch, state):
    """The certified engine and `trace=True` on the main path's PF(31)
    flows.  The path-cost counts start at 0 here and are read at the
    end."""
    import math

    import numpy as np

    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.kernels.minplus import ops
    from repro_torch.simulation import (build_flow_paths, evaluate_load,
                                        make_pattern, saturation_throughput)
    from repro_torch.simulation import fluid

    with open(CERT_FIXTURE) as fh:
        cref = {(r["pattern"], r["mode"]): r
                for r in json.load(fh)["saturations"]}
    with open(FIXTURE) as fh:
        uref = {(r["pattern"], r["mode"]): r["saturation"]
                for r in json.load(fh)["saturations"]}
    tol = 0.01
    probes = max(1, int(math.ceil(math.log2(1.0 / tol))))
    rt = state.get("pf31_routing")
    if rt is None:
        pf = build_polarfly(31)
        rt = build_routing(pf.graph, pf)
    pats = {p: make_pattern(p, rt, p=16, seed=0)
            for p in ("random_perm", "uniform")}
    fps = {}

    def flows(pattern, mode):
        if (pattern, mode) not in fps:
            fp = build_flow_paths(rt, pats[pattern], mode, k_candidates=10,
                                  seed=0)
            fp.device_arrays("cuda")
            fps[pattern, mode] = fp
        return fps[pattern, mode]

    rows, problems = [], []

    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)

    def certified(pattern, mode, **kw):
        fp = flows(pattern, mode)
        torch.cuda.synchronize()
        before = ops.LAUNCHES
        t = time.perf_counter()
        res = saturation_throughput(fp, tol=tol, certify=True,
                                    device="cuda", **kw)
        wall = time.perf_counter() - t
        launches = ops.LAUNCHES - before
        want = (probes + 1) + 33 * res.cert.iters // 32
        row = {"pattern": pattern, "mode": mode, "wall_s": wall,
               "value": res.value, "sat_lo": res.sat_lo,
               "sat_hi": res.sat_hi, "iters": res.cert.iters,
               "converged": res.cert.converged, "gap": res.cert.gap,
               "util_lb": res.cert.util_lb, "util_ub": res.cert.util_ub,
               "kind": res.cert.kind, "dtype": res.cert.dtype,
               "launches": launches, "launches_expected": want,
               "trace": "trace" in kw,
               "ok": check(launches == want and np.isfinite(res.value)
                           and res.sat_lo <= res.value + 1e-9,
                           f"{pattern} {mode} launches or bracket")}
        return res, row

    ops.LAUNCHES = 0  # the certified path's counts start here
    ops.LAUNCHES_BY_DTYPE.update(float32=0, float64=0)
    results = {}
    for pattern, mode in (("random_perm", "ugal"), ("random_perm", "ugal_pf"),
                          ("uniform", "ugal")):
        res, row = certified(pattern, mode)
        ref, unc = cref[pattern, mode], uref[pattern, mode]
        # a bracket end within one bisection step of where the reference
        # puts it at its demand or at its demand moved one ulp either way
        runs = [ref] + ref["ulp_runs"]
        band = {end: (min(r[end] for r in runs) - tol - 1e-9,
                      max(r[end] for r in runs) + tol + 1e-9)
                for end in ("sat_lo", "sat_hi")}
        row.update({"reference": {k: ref[k] for k in
                                  ("value", "sat_lo", "sat_hi")},
                    "reference_iters": ref["cert"]["iters"],
                    "reference_ulp_runs": ref["ulp_runs"],
                    "uncertified_fixture": unc})
        row["ok"] &= check(
            abs(res.value - ref["value"]) <= 0.06
            and band["sat_lo"][0] <= res.sat_lo <= band["sat_lo"][1]
            and band["sat_hi"][0] <= res.sat_hi <= band["sat_hi"][1]
            and res.cert.kind == ref["cert"]["kind"]
            and res.sat_lo - 0.06 <= unc <= res.sat_hi + 0.06,
            f"{pattern} {mode} against the certified fixture")
        results[pattern, mode] = res
        rows.append(row)
        emit({"phase": "certified.run", **row})

    # float64 at half the uniform saturation: path_costs_f64 only.  It
    # does not converge within the default 2016 steps either, and it is
    # held on its launches, dtype and gap, so 512 steps show as much
    fp = flows("uniform", "ugal")
    before = (ops.LAUNCHES, dict(ops.LAUNCHES_BY_DTYPE))
    torch.cuda.synchronize()
    t = time.perf_counter()
    el = evaluate_load(fp, 0.5 * results["uniform", "ugal"].value,
                       certify=True, dtype="float64", cert_iters=512,
                       device="cuda")
    wall = time.perf_counter() - t
    launches = ops.LAUNCHES - before[0]
    by_dtype = {k: ops.LAUNCHES_BY_DTYPE[k] - before[1][k]
                for k in before[1]}
    want = 2 + 33 * el.cert.iters // 32
    rows.append({"pattern": "uniform", "mode": "ugal", "dtype": "float64",
                 "offered": el.value.offered, "wall_s": wall,
                 "max_util": el.value.max_util, "iters": el.cert.iters,
                 "converged": el.cert.converged, "gap": el.cert.gap,
                 "util_lb": el.cert.util_lb, "util_ub": el.cert.util_ub,
                 "launches": launches, "launches_by_dtype": by_dtype,
                 "launches_expected": want,
                 "ok": check(el.cert.dtype == "float64"
                             and np.isfinite(el.cert.gap)
                             and launches == want
                             and by_dtype == {"float32": 0,
                                              "float64": want},
                             "float64 evaluate_load")})
    emit({"phase": "certified.run", **rows[-1]})

    # trace=True: the certified saturation again, bit-identical
    res, row = certified("random_perm", "ugal", trace=True)
    plain = results["random_perm", "ugal"]
    same = (res.value, res.sat_lo, res.sat_hi, res.cert) == (
        plain.value, plain.sat_lo, plain.sat_hi, plain.cert)
    row.update({"bit_identical": check(same, "traced certified result"),
                "final_gap_is_cert_gap": check(
                    res.trace.final_gap == res.cert.gap,
                    "trace.final_gap != cert.gap"),
                "samples": res.trace.num_samples,
                "probes": res.trace.num_probes})
    rows.append(row)
    emit({"phase": "certified.run", **row})

    # trace=True on the uncertified batched saturation: the solve reads
    # nothing back on the host, so it runs with synchronising calls made
    # errors
    fp = flows("random_perm", "ugal")
    iters = 1500
    sched = fluid._probe_schedule(iters, probes)
    before = ops.LAUNCHES
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sat_t, yss, brs = fluid._saturation_batch_traced(
            fp, iters, sched, torch.device("cuda"))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sat_t = float(sat_t)
    wall = time.perf_counter() - t
    launches = ops.LAUNCHES - before
    pub = saturation_throughput(fp, tol=tol, iters=iters, trace=True,
                                device="cuda")
    main = state.get("main_sats", {}).get(("random_perm", "ugal"))
    rows.append({"pattern": "random_perm", "mode": "ugal",
                 "uncertified_trace": True, "iters": iters,
                 "saturation": sat_t, "public_trace": pub.saturation,
                 "main_path": main, "wall_s": wall, "launches": launches,
                 "samples": pub.trace.num_samples,
                 "ok": check(sat_t == pub.saturation == main
                             and launches == iters + sum(sched)
                             and pub.trace.num_samples == iters + sum(sched),
                             "traced uncertified saturation")})
    emit({"phase": "certified.run", **rows[-1]})
    state["certified_launches"] = ops.LAUNCHES
    state["certified_launches_by_dtype"] = dict(ops.LAUNCHES_BY_DTYPE)
    check(ops.LAUNCHES > 0, "the certified path launched no kernel")
    if problems:
        raise AssertionError(f"certified path failed its checks: {problems}")
    return {"config": "PF(31) p=16 seed 0 k_candidates 10 tol 0.01, "
                      "default budget",
            "kernel_launches": ops.LAUNCHES,
            "kernel_launches_by_dtype": dict(ops.LAUNCHES_BY_DTYPE),
            "runs": rows}


def phase_analysis(torch, state):
    """The structural-analysis path on the card: the §IV-D routing table,
    the §IX diameters under link failure, the blocked routing on the
    device BFS.  The kernel counts start at 0 here and are read at the
    end; the checks against plain versions launch no kernel."""
    import numpy as np

    from repro_torch.core.metrics import diameter_and_aspl, resilience_sweep
    from repro_torch.core.routing import (build_blocked_routing,
                                          distance_blocks)
    from repro_torch.kernels.gf_crossprod import ops as gf_ops
    from repro_torch.kernels.minplus import ops as mp_ops
    from repro_torch.kernels.minplus.ref import apsp_steps

    pf, dmg = graphs(state)
    out, problems = {"pf_build_s": state["pf_build_s"]}, []

    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)

    gf_ops.LAUNCHES = 0  # the analysis path's counts start here
    mp_ops.MINPLUS_LAUNCHES = 0
    mp_ops.MINPLUS_HOPS_LAUNCHES = 0

    # §IV-D: the table of 2-hop intermediate routers
    p31, p79 = pf[31], pf[79]
    t = time.perf_counter()
    table = gf_ops.intermediate_table(p31.vertices, 31)
    wall = time.perf_counter() - t
    off = ~np.eye(p31.n, dtype=bool)
    host = p31.intermediates_all_pairs()
    out["table_pf31"] = {"wall_s": wall, "shape": list(table.shape),
                         "equal_off_diagonal": check(
                             np.array_equal(table[off], host[off]),
                             "pf31 intermediate table")}
    t = time.perf_counter()
    table = gf_ops.intermediate_table(p79.vertices, 79)
    wall = time.perf_counter() - t
    rng = np.random.default_rng(0)
    src = rng.integers(0, p79.n, 4096)
    dst = (src + rng.integers(1, p79.n, 4096)) % p79.n  # never src
    want = np.array([p79.intermediate(int(a), int(b))
                     for a, b in zip(src, dst)])
    out["table_pf79"] = {"wall_s": wall, "shape": list(table.shape),
                         "pairs_checked": len(src), "equal": check(
                             np.array_equal(table[src, dst], want),
                             "pf79 intermediate table")}
    del table
    out["gf_crossprod_launches"] = gf_ops.LAUNCHES
    check(gf_ops.LAUNCHES == 2, "one gf_crossprod launch per table")

    # §IX at PF(31): card diameters against the host resilience sweep
    fr = FIG14_FRACTIONS[31]
    t = time.perf_counter()
    sweep = resilience_sweep(p31.graph, fr, seed=1)
    host_s = time.perf_counter() - t
    rows = []
    for f, g, pt in zip(fr, dmg[31], sweep):
        before = mp_ops.MINPLUS_HOPS_LAUNCHES
        t = time.perf_counter()
        diam = mp_ops.diameter_from_adj(g.adjacency)
        wall = time.perf_counter() - t
        launches = mp_ops.MINPLUS_HOPS_LAUNCHES - before
        want = np.inf if pt.diameter == -1 else float(pt.diameter)
        rows.append({"fraction": f, "diameter": diam,
                     "host_diameter": pt.diameter, "wall_s": wall,
                     "launches": launches,
                     "ok": check(diam == want and launches == apsp_steps(
                         g.n), f"pf31 diameter at {f}")})
    out["fig14_pf31"] = {"host_sweep_s": host_s, "runs": rows}

    # §IX at PF(79): APSP against the device BFS over all pairs
    rows = []
    for f, g in zip(FIG14_FRACTIONS[79], dmg[79]):
        before = mp_ops.MINPLUS_HOPS_LAUNCHES
        t = time.perf_counter()
        d = mp_ops.apsp(g.adjacency)
        apsp_s = time.perf_counter() - t
        launches = mp_ops.MINPLUS_HOPS_LAUNCHES - before
        t = time.perf_counter()
        same, blocks = True, 0
        for srcs, db, _ in distance_blocks(g, backend="sharded"):
            bfs = db.astype(np.float32)
            bfs[db < 0] = np.inf
            same &= bool(np.array_equal(d[srcs], bfs))
            blocks += 1
        bfs_s = time.perf_counter() - t
        t = time.perf_counter()
        diam, aspl = diameter_and_aspl(g, backend="sharded")
        metric_s = time.perf_counter() - t
        apsp_diam = float(d.max())
        want_diam = np.inf if diam == -1 else float(diam)
        finite = np.isfinite(d).all()
        apsp_aspl = (float(d.sum(dtype=np.float64)) / (g.n * (g.n - 1))
                     if finite else float("inf"))
        rows.append({"fraction": f, "links": g.num_edges,
                     "apsp_s": apsp_s, "launches": launches,
                     "bfs_s": bfs_s, "bfs_blocks": blocks,
                     "diameter_and_aspl_s": metric_s,
                     "diameter": diam, "aspl": aspl,
                     "apsp_diameter": apsp_diam, "apsp_aspl": apsp_aspl,
                     "equal_all_pairs": check(same, f"pf79 apsp at {f}"),
                     "ok": check(apsp_diam == want_diam and aspl == apsp_aspl
                                 and launches == apsp_steps(g.n),
                                 f"pf79 diameter at {f}")})
        del d
    out["fig14_pf79"] = {"runs": rows}

    # blocked routing on the device BFS against the host backend
    g = p31.graph
    t = time.perf_counter()
    dev = build_blocked_routing(g, backend="sharded")
    cols_same = True
    for a, b in zip(build_blocked_routing(g, backend="host").dest_blocks(),
                    dev.dest_blocks()):
        cols_same &= all(np.array_equal(x, y) for x, y in zip(a, b))
    out["blocked_routing_pf31"] = {
        "wall_s": time.perf_counter() - t, "diameter": dev.diameter,
        "block": dev.block, "equal_columns": check(
            cols_same and dev.diameter == 2, "pf31 blocked routing")}

    # `apsp` takes the integer route on these symmetric graphs: the float
    # kernel is launched by no call of the path
    check(mp_ops.MINPLUS_LAUNCHES == 0, "float minplus launched by apsp")
    state["minplus_launches"] = mp_ops.MINPLUS_LAUNCHES
    state["minplus_hops_launches"] = mp_ops.MINPLUS_HOPS_LAUNCHES
    state["gf_launches"] = gf_ops.LAUNCHES
    out["minplus_launches"] = mp_ops.MINPLUS_LAUNCHES
    out["minplus_hops_launches"] = mp_ops.MINPLUS_HOPS_LAUNCHES
    if problems:
        raise AssertionError(f"analysis path failed its checks: {problems}")
    return out


def device_time_by_kernel(torch, fn):
    """Run `fn` once under torch.profiler: {"wall_ms", "device_ms" (the sum
    of the device's kernel and copy times), "kernels" (their number),
    "flash_ms" (both flash-attention kernels), "top" (the largest by
    device time)}.
    An error of `fn` (a kernel's launch or a CUDA fault) propagates; one of
    the profiler itself is reported in the result under "error", since the
    breakdown checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof, error = profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]), None
    try:
        prof.start()
    except Exception:  # noqa: BLE001 -- the profiler's own failure
        error = traceback.format_exc(limit=2)
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if error is None:
        try:
            prof.stop()
            events = prof.key_averages()
        except Exception:  # noqa: BLE001 -- the profiler's own failure
            error = traceback.format_exc(limit=2)
    if error is not None:
        return {"wall_ms": wall * 1e3, "error": error}
    rows = [(evt.key, evt.self_device_time_total / 1e3, evt.count)
            for evt in events
            if evt.device_type == DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return {"wall_ms": wall * 1e3, "device_ms": total,
            "kernels": sum(r[2] for r in rows),
            "flash_ms": sum(r[1] for r in rows
                            if "flash_attention_kernel" in r[0]
                            or "flash_attention_sm90_kernel" in r[0]),
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in rows[:6]]}


def phase_model(torch, state):
    """Gemma2-9B at its published widths, bf16, random parameters from seed
    0 on the card: the prefill (`forward`, S = 8192, all 42 layers, one
    flash-attention launch a layer), then `launch.serve.generate` answering
    4 requests, then float32 consistency at full width (4 layers)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import TransformerLM

    out, problems = {}, []

    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)

    cfg = get_config(GEMMA)
    t = time.perf_counter()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    out["config"] = {"arch": cfg.name, "layers": cfg.num_layers,
                     "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                                       cfg.num_kv_heads],
                     "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                     "vocab": cfg.vocab_size, "window": cfg.local_window,
                     "softcaps": [cfg.attn_softcap, cfg.final_softcap],
                     "dtype": "bfloat16", "depth_cut": None,
                     "init_s": time.perf_counter() - t,
                     "param_bytes": sum(p.numel() * p.element_size()
                                        for p in model.parameters())}

    # prefill: one warm-up forward (cuBLAS set-up) outside the count
    gen = torch.Generator(device="cuda").manual_seed(0)
    model.forward(torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                                device="cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_S), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES = 0  # the prefill path's counts start here
    ops.LAUNCHES_BY_KERNEL.update(sm90=0, simt=0)
    t = time.perf_counter()
    logits = model.forward(tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = ops.LAUNCHES
    by_kernel = dict(ops.LAUNCHES_BY_KERNEL)
    state["flash_sm90_launches"] = by_kernel["sm90"]
    finite = bool(torch.isfinite(logits).all())
    out["prefill"] = {
        "batch": 1, "seq": PREFILL_S, "wall_s": wall,
        "tokens_per_s": PREFILL_S / wall, "flash_launches": launches,
        "flash_launches_by_kernel": by_kernel,
        "logits_shape": list(logits.shape),
        "logits_finite": check(finite, "prefill logits not finite"),
        "logits_abs_max": float(logits.abs().max()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_ok": check(by_kernel == {"sm90": cfg.num_layers,
                                           "simt": 0},
                             f"flash launches {by_kernel} for "
                             f"{cfg.num_layers} bf16 layers")}
    del logits
    out["prefill"]["profile"] = device_time_by_kernel(
        torch, lambda: model.forward(tokens))
    del tokens
    torch.cuda.empty_cache()

    # serve: 4 requests, greedy, through launch.serve.generate; one
    # warm-up run of the same shapes, then SERVE["runs"] timed ones
    b, plen, ntok = SERVE["batch"], SERVE["prompt"], SERVE["tokens"]
    prompt = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen,
                           device="cuda")
    generate(model, model.init_cache(b, plen + ntok), prompt, ntok)
    walls, answers = [], []
    before = ops.LAUNCHES
    for _ in range(SERVE["runs"]):
        cache = model.init_cache(b, plen + ntok)
        torch.cuda.synchronize()
        t = time.perf_counter()
        answers.append(generate(model, cache, prompt, ntok))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    serve_launches = ops.LAUNCHES - before  # decode runs no kernel: 0
    answer, wall = answers[0], sorted(walls)[len(walls) // 2]
    # one more decode step, profiled (a breakdown only)
    step_profile = device_time_by_kernel(
        torch, lambda: model.decode_step(cache, answer[:, -1:],
                                         plen + ntok - 1))
    # greedy tokens against the argmax of one forward over prompt + answer
    full = model.forward(torch.cat([prompt, answer], dim=1))
    agree = float((full[:, plen - 1:-1].argmax(-1) == answer).float().mean())
    out["serve"] = {
        "requests": b, "prompt": plen, "new_tokens": ntok,
        "reading": "smoke: one batch of 4 requests after one warm-up run, "
                   "not a serve rate",
        "wall_s": wall, "wall_s_runs": walls,
        "tokens_per_s": b * (plen + ntok) / wall,
        "new_tokens_per_s": b * ntok / wall,
        "answers_equal_across_runs": all(bool((a == answer).all())
                                         for a in answers),
        "decode_steps": plen + ntok, "flash_launches": serve_launches,
        "greedy_agreement_with_forward_argmax": agree,
        "answer_ok": check(answer.shape == (b, ntok) and bool(
            ((answer >= 0) & (answer < cfg.vocab_size)).all()),
            "serve answer shape or range"),
        "sample": answer[0, :8].tolist(), "decode_step_profile": step_profile,
        "card": torch.cuda.get_device_name(0)}
    del model, cache, full
    torch.cuda.empty_cache()

    # float32 consistency at full width, two local/global pairs
    c = CONSISTENCY
    cfg4 = cfg.with_(num_layers=c["layers"], dtype="float32")
    model = build_model(cfg4, device="cuda", seed=1)
    toks = torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"]),
                         generator=gen, device="cuda")
    ops.LAUNCHES = 0  # the float32 path's counts start here
    ops.LAUNCHES_BY_KERNEL.update(sm90=0, simt=0)
    full = model.forward(toks)
    fwd_launches = dict(ops.LAUNCHES_BY_KERNEL)
    state["flash_simt_launches"] = fwd_launches["simt"]
    cache = model.init_cache(c["batch"], c["seq"])
    steps = []
    for pos in range(c["seq"]):
        lg, cache = model.decode_step(cache, toks[:, pos:pos + 1], pos)
        steps.append(lg[:, 0])
    dec = torch.stack(steps, dim=1)
    dec_err = float((dec - full).abs().max())
    dec_ok = bool(torch.allclose(dec, full, rtol=c["tol"], atol=c["tol"]))
    t = time.perf_counter()
    cpu = TransformerLM(cfg4, tree_map(lambda a: a.detach().cpu(),
                                       model.params.tree()))
    cpu_full = cpu.forward(toks.cpu())
    cpu_s = time.perf_counter() - t
    full_cpu = full.cpu()
    cpu_err = float((full_cpu - cpu_full).abs().max())
    cpu_ok = bool(torch.allclose(full_cpu, cpu_full, rtol=c["tol"],
                                 atol=c["tol"]))
    out["consistency_fp32"] = {
        "layers": c["layers"], "batch": c["batch"], "seq": c["seq"],
        "tol": c["tol"], "tf32": torch.backends.cuda.matmul.allow_tf32,
        "forward_flash_launches": fwd_launches,
        "launches_ok": check(fwd_launches == {"sm90": 0,
                                              "simt": c["layers"]},
                             f"fp32 flash launches {fwd_launches}"),
        "decode_vs_forward_max_abs_err": dec_err,
        "decode_vs_forward_ok": check(dec_ok, "fp32 decode vs forward"),
        "card_vs_cpu_max_abs_err": cpu_err, "cpu_forward_s": cpu_s,
        "card_vs_cpu_ok": check(cpu_ok, "fp32 card forward vs CPU forward"),
        "logits_abs_max": float(full.abs().max())}
    del model, cpu, cache, full
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"model path failed its checks: {problems}")
    return out


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
        smoke.phase("certified", phase_certified, torch, state)
        smoke.phase("analysis", phase_analysis, torch, state)
        smoke.phase("model", phase_model, torch, state)
    launches = {"path_costs": state.get("launches", 0),
                "minplus": state.get("minplus_launches", 0),
                "minplus_hops": state.get("minplus_hops_launches", 0),
                "gf_crossprod": state.get("gf_launches", 0),
                "flash_attention": state.get("flash_simt_launches", 0),
                "flash_attention_sm90": state.get("flash_sm90_launches", 0)}
    kernels = [{**state[name], "launches": launches[name]}
               for name in launches if name in state]
    for k in kernels:
        if k["name"] == "path_costs":
            # the main path's count is `launches`; the certified path's
            # beside it
            k["launches_certified"] = state.get("certified_launches", 0)
            k["launches_certified_by_dtype"] = state.get(
                "certified_launches_by_dtype")
    smoke.record["kernels"] = kernels
    smi = nvidia_smi()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as fh:
        json.dump({**smoke.record, "nvidia_smi": smi,
                   "failed": smoke.failed}, fh, indent=1)
    emit({"kernels": kernels})
    print(smi, flush=True)
    # every kernel a path routes to was launched by it; the float minplus
    # kernel serves `ops.minplus` alone since `apsp` takes the integer
    # route (the analysis phase checks it stays at 0), and the kernels
    # phase holds and times it
    on_path = [n for name, n in launches.items() if name != "minplus"]
    if (smoke.failed or len(kernels) != len(launches)
            or not all(on_path)):
        print(f"chip_smoke: failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
