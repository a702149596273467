"""Times the path-cost, tropical-product and GF(q) cross-product kernels of
one checkout at the shapes the port's paths give them, so two checkouts can
be compared on one card in one call.

    PYTHONPATH=src python scripts/kernel_ab.py [--tree DIR] [--sweep] [--split]

`--tree` is the root of a checkout (default: this one); its `src/` is
imported, so an older checkout unpacked with `git archive` into a
git-ignored directory times its own kernels, built from its own sources
into its own `build/`.  Run the two in turns (parent, change, change,
parent) inside one call.  Shapes, as `chip_smoke.py`'s kernels phase
builds them:

  path_costs  PF(31) uniform ugal_pf (F*K = 1.24M candidates, L = 4), fp32
              and fp64, a delay table from the load at offered load 0.5
  minplus     the second squaring of APSP on PF(31) and PF(79) with 5 % of
              the links removed (seed 1), on the matrix `apsp` squares
              (`ops.apsp_dist0`, padded to a multiple of 4, where the
              checkout has it; else the n x n matrix)
  gf_crossprod PF(31)'s and PF(79)'s vertex lists against themselves, as
              `intermediate_table` calls the kernel; then the wall seconds
              of `intermediate_table` itself (median of 5) at both sizes

`--split` adds, at PF(79), the split of `intermediate_table` into its
pieces, timed one by one on this checkout's kernel: the op layer as it was
before the int32 code (an int64 copy of the [N, N, 3] table, three int64
passes to form the code, a LUT gather with int64 indices) and as it is now
(two int32 passes, `index_select` with int32 indices), the LUT's own
build, the device-to-host copy into a fresh pageable array (what `.cpu()`
does), into one already touched, and into pinned memory, and the first
touch of a fresh 160 MB host array.  CUDA events (median of 30, L2
emptied) for the device pieces, host clock around a synchronised copy
(median of 5) for the host ones.

Each kernel is first held against its plain version (bit for bit; PF(79)'s
product on 256 rows), then timed: CUDA events, median of 30 calls, L2
emptied of the inputs before each.  `apsp` and `diameter_from_adj` wall
seconds (host clock, median of 3) are timed at PF(31) and PF(79) in every
tree.  `--sweep` (this checkout's launch interface only) also times
the path-cost kernel's two forms (8 rows a thread, the generic one), each
also with every index 0 (the same bytes without random gathers), the
product at PF(31) with 1, 2, 4, 8 and 16 k splits, the integer route's
kernel at PF(31) with 1, 2, 4 and 8, and a PF(79) `apsp` on the float
route, each variant held against the plain version before it is timed.
Prints one JSON line with the card's name and power
limit.  Needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def gpu_ms(torch, fn, samples=30, flush_bytes=128 << 20, warmup=3):
    """Median device time of `fn()` in ms (as chip_smoke.py's gpu_ms)."""
    scratch = torch.ones(flush_bytes // 4, dtype=torch.float32,
                         device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        scratch.sum()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def same(torch, out, ref, what):
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        err = float((out.double() - ref.double()).abs().max())
        raise AssertionError(f"{what}: differs from its plain version, "
                             f"max abs err {err}")


def path_cost_inputs(torch):
    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.simulation import build_flow_paths, fluid, make_pattern

    pf = build_polarfly(31)
    rt = build_routing(pf.graph, pf)
    pat = make_pattern("uniform", rt, p=16, seed=0)
    fp = build_flow_paths(rt, pat, "ugal_pf", k_candidates=10, seed=0)
    fw, demand, _, _ = fluid._pieces(fp, torch.device("cuda"))
    rho = fw.loads(fw.init, demand * 0.5)
    delay = torch.cat([1.0 + fluid._queue_delay(rho),
                       rho.new_zeros(1)]).contiguous()
    return fp.device_arrays("cuda")[0], delay


def damaged_adj(q):
    """PF(q)'s adjacency with 5 % of its links removed (seed 1)."""
    import numpy as np

    from repro_torch.core.polarfly import build_polarfly

    g = build_polarfly(q).graph
    edges = g.edge_list.copy()
    np.random.default_rng(1).shuffle(edges)
    g = g.subgraph_without_edges(edges[:int(round(0.05 * len(edges)))])
    return g.adjacency


def squared_dist(torch, adj):
    """APSP's first product, the matrix the second squaring takes."""
    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import adjacency_to_dist0

    adj = torch.from_numpy(adj).cuda()
    d0 = ops.apsp_dist0(adj) if hasattr(ops, "apsp_dist0") \
        else adjacency_to_dist0(adj)
    return ops.minplus(d0, d0)


def wall_s(torch, fn, runs=3):
    """Median host seconds of `fn()`, each run ended by a sync."""
    import time

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return sorted(times)[len(times) // 2]


def sweep(torch, eidx, delay, dists, hops, adjs):
    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import minplus_ref, path_costs_ref

    out = {"path_costs": {}, "minplus_splits_pf31": {}, "hops": {}}
    stream = torch.cuda.current_stream().cuda_stream
    # the same bytes with every gather on table slot 0: what the random
    # gathers cost
    zeros = torch.zeros_like(eidx)
    for dtype in (torch.float32, torch.float64):
        fn = ops._launcher(dtype)
        d = delay.to(dtype)
        res = torch.empty(eidx.shape[:-1], dtype=dtype, device="cuda")
        want = path_costs_ref(d, eidx)
        for rows in (0, ops.PATH_COSTS_ROWS):
            for label, x in (("", eidx), (" zero indices", zeros)):
                def pc():
                    assert fn(d.data_ptr(), x.data_ptr(), res.data_ptr(),
                              res.numel(), x.shape[-1], rows, stream) == 0
                    return res

                if not label:
                    same(torch, pc(), want, f"path_costs rows {rows}")
                out["path_costs"][f"{str(dtype)[6:]} rows {rows}{label}"] \
                    = gpu_ms(torch, pc)
    d = dists[31]
    n = d.shape[0]
    want = minplus_ref(d, d)
    c = torch.empty_like(d)
    mp = ops._minplus_launcher()
    for splits in (1, 2, 4, 8, 16):
        kper = -(-(-(-n // splits)) // ops.MINPLUS_K) * ops.MINPLUS_K
        part = torch.empty((splits, n, n), device="cuda")

        def run():
            assert mp(d.data_ptr(), d.data_ptr(), c.data_ptr(),
                      part.data_ptr(), n, n, n, n, n, -(-n // kper), kper,
                      stream) == 0
            return c

        same(torch, run(), want, f"minplus splits {splits}")
        out["minplus_splits_pf31"][splits] = gpu_ms(torch, run)
    hp = ops._hops_launcher()
    for q, h in hops.items():
        n = h.shape[0]
        want = ops.minplus_hops(h)
        c = torch.empty_like(h)
        for splits in ((1, 2, 4, 8) if q == 31 else (1,)):
            kper = -(-(-(-n // splits)) // ops.HOPS_K) * ops.HOPS_K
            part = torch.empty((splits, n, n), dtype=h.dtype, device="cuda")

            def run():
                assert hp(h.data_ptr(), c.data_ptr(), part.data_ptr(), n,
                          -(-n // kper), kper, stream) == 0
                return c

            same(torch, run(), want, f"hops pf{q} splits {splits}")
            out["hops"][f"pf{q} splits {splits}"] = \
                gpu_ms(torch, run, samples=30 if q == 31 else 10)
    route = ops._apsp_route
    try:
        ops._apsp_route = lambda n, symmetric: "float"
        out["apsp_pf79_float_route_wall_s"] = wall_s(
            torch, lambda: ops.apsp(adjs[79]))
    finally:
        ops._apsp_route = route
    return out


def host_s(fn, runs=5):
    """Median host seconds of `fn()` (which ends in a sync)."""
    import time

    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return sorted(times)[len(times) // 2]


def table_split(torch, v, q):
    """PF(q)'s `intermediate_table` cut into its pieces and each timed on
    its own, the op layer in its int64 form (as it was before the int32
    code) and its int32 form; the cross product is this checkout's kernel
    in both."""
    import numpy as np

    from repro_torch.kernels.gf_crossprod import ops

    n = v.shape[0]
    w = ops.crossprod_normalized(v, v, q)
    lut = torch.full((q ** 3,), -1, dtype=torch.int32, device="cuda")
    vl = v.long()
    vcode = (vl[:, 0] * q + vl[:, 1]) * q + vl[:, 2]
    lut[vcode] = torch.arange(n, dtype=torch.int32, device="cuda")

    def build_lut():
        t = torch.full((q ** 3,), -1, dtype=torch.int32, device="cuda")
        t[vcode] = torch.arange(n, dtype=torch.int32, device="cuda")
        return t

    def code64():
        w64 = w.long()
        return (w64[..., 0] * q + w64[..., 1]) * q + w64[..., 2]

    def code32():
        code = torch.add(w[..., 1], w[..., 0], alpha=q)
        return torch.add(w[..., 2], code, alpha=q, out=code)

    c64, c32 = code64(), code32()
    if not torch.equal(c64, c32.long()):
        raise AssertionError("int32 code differs from the int64 one")
    t64, t32 = lut[c64], lut.index_select(0, c32.view(-1)).view(n, n)
    if not torch.equal(t64, t32):
        raise AssertionError("index_select differs from the int64 gather")
    touched = torch.empty((n, n), dtype=torch.int32)
    touched.fill_(0)
    pinned = torch.empty((n, n), dtype=torch.int32, pin_memory=True)

    def d2h(dst):
        def run():
            dst.copy_(t32)
            torch.cuda.synchronize()
        return run

    def fresh():
        t32.cpu()  # allocates, faults in and fills a new pageable array

    def touch():
        np.full((n, n), -1, dtype=np.int32)

    torch.cuda.synchronize()
    return {
        "kernel_ms": gpu_ms(torch, lambda: ops.crossprod_normalized(v, v, q)),
        "int64_form": {"copy_and_code_ms": gpu_ms(torch, code64),
                       "gather_ms": gpu_ms(torch, lambda: lut[c64])},
        "int32_form": {"code_ms": gpu_ms(torch, code32),
                       "gather_ms": gpu_ms(
                           torch, lambda: lut.index_select(0, c32.view(-1)))},
        "lut_build_ms": gpu_ms(torch, build_lut),
        "d2h_fresh_pageable_s": host_s(fresh),
        "d2h_touched_pageable_s": host_s(d2h(touched)),
        "d2h_pinned_s": host_s(d2h(pinned)),
        "host_array_first_touch_s": host_s(touch),
        "table_mb": n * n * 4 / 1e6}


def gf_section(torch, rec, split):
    import numpy as np

    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.kernels.gf_crossprod import ops
    from repro_torch.kernels.gf_crossprod.ref import crossprod_normalized_ref

    for q in (31, 79):
        pf = build_polarfly(q)
        v = torch.from_numpy(pf.vertices.astype(np.int32)).cuda()
        same(torch, ops.crossprod_normalized(v, v, q),
             crossprod_normalized_ref(v, v, q), f"gf_crossprod pf{q}")
        rec["kernels"][f"gf_crossprod_pf{q}"] = {
            "shape": [v.shape[0], v.shape[0], 3],
            "ms": gpu_ms(torch, lambda: ops.crossprod_normalized(v, v, q))}
        rec["kernels"][f"intermediate_table_pf{q}_wall_s"] = wall_s(
            torch, lambda: ops.intermediate_table(pf.vertices, q), runs=5)
        if q == 79 and split:
            rec["intermediate_table_split_pf79"] = table_split(torch, v, q)


def path_costs_section(torch, rec):
    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import path_costs_ref

    eidx, delay = path_cost_inputs(torch)
    for dtype in (torch.float32, torch.float64):
        d = delay.to(dtype)
        same(torch, ops.path_costs(d, eidx), path_costs_ref(d, eidx),
             f"path_costs {dtype}")
        rec["kernels"][f"path_costs_{str(dtype)[6:]}"] = {
            "shape": list(eidx.shape),
            "ms": gpu_ms(torch, lambda: ops.path_costs(d, eidx))}
    return eidx, delay


def minplus_section(torch, rec):
    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import minplus_ref

    dists, adjs, hops = {}, {}, {}
    for q in (31, 79):
        adjs[q] = damaged_adj(q)
        d = dists[q] = squared_dist(torch, adjs[q])
        rows = d[:256].contiguous()
        same(torch, ops.minplus(rows, d), minplus_ref(rows, d),
             f"minplus pf{q} rows 0-255")
        rec["kernels"][f"minplus_pf{q}"] = {
            "shape": list(d.shape),
            "ms": gpu_ms(torch, lambda: ops.minplus(d, d))}
        if hasattr(ops, "minplus_hops"):
            h0 = ops.apsp_hops0(torch.from_numpy(adjs[q]).cuda())
            h = hops[q] = ops.minplus_hops(h0)
            out = ops.minplus_hops(h)
            want = minplus_ref(h[:256].float().contiguous(), h.float())
            same(torch, out[:256].float(), want, f"minplus_hops pf{q}")
            rec["kernels"][f"minplus_hops_pf{q}"] = {
                "shape": list(h.shape),
                "ms": gpu_ms(torch, lambda: ops.minplus_hops(h))}
        rec["kernels"][f"apsp_pf{q}_wall_s"] = wall_s(
            torch, lambda: ops.apsp(adjs[q]))
        rec["kernels"][f"diameter_pf{q}_wall_s"] = wall_s(
            torch, lambda: ops.diameter_from_adj(adjs[q]))
    return dists, adjs, hops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))

    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA card")
    rec = {"tree": tree, "kernels": {}}
    gf_section(torch, rec, args.split)
    eidx, delay = path_costs_section(torch, rec)
    dists, adjs, hops = minplus_section(torch, rec)
    if args.sweep:
        rec["sweep"] = sweep(torch, eidx, delay, dists, hops, adjs)
    rec["device"] = torch.cuda.get_device_name(0)
    rec["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
