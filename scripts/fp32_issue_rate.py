"""Issue rates of the instructions the port's kernel bounds count.

The (min,+) product's bound counts one fp32 add (FADD) and one fp32 min
(FMNMX) for each candidate at the fp32 peak (132 SMs x 128 lanes x
1.98 GHz = 33.5e12 lane-instructions a second); the GF(q) cross
product's counts int32 adds and multiplies at 132 x 64 x 1.98 GHz =
16.7e12.  This script measures, with a tiny kernel of 8 independent
chains per thread on every SM, how many of each instruction the card
retires per second: FADD, FMNMX, the product's add-then-min pair, int32
add and int32 multiply-add; Hopper's DPX add-then-min in one instruction
(`__viaddmin_s32`, one candidate, and `__viaddmin_s16x2`, two 16-bit
candidates); and shared-memory loads of 4 bytes a lane (LDS.32) against
16 bytes a lane (LDS.128).  It prints one JSON object with the rates
(lane-instructions per second; candidates per second for the (min,+)
forms; bytes per second for the loads), their shares of the peak each
bound uses, and the card's name, power limit and SM clock.
The PTX is inline `asm volatile` (the DPX forms are the intrinsics, whose
add-then-min ptxas fuses into one instruction; the loads are
`ld.volatile`, which ptxas may not drop), so the compiler cannot fold a
chain; each loop iteration issues 64 of them, so loop overhead
stays small.  Needs a CUDA card and nvcc.

    python scripts/fp32_issue_rate.py
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PEAK = 132 * 128 * 1.98e9
INT_PEAK = 132 * 64 * 1.98e9

SOURCE = r"""
#include <cuda_runtime.h>
template <int MODE>
__global__ void probe(float* out, int iters, float y) {
  __shared__ float4 sh[256 * 4];
  float x[8], b[8];
  int k[8];
  unsigned h[8];
  const int j = (int)y + 2;
  const unsigned jj = (unsigned)j * 0x10001u;
  for (int r = 0; r < 8; ++r) {
    x[r] = threadIdx.x + r; b[r] = r * 0.5f; k[r] = threadIdx.x + r;
    h[r] = (threadIdx.x + r) * 0x10001u;
  }
  for (int i = threadIdx.x; i < 256 * 4; i += blockDim.x)
    sh[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  // lane t of load r reads word 256 r + t (or 16-byte chunk 256 (r % 4)
  // + t): no bank conflicts
  const unsigned base = (unsigned)__cvta_generic_to_shared(sh);
  const unsigned a32 = base + 4u * threadIdx.x;
  const unsigned a128 = base + 16u * threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (MODE == 0) {
          asm volatile("add.f32 %0, %0, %1;" : "+f"(x[r]) : "f"(y));
        } else if (MODE == 1) {
          asm volatile("min.f32 %0, %0, %1;" : "+f"(x[r]) : "f"(b[r]));
        } else if (MODE == 2) {
          float t;
          asm volatile("add.f32 %0, %1, %2;" : "=f"(t) : "f"(b[r]), "f"(y));
          asm volatile("min.f32 %0, %0, %1;" : "+f"(x[r]) : "f"(t));
        } else if (MODE == 3) {
          asm volatile("add.s32 %0, %0, %1;" : "+r"(k[r]) : "r"(j));
        } else if (MODE == 4) {
          asm volatile("mad.lo.s32 %0, %0, %1, %2;" : "+r"(k[r])
                       : "r"(j), "r"(r));
        } else if (MODE == 5) {
          k[r] = __viaddmin_s32(k[r], j, k[(r + 1) % 8]);
        } else if (MODE == 6) {
          h[r] = __viaddmin_s16x2(h[r], jj, h[(r + 1) % 8]);
        } else if (MODE == 7) {
          asm volatile("ld.volatile.shared.f32 %0, [%1];" : "=f"(x[r])
                       : "r"(a32 + 1024u * r));
        } else {
          float p, q, s;
          asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                       : "=f"(x[r]), "=f"(p), "=f"(q), "=f"(s)
                       : "r"(a128 + 4096u * (r & 3)));
          x[r] += p + q + s;
        }
      }
    }
  }
  float s = 0.f;
  for (int r = 0; r < 8; ++r) s += x[r] + (float)k[r] + (float)h[r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int blocks, int threads, int iters, int mode,
                   cudaStream_t stream) {
  if (mode == 0) probe<0><<<blocks, threads, 0, stream>>>(out, iters, 1.0f);
  if (mode == 1) probe<1><<<blocks, threads, 0, stream>>>(out, iters, 1.0f);
  if (mode == 2) probe<2><<<blocks, threads, 0, stream>>>(out, iters, 1.0f);
  if (mode == 3) probe<3><<<blocks, threads, 0, stream>>>(out, iters, 1.0f);
  if (mode == 4) probe<4><<<blocks, threads, 0, stream>>>(out, iters, 1.0f);
  if (mode == 5) probe<5><<<blocks, threads, 0, stream>>>(out, iters, 1.0f);
  if (mode == 6) probe<6><<<blocks, threads, 0, stream>>>(out, iters, 1.0f);
  if (mode == 7) probe<7><<<blocks, threads, 0, stream>>>(out, iters, 1.0f);
  if (mode == 8) probe<8><<<blocks, threads, 0, stream>>>(out, iters, 1.0f);
  return (int)cudaGetLastError();
}
"""


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("fp32_issue_rate: needs a CUDA card")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        src = os.path.join(tmp, "probe.cu")
        lib = os.path.join(tmp, "probe.so")
        with open(src, "w") as fh:
            fh.write(SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
                        src], check=True)
        fn = ctypes.CDLL(lib).run
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        blocks, threads, iters = 132 * 8, 256, 2500
        out = torch.empty(blocks * threads, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        rates = {}
        # mode, name, instructions a thread an iteration, peak they are
        # held to, (min,+) candidates an instruction, bytes a lane
        for mode, name, per_iter, peak, cand, nbytes in (
                (0, "fadd", 64, PEAK, 0, 0), (1, "fmnmx", 64, PEAK, 0, 0),
                (2, "fadd+fmnmx", 128, PEAK, 0.5, 0),
                (3, "iadd", 64, INT_PEAK, 0, 0),
                (4, "imad", 64, INT_PEAK, 0, 0),
                (5, "viaddmin_s32", 64, PEAK, 1, 0),
                (6, "viaddmin_s16x2", 64, PEAK, 2, 0),
                (7, "lds32", 64, PEAK, 0, 4), (8, "lds128", 64, PEAK, 0, 16)):
            for _ in range(2):
                assert fn(out.data_ptr(), blocks, threads, 100, mode,
                          stream) == 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            assert fn(out.data_ptr(), blocks, threads, iters, mode,
                      stream) == 0
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
            rate = blocks * threads * iters * per_iter / sec
            rates[name] = {"lane_instr_per_s": rate, "share_of_peak":
                           rate / peak, "ms": sec * 1e3}
            if cand:
                rates[name]["candidates_per_s"] = rate * cand
            if nbytes:
                rates[name]["bytes_per_s"] = rate * nbytes
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "fp32_peak": PEAK,
                      "int32_peak": INT_PEAK,
                      "rates": rates,
                      "fmnmx_over_fadd": rates["fmnmx"]["lane_instr_per_s"]
                      / rates["fadd"]["lane_instr_per_s"],
                      "candidates_over_fadd_fmnmx": {
                          name: rates[name]["candidates_per_s"]
                          / rates["fadd+fmnmx"]["candidates_per_s"]
                          for name in ("viaddmin_s32", "viaddmin_s16x2")},
                      "lds128_over_lds32_bytes":
                          rates["lds128"]["bytes_per_s"]
                          / rates["lds32"]["bytes_per_s"]}))


if __name__ == "__main__":
    main()
