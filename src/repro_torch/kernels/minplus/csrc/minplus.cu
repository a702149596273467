// Tropical (min,+) matrix product for all-pairs shortest paths:
//
//   C[i, j] = min_{k} A[i, k] + B[k, j],   A [m, K], B [K, n], float32
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/minplus/kernel.py::minplus_pallas (body
// _minplus_kernel).  That kernel keeps a 128x128 C tile in VMEM and walks k
// as the innermost, sequential grid axis, with the inputs padded to whole
// tiles with INF.  Hopper runs blocks in no order, so here the k walk is a
// loop inside the block, and the ragged edges are bounds checks, not a
// padded copy.
//
// What bounds it: operations.  Each (i, j, k) candidate is one FADD and one
// FMNMX, and there is no tensor-core (min,+) mode, so the product runs on
// the CUDA cores: 2 m n K lane-instructions at 132 SMs x 128 fp32 lanes x
// 1.98 GHz = 33.5e12 per second (15 ms per product at PF(79), n = 6321;
// about 58 us at PF(31)).  FMNMX alone issues at half that rate (64 lanes
// a clock; scripts/fp32_issue_rate.py), which gives the same 15 ms, and an
// add-then-min pair runs at the full rate.  The bytes are small beside
// that (three n x n float32 matrices), so the design is the one of a
// CUDA-core SGEMM: a 128x128 C tile per 256-thread block, an 8x8 register
// micro-tile per thread, A and B staged through shared memory 16 k at a
// time (A stored transposed, so a thread's eight A values for one k are
// one row of the shared tile).  Per k a thread does 16 shared loads for
// 64 FADD + 64 FMNMX, which keeps the shared-memory pipe off the critical
// path.  A thread's outputs are rows ty + 16 r and columns tx + 16 c of
// the tile, so the 16 threads of a half-warp read 16 consecutive B words
// (no bank conflict) and store 16 consecutive C words.  Not
// double-buffered, no wgmma, no DPX: a plain kernel first.
//
// Exactness: every candidate is one rounded add and min is exact, so the
// result does not depend on the order of k and equals the plain PyTorch
// version (ref.py::minplus_ref) bit for bit.  The accumulator starts from
// +inf and reads past the ragged k edge are +inf, so padding never wins a
// min: a row whose every candidate exceeds the repo's INF (3e38/4) gives
// what the plain version gives.  (The Pallas kernel starts from INF and so
// clamps such a row to INF; in APSP the zero diagonal keeps every value at
// or below INF, where the two agree.)  nvcc does not contract or reorder
// the add without fast-math.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;    // C tile edge
constexpr int kK = 16;        // k slice staged in shared memory
constexpr int kThreads = 256; // 16 x 16 threads
constexpr int kMicro = 8;     // 8 x 8 outputs per thread
constexpr int kPad = 4;       // row padding of the transposed A tile

__global__ void __launch_bounds__(kThreads)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ c, int m, int n, int kdim) {
  __shared__ float as[kK][kTile + kPad];  // as[k][i] = A[i0 + i, k0 + k]
  __shared__ float bs[kK][kTile];         // bs[k][j] = B[k0 + k, j0 + j]

  const float kInf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int q = 0; q < kMicro; ++q) acc[r][q] = kInf;

  // loaders: A as 16 rows x 16 k per pass (16 consecutive k of a row per
  // half-warp), B as 2 k-rows x 128 columns per pass
  const int a_k = tid % kK, a_i = tid / kK;
  const int b_j = tid % kTile, b_k = tid / kTile;

  for (int k0 = 0; k0 < kdim; k0 += kK) {
#pragma unroll
    for (int p = 0; p < kTile / 16; ++p) {
      const int i = a_i + 16 * p, gi = i0 + i, gk = k0 + a_k;
      as[a_k][i] = (gi < m && gk < kdim)
                       ? __ldg(a + (long long)gi * kdim + gk) : kInf;
    }
#pragma unroll
    for (int p = 0; p < kK / 2; ++p) {
      const int k = b_k + 2 * p, gk = k0 + k, gj = j0 + b_j;
      bs[k][b_j] = (gk < kdim && gj < n)
                       ? __ldg(b + (long long)gk * n + gj) : kInf;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float av[kMicro], bv[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) av[r] = as[k][ty + 16 * r];
#pragma unroll
      for (int q = 0; q < kMicro; ++q) bv[q] = bs[k][tx + 16 * q];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int q = 0; q < kMicro; ++q)
          acc[r][q] = fminf(acc[r][q], av[r] + bv[q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int gi = i0 + ty + 16 * r;
    if (gi >= m) continue;
#pragma unroll
    for (int q = 0; q < kMicro; ++q) {
      const int gj = j0 + tx + 16 * q;
      if (gj < n) c[(long long)gi * n + gj] = acc[r][q];
    }
  }
}

}  // namespace

extern "C" {

int minplus_f32(const float* a, const float* b, float* c, int m, int n,
                int kdim, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  minplus_kernel<<<grid, kThreads, 0, stream>>>(a, b, c, m, n, kdim);
  return (int)cudaGetLastError();
}

}  // extern "C"
