// Tropical (min,+) matrix product for all-pairs shortest paths:
//
//   C[i, j] = min_{k} A[i, k] + B[k, j],   A [m, K], B [K, n], float32
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/minplus/kernel.py::minplus_pallas (body
// _minplus_kernel).  That kernel keeps a 128x128 C tile in VMEM and walks k
// as the innermost, sequential grid axis, with the inputs padded to whole
// tiles with INF.  Hopper runs blocks in no order, so here the k walk is a
// loop inside the block (split over blocks where the tiles are few), and
// the ragged edges are bounds checks.  `apsp` squares an undirected
// graph's hop counts with csrc/minplus_dpx.cu instead; this kernel serves
// `ops.minplus` and `apsp` of a directed or a larger graph.
//
// What bounds it: operations.  Each (i, j, k) candidate is one FADD and one
// FMNMX, and there is no tensor-core (min,+) mode, so the product runs on
// the CUDA cores: 2 m n K lane-instructions at 132 SMs x 128 fp32 lanes x
// 1.98 GHz = 33.5e12 per second (15 ms per product at PF(79), n = 6321;
// about 58 us at PF(31)).  FMNMX alone issues at half that rate (64 lanes
// a clock; scripts/fp32_issue_rate.py), which gives the same 15 ms, and an
// add-then-min pair runs at the full rate.  The bytes are small beside
// that (three n x n float32 matrices), so every instruction that is not an
// FADD or FMNMX comes out of the bound share, and the design is the one of
// a CUDA-core SGEMM built to issue few of them:
//
// - A 128x128 C tile per 256-thread block, an 8x8 register micro-tile per
//   thread: rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, columns 4 tx + {0..3}
//   and 64 + 4 tx + {0..3} (tx = tid % 16, ty = tid / 16).
// - k in slices of 16, copied global -> shared with 16-byte cp.async into
//   two stages: the copy of slice t + 1 runs while slice t is computed, and
//   one __syncthreads per slice both publishes slice t and frees the stage
//   slice t + 2 will take.  A is kept as it lies (a row's 16 k are 64
//   contiguous bytes, rows 80 bytes apart so the two rows a warp reads at
//   once sit 16 banks apart), B as k rows of 128 columns.
// - Shared loads are 16 bytes: per 4 k a thread loads its 8 A rows' 4 k
//   each (8 LDS.128) and per k its 8 B columns (2 LDS.128), so 4 LDS.128
//   feed 64 FADD + 64 FMNMX (scalar loads would take 16 LDS.32).  The 16
//   threads of a half-warp read 256 contiguous bytes of B: no conflict.
// - Split-K where the tiles do not fill the card (n ~ 1000: 64 tiles for
//   264 block slots): blockIdx.z takes k range [z kper, (z + 1) kper), the
//   block writes its partial minima to a [splits, m, n] scratch the
//   wrapper allocates, and minplus_combine takes the min over splits.  The
//   plan (tile, splits, kper) is chosen in Python (ops.py::_minplus_plan),
//   so it is tested on the CPU.
//
// The 16-byte copies need A's and B's rows 16-byte aligned: the wrapper
// hands the kernel rows of a multiple of 4 floats, padding a ragged A with
// +inf columns (and B with +inf; columns past n are never stored).  Slices
// past K are +inf in shared memory, never copied.
//
// Exactness: every candidate is one rounded add and min is exact, so the
// result depends neither on the order of k nor on the split: it equals the
// plain PyTorch version (ref.py::minplus_ref) bit for bit.  The accumulator
// starts from +inf and padding is +inf, so padding never wins a min: a row
// whose every candidate exceeds the repo's INF (3e38/4) gives what the
// plain version gives.  (The Pallas kernel starts from INF and so clamps
// such a row to INF; in APSP the zero diagonal keeps every value at or
// below INF, where the two agree.)  nvcc does not contract or reorder the
// add without fast-math.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;     // C tile edge
constexpr int kK = 16;         // k slice staged in shared memory
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kAStride = kK + 4;  // floats a row of the A stage (80 bytes)

struct Stage {
  float a[kTile * kAStride];  // a[i * kAStride + k] = A[i0 + i, k0 + k]
  float b[kK * kTile];        // b[k * kTile + j] = B[k0 + k, j0 + j]
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ float4 inf4() {
  const float inf = __int_as_float(0x7f800000);
  return make_float4(inf, inf, inf, inf);
}

// One slice: A rows i0 .. i0 + 127 x k0 .. k0 + 15, B k0 .. k0 + 15 x j0 ..
// j0 + 127, two 16-byte chunks of each a thread.  a_hi is the end of A's
// readable columns in this split (its +inf pad included), k_hi the end of
// B's rows.
__device__ __forceinline__ void load_slice(Stage& st, const float* a,
                                           const float* b, int m, int n,
                                           int lda, int ldb, int i0, int j0,
                                           int k0, int a_hi, int k_hi,
                                           int tid) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int q = tid + kThreads * p;
    const int i = q >> 2, kc = (q & 3) << 2;
    float* dst = &st.a[i * kAStride + kc];
    if (i0 + i < m && k0 + kc < a_hi)
      cp_async16(dst, a + (long long)(i0 + i) * lda + k0 + kc);
    else
      *reinterpret_cast<float4*>(dst) = inf4();
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int q = tid + kThreads * p;
    const int k = q >> 5, jc = (q & 31) << 2;
    float* dst = &st.b[k * kTile + jc];
    if (k0 + k < k_hi && j0 + jc < n)
      cp_async16(dst, b + (long long)(k0 + k) * ldb + j0 + jc);
    else
      *reinterpret_cast<float4*>(dst) = inf4();
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, 2)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ c, int m, int n, int kdim, int lda,
               int ldb, int kper, int vec_store) {
  __shared__ __align__(16) Stage st[2];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int k_lo = blockIdx.z * kper;
  const int k_hi = min(kdim, k_lo + kper);
  const int a_hi = min((kdim + 3) & ~3, k_lo + kper);
  const int slices = (k_hi - k_lo + kK - 1) / kK;
  c += (long long)blockIdx.z * m * n;  // this split's partial minima

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = __int_as_float(0x7f800000);

  load_slice(st[0], a, b, m, n, lda, ldb, i0, j0, k_lo, a_hi, k_hi, tid);
  for (int t = 0; t < slices; ++t) {
    // slice t has landed for every thread, and every thread is done with
    // slice t - 1, whose stage slice t + 1 now takes
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (t + 1 < slices)
      load_slice(st[(t + 1) & 1], a, b, m, n, lda, ldb, i0, j0,
                 k_lo + (t + 1) * kK, a_hi, k_hi, tid);
    const Stage& s = st[t & 1];
#pragma unroll
    for (int kk = 0; kk < kK; kk += 4) {
      float4 av[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = (r < 4 ? 0 : 64) + 4 * ty + (r & 3);
        av[r] = *reinterpret_cast<const float4*>(&s.a[i * kAStride + kk]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&s.b[(kk + u) * kTile + 4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(
            &s.b[(kk + u) * kTile + 64 + 4 * tx]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float x = u == 0 ? av[r].x : u == 1 ? av[r].y
                        : u == 2 ? av[r].z : av[r].w;
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = fminf(acc[r][q], x + bv[q]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gi = i0 + (r < 4 ? 0 : 64) + 4 * ty + (r & 3);
    if (gi >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gj = j0 + 64 * h + 4 * tx;
      float* dst = c + (long long)gi * n + gj;
      if (vec_store && gj + 3 < n) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                        acc[r][4 * h + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (gj + q < n) dst[q] = acc[r][4 * h + q];
      }
    }
  }
}

// c[e] = min over splits of part[s, e], e < count
__global__ void minplus_combine(const float* __restrict__ part,
                                float* __restrict__ c, long long count,
                                int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < count; e += stride) {
    float v = part[e];
    for (int s = 1; s < splits; ++s) v = fminf(v, part[s * count + e]);
    c[e] = v;
  }
}

}  // namespace

extern "C" {

// a [m, >= K] with lda % 4 == 0 (columns K .. ceil4(K) - 1 are +inf), b
// [K, >= n] with ldb % 4 == 0, both 16-byte aligned; c [m, n] contiguous.
// splits == 1: the tiles write c.  splits > 1: they write part [splits, m,
// n], split z covering k in [z kper, min(K, (z + 1) kper)), and
// minplus_combine writes c.  kper is a multiple of 16 covering K in
// `splits` ranges.
int minplus_f32(const float* a, const float* b, float* c, float* part,
                int m, int n, int kdim, int lda, int ldb, int splits,
                int kper, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  if (splits < 1 || kper % kK != 0 || (long long)splits * kper < kdim ||
      (splits > 1 && part == nullptr) || lda % 4 != 0 || ldb % 4 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, splits);
  minplus_kernel<<<grid, kThreads, 0, stream>>>(
      a, b, splits > 1 ? part : c, m, n, kdim, lda, ldb, kper, n % 4 == 0);
  if (splits > 1) {
    const long long count = (long long)m * n;
    long long blocks = (count + kThreads - 1) / kThreads;
    if (blocks > 132LL * 8) blocks = 132LL * 8;
    minplus_combine<<<(unsigned)blocks, kThreads, 0, stream>>>(part, c, count,
                                                              splits);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
