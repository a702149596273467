// Tropical (min,+) squaring of a symmetric hop-count matrix, for APSP:
//
//   C[i, j] = min_k D[i, k] + D[k, j] = min_k D[i, k] + D[j, k],
//   D [N, N] int16, symmetric, entries in {0 .. n - 1} or the sentinel S
//
// The integer route of the JAX package's Pallas TPU kernel
// src/repro/kernels/minplus/kernel.py::minplus_pallas inside `apsp` only
// (ops.py::_apsp_device).  There every distance is an integer hop count
// at most n - 1 or unreachable, so with unreachable as S = 16383 (> n - 1,
// and S + S = 32766 fits int16) the products give the float route's
// distances exactly: a reachable pair's min is its hop count, an
// unreachable pair's is S (the zero diagonal's candidate 0 + S), and no
// sum overflows.  The wrapper maps S back to INF.
//
// What bounds it: operations.  Hopper's DPX add-then-min on 16-bit pairs
// (`__viaddmin_s16x2`, one VIADDMNMX) takes two candidates an instruction,
// where the float route takes two instructions (FADD, FMNMX) a candidate.
// The pairs run along k: word w of a row holds k = 2w (low half) and 2w + 1
// (high half), so with D symmetric the A and B tiles are both rows of D,
// each lane of the accumulator keeps the min over even or odd k, and the
// epilogue takes the min of the two halves.
//
// Design, as csrc/minplus.cu's: a 128x128 C tile per 256-thread block, an
// 8x8 micro-tile per thread (rows ty + 16 r, columns tx + 16 c, so a
// half-warp's B rows fall in distinct banks), k in slices of 32 (16 words,
// 64 bytes a row) copied with 16-byte cp.async into two stages, one
// __syncthreads a slice, two words of k a shared load (LDS.64: 16 loads
// feed 128 VIADDMNMX, 256 candidates), and split-K with a combine pass
// where the tiles do not fill the card.
// Rows and k past N are S in shared memory: a candidate S + S never wins.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;
constexpr int kWords = 16;              // words of k a slice (32 k)
constexpr int kStride = kWords + 4;     // words a row of a stage (80 bytes)
constexpr int kThreads = 256;
constexpr unsigned kSentinelPair = 0x3fff3fffu;  // S = 16383 in both halves

struct Stage {
  unsigned a[kTile * kStride];  // a[i * kStride + w]: D[i0 + i, k pair w]
  unsigned b[kTile * kStride];  // b[j * kStride + w]: D[j0 + j, k pair w]
};

__device__ __forceinline__ void cp_async16(unsigned* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// rows r0 .. r0 + 127 of D, words w0 .. w0 + 15: 512 chunks of 16 bytes,
// two a thread
__device__ __forceinline__ void load_rows(unsigned* st, const short* d,
                                          int n, int r0, int w0, int tid) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int q = tid + kThreads * p;
    const int i = q >> 2, wc = (q & 3) << 2;
    unsigned* dst = &st[i * kStride + wc];
    if (r0 + i < n && 2 * (w0 + wc) < n)
      cp_async16(dst, d + (long long)(r0 + i) * n + 2 * (w0 + wc));
    else
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(kSentinelPair, kSentinelPair, kSentinelPair,
                     kSentinelPair);
  }
}

// 64 registers of sums and 16 + 16 of operands: two blocks an SM (ptxas
// spills a few words at 128 registers; four words a load took 190
// registers, one block an SM, and was slower at PF(79))
__global__ void __launch_bounds__(kThreads, 2)
minplus_dpx_kernel(const short* __restrict__ d, short* __restrict__ c, int n,
                   int kper) {
  __shared__ __align__(16) Stage st[2];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int k_lo = blockIdx.z * kper;
  const int k_hi = min(n, k_lo + kper);
  const int slices = (k_hi - k_lo + 2 * kWords - 1) / (2 * kWords);
  c += (long long)blockIdx.z * n * n;

  unsigned acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0x7fff7fffu;

  load_rows(st[0].a, d, n, i0, k_lo / 2, tid);
  load_rows(st[0].b, d, n, j0, k_lo / 2, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int t = 0; t < slices; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (t + 1 < slices) {
      const int w0 = (k_lo + (t + 1) * 2 * kWords) / 2;
      load_rows(st[(t + 1) & 1].a, d, n, i0, w0, tid);
      load_rows(st[(t + 1) & 1].b, d, n, j0, w0, tid);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const Stage& s = st[t & 1];
#pragma unroll
    for (int w = 0; w < kWords; w += 2) {
      uint2 av[8], bv[8];  // two words of k: rows ty + 16 r, tx + 16 r
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        av[r] = *reinterpret_cast<const uint2*>(
            &s.a[(ty + 16 * r) * kStride + w]);
        bv[r] = *reinterpret_cast<const uint2*>(
            &s.b[(tx + 16 * r) * kStride + w]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          acc[r][q] = __viaddmin_s16x2(av[r].x, bv[q].x, acc[r][q]);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          acc[r][q] = __viaddmin_s16x2(av[r].y, bv[q].y, acc[r][q]);
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gi = i0 + ty + 16 * r;
    if (gi >= n) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int gj = j0 + tx + 16 * q;
      const short lo = (short)(acc[r][q] & 0xffffu);
      const short hi = (short)(acc[r][q] >> 16);
      if (gj < n) c[(long long)gi * n + gj] = lo < hi ? lo : hi;
    }
  }
}

// c[e] = min over splits of part[s, e], e < count
__global__ void minplus_dpx_combine(const short* __restrict__ part,
                                    short* __restrict__ c, long long count,
                                    int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < count; e += stride) {
    short v = part[e];
    for (int s = 1; s < splits; ++s) {
      const short x = part[s * count + e];
      v = x < v ? x : v;
    }
    c[e] = v;
  }
}

}  // namespace

extern "C" {

// d, c [n, n] int16, n % 8 == 0, 16-byte aligned, d symmetric with entries
// in [0, 16383]; splits == 1: the tiles write c; splits > 1: they write part
// [splits, n, n], split z covering k in [z kper, min(n, (z + 1) kper)), and
// the combine pass writes c.  kper is a multiple of 32.
int minplus_sym_s16(const short* d, short* c, short* part, int n, int splits,
                    int kper, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n % 8 != 0 || n > 16383 || splits < 1 || kper % (2 * kWords) != 0 ||
      (long long)splits * kper < n || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile, splits);
  short* out = splits > 1 ? part : c;
  minplus_dpx_kernel<<<grid, kThreads, 0, stream>>>(d, out, n, kper);
  if (splits > 1) {
    const long long count = (long long)n * n;
    long long blocks = (count + kThreads - 1) / kThreads;
    if (blocks > 132LL * 8) blocks = 132LL * 8;
    minplus_dpx_combine<<<(unsigned)blocks, kThreads, 0, stream>>>(
        part, c, count, splits);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
