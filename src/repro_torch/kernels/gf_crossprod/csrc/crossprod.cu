// All-pairs GF(q) cross product with left-normalisation (paper §IV-D):
//
//   c = s_i x d_j (mod q),  out[i, j, :] = c * lead(c)^(q-2) (mod q)
//
// where lead(c) is the first nonzero component (the zero vector, for
// parallel s_i and d_j, stays zero).  The [N, N] table of 2-hop
// intermediate routers of PolarFly's minimal routing is this product of
// the vertex list with itself, looked up in a vertex-code table by
// ops.intermediate_table.  s is [n, 3], d is [m, 3], int32 with entries in
// [0, q), 2 <= q <= 46340; out is [n, m, 3] int32.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/gf_crossprod/kernel.py::crossprod_normalized_pallas
// (body _make_kernel(q)).  That kernel tiles (256, 256) pairs, unrolls the
// Fermat power at trace time (q is static there) and writes three [n, m]
// planes that the caller stacks.  Here q is a run-time argument and the
// kernel writes the public [n, m, 3] layout itself.
//
// What bounds it: the 12 n m bytes it writes (at PF(79), n = m = 6321, 479
// MB: 143 us at 3.35 TB/s).  The first design of this kernel ran at 20 % of
// that, held by integer work: C's % by a run-time q is a long instruction
// sequence, it ran 17 of them a pair at q = 79 (the Fermat power was
// recomputed for every pair), and its three 4-byte stores a pair at a
// 12-byte stride spread each warp store over 12 sectors.  This design:
//
// * Remainders by a reciprocal multiply (mod_q below), exact for every
//   uint32 x: with M = floor(2^32 / q) = (2^32 - e) / q, 0 <= e < q, the
//   quotient estimate t = umulhi(x, M) = floor(x M / 2^32) satisfies
//   x / q - 1 - x e / (q 2^32) < t <= x / q, so r = x - t q lies in
//   [0, q + x e / 2^32) within [0, 2q), and one conditional subtraction
//   (an unsigned min of r and r - q, which wraps when r < q) leaves
//   x mod q.  Each cross-product term s_a d_b - s_b d_a lies in
//   [-(q-1)^2, (q-1)^2]; biased by q^2 it lies in [2q - 1, 2q^2) and stays
//   below 2^32 for q <= 46340, and the bias is a multiple of q, so its
//   remainder is the floor remainder of ref.py (torch.remainder).  The
//   normalising products c_k inv are below q^2.
// * A table of x^(q-2) mod q for x in [0, q), built by each block in
//   shared memory (uint16, at most 92,680 bytes) by the same square-and-
//   multiply as the plain version -- not by an extended-Euclid inverse --
//   so composite q and 0 -> 0 (0 -> 1 at q = 2, where the exponent is 0)
//   come out bit for bit.  A pair then does one shared-memory load in
//   place of 2 log2(q) multiply-remainders.
// * Whole-sector 16-byte streaming stores.  Pairs are walked as flat
//   indices p = i m + j, four consecutive pairs a thread, 128 a warp (a
//   chunk), whose 384 output words are one contiguous 1536-byte span.
//   Each lane writes its 12 words into the warp's shared staging buffer
//   (three 16-byte stores at a 48-byte stride: the eight lanes of each
//   quarter-warp phase cover all 32 banks once), then the warp reads the
//   span back 16 bytes a lane and stores it with three __stcs of 512
//   contiguous bytes each.  (Stored straight from each lane, three 16-byte
//   stores at a 48-byte stride that each write half of 48 sectors, the
//   kernel took 1.8 times as long at PF(79); PERF.md has the numbers.)
//   The walk is persistent and grid-strided over chunks; (i, j) advances
//   by a stride precomputed once a thread, and within a chunk by one
//   compare a pair, so no pair divides.  The last n m mod 128 pairs are a
//   scalar tail.  s and d (12 bytes a vertex) stay in L1.
//
// Integer work left (chip_smoke.py's gf_ops_per_pair counts it): about 48
// instructions a pair, 22 of them multiplies -- 57 us at PF(79) at the
// card's instruction rates (128 lanes a clock, 64 for multiplies), 40 % of
// the bytes bound.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkPairs = 128;          // 4 pairs a lane, 32 lanes
constexpr int kChunkWords = 3 * kChunkPairs;
constexpr int kStageBytes = kWarps * kChunkWords * 4;  // 12,288

struct Mod {
  uint32_t q, m;  // m = floor(2^32 / q)
};

__device__ __forceinline__ uint32_t mod_q(uint32_t x, Mod md) {
  const uint32_t r = x - __umulhi(x, md.m) * md.q;  // in [0, 2q)
  return min(r, r - md.q);
}

struct Pair {
  uint32_t o0, o1, o2;
};

__device__ __forceinline__ Pair normalised(uint32_t s0, uint32_t s1,
                                           uint32_t s2, const int* d,
                                           const uint16_t* inv_table,
                                           Mod md, uint32_t q2) {
  const uint32_t d0 = __ldg(d), d1 = __ldg(d + 1), d2 = __ldg(d + 2);
  const uint32_t c0 = mod_q(q2 + s1 * d2 - s2 * d1, md);
  const uint32_t c1 = mod_q(q2 + s2 * d0 - s0 * d2, md);
  const uint32_t c2 = mod_q(q2 + s0 * d1 - s1 * d0, md);
  const uint32_t lead = c0 != 0 ? c0 : (c1 != 0 ? c1 : c2);
  const uint32_t inv = inv_table[lead];
  return {mod_q(c0 * inv, md), mod_q(c1 * inv, md), mod_q(c2 * inv, md)};
}

__global__ void __launch_bounds__(kThreads)
crossprod_kernel(const int* __restrict__ s, const int* __restrict__ d,
                 int* __restrict__ out, int n, int m, Mod md) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
  uint16_t* inv_table = reinterpret_cast<uint16_t*>(smem + kStageBytes);
  const uint32_t q = md.q, q2 = q * q;

  // x^(q-2) mod q for x in [0, q), square and multiply as in ref.py
  for (uint32_t x = threadIdx.x; x < q; x += kThreads) {
    uint32_t r = 1, b = x;
    for (uint32_t e = q - 2; e > 0; e >>= 1) {
      if (e & 1) r = mod_q(r * b, md);
      b = mod_q(b * b, md);
    }
    inv_table[x] = (uint16_t)r;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long pairs = (long long)n * m;
  const long long chunks = pairs / kChunkPairs;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long warps = (long long)gridDim.x * kWarps;
  uint32_t* buf = stage + (threadIdx.x >> 5) * kChunkWords;

  if (warp < chunks) {
    // this lane's first pair, and the step to its pair one stride on
    const long long p0 = warp * kChunkPairs + 4 * lane;
    int i = (int)(p0 / m), j = (int)(p0 - (long long)i * m);
    const long long stride = warps * kChunkPairs;
    const int step_i = (int)(stride / m);
    const int step_j = (int)(stride - (long long)step_i * m);
    for (long long c = warp; c < chunks; c += warps) {
      int ii = i, jj = j;
      uint32_t s0 = __ldg(s + 3 * ii), s1 = __ldg(s + 3 * ii + 1),
               s2 = __ldg(s + 3 * ii + 2);
      uint32_t w[12];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const Pair o = normalised(s0, s1, s2, d + 3 * jj, inv_table, md, q2);
        w[3 * k] = o.o0;
        w[3 * k + 1] = o.o1;
        w[3 * k + 2] = o.o2;
        if (k < 3 && ++jj == m) {  // the next pair starts a row
          jj = 0;
          ++ii;
          s0 = __ldg(s + 3 * ii);
          s1 = __ldg(s + 3 * ii + 1);
          s2 = __ldg(s + 3 * ii + 2);
        }
      }
      uint4* mine = reinterpret_cast<uint4*>(buf + 12 * lane);
      mine[0] = make_uint4(w[0], w[1], w[2], w[3]);
      mine[1] = make_uint4(w[4], w[5], w[6], w[7]);
      mine[2] = make_uint4(w[8], w[9], w[10], w[11]);
      __syncwarp();
      const uint4* span = reinterpret_cast<const uint4*>(buf);
      int4* dst = reinterpret_cast<int4*>(out + c * kChunkWords);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint4 v = span[32 * k + lane];
        __stcs(dst + 32 * k + lane,
               make_int4((int)v.x, (int)v.y, (int)v.z, (int)v.w));
      }
      __syncwarp();  // the buffer is rewritten by the next chunk
      i += step_i;
      j += step_j;
      if (j >= m) {
        j -= m;
        ++i;
      }
    }
  }

  // the last pairs % 128 pairs, one a thread
  const long long tail = chunks * kChunkPairs;
  for (long long p = tail + (long long)blockIdx.x * kThreads + threadIdx.x;
       p < pairs; p += (long long)gridDim.x * kThreads) {
    const int i = (int)(p / m), j = (int)(p - (long long)i * m);
    const Pair o = normalised(__ldg(s + 3 * i), __ldg(s + 3 * i + 1),
                              __ldg(s + 3 * i + 2), d + 3 * j, inv_table, md,
                              q2);
    out[3 * p] = (int)o.o0;
    out[3 * p + 1] = (int)o.o1;
    out[3 * p + 2] = (int)o.o2;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at modulus q: the warps' staging
// buffers, then the uint16 power table.
size_t crossprod_smem_bytes(int q) {
  return (size_t)kStageBytes + (((size_t)q * 2 + 15) & ~(size_t)15);
}

int crossprod_normalized_i32(const int* s, const int* d, int* out, int n,
                             int m, int q, cudaStream_t stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  if (q < 2 || q > 46340) return (int)cudaErrorInvalidValue;
  const size_t smem = crossprod_smem_bytes(q);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(crossprod_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, crossprod_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  // one wave of persistent blocks, no more than the chunks (or, for fewer
  // than 128 pairs, the tail) need
  const long long pairs = (long long)n * m;
  const long long chunks = pairs / kChunkPairs;
  long long need = chunks > 0 ? (chunks + kWarps - 1) / kWarps
                              : (pairs + kThreads - 1) / kThreads;
  long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(need < wave ? need : wave);
  const Mod md = {(uint32_t)q, (uint32_t)(0x100000000ull / (uint32_t)q)};
  crossprod_kernel<<<grid, kThreads, smem, stream>>>(s, d, out, n, m, md);
  return (int)cudaGetLastError();
}

}  // extern "C"
