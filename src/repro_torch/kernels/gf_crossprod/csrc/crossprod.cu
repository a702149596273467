// All-pairs GF(q) cross product with left-normalisation (paper §IV-D):
//
//   c = s_i x d_j (mod q),  out[i, j, :] = c * lead(c)^(q-2) (mod q)
//
// where lead(c) is the first nonzero component (the zero vector, for
// parallel s_i and d_j, stays zero).  The [N, N] table of 2-hop
// intermediate routers of PolarFly's minimal routing is this product of
// the vertex list with itself, looked up in a vertex-code table by
// ops.intermediate_table.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/gf_crossprod/kernel.py::crossprod_normalized_pallas
// (body _make_kernel(q)).  That kernel tiles (256, 256) pairs, unrolls the
// Fermat power at trace time (q is static there) and writes three [n, m]
// planes that the caller stacks.  Here q is a run-time argument, so the
// power is a loop over the bits of q - 2; one thread computes one (i, j)
// pair and writes its three components straight into the public [n, m, 3]
// layout (12 bytes a thread, consecutive threads on consecutive 12-byte
// records, so a warp stores 384 contiguous bytes).  There is no stacking
// pass.  The grid is 2-D -- x over j in 256-wide blocks, y over rows i --
// so no thread divides to find its pair, and a block's 256 threads share
// one s row.
//
// What bounds it: at PF(79) (n = m = 6321) the output is 479 MB, 143 us at
// 3.35 TB/s.  The integer work counted from this code is 92 int32
// operations a pair, 20 of them multiplies (6 multiplies and 3
// subtractions of the cross product, a remainder, compare and add per
// reduction, a square-and-reduce and the loop test per bit of q - 2 and a
// multiply-and-reduce per set bit; chip_smoke.py's gf_ops_per_pair): 110 us
// at 128 int32 operations a clock on each of 132 SMs, 48 us for the
// multiplies at 64.  So on paper the bytes bound it.  In fact the integer
// work does: C's % by a run-time divisor is a sequence of several
// instructions, not one.  The inputs (12 bytes a vertex) stay in L1/L2.
//
// C's % truncates toward zero, like lax.rem; the "+ q if negative" of the
// Pallas kernel's _mod makes it the floor remainder of ref.py (torch.
// remainder), so the two agree bit for bit.  Products stay below 2^31 for
// q < 46341.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 65535;  // gridDim.y limit; larger n loops

__device__ __forceinline__ int mod_q(int x, int q) {
  const int r = x % q;
  return r < 0 ? r + q : r;
}

__global__ void crossprod_kernel(const int* __restrict__ s,
                                 const int* __restrict__ d,
                                 int* __restrict__ out, int n, int m, int q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const int s0 = __ldg(s + 3 * i), s1 = __ldg(s + 3 * i + 1),
              s2 = __ldg(s + 3 * i + 2);
    const int d0 = __ldg(d + 3 * j), d1 = __ldg(d + 3 * j + 1),
              d2 = __ldg(d + 3 * j + 2);
    const int c0 = mod_q(s1 * d2 - s2 * d1, q);
    const int c1 = mod_q(s2 * d0 - s0 * d2, q);
    const int c2 = mod_q(s0 * d1 - s1 * d0, q);
    const int lead = c0 != 0 ? c0 : (c1 != 0 ? c1 : c2);
    int inv = 1, base = lead;
    for (int e = q - 2; e > 0; e >>= 1) {
      if (e & 1) inv = mod_q(inv * base, q);
      base = mod_q(base * base, q);
    }
    int* o = out + 3 * ((long long)i * m + j);
    o[0] = mod_q(c0 * inv, q);
    o[1] = mod_q(c1 * inv, q);
    o[2] = mod_q(c2 * inv, q);
  }
}

}  // namespace

extern "C" {

int crossprod_normalized_i32(const int* s, const int* d, int* out, int n,
                             int m, int q, cudaStream_t stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  dim3 grid((m + kThreads - 1) / kThreads, n < kMaxRows ? n : kMaxRows);
  crossprod_kernel<<<grid, kThreads, 0, stream>>>(s, d, out, n, m, q);
  return (int)cudaGetLastError();
}

}  // extern "C"
