// Per-candidate path costs for the fluid solver's Frank-Wolfe step:
//
//   cost[i] = sum_{l = 0 .. L-1} delay[eidx[i * L + l]],   i = (f, k) flat
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/minplus/kernel.py::path_costs_pallas (body
// _path_cost_kernel).  That kernel keeps the whole delay table in VMEM and
// streams 256-flow tiles of edge ids through a sequential grid.  Hopper has
// no such grid order and a far smaller scratchpad per block, so this is not
// a carry-over of that tiling.
//
// What bounds it: bytes.  Each output reads L indices (4 B each) and writes
// one value, and the gathers hit a table of E+1 values that stays resident
// in the 50 MB L2 (127 KB at PF(31), 1 MB at PF(79) in fp32), read through
// __ldg; with no shared memory in use, the SM's L1 holds PF(31)'s fp32
// table too.  At PF(31) uniform ugal_pf (F*K = 1.24M, L = 4) that is about
// 25 MB, or about 7.5 us at 3.35 TB/s.  There are no FLOPs to speak of.
//
// The design (path_costs_rows, for L <= 4): each thread owns kRows = 8
// rows, kThreads apart so a warp's loads stay coalesced, and issues all
// its index loads before any gather, then all 8 L gathers, then the sums:
// eight outputs' memory requests are in flight at once instead of one
// dependent index -> gather -> store chain.  A row of L = 4 indices is one
// 16-byte load (L = 2: one 8-byte load), read with an L2 evict_last policy
// and without allocating in L1: eidx is the same tensor in every step of a
// saturation (19.8 MB at PF(31)) and fits the L2, while L1 is left to the
// delay table.  Outputs go out with streaming stores.  The wrapper
// (ops.py::_path_costs_plan) picks this kernel only when the rows are
// aligned for their vector load; other L (TEST_SHAPES has L = 5) and
// misaligned bases take path_costs_any, one thread per output in a
// grid-stride loop.  On the card (PERF.md) the same launch with every index
// 0 takes 89 % of the time with the real indices: the 25 MB stream, not
// the random gathers, is what is left, at about 2 TB/s; a variant that
// staged the table in shared memory was no faster and is not kept.
//
// The sum runs in order l = 0 .. L-1 from 0, as the plain PyTorch version
// (ref.py::path_costs_ref) does, so the two agree bit for bit.  nvcc does
// not reassociate or contract plain adds without fast-math.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the launchers return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows a thread of path_costs_rows
// one wave of the generic kernel: 2048 resident threads / 256 = 8 blocks on
// each of 132 SMs
constexpr long long kMaxBlocks = 132LL * 8;

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// The L indices of one row: one vector load where the row is 8 or 16
// bytes, else L scalar loads; all with the evict_last policy, no L1 line.
template <int L>
__device__ __forceinline__ void load_row(const int* p, uint64_t policy,
                                         int (&v)[L]) {
  if constexpr (L == 4) {
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 "
        "{%0, %1, %2, %3}, [%4], %5;"
        : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
        : "l"(p), "l"(policy));
  } else if constexpr (L == 2) {
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v2.s32 "
        "{%0, %1}, [%2], %3;"
        : "=r"(v[0]), "=r"(v[1]) : "l"(p), "l"(policy));
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l)
      asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;"
          : "=r"(v[l]) : "l"(p + l), "l"(policy));
  }
}

// kRows rows a thread, kThreads apart: all index loads, then all gathers,
// then the sums and streaming stores.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
path_costs_rows(const T* __restrict__ delay, const int* __restrict__ eidx,
                T* __restrict__ out, long long n_out) {
  const uint64_t policy = evict_last();
  const long long first =
      (long long)blockIdx.x * (kThreads * kRows) + threadIdx.x;
  int idx[kRows][L];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = first + (long long)r * kThreads;
    if (i < n_out) {
      load_row<L>(eidx + i * L, policy, idx[r]);
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) idx[r][l] = 0;  // slot 0 exists; unused
    }
  }
  T val[kRows][L];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int l = 0; l < L; ++l) val[r][l] = __ldg(delay + idx[r][l]);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = first + (long long)r * kThreads;
    T acc = T(0);
#pragma unroll
    for (int l = 0; l < L; ++l) acc = acc + val[r][l];
    if (i < n_out) __stcs(out + i, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
path_costs_any(const T* __restrict__ delay, const int* __restrict__ eidx,
               T* __restrict__ out, long long n_out, int L) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_out; i += stride) {
    const int* row = eidx + i * L;
    T acc = T(0);
    for (int l = 0; l < L; ++l) {
      acc = acc + __ldg(delay + __ldg(row + l));
    }
    __stcs(out + i, acc);
  }
}

template <typename T, int L>
int launch_rows(const T* delay, const int* eidx, T* out, long long n_out,
                cudaStream_t stream) {
  const long long blocks =
      (n_out + kThreads * kRows - 1) / (kThreads * kRows);
  path_costs_rows<T, L><<<(unsigned)blocks, kThreads, 0, stream>>>(
      delay, eidx, out, n_out);
  return (int)cudaGetLastError();
}

// rows = 0: the generic kernel; rows = kRows with L <= 4: path_costs_rows.
// Anything else is refused with cudaErrorInvalidValue.
template <typename T>
int launch(const T* delay, const int* eidx, T* out, long long n_out, int L,
           int rows, cudaStream_t stream) {
  if (n_out <= 0) return (int)cudaSuccess;
  if (rows == 0) {
    long long blocks = (n_out + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    path_costs_any<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        delay, eidx, out, n_out, L);
    return (int)cudaGetLastError();
  }
  if (rows != kRows) return (int)cudaErrorInvalidValue;
  switch (L) {
    case 1: return launch_rows<T, 1>(delay, eidx, out, n_out, stream);
    case 2: return launch_rows<T, 2>(delay, eidx, out, n_out, stream);
    case 3: return launch_rows<T, 3>(delay, eidx, out, n_out, stream);
    case 4: return launch_rows<T, 4>(delay, eidx, out, n_out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int path_costs_f32(const float* delay, const int* eidx, float* out,
                   long long n_out, int L, int rows, cudaStream_t stream) {
  return launch<float>(delay, eidx, out, n_out, L, rows, stream);
}

int path_costs_f64(const double* delay, const int* eidx, double* out,
                   long long n_out, int L, int rows, cudaStream_t stream) {
  return launch<double>(delay, eidx, out, n_out, L, rows, stream);
}

}  // extern "C"
