// Per-candidate path costs for the fluid solver's Frank-Wolfe step:
//
//   cost[i] = sum_{l = 0 .. L-1} delay[eidx[i * L + l]],   i = (f, k) flat
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/minplus/kernel.py::path_costs_pallas (body
// _path_cost_kernel).  That kernel keeps the whole delay table in VMEM and
// streams 256-flow tiles of edge ids through a sequential grid.  Hopper has
// no such grid order and a far smaller scratchpad per block, so this is not
// a carry-over of that tiling: one thread per (f, k) output, a grid-stride
// loop over F*K outputs, L int32 indices read per thread.
//
// What bounds it: bytes.  Each output reads L indices (4 B each) and writes
// one value, and the gathers hit a table of E+1 values that stays resident
// in the 50 MB L2 (127 KB at PF(31), 2 MB at PF(79)), read through __ldg.
// At PF(31) uniform ugal_pf (F*K = 1.24M, L = 4) that is about 25 MB, or
// about 7.5 us at 3.35 TB/s.  There are no FLOPs to speak of.
//
// The sum runs in order l = 0 .. L-1 from 0, as the plain PyTorch version
// (ref.py::path_costs_ref) does, so the two agree bit for bit.  nvcc does
// not reassociate or contract plain adds without fast-math.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the launchers return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// one wave: 2048 resident threads / 256 = 8 blocks on each of 132 SMs
constexpr long long kMaxBlocks = 132LL * 8;

template <typename T>
__global__ void path_costs_kernel(const T* __restrict__ delay,
                                  const int* __restrict__ eidx,
                                  T* __restrict__ out, long long n_out,
                                  int L) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_out; i += stride) {
    const int* row = eidx + i * L;
    T acc = T(0);
    for (int l = 0; l < L; ++l) {
      acc = acc + __ldg(delay + __ldg(row + l));
    }
    out[i] = acc;
  }
}

template <typename T>
int launch(const T* delay, const int* eidx, T* out, long long n_out, int L,
           cudaStream_t stream) {
  if (n_out <= 0) return (int)cudaSuccess;
  long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  path_costs_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      delay, eidx, out, n_out, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int path_costs_f32(const float* delay, const int* eidx, float* out,
                   long long n_out, int L, cudaStream_t stream) {
  return launch<float>(delay, eidx, out, n_out, L, stream);
}

int path_costs_f64(const double* delay, const int* eidx, double* out,
                   long long n_out, int L, cudaStream_t stream) {
  return launch<double>(delay, eidx, out, n_out, L, stream);
}

}  // extern "C"
