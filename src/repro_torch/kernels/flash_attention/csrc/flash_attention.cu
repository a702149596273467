// FlashAttention-style online-softmax GQA attention, forward only:
//
//   o[b, h, i] = sum_j softmax_j(s[i, j]) v[b, h / g, j],
//   s[i, j] = cap tanh((scale q[b, h, i] . k[b, h / g, j]) / cap)
//             where (j <= i if causal) and (j > i - window if windowed),
//             NEG_INF = -1e30 elsewhere,
//
// q [B, Hq, S, D], k and v [B, Hkv, S, D], all contiguous, float32 or
// bfloat16; o [B, Hq, S, D] in q's dtype; g = Hq / Hkv.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas (body
// _make_kernel).  That kernel walks a (batch, head, q tile, kv tile) grid
// with the kv axis innermost and sequential, carrying m, l and acc in VMEM
// scratch from one grid step to the next.  Hopper runs blocks in no order,
// so here one block owns one (b, h, 64-row q tile) and the kv sweep is a
// loop inside it: m, l live in registers of the threads that do the
// softmax, acc in registers of the threads that own the output.  The loop
// visits only the kv tiles that the Pallas kernel's tile-level tests keep
// (kernel.py:46-51): from the tile holding the window's first key for the
// tile's first row to the tile holding the last row's causal limit.
//
// Arithmetic, as in the Pallas kernel: q converted to float32 and
// multiplied by `scale` once, at load; the logit softcap with the accurate
// tanhf and a true division by cap; masked entries get the finite -1e30,
// so a row whose keys in a visited tile are all masked while m is still
// -1e30 takes p = exp(0) = 1 for them, and the first real key zeroes that
// out through alpha = exp(-1e30 - m) = 0 (-INFINITY would give
// exp(-inf + inf) = NaN); m, l, acc in float32; o = acc / (l > 0 ? l : 1).
// bfloat16 inputs are converted to float32 as they are staged; there is
// no bfloat16 arithmetic.  Keys past S (the ragged tail, which the Pallas
// kernel cannot have: it asserts that S divides its tile) are masked like
// any other and read as zeros.
//
// Design: a simple kernel on the CUDA cores, float32 FMAs.  256 threads
// (16 x 16) per block; the q tile (64 x D, scaled) stays in shared memory
// for the whole sweep; k and v tiles of 32 keys take turns in one shared
// buffer, which keeps the block at 106 KB for D = 256 so that two blocks
// share an SM.  Per kv tile:
//   1. s = q k^T: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and keys tx,
//      tx + 16, reading float4 runs along D (the rows are padded by 4
//      floats so 8 threads reading 8 keys hit 32 distinct banks);
//   2. softcap and mask, s stored transposed in shared memory;
//   3. the online softmax, four threads a row (shuffles), while the v tile
//      is staged over the k tile;
//   4. acc = alpha acc + p v: thread (ty, tx) owns the same four rows and
//      the float4 columns 4 (tx + 16 j) of D.
// Blocks are issued longest sweep first (the last q tiles of a causal
// sweep have the most kv tiles), which shortens the tail.
//
// What bounds it on this card: operations.  The work is 4 D flops per
// unmasked (query, key) pair and head (two products); at the tensor
// cores' dense bf16 rate (989e12 flop/s) that is 0.56 ms for one Gemma2-9B
// global layer at S = 8192 (16 heads, D = 256, causal) and 0.42 ms for a
// local one (window 4096); the bytes (q, k, v, o: 201 MB in bf16) take
// 0.06 ms at 3.35 TB/s.  This kernel does those flops as float32 FMAs on
// the CUDA cores (67e12 flop/s at most, 15x below the tensor cores), and
// its shared-memory reads cost about as much as its FMAs, so it runs far
// from that bound: wgmma, TMA and a warp-specialised pipeline are later
// work (PERF.md has its times).
//
// Launches are counted by the Python wrapper (ops.py, `LAUNCHES`), once
// per successful launch.  Built by repro_torch/kernels/_build.py with nvcc
// into a shared library with a plain C interface; the launcher returns
// cudaGetLastError().  No --use_fast_math: tanhf and expf stay accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows a block
constexpr int kBK = 32;        // keys a kv tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// rows [row0, row0 + nrows) of a [S, D] matrix into shared memory with row
// stride ld, times `mul`; rows at or past S read as zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int row0, int nrows, int s, int d,
                                      float mul) {
  const int d4 = d / 4;
  for (int e = threadIdx.x; e < nrows * d4; e += kThreads) {
    const int r = e / d4, c = (e - r * d4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s) {
      v = load4(src + (long long)(row0 + r) * d + c);
      v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
    }
    store4(dst + r * ld + c, v);
  }
}

// NJ = ceil(D / 64): float4 column chunks of the output per thread
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int s, int d, int causal, float softcap,
                       int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = d + 4;                 // row stride of the q and kv tiles
  constexpr int ldp = kBQ + 4;          // row stride of the transposed p
  float* qs = smem;                     // [kBQ][ld]
  float* kvs = qs + kBQ * ld;           // [kBK][ld], k then v
  float* ps = kvs + kBK * ld;           // [kBK][ldp]: ps[key][row]
  float* alphas = ps + kBK * ldp;       // [kBQ]
  float* ls = alphas + kBQ;             // [kBQ]

  const int nq = (s + kBQ - 1) / kBQ;
  const int iq = nq - 1 - blockIdx.x;   // longest sweeps first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const long long head = (long long)s * d;
  const T* qh = q + ((long long)b * hq + h) * head;
  const T* kh = k + ((long long)b * hkv + hk) * head;
  const T* vh = v + ((long long)b * hkv + hk) * head;
  T* oh = o + ((long long)b * hq + h) * head;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int srow = tid / 4, part = tid % 4;  // softmax: 4 threads a row
  const int q0 = iq * kBQ;
  const int nk = (s + kBK - 1) / kBK;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int kt_hi = causal ? min(nk - 1, (q0 + kBQ - 1) / kBK) : nk - 1;

  stage(qs, ld, qh, q0, kBQ, s, d, scale);

  float acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  float m_run = kNegInf, l_run = 0.f;  // of row srow

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's p v is done with kvs and ps
    stage(kvs, ld, kh, k0, kBK, s, d, 1.f);
    __syncthreads();

    // 1. s = q k^T for rows 4 ty + i, keys tx and tx + 16
    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; c += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(qs + (4 * ty + i) * ld + c);
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = load4(kvs + (tx + 16 * j) * ld + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sc[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                      qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }
    // 2. softcap and mask, stored transposed: ps[key][row]
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kpos = k0 + tx + 16 * j;
      float out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + 4 * ty + i;
        float x = sc[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < s;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        out[i] = ok ? x : kNegInf;
      }
      store4(ps + (tx + 16 * j) * ldp + 4 * ty,
             make_float4(out[0], out[1], out[2], out[3]));
    }
    __syncthreads();  // ps complete; k no longer needed

    // 3. v over k, and the online softmax of row srow (keys 4 c + part)
    stage(kvs, ld, vh, k0, kBK, s, d, 1.f);
    {
      float x[kBK / 4];
      float mc = kNegInf;
#pragma unroll
      for (int c = 0; c < kBK / 4; ++c) {
        x[c] = ps[(4 * c + part) * ldp + srow];
        mc = fmaxf(mc, x[c]);
      }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_new = fmaxf(m_run, mc);
      const float alpha = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kBK / 4; ++c) {
        const float p = expf(x[c] - m_new);
        ps[(4 * c + part) * ldp + srow] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (part == 0) alphas[srow] = alpha;
    }
    __syncthreads();

    // 4. acc = alpha acc + p v
    float al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) al[i] = alphas[4 * ty + i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= al[i];
#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      const float4 p = load4(ps + key * ldp + 4 * ty);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 4 * (tx + 16 * j);
        if (col < d) {
          const float4 vv = load4(kvs + key * ld + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j][0] += pr[i] * vv.x;
            acc[i][j][1] += pr[i] * vv.y;
            acc[i][j][2] += pr[i] * vv.z;
            acc[i][j][3] += pr[i] * vv.w;
          }
        }
      }
    }
  }

  if (part == 0) ls[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i;
    if (q0 + row >= s) continue;
    const float l = ls[row];
    const float den = l > 0.f ? l : 1.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 4 * (tx + 16 * j);
      if (col < d)
        store4(oh + (long long)(q0 + row) * d + col,
               make_float4(acc[i][j][0] / den, acc[i][j][1] / den,
                           acc[i][j][2] / den, acc[i][j][3] / den));
    }
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)(kBQ + kBK) * (d + 4) + (size_t)kBK * (kBQ + 4) + 2 * kBQ);
}

template <typename T, int NJ>
int launch(const T* q, const T* k, const T* v, T* o, int b, int hq, int hkv,
           int s, int d, int causal, float softcap, int window, float scale,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, NJ>;
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, o, hq, hkv, s, d, causal,
                                            softcap, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int b, int hq,
             int hkv, int s, int d, int causal, float softcap, int window,
             float scale, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > kMaxD || d % 4 != 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  switch ((d + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, b, hq, hkv, s, d, causal, softcap,
                                window, scale, stream);
    case 2: return launch<T, 2>(q, k, v, o, b, hq, hkv, s, d, causal, softcap,
                                window, scale, stream);
    case 3: return launch<T, 3>(q, k, v, o, b, hq, hkv, s, d, causal, softcap,
                                window, scale, stream);
    default: return launch<T, 4>(q, k, v, o, b, hq, hkv, s, d, causal,
                                 softcap, window, scale, stream);
  }
}

}  // namespace

extern "C" {

// dynamic shared memory of one block for head dim d, in bytes
long long flash_attention_smem_bytes(int d) { return (long long)smem_bytes(d); }

// softcap <= 0 means none, window <= 0 means none
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* o, int b, int hq, int hkv, int s, int d,
                        int causal, float softcap, int window, float scale,
                        cudaStream_t stream) {
  return dispatch(q, k, v, o, b, hq, hkv, s, d, causal, softcap, window,
                  scale, stream);
}

int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o, int b,
                         int hq, int hkv, int s, int d, int causal,
                         float softcap, int window, float scale,
                         cudaStream_t stream) {
  return dispatch(q, k, v, o, b, hq, hkv, s, d, causal, softcap, window,
                  scale, stream);
}

}  // extern "C"
