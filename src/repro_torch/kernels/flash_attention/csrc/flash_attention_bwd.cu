// Backward of flash_attention.cu / flash_attention_sm90.cu: dq, dk, dv of
//
//   o[b, h, i] = sum_j p[i, j] v[b, h / g, j],   p[i, j] = softmax_j(s[i, j]),
//   s[i, j] = cap tanh(x[i, j] / cap),   x[i, j] = (scale q[b, h, i]) . k[b, h / g, j]
//             where (j <= i if causal) and (j > i - window if windowed);
//             masked pairs take no part (p = 0, no gradient),
//
// given do = dL/do:
//
//   dv[j]  = sum_i p[i, j] do[i]                  (summed over the g q heads
//   dk[j]  = sum_i dx[i, j] (scale q[i])           of j's kv head too)
//   dq[i]  = scale sum_j dx[i, j] k[j]
//   dx[i, j] = p[i, j] (do[i] . v[j] - Dsum[i]) (1 - tanh^2(x[i, j] / cap)),
//   Dsum[i] = do[i] . o[i] = sum_j p[i, j] (do[i] . v[j]).
//
// q, o, do, dq [B, Hq, S, D]; k, v, dk, dv [B, Hkv, S, D]; all contiguous,
// float32 or bfloat16 (one dtype); D a multiple of 4 up to 256.  lse and dsum
// are [B, Hq, S] float32 scratch the wrapper allocates.
//
// No Pallas counterpart: the JAX package never differentiates its Pallas
// kernel (src/repro/kernels/flash_attention/kernel.py:92 defines no VJP);
// its train paths build their models with use_pallas=False, so its
// gradients are XLA autodiff through ref.attention_ref.  This kernel computes
// that gradient (the port's oracle is autograd through
// ref.attention_backward_ref).  ops.py launches it from the backward of the
// torch.autograd.Function around both forward kernels.
//
// Deterministic: no floating-point atomics, so the same inputs give the
// same bits on every run (a restart from a checkpoint repeats its steps bit
// for bit).  Two kernels, one after the other on the caller's stream:
//
//   1. dq: one block a (b, h, 32-row q tile).  Sweep 1 over the kv tiles
//      the tile sees recomputes each row's log-sum-exp (online max and sum)
//      and Dsum = do . o; both go to the scratch.  Sweep 2 recomputes p,
//      do . v and dx tile by tile and accumulates dq in registers.
//   2. dk/dv: one block a (b, kv head, 32-key tile).  It loops over the g
//      q heads of its group and the q tiles that see its keys, recomputes
//      p and dx from the scratch's lse and Dsum, and accumulates dk and dv
//      in registers; the group's sum runs in a fixed order.
//
// Arithmetic as in flash_attention.cu: q converted to float32 and
// multiplied by `scale` at staging, the accurate tanhf with a true division
// by cap, expf, float32 throughout, one rounding of each output to its
// dtype.  The recomputed lse is m + log(l) of this kernel's own scores, so
// p is consistent within the backward whatever forward kernel produced o.
//
// Design: the simple kernel, float32 FMAs on the CUDA cores.  256 threads
// (16 x 16); tiles of 32 rows on both sides, staged into shared memory as
// float32 with rows padded by 4 floats (8 threads reading 8 rows hit 32
// distinct banks).  Scores: thread (ty, tx) owns the 2 x 2 entries (rows
// ty, ty + 16; keys tx, tx + 16) of the 32 x 32 tile and forms x and
// do . v together, reading float4 runs along D.  Accumulation: thread
// (ty, tx) owns rows ty, ty + 16 of its block's 32 rows and the float4
// columns 4 (tx + 16 j).  Shared memory: four [32][D + 4] tiles and two
// [32][33] score tiles, 142 KB at D = 256 (one block an SM), 43 KB at
// D = 64.
//
// What bounds it on this card: operations.  The backward is about 10 D
// flops per unmasked (query, key) pair and head (the products q k^T,
// do v^T, p^T do, dx^T q, dx k: FlashAttention-2's count, 2.5 times the
// forward's 4 D); at the dense bf16 tensor-core rate (989e12 flop/s) that
// is 0.08 ms a qwen2-0.5b layer at B = 4, S = 2048 (14 heads, D = 64,
// causal).  This kernel recomputes the scores three times (lse, dq, dk/dv:
// about 16 D flops a pair) as float32 FMAs on the CUDA cores (67e12 flop/s
// at most), so it runs far from that bound; a wgmma/TMA bf16 version is
// later work (PERF.md has its times).
//
// Launches are counted by the Python wrapper (ops.py, LAUNCHES_BY_KERNEL
// "bwd"), once per backward.  Built by repro_torch/kernels/_build.py with
// nvcc into a shared library with a plain C interface; the launcher returns
// cudaGetLastError().  No --use_fast_math: tanhf, expf and logf stay
// accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;         // rows a tile (q rows and keys alike)
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxD = 256;
constexpr int kLdS = kT + 1;   // row stride of the score tiles
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

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float w, float4 x) {
  acc.x += w * x.x; acc.y += w * x.y; acc.z += w * x.z; acc.w += w * x.w;
}

// rows [row0, row0 + kT) of a [S, D] matrix into shared memory with row
// stride ld, times `mul`; rows at or past S read as zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int row0, int s, int d, float mul) {
  const int d4 = d / 4;
  for (int e = threadIdx.x; e < kT * d4; e += kThreads) {
    const int r = e / d4, c = (e - r * d4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s) {
      v = load4(src + (long long)(row0 + r) * d + c);
      v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
    }
    store4(dst + r * ld + c, v);
  }
}

struct Mask {
  int s, causal, window;
  __device__ __forceinline__ bool keep(int i, int j) const {
    bool ok = i < s && j < s;
    if (causal) ok = ok && j <= i;
    if (window > 0) ok = ok && j > i - window;
    return ok;
  }
};

// x (or, with dos / vs, also do . v) for the 2 x 2 entries of thread
// (ty, tx): q-side rows ty, ty + 16 of qs / dos, keys tx, tx + 16 of ks / vs
template <bool kDp>
__device__ __forceinline__ void scores(const float* qs, const float* ks,
                                       const float* dos, const float* vs,
                                       int ld, int d, int ty, int tx,
                                       float x[2][2], float dp[2][2]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) x[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; c += 4) {
    const float4 q0 = load4(qs + ty * ld + c);
    const float4 q1 = load4(qs + (ty + 16) * ld + c);
    const float4 k0 = load4(ks + tx * ld + c);
    const float4 k1 = load4(ks + (tx + 16) * ld + c);
    x[0][0] += dot4(q0, k0); x[0][1] += dot4(q0, k1);
    x[1][0] += dot4(q1, k0); x[1][1] += dot4(q1, k1);
    if (kDp) {
      const float4 o0 = load4(dos + ty * ld + c);
      const float4 o1 = load4(dos + (ty + 16) * ld + c);
      const float4 v0 = load4(vs + tx * ld + c);
      const float4 v1 = load4(vs + (tx + 16) * ld + c);
      dp[0][0] += dot4(o0, v0); dp[0][1] += dot4(o0, v1);
      dp[1][0] += dot4(o1, v0); dp[1][1] += dot4(o1, v1);
    }
  }
}

// the softcapped score of x and the factor d s / d x (1 without a cap)
__device__ __forceinline__ float capped(float x, float softcap, float* dsdx) {
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    *dsdx = 1.f - t * t;
    return softcap * t;
  }
  *dsdx = 1.f;
  return x;
}

// p and dx of one entry from its x, do . v and its row's lse and Dsum
__device__ __forceinline__ void grad_entry(bool keep, float x, float dp,
                                           float lse, float dsum,
                                           float softcap, float* p,
                                           float* dx) {
  float dsdx;
  const float sc = capped(x, softcap, &dsdx);
  const float pe = keep ? expf(sc - lse) : 0.f;
  *p = pe;
  *dx = pe * (dp - dsum) * dsdx;
}

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)4 * kT * (d + 4) + (size_t)2 * kT * kLdS +
                          2 * kT);
}

// NJ = ceil(D / 64): float4 column chunks of an accumulator row per thread
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, T* __restrict__ dq,
              float* __restrict__ lse_out, float* __restrict__ dsum_out,
              int hq, int hkv, int s, int d, int causal, float softcap,
              int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = d + 4;
  float* qs = smem;                // [kT][ld], q * scale
  float* dos = qs + kT * ld;       // [kT][ld]
  float* ks = dos + kT * ld;       // [kT][ld]
  float* vs = ks + kT * ld;        // [kT][ld]
  float* dxs = vs + kT * ld;       // [kT][kLdS]: dxs[key][row]
  float* lse_s = dxs + 2 * kT * kLdS;  // [kT]
  float* dsum_s = lse_s + kT;          // [kT]

  const int nt = (s + kT - 1) / kT;
  const int it = nt - 1 - blockIdx.x;  // longest sweeps first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const long long head = (long long)s * d;
  const T* qh = q + ((long long)b * hq + h) * head;
  const T* oh = o + ((long long)b * hq + h) * head;
  const T* doh = dout + ((long long)b * hq + h) * head;
  const T* kh = k + ((long long)b * hkv + hk) * head;
  const T* vh = v + ((long long)b * hkv + hk) * head;
  T* dqh = dq + ((long long)b * hq + h) * head;
  const long long row_base = ((long long)b * hq + h) * s;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = it * kT;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kT : 0;
  const int kt_hi = causal ? min(nt - 1, (q0 + kT - 1) / kT) : nt - 1;
  const Mask mask{s, causal, window};

  stage(qs, ld, qh, q0, s, d, scale);
  stage(dos, ld, doh, q0, s, d, 1.f);
  __syncthreads();

  // Dsum of rows ty, ty + 16: each thread a stride of columns, then the 16
  // threads of the row (one half-warp) summed by shuffles
  float dsum[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = ty + 16 * a;
    float acc = 0.f;
    if (q0 + row < s)
      for (int c = 4 * tx; c < d; c += 64)
        acc += dot4(load4(oh + (long long)(q0 + row) * d + c),
                    load4(dos + row * ld + c));
#pragma unroll
    for (int off = 1; off < 16; off *= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    dsum[a] = acc;
  }

  // sweep 1: the rows' log-sum-exp over their kept keys
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the previous tile's scores are done with ks
    stage(ks, ld, kh, k0, s, d, 1.f);
    __syncthreads();
    float x[2][2], unused[2][2];
    scores<false>(qs, ks, nullptr, nullptr, ld, d, ty, tx, x, unused);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float sc[2], dsdx;
      bool kept[2];
      float mt = m[a];
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        kept[bb] = mask.keep(q0 + ty + 16 * a, k0 + tx + 16 * bb);
        sc[bb] = capped(x[a][bb], softcap, &dsdx);
        if (kept[bb]) mt = fmaxf(mt, sc[bb]);
      }
      float lt = l[a] * expf(m[a] - mt);
#pragma unroll
      for (int bb = 0; bb < 2; ++bb)
        if (kept[bb]) lt += expf(sc[bb] - mt);
      m[a] = mt;
      l[a] = lt;
    }
  }
  float lse[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float mm = m[a], ll = l[a];
#pragma unroll
    for (int off = 1; off < 16; off *= 2) {
      const float mo = __shfl_xor_sync(0xffffffffu, mm, off);
      const float lo = __shfl_xor_sync(0xffffffffu, ll, off);
      const float mn = fmaxf(mm, mo);
      ll = ll * expf(mm - mn) + lo * expf(mo - mn);
      mm = mn;
    }
    lse[a] = ll > 0.f ? mm + logf(ll) : 0.f;  // every row < S keeps a key
    const int row = ty + 16 * a;
    if (tx == 0) {
      lse_s[row] = lse[a];
      dsum_s[row] = dsum[a];
      if (q0 + row < s) {
        lse_out[row_base + q0 + row] = lse[a];
        dsum_out[row_base + q0 + row] = dsum[a];
      }
    }
  }

  // sweep 2: dq = scale sum_j dx[i, j] k[j]
  float4 acc[2][NJ];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the previous tile's accumulation is done with ks, dxs
    stage(ks, ld, kh, k0, s, d, 1.f);
    stage(vs, ld, vh, k0, s, d, 1.f);
    __syncthreads();
    float x[2][2], dp[2][2];
    scores<true>(qs, ks, dos, vs, ld, d, ty, tx, x, dp);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        float p, dx;
        grad_entry(mask.keep(q0 + ty + 16 * a, k0 + tx + 16 * bb), x[a][bb],
                   dp[a][bb], lse[a], dsum[a], softcap, &p, &dx);
        dxs[(tx + 16 * bb) * kLdS + ty + 16 * a] = dx;
      }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kT; ++key) {
      const float w0 = dxs[key * kLdS + ty], w1 = dxs[key * kLdS + ty + 16];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 4 * (tx + 16 * j);
        if (col < d) {
          const float4 kv = load4(ks + key * ld + col);
          fma4(acc[0][j], w0, kv);
          fma4(acc[1][j], w1, kv);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = ty + 16 * a;
    if (q0 + row >= s) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 4 * (tx + 16 * j);
      if (col < d) {
        const float4 g = acc[a][j];
        store4(dqh + (long long)(q0 + row) * d + col,
               make_float4(g.x * scale, g.y * scale, g.z * scale,
                           g.w * scale));
      }
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse_in,
                const float* __restrict__ dsum_in, T* __restrict__ dk,
                T* __restrict__ dv, int hq, int hkv, int s, int d, int causal,
                float softcap, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = d + 4;
  float* qs = smem;                // [kT][ld], q * scale
  float* dos = qs + kT * ld;       // [kT][ld]
  float* ks = dos + kT * ld;       // [kT][ld]
  float* vs = ks + kT * ld;        // [kT][ld]
  float* ps = vs + kT * ld;        // [kT][kLdS]: ps[q row][key]
  float* dxs = ps + kT * kLdS;     // [kT][kLdS]: dxs[q row][key]
  float* lse_s = dxs + kT * kLdS;  // [kT]
  float* dsum_s = lse_s + kT;      // [kT]

  const int nt = (s + kT - 1) / kT;
  const int kt = blockIdx.x;  // causal: the first key tiles see the most rows
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = hq / hkv;
  const long long head = (long long)s * d;
  const T* kh = k + ((long long)b * hkv + hk) * head;
  const T* vh = v + ((long long)b * hkv + hk) * head;
  T* dkh = dk + ((long long)b * hkv + hk) * head;
  T* dvh = dv + ((long long)b * hkv + hk) * head;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = kt * kT;
  const int qt_lo = causal ? k0 / kT : 0;
  const int qt_hi = window > 0 ? min(nt - 1, (k0 + kT + window - 2) / kT)
                               : nt - 1;
  const Mask mask{s, causal, window};

  stage(ks, ld, kh, k0, s, d, 1.f);
  stage(vs, ld, vh, k0, s, d, 1.f);

  float4 gk[2][NJ], gv[2][NJ];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      gk[a][j] = gv[a][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const T* qh = q + ((long long)b * hq + h) * head;
    const T* doh = dout + ((long long)b * hq + h) * head;
    const long long row_base = ((long long)b * hq + h) * s;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();  // the previous tile's accumulation is done
      stage(qs, ld, qh, q0, s, d, scale);
      stage(dos, ld, doh, q0, s, d, 1.f);
      if (tid < kT) {
        const bool in = q0 + tid < s;
        lse_s[tid] = in ? lse_in[row_base + q0 + tid] : 0.f;
        dsum_s[tid] = in ? dsum_in[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();
      float x[2][2], dp[2][2];
      scores<true>(qs, ks, dos, vs, ld, d, ty, tx, x, dp);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int row = ty + 16 * a;
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          float p, dx;
          grad_entry(mask.keep(q0 + row, k0 + tx + 16 * bb), x[a][bb],
                     dp[a][bb], lse_s[row], dsum_s[row], softcap, &p, &dx);
          ps[row * kLdS + tx + 16 * bb] = p;
          dxs[row * kLdS + tx + 16 * bb] = dx;
        }
      }
      __syncthreads();
      // keys ty, ty + 16: dv += p^T do, dk += dx^T (scale q)
#pragma unroll 4
      for (int i = 0; i < kT; ++i) {
        const float p0 = ps[i * kLdS + ty], p1 = ps[i * kLdS + ty + 16];
        const float x0 = dxs[i * kLdS + ty], x1 = dxs[i * kLdS + ty + 16];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = 4 * (tx + 16 * j);
          if (col < d) {
            const float4 ov = load4(dos + i * ld + col);
            const float4 qv = load4(qs + i * ld + col);
            fma4(gv[0][j], p0, ov);
            fma4(gv[1][j], p1, ov);
            fma4(gk[0][j], x0, qv);
            fma4(gk[1][j], x1, qv);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = ty + 16 * a;
    if (k0 + key >= s) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 4 * (tx + 16 * j);
      if (col < d) {
        store4(dkh + (long long)(k0 + key) * d + col, gk[a][j]);
        store4(dvh + (long long)(k0 + key) * d + col, gv[a][j]);
      }
    }
  }
}

template <typename T, int NJ>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           T* dq, T* dk, T* dv, float* lse, float* dsum, int b, int hq,
           int hkv, int s, int d, int causal, float softcap, int window,
           float scale, cudaStream_t stream) {
  auto dq_kernel = bwd_dq_kernel<T, NJ>;
  auto dkdv_kernel = bwd_dkdv_kernel<T, NJ>;
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int nt = (s + kT - 1) / kT;
  dq_kernel<<<dim3(nt, hq, b), kThreads, bytes, stream>>>(
      q, k, v, o, dout, dq, lse, dsum, hq, hkv, s, d, causal, softcap,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<<<dim3(nt, hkv, b), kThreads, bytes, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, hq, hkv, s, d, causal, softcap,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, const T* o, const T* dout,
             T* dq, T* dk, T* dv, float* lse, float* dsum, int b, int hq,
             int hkv, int s, int d, int causal, float softcap, int window,
             float scale, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > kMaxD || d % 4 != 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  switch ((d + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, dout, dq, dk, dv, lse, dsum, b,
                                hq, hkv, s, d, causal, softcap, window, scale,
                                stream);
    case 2: return launch<T, 2>(q, k, v, o, dout, dq, dk, dv, lse, dsum, b,
                                hq, hkv, s, d, causal, softcap, window, scale,
                                stream);
    case 3: return launch<T, 3>(q, k, v, o, dout, dq, dk, dv, lse, dsum, b,
                                hq, hkv, s, d, causal, softcap, window, scale,
                                stream);
    default: return launch<T, 4>(q, k, v, o, dout, dq, dk, dv, lse, dsum, b,
                                 hq, hkv, s, d, causal, softcap, window,
                                 scale, stream);
  }
}

}  // namespace

extern "C" {

// softcap <= 0 means none, window <= 0 means none; lse and dsum: [B, Hq, S]
// float32 scratch
int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                            const float* o, const float* dout, float* dq,
                            float* dk, float* dv, float* lse, float* dsum,
                            int b, int hq, int hkv, int s, int d, int causal,
                            float softcap, int window, float scale,
                            cudaStream_t stream) {
  return dispatch(q, k, v, o, dout, dq, dk, dv, lse, dsum, b, hq, hkv, s, d,
                  causal, softcap, window, scale, stream);
}

int flash_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, const __nv_bfloat16* o,
                             const __nv_bfloat16* dout, __nv_bfloat16* dq,
                             __nv_bfloat16* dk, __nv_bfloat16* dv, float* lse,
                             float* dsum, int b, int hq, int hkv, int s,
                             int d, int causal, float softcap, int window,
                             float scale, cudaStream_t stream) {
  return dispatch(q, k, v, o, dout, dq, dk, dv, lse, dsum, b, hq, hkv, s, d,
                  causal, softcap, window, scale, stream);
}

}  // extern "C"
