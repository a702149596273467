// Flash attention for Hopper on the tensor cores, bf16, forward only:
//
//   o[b, h, i] = sum_j softmax_j(s[i, j]) v[b, h / g, j],
//   s[i, j] = cap tanh((scale q[b, h, i] . k[b, h / g, j]) / cap)
//             where (j <= i if causal) and (j > i - window if windowed),
//             NEG_INF = -1e30 elsewhere,
//
// q [B, Hq, S, D], k and v [B, Hkv, S, D], contiguous bf16, 16-byte aligned;
// o [B, Hq, S, D] bf16; g = Hq / Hkv; D in {64, 128, 192, 256} (the head dims
// of every in-repo config).  It computes what csrc/flash_attention.cu
// computes, on the tensor cores instead of the CUDA cores; ops.py routes bf16
// at these head dims here and everything else to that kernel.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:92 (flash_attention_pallas),
// as flash_attention.cu does: one block owns one (b, h, 128-row q tile) and
// sweeps the kv tiles in a loop (the Pallas kernel's sequential kv grid axis
// carrying m, l, acc in VMEM), visiting the same range of tiles:
// kt_lo = max(0, q0 - window + 1) / BK to kt_hi = (q0 + BQ - 1) / BK if
// causal, else the last tile.  Blocks are issued longest sweep first.
//
// What bounds it on this card: operations.  4 D flops per unmasked (query,
// key) pair and head at the dense bf16 tensor-core rate (989e12 flop/s):
// 0.556 ms for one Gemma2-9B global layer at S = 8192 (16 heads, D = 256,
// causal), 0.417 ms for a local one (window 4096); the bytes (q, k, v, o)
// take 0.06 ms at 3.35 TB/s.
//
// Why P is split.  The textbook FlashAttention-2/3 kernel rounds the softmax
// numerator p = exp(s - m) to bf16 before P V.  That is a second rounding the
// plain version (float32 throughout, one rounding of o) does not make, and
// this repo holds bf16 outputs within one bf16 rounding of the plain
// version, 2^-7 |ref| + 1e-5 element by element (chip_smoke.py's
// FLASH_BF16_BAR).  Worst share of that bar (1 = at the bar):
//
//   P V computed with                  CPU emulation      this kernel, card
//                                      (S = 1024)         (Gemma2-9B, 8192)
//   P rounded to bf16 (textbook)       51                 64.9
//   p_hi = bf16(p), p_lo = bf16(p -    0.96               0.99
//     p_hi): two bf16 products summed
//     in float32
//
// (D = 256, softcap 50; the emulation is tests/test_torch_flash_numerics.py,
// the card's column scripts/flash_split_p.py, which builds this file with
// -DFLASH_SM90_PLAIN_P for the first row.)  p_hi + p_lo carries p to about
// 2^-16 relative.  The split costs one more P V product, half the tensor
// work again: a floor of 0.83 ms instead of 0.556 ms a global layer.
//
// Design:
//   * Block: 256 threads, two warpgroups of 64 q rows each, each running the
//     whole loop below on its own rows; the two overlap each other (one's
//     softmax runs while the other's wgmmas do).  There is no producer
//     warpgroup: registers are allocated per warpgroup, and ptxas compiles
//     code after setmaxnreg.inc within the launch's register count, so with
//     a third warpgroup (384 threads, 168 registers) the consumers spilled
//     their accumulators around every wgmma, which ptxas then serialised.
//     At 256 threads each thread may have 255; the kernel takes 220 at
//     D = 256 (o 128, S 32, P hi/lo 32) and spills nothing (chip_smoke.py's
//     build phase prints ptxas's report).
//   * Loads: TMA (cp.async.bulk.tensor) with 128-byte swizzle, boxes 64
//     columns (128 bytes) wide, from 3-D tensor maps [B H, S, D] built in the
//     launcher (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint, so no -lcuda) and passed as __grid_constant__.
//     Rows past S read as zeros (the maps' bounds), so any S works.  Q is
//     loaded once a block; K and V tiles of 64 keys go through a ring of two
//     stages guarded by full/empty mbarriers, K and V separately.  One
//     thread issues every load, refilling a stage once both warpgroups have
//     released it, after its own softmax (K) or P V (V), so the ring runs a
//     tile ahead.  Shared memory at D = 256: Q 64 KB, K and V 2 x 2 x 32 KB:
//     192 KB, one block an SM.
//   * S = Q K^T: wgmma m64n64k16, A = Q and B = the K tile, both K-major in
//     shared memory, D / 16 k-steps.  `scale` multiplies the float32 product
//     (not bf16 q).
//   * Softmax in the accumulator's register layout: a thread holds 2 rows x
//     16 keys; row maxima by shuffles within a quad, row sums kept per thread
//     and summed once at the end.  Scores are kept in log2 units (log2(e) is
//     folded into the scale, or into cap), so p = ex2.approx(z - m); the
//     softcap uses the accurate tanhf (1 / cap folded into the scale on the
//     host).  Masks are evaluated only on tiles that cross the diagonal, the
//     window's edge or S, as two compares a score against the row's first
//     and last kept key.  The finite -1e30 stays: a row whose first visited
//     keys are all masked takes p = ex2(0) = 1 for them and the first real
//     key erases them through alpha = ex2(-1e30 - m) = 0.  m, l and o in
//     float32; o = acc / (l > 0 ? l : 1), rounded to bf16; rows past S not
//     stored.
//   * O += P V: P is the register A operand (the float32 accumulator
//     fragments pack into bf16x2 A fragments without shuffles); B is the V
//     tile read MN-major (transposed) from shared memory, N = D.  Two wgmmas
//     a 16-key step, p_hi then p_lo, into the same o.
//   * Not kept, because trial builds of them were slower or no faster on
//     the card: issuing the next tile's S before this tile's softmax
//     (wait_group 1), with and without ping-pong turns of the two
//     warpgroups (each issues its wgmmas in its turn, then runs its
//     softmax under the other's); one consumer warpgroup beside a producer
//     warpgroup (setmaxnreg 24 / 240).
//
// Logsumexp: with a non-null `lse` the epilogue also writes each row's
// logsumexp, m + log2(l) in the kernel's log2 units, for the backward
// (flash_attention_bwd_sm90.cu), which then need not recompute it.  Every
// inference call passes null; the output is the same bits either way.
//
// The mbarrier, TMA, descriptor and wgmma wrappers are sm90.cuh's, shared
// with the backward.  A wait on an mbarrier that has not completed after
// 4 s traps (a "unspecified launch failure" the wrapper reports) instead
// of hanging.
//
// Launches are counted by the Python wrapper (ops.py).  Built by
// repro_torch/kernels/_build.py with nvcc (sm_90a) into the
// "flash_attention" library with a plain C interface; the launcher returns
// cudaGetLastError().  No --use_fast_math.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;     // q rows a block: two warpgroups of 64
constexpr int kBK = 64;      // keys a kv tile
constexpr int kStages = 2;   // K and V tiles in flight
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// mbarriers: Q full, then per stage K full, V full, K empty, V empty
constexpr int kQFull = 0, kKFull = 1, kVFull = 1 + kStages,
              kKEmpty = 1 + 2 * kStages, kVEmpty = 1 + 3 * kStages,
              kBars = 1 + 4 * kStages;

// Dynamic shared memory of one block, 1024-byte aligned regions: Q as D / 64
// chunks of [BQ rows][128 bytes], each K or V stage as D / 64 chunks of
// [BK rows][128 bytes], all 128-byte swizzled by TMA; then the mbarriers.
template <int D>
struct Layout {
  static constexpr int kChunks = D / 64;
  static constexpr int kQ = kBQ * D * 2;
  static constexpr int kTile = kBK * D * 2;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + alignment slack
};


// S = Q K^T of one kv tile: D / 16 k-steps; dq, dk the descriptors of the
// warpgroup's Q rows and of the K tile (chunk ks / 4, 16 columns = 32 bytes
// ks % 4; descriptors count addresses in 16-byte units)
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss_n64(sc, dq + ((ks / 4) * kBQ * 8 + (ks % 4) * 2),
                 dk + ((ks / 4) * kBK * 8 + (ks % 4) * 2), ks > 0);
}

// O += P V over the tile's 16-key steps, p_hi then p_lo (16 keys = 2048
// bytes of the V tile = 128 descriptor units)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&phi)[kBK / 16][4],
                                         const uint32_t (&plo)[kBK / 16][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    wgmma_pv<D>(acc, phi[kk], dv + kk * 128);
#ifndef FLASH_SM90_PLAIN_P
    wgmma_pv<D>(acc, plo[kk], dv + kk * 128);
#endif
  }
}

// The thread's part of the online softmax of one tile: sc[4 j + e] holds
// the product of row r0 + 8 (e / 2) and key k0 + c0 + 8 j + e % 2; it
// becomes the score z in log2 units (masked: -1e30), then p = 2^(z - m).
// m is the running row maximum (reduced over the quad); alpha the factor
// that rescales earlier terms, sum the thread's part of the row sums.
// Row r keeps keys klo[r] .. khi[r].
struct Softmax {
  bool capped;
  float zs, zc;  // z = zs * dot, or zc * tanh(zs * dot)
  int klo[2], khi[2];

  __device__ __forceinline__ void tile(float (&sc)[kBK / 2], float (&m)[2],
                                       float (&alpha)[2], float (&sum)[2],
                                       int kc, bool edge) const {
    // on a tile that needs them, the kept offsets 8 j + e % 2 of each row
    const int lo[2] = {klo[0] - kc, klo[1] - kc},
              hi[2] = {khi[0] - kc, khi[1] - kc};
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float z = capped ? zc * tanhf(zs * sc[4 * j + e])
                         : zs * sc[4 * j + e];
        if (edge) {
          const int x = 8 * j + (e & 1), r = e >> 1;
          z = (x >= lo[r] && x <= hi[r]) ? z : kNegInf;
        }
        sc[4 * j + e] = z;
        mx[e >> 1] = fmaxf(mx[e >> 1], z);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      sum[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const float p = ex2(sc[i] - m[(i >> 1) & 1]);
      sc[i] = p;
      sum[(i >> 1) & 1] += p;
    }
  }
};

// P as the A fragments of the 16-key steps (rows r0 / r0 + 8, keys
// 16 kk + c0 + {0, 1} and 16 kk + 8 + c0 + {0, 1}): p_hi = bf16(p) and
// p_lo = bf16(p - p_hi), packed in pairs
__device__ __forceinline__ void split_p(const float (&sc)[kBK / 2],
                                        uint32_t (&phi)[kBK / 16][4],
                                        uint32_t (&plo)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float a = sc[8 * kk + 2 * f], b = sc[8 * kk + 2 * f + 1];
      const uint32_t hi = bf16x2(a, b);
      phi[kk][f] = hi;
      plo[kk][f] = bf16x2(a - __uint_as_float(hi << 16),
                          b - __uint_as_float(hi & 0xffff0000u));
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int hq, int hkv,
                            int nbh, int s, int causal, int window,
                            int capped, float zs, float zc) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV,
                 bars = base + L::kBar;

  const int nq = (s + kBQ - 1) / kBQ;
  const int iq = nq - 1 - blockIdx.x / nbh;  // longest sweeps first
  const int bh = blockIdx.x % nbh;           // b * hq + h
  const int bhk = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = iq * kBQ;
  const int nk = (s + kBK - 1) / kBK;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int kt_hi = causal ? min(nk - 1, (q0 + kBQ - 1) / kBK) : nk - 1;
  const int ntiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bars + 8 * kQFull, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * (kKFull + st), 1);
      mbar_init(bars + 8 * (kVFull + st), 1);
      mbar_init(bars + 8 * (kKEmpty + st), 2);  // one arrival a warpgroup
      mbar_init(bars + 8 * (kVEmpty + st), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 issues every TMA load: Q and the first kStages K and V tiles
  // here, then tile j + kStages into the stage of tile j as soon as both
  // warpgroups have arrived on that stage's empty barrier (its
  // (j / kStages)-th phase): K after this thread's softmax of tile j, V
  // after its P V of tile j, so neither wait holds up a wgmma.
  const bool loader = threadIdx.x == 0;
  auto load = [&](const CUtensorMap* map, uint32_t dst, int full, int j) {
    const int st = j % kStages;
    mbar_expect_tx(bars + 8 * (full + st), L::kTile);
    for (int c = 0; c < L::kChunks; ++c)
      tma_load(dst + st * L::kTile + c * kBK * 128, map,
               bars + 8 * (full + st), c * 64, (kt_lo + j) * kBK, bhk);
  };
  auto refill = [&](const CUtensorMap* map, uint32_t dst, int full,
                    int empty, int j) {
    if (loader && j + kStages < ntiles) {
      mbar_wait(bars + 8 * (empty + j % kStages), (j / kStages) & 1);
      load(map, dst, full, j + kStages);
    }
  };
  if (loader) {
    mbar_expect_tx(bars + 8 * kQFull, L::kQ);
    for (int c = 0; c < L::kChunks; ++c)
      tma_load(sq + c * kBQ * 128, &tm_q, bars + 8 * kQFull, c * 64, q0, bh);
    for (int j = 0; j < kStages && j < ntiles; ++j) {
      load(&tm_k, sk, kKFull, j);
      load(&tm_v, sv, kVFull, j);
    }
  }

  // the warpgroup's 64 rows from row_a; the thread's rows r0 and r0 + 8,
  // its columns c0 and c0 + 1 of each group of 8
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int row_a = q0 + 64 * wg;
  const int r0 = row_a + 16 * (tid / 32) + (tid % 32) / 4;
  const int c0 = 2 * (tid % 4);
  Softmax sm{capped != 0, zs, zc, {}, {}};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    sm.klo[r] = window > 0 ? row - window + 1 : 0;
    sm.khi[r] = causal ? min(row, s - 1) : s - 1;
  }
  // some (row, key) of the warpgroup's tile at k0 is masked
  auto edge = [&](int k0) {
    return k0 + kBK > s || (causal && k0 + kBK - 1 > row_a) ||
           (window > 0 && k0 <= row_a + 63 - window);
  };
  const uint32_t qa = sq + wg * 64 * 128;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float sc[kBK / 2], alpha[2], sum[2];
  uint32_t phi[kBK / 16][4], plo[kBK / 16][4];
  mbar_wait(bars + 8 * kQFull, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int k0 = (kt_lo + i) * kBK;
    // S = Q K^T
    mbar_wait(bars + 8 * (kKFull + st), ph);
    fence_regs(sc);
    wgmma_fence();
    issue_qk<D>(sc, opaque(desc_kmajor(qa)),
                opaque(desc_kmajor(sk + st * L::kTile)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    if (tid == 0) mbar_arrive(bars + 8 * (kKEmpty + st));
    // softmax, rescale, P
    sm.tile(sc, m, alpha, sum, k0 + c0, edge(k0));
    refill(&tm_k, sk, kKFull, kKEmpty, i);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
    split_p(sc, phi, plo);
    // O += P V
    mbar_wait(bars + 8 * (kVFull + st), ph);
    fence_regs(acc);
    fence_regs(phi);
    fence_regs(plo);
    wgmma_fence();
    issue_pv<D>(acc, phi, plo,
                opaque(desc_mnmajor(sv + st * L::kTile, kBK * 128)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(phi);
    fence_regs(plo);
    if (tid == 0) mbar_arrive(bars + 8 * (kVEmpty + st));
    refill(&tm_v, sv, kVFull, kVEmpty, i);
  }

  // epilogue: o = acc / l (l > 0, else 1), as acc times the reciprocal
  // (rcp.approx and one Newton step: within an ulp of float32, and no
  // division's slow-path call while D / 2 accumulators are live); rows
  // past S not stored
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float den = l[r] > 0.f ? l[r] : 1.f;
    float x;
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(x) : "f"(den));
    inv[r] = fmaf(x, fmaf(-den, x, 1.f), x);
  }
  // the rows' logsumexp for the backward, in the kernel's log2 units:
  // lse[row] = m + log2(l) = log2 sum_j 2^z[j] = (natural logsumexp of the
  // scores) * log2(e); one thread of the quad writes, rows past S not
  // stored.  Every row below S keeps a key, so l > 0 there
  if (lse != nullptr && (tid & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < s) lse[(long long)bh * s + row] = m[r] + log2f(l[r]);
    }
  }
  __nv_bfloat16* oh = o + (long long)bh * s * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(oh + (long long)row * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      dst[(8 * j + c0) / 2] = bf16x2(acc[4 * j + 2 * r] * inv[r],
                                     acc[4 * j + 2 * r + 1] * inv[r]);
  }
}

// ---- host side ----


template <int D>
constexpr int smem_bytes() {
  return Layout<D>::kBytes;
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int b,
           int hq, int hkv, int s, int causal, float softcap, int window,
           float scale, cudaStream_t stream) {
  // a runtime call first: it makes the device's context current on this
  // thread (autograd may run a recomputed forward on a thread of its own),
  // which cuTensorMapEncodeTiled (libcuda, below) needs
  auto kernel = flash_attention_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (err != cudaSuccess) return (int)err;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(encode, &tq, q, D, s, b * hq, kBQ) ||
      !tensor_map(encode, &tk, k, D, s, b * hkv, kBK) ||
      !tensor_map(encode, &tv, v, D, s, b * hkv, kBK))
    return (int)cudaErrorInvalidValue;
  // scores in log2 units: z = zs (q . k), or zc tanh(zs (q . k)) with the
  // softcap
  const int capped = softcap > 0.f;
  const float zs = capped ? scale / softcap : scale * kLog2e;
  const float zc = softcap * kLog2e;
  const int nbh = b * hq;
  const int blocks = (s + kBQ - 1) / kBQ * nbh;
  kernel<<<blocks, kThreads, smem_bytes<D>(), stream>>>(
      tq, tk, tv, o, lse, hq, hkv, nbh, s, causal, window, capped, zs, zc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dynamic shared memory of one block for head dim d, in bytes (0: not taken)
long long flash_attention_sm90_smem_bytes(int d) {
  switch (d) {
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    case 192: return smem_bytes<192>();
    case 256: return smem_bytes<256>();
    default: return 0;
  }
}

// softcap <= 0 means none, window <= 0 means none; lse: null, or [B, Hq, S]
// float32 that receives each row's logsumexp in log2 units (the backward's
// input); the output's bits do not depend on it
int flash_attention_bf16_sm90(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, __nv_bfloat16* o,
                              float* lse, int b, int hq, int hkv, int s,
                              int d, int causal, float softcap, int window,
                              float scale, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64: return launch<64>(q, k, v, o, lse, b, hq, hkv, s, causal,
                               softcap, window, scale, stream);
    case 128: return launch<128>(q, k, v, o, lse, b, hq, hkv, s, causal,
                                 softcap, window, scale, stream);
    case 192: return launch<192>(q, k, v, o, lse, b, hq, hkv, s, causal,
                                 softcap, window, scale, stream);
    case 256: return launch<256>(q, k, v, o, lse, b, hq, hkv, s, causal,
                                 softcap, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
