// Backward of flash_attention_sm90.cu on the tensor cores, bf16: dq, dk, dv
// of the same function as flash_attention_bwd.cu,
//
//   o[b, h, i] = sum_j p[i, j] v[b, h / g, j],   p[i, j] = softmax_j(s[i, j]),
//   s[i, j] = cap tanh(x[i, j] / cap),   x[i, j] = (scale q[b, h, i]) . k[b, h / g, j]
//             where (j <= i if causal) and (j > i - window if windowed);
//             masked pairs take no part,
//
//   dv[j] = sum_i p[i, j] do[i]          (summed over the g q heads of j's
//   dk[j] = scale sum_i dx[i, j] q[i]     kv head too)
//   dq[i] = scale sum_j dx[i, j] k[j]
//   dx[i, j] = p[i, j] (do[i] . v[j] - Dsum[i]) (1 - tanh^2(x[i, j] / cap)),
//   Dsum[i] = do[i] . o[i],
//
// q, o, do, dq [B, Hq, S, D]; k, v, dk, dv [B, Hkv, S, D]; contiguous bf16,
// 16-byte aligned; D in {64, 128}.  lse [B, Hq, S] float32 is the forward's
// (flash_attention_sm90.cu with its lse pointer set): each row's
// logsumexp in log2 units, log2 sum_j 2^z[j] with z = s log2(e), so here
// p = 2^(z - lse) with the forward's own z.  ops.py routes bf16 at these
// head dims here and everything else to flash_attention_bwd.cu.
//
// No Pallas counterpart: the JAX package never differentiates its Pallas
// kernel (src/repro/kernels/flash_attention/kernel.py:92 defines no VJP);
// its train paths take XLA autodiff through ref.attention_ref
// (src/repro/kernels/flash_attention/ref.py:13).  This kernel computes that
// gradient; the port's oracle is autograd through ref.attention_backward_ref.
//
// What bounds it on this card: operations.  It does 14 D flops an unmasked
// (query, key) pair and head: 6 D in the dq pass (S = Q K^T, dP = dO V^T,
// dQ += dS K) and 8 D in the dk/dv pass (S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO, dK += dS^T Q), all on the tensor cores: 0.106 ms a
// qwen2-0.5b train layer (B = 4, 14/2 heads, S = 2048, D = 64, causal) at
// the dense bf16 rate (989e12 flop/s).  The bytes (q, k, v, o, do, lse in;
// dq, dk, dv out; the float32 per-head partials of dk and dv, 58.7 MB
// written and read at that layer) take about 0.05 ms at 3.35 TB/s.
//
// Deterministic: no floating-point atomics, every sum in a fixed order, so
// the same inputs give the same bits (a restart from a checkpoint repeats
// its steps bit for bit).  Three kernels on the caller's stream:
//
//   1. dq pass: one block a (b, h, 128-row q tile), two warpgroups of 64
//      rows, longest kv sweep first.  Its prologue computes Dsum = do . o
//      and copies the forward's lse into a scratch of (lse, Dsum) pairs
//      [B Hq, S rounded up to 128] (zeros past S).  Over the 64-key tiles
//      the tile sees (the forward's kt_lo .. kt_hi): S = Q K^T and
//      dP = dO V^T (SS wgmma, A and B K-major), then dS = P (dP - Dsum)
//      (times 1 - tanh^2 under a softcap) in the accumulator's registers,
//      rounded to bf16 as the register A operand, then dQ += dS K (RS
//      wgmma, K read MN-major as the forward reads V).  dq = scale dQ.
//   2. dk/dv pass: one block a (b, q head h, 128-key tile), two warpgroups
//      of 64 keys; K and V loaded once, then the 64-row q tiles that see
//      the keys (qt_lo .. qt_hi) through a ring of Q, dO and their (lse,
//      Dsum) rows.  S^T = K Q^T and dP^T = V dO^T (SS) put P^T and dS^T in
//      the accumulator layout that wgmma takes as its register A operand,
//      so dV += P^T dO and dK += dS^T Q are RS wgmmas with B (dO, Q)
//      MN-major.  With g = 1 the block stores dk, dv in bf16; with g > 1
//      it stores its head's float32 partials [B, Hq, S, D].
//   3. g > 1 only: dk, dv = the sums of the g partials of each kv head, in
//      head order, rounded to bf16.
//
// Why a block per q head in the dk/dv pass.  A block per (b, kv head, key
// tile) that loops over the group's g heads is 16 x 2 x 4 = 128 blocks at
// the qwen2 layer (132 SMs), and under the causal mask the first key
// tile's block walks 16 q tiles of 128 rows a head against a mean of 8.5:
// the pass lasts as long as its longest block, about 1.9 times the mean.
// A block per q head is 896 blocks, issued longest first, which the card's
// block scheduler packs; the price is the partials' float32 traffic and
// the small third kernel.  Measured on an H100 80GB HBM3 at 700 W, in
// turns with the looping design while it was still a build option of this
// file (scripts/flash_bwd_ab.py then built both): at the qwen2 layer the
// looping dk/dv pass took 0.370 ms, this one 0.180 ms plus 0.024 ms of
// group sums (2.06x: the imbalance), the whole backward 0.581 against
// 0.409 ms; at B = 1 (32 looping blocks) 0.426 against 0.114 ms; at D =
// 128 (GQA 2:1, S = 4096) 0.43-0.47 against 0.30-0.33 ms.  It lost at
// every shape and was taken out.
//
// Numerics.  Products are bf16 operands summed exactly in float32: q, k,
// v, do are bf16 already; P (for dV) and dS (for dQ and dK) are rounded to
// bf16 once, as in the textbook FlashAttention-2/3 backward.  The bar is
// 2e-2 of each gradient's largest magnitude (chip_smoke.py's
// FLASH_BWD_TOL), not the forward's one-rounding one;
// tests/test_torch_flash_bwd_sm90.py emulates these roundings on the CPU
// and records the worst share of that bar (at most 0.5 keeps them; above
// it P and dS would be split hi + lo as the forward splits P): 0.33 at
// its worst case (GQA 3:1, S = 77, window 5), 0.26 at a qwen2-0.5b head
// group (S = 2048); on the card (chip_smoke.py) 0.31 at the qwen2 layer.
// Scores, masks, ex2 and the softcap's tanhf are the forward's, in log2
// units.
//
// Design, as the forward: 256 threads, two consumer warpgroups, thread 0
// issuing every TMA load (128-byte swizzle, boxes 64 columns wide, rows
// past S read as zeros); K/V (dq pass) and Q/dO (dk/dv pass) tiles through
// a two-stage ring of full/empty mbarriers; each product group committed
// and waited before its registers are read.  The sm90.cuh wrappers are the
// forward's.  A wait on an mbarrier traps after 4 s instead of hanging.
//
// Launches are counted by the Python wrapper (ops.py, LAUNCHES_BY_KERNEL
// "bwd_sm90"), once a backward.  Built by repro_torch/kernels/_build.py with
// nvcc (sm_90a) into the "flash_attention" library with a plain C
// interface; the launcher returns cudaGetLastError().  No --use_fast_math.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;

// dq pass: q rows a block, keys a kv tile
constexpr int kQRows = 128;
constexpr int kQKeys = 64;
// dk/dv pass: keys a block, q rows a q tile
constexpr int kKRows = 128;
constexpr int kKQ = 64;

// the scratch of (lse, Dsum) rows: [B Hq, s_pad] float2, s_pad = S rounded
// up to kQRows (ops.py allocates it with the same rounding)
__host__ __device__ constexpr int s_pad(int s) {
  return (s + kQRows - 1) / kQRows * kQRows;
}

// S = A B^T over D / 16 k-steps, A [64 rows x D] and B [64 rows x D] both
// K-major (TMA's [rows][128 bytes] chunks, `arows` / `brows` rows a chunk)
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint64_t da,
                                         uint64_t db, int arows, int brows) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss_n64(acc, da + ((ks / 4) * arows * 8 + (ks % 4) * 2),
                 db + ((ks / 4) * brows * 8 + (ks % 4) * 2), ks > 0);
}

// acc += A B over 64 rows of B in 16-row k-steps: A the register fragments,
// B [64 rows x D] read MN-major (16 rows = 2048 bytes = 128 units)
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(acc, a[kk], db + kk * 128);
}

// The per-element gradient of one 64 x 64 tile in the accumulator layout:
// sc[4 j + e] holds the product of row 16 (tid / 32) + (tid % 32) / 4 +
// 8 (e / 2) and column c0 + 8 j + e % 2.  `sc` (the score products x /
// scale) becomes p, `dp` becomes dx = p (dp - Dsum) (1 - t^2); `kept(j, e)`
// says whether the pair is unmasked (only asked on edge tiles), lse and
// dsum(j, e) give the q row's.
struct Grad {
  bool capped;
  float zs, zc;  // z = zs * x, or zc * tanh(zs * x), in log2 units

  template <class Kept, class Row>
  __device__ __forceinline__ void tile(float (&sc)[32], float (&dp)[32],
                                       bool edge, Kept kept, Row row) const {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float z, dsdx = 1.f;
        if (capped) {
          const float t = tanhf(zs * sc[i]);
          z = zc * t;
          dsdx = 1.f - t * t;
        } else {
          z = zs * sc[i];
        }
        if (edge && !kept(j, e)) z = kNegInf;
        float lse, dsum;
        row(j, e, lse, dsum);
        const float p = ex2(z - lse);  // 0 where masked (ftz)
        sc[i] = p;
        dp[i] = p * (dp[i] - dsum) * dsdx;
      }
  }
};

// a 64 x 64 accumulator tile as the four m64k16 A fragments of bf16 pairs
// (rows r / r + 8, columns 16 kk + c0 + {0, 1} and 16 kk + 8 + c0 + {0, 1})
__device__ __forceinline__ void pack(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      a[kk][f] = bf16x2(x[8 * kk + 2 * f], x[8 * kk + 2 * f + 1]);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// ---- 1. the dq pass ----

// mbarriers: Q and dO full, then per stage K full, V full, K empty, V empty
constexpr int kDqQFull = 0, kDqKFull = 1, kDqVFull = 1 + kStages,
              kDqKEmpty = 1 + 2 * kStages, kDqVEmpty = 1 + 3 * kStages,
              kDqBars = 1 + 4 * kStages;

// Q and dO as D / 64 chunks of [128 rows][128 bytes], each K or V stage as
// D / 64 chunks of [64 rows][128 bytes]; the block's (lse, Dsum) rows; the
// mbarriers
template <int D>
struct DqLayout {
  static constexpr int kChunks = D / 64;
  static constexpr int kQ = kQRows * D * 2;
  static constexpr int kTile = kQKeys * D * 2;
  static constexpr int kDo = kQ;
  static constexpr int kK = 2 * kQ;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kRows = kV + kStages * kTile;
  static constexpr int kBar = kRows + kQRows * 8;
  static constexpr int kBytes = kBar + 8 * kDqBars + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_sm90_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse_in,
                   float2* __restrict__ rows_out,
                   __nv_bfloat16* __restrict__ dq, int hq, int hkv, int nbh,
                   int s, int causal, int window, int capped, float zs,
                   float zc, float scale) {
  using L = DqLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sdo = base + L::kDo, sk = base + L::kK,
                 sv = base + L::kV, bars = base + L::kBar;
  float2* rows_s = reinterpret_cast<float2*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::kRows);

  const int nq = (s + kQRows - 1) / kQRows;
  const int iq = nq - 1 - blockIdx.x / nbh;  // longest sweeps first
  const int bh = blockIdx.x % nbh;           // b * hq + h
  const int bhk = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = iq * kQRows;
  const int nk = (s + kQKeys - 1) / kQKeys;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kQKeys : 0;
  const int kt_hi = causal ? min(nk - 1, (q0 + kQRows - 1) / kQKeys) : nk - 1;
  const int ntiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bars + 8 * kDqQFull, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * (kDqKFull + st), 1);
      mbar_init(bars + 8 * (kDqVFull + st), 1);
      mbar_init(bars + 8 * (kDqKEmpty + st), 2);  // one arrival a warpgroup
      mbar_init(bars + 8 * (kDqVEmpty + st), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every load: Q and dO, the first kStages K and V tiles,
  // then tile j + kStages into tile j's stage once both warpgroups are done
  // with it (V after dP, K after dQ)
  const bool loader = threadIdx.x == 0;
  auto load = [&](const CUtensorMap* map, uint32_t dst, int full, int j) {
    const int st = j % kStages;
    mbar_expect_tx(bars + 8 * (full + st), L::kTile);
    for (int c = 0; c < L::kChunks; ++c)
      tma_load(dst + st * L::kTile + c * kQKeys * 128, map,
               bars + 8 * (full + st), c * 64, (kt_lo + j) * kQKeys, bhk);
  };
  auto refill = [&](const CUtensorMap* map, uint32_t dst, int full,
                    int empty, int j) {
    if (loader && j + kStages < ntiles) {
      mbar_wait(bars + 8 * (empty + j % kStages), (j / kStages) & 1);
      load(map, dst, full, j + kStages);
    }
  };
  if (loader) {
    mbar_expect_tx(bars + 8 * kDqQFull, 2 * L::kQ);
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load(sq + c * kQRows * 128, &tm_q, bars + 8 * kDqQFull, c * 64, q0,
               bh);
      tma_load(sdo + c * kQRows * 128, &tm_do, bars + 8 * kDqQFull, c * 64,
               q0, bh);
    }
    for (int j = 0; j < kStages && j < ntiles; ++j) {
      load(&tm_k, sk, kDqKFull, j);
      load(&tm_v, sv, kDqVFull, j);
    }
  }

  // prologue, while the loads fly: Dsum = do . o of the block's 128 rows,
  // two threads a row (D / 2 columns each, 16-byte loads), and the
  // forward's lse beside it, into shared memory and the scratch (zeros
  // past S)
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = q0 + r;
    float acc = 0.f, l2 = 0.f;
    if (row < s) {
      const long long off = ((long long)bh * s + row) * D + half * (D / 2);
      const uint4* ov = reinterpret_cast<const uint4*>(o + off);
      const uint4* dv = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 a = ov[c], b = dv[c];
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w},
                       bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int w = 0; w < 4; ++w)
          acc += bf16_lo(aw[w]) * bf16_lo(bw[w]) +
                 bf16_hi(aw[w]) * bf16_hi(bw[w]);
      }
      l2 = lse_in[(long long)bh * s + row];
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const float2 pair = make_float2(l2, acc);
      rows_s[r] = pair;
      rows_out[(long long)bh * s_pad(s) + row] = pair;
    }
  }
  __syncthreads();

  // the warpgroup's 64 rows from row_a; the thread's rows r0 and r0 + 8,
  // its columns c0 and c0 + 1 of each group of 8
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int row_a = q0 + 64 * wg;
  const int r0 = row_a + 16 * (tid / 32) + (tid % 32) / 4;
  const int c0 = 2 * (tid % 4);
  float lse[2], dsum[2];
  int klo[2], khi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const float2 pair = rows_s[row - q0];
    lse[r] = pair.x;
    dsum[r] = pair.y;
    // row keeps keys klo .. khi (none past S)
    klo[r] = window > 0 ? row - window + 1 : 0;
    khi[r] = row >= s ? -1 : causal ? min(row, s - 1) : s - 1;
  }
  // some (row, key) of the warpgroup's tile at k0 is masked
  auto edge = [&](int k0) {
    return k0 + kQKeys > s || row_a + 63 >= s ||
           (causal && k0 + kQKeys - 1 > row_a) ||
           (window > 0 && k0 <= row_a + 63 - window);
  };
  const Grad grad{capped != 0, zs, zc};
  const uint32_t qa = sq + wg * 64 * 128, doa = sdo + wg * 64 * 128;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t ds[4][4];
  mbar_wait(bars + 8 * kDqQFull, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int k0 = (kt_lo + i) * kQKeys;
    // S = Q K^T, dP = dO V^T
    mbar_wait(bars + 8 * (kDqKFull + st), ph);
    mbar_wait(bars + 8 * (kDqVFull + st), ph);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    issue_ss<D>(sc, opaque(desc_kmajor(qa)),
                opaque(desc_kmajor(sk + st * L::kTile)), kQRows, kQKeys);
    issue_ss<D>(dp, opaque(desc_kmajor(doa)),
                opaque(desc_kmajor(sv + st * L::kTile)), kQRows, kQKeys);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    if (tid == 0) mbar_arrive(bars + 8 * (kDqVEmpty + st));
    refill(&tm_v, sv, kDqVFull, kDqVEmpty, i);
    // dS, rounded to bf16
    const int kc = k0 + c0;
    grad.tile(
        sc, dp, edge(k0),
        [&](int j, int e) {
          const int key = kc + 8 * j + (e & 1), r = e >> 1;
          return key >= klo[r] && key <= khi[r];
        },
        [&](int, int e, float& l, float& d) {
          l = lse[e >> 1];
          d = dsum[e >> 1];
        });
    pack(dp, ds);
    // dQ += dS K
    fence_regs(acc);
    fence_regs(ds);
    wgmma_fence();
    issue_rs<D>(acc, ds,
                opaque(desc_mnmajor(sk + st * L::kTile, kQKeys * 128)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ds);
    if (tid == 0) mbar_arrive(bars + 8 * (kDqKEmpty + st));
    refill(&tm_k, sk, kDqKFull, kDqKEmpty, i);
  }

  // dq = scale dQ, rows past S not stored
  __nv_bfloat16* dqh = dq + (long long)bh * s * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(dqh + (long long)row * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      dst[(8 * j + c0) / 2] = bf16x2(acc[4 * j + 2 * r] * scale,
                                     acc[4 * j + 2 * r + 1] * scale);
  }
}

// ---- 2. the dk/dv pass ----

// mbarriers: K and V full, then per stage (Q, dO, rows) full and empty
constexpr int kKvFull = 0, kKvTileFull = 1, kKvTileEmpty = 1 + kStages,
              kKvBars = 1 + 2 * kStages;
constexpr int kRowBytes = kKQ * 8;  // a q tile's (lse, Dsum) rows

// K and V as D / 64 chunks of [128 rows][128 bytes], each Q or dO stage as
// D / 64 chunks of [64 rows][128 bytes], each stage's rows; the mbarriers
template <int D>
struct KvLayout {
  static constexpr int kChunks = D / 64;
  static constexpr int kKV = kKRows * D * 2;
  static constexpr int kTile = kKQ * D * 2;
  static constexpr int kV = kKV;
  static constexpr int kQ = 2 * kKV;
  static constexpr int kDo = kQ + kStages * kTile;
  static constexpr int kRows = kDo + kStages * kTile;
  static constexpr int kBar = kRows + kStages * kRowBytes;
  static constexpr int kBytes = kBar + 8 * kKvBars + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_sm90_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float2* __restrict__ rows_in,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     float* __restrict__ part_k, float* __restrict__ part_v,
                     int hq, int hkv, int nhb, int s, int causal, int window,
                     int capped, float zs, float zc, float scale) {
  using L = KvLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = base, sv = base + L::kV, sq = base + L::kQ,
                 sdo = base + L::kDo, srows = base + L::kRows,
                 bars = base + L::kBar;
  const uint8_t* rows_s = smem_raw + (base - smem_u32(smem_raw)) + L::kRows;

  const int kt = blockIdx.x / nhb;  // causal: the first key tiles see most
  const int bh = blockIdx.x % nhb;  // b * hq + h
  const int bhk = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int k0 = kt * kKRows;
  const int nqt = (s + kKQ - 1) / kKQ;
  const int qt_lo = causal ? k0 / kKQ : 0;
  const int qt_hi =
      window > 0 ? min(nqt - 1, (k0 + kKRows + window - 2) / kKQ) : nqt - 1;
  const int ntiles = qt_hi - qt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bars + 8 * kKvFull, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * (kKvTileFull + st), 1);
      mbar_init(bars + 8 * (kKvTileEmpty + st), 2);  // one a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const bool loader = threadIdx.x == 0;
  auto load = [&](int j) {
    const int st = j % kStages, q0 = (qt_lo + j) * kKQ;
    const uint32_t bar = bars + 8 * (kKvTileFull + st);
    mbar_expect_tx(bar, 2 * L::kTile + kRowBytes);
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load(sq + st * L::kTile + c * kKQ * 128, &tm_q, bar, c * 64, q0,
               bh);
      tma_load(sdo + st * L::kTile + c * kKQ * 128, &tm_do, bar, c * 64, q0,
               bh);
    }
    bulk_load(srows + st * kRowBytes,
              rows_in + (long long)bh * s_pad(s) + q0, kRowBytes, bar);
  };
  if (loader) {
    mbar_expect_tx(bars + 8 * kKvFull, 2 * L::kKV);
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load(sk + c * kKRows * 128, &tm_k, bars + 8 * kKvFull, c * 64, k0,
               bhk);
      tma_load(sv + c * kKRows * 128, &tm_v, bars + 8 * kKvFull, c * 64, k0,
               bhk);
    }
    for (int j = 0; j < kStages && j < ntiles; ++j) load(j);
  }

  // the warpgroup's 64 keys from key_a; the thread's keys r0 and r0 + 8,
  // its q columns c0 and c0 + 1 of each group of 8
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int key_a = k0 + 64 * wg;
  const int r0 = key_a + 16 * (tid / 32) + (tid % 32) / 4;
  const int c0 = 2 * (tid % 4);
  int qlo[2], qhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + 8 * r;
    // key is seen by q rows qlo .. qhi (none if it lies past S)
    qlo[r] = causal ? key : 0;
    qhi[r] = key >= s ? -1 : window > 0 ? min(s - 1, key + window - 1)
                                        : s - 1;
  }
  // some (key, q row) of the warpgroup's tile at q0 is masked
  auto edge = [&](int q0) {
    return q0 + kKQ > s || key_a + 63 >= s ||
           (causal && q0 < key_a + 63) ||
           (window > 0 && q0 + kKQ - 1 - key_a >= window);
  };
  const Grad grad{capped != 0, zs, zc};
  const uint32_t ka = sk + wg * 64 * 128, va = sv + wg * 64 * 128;

  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;
  float sc[32], dp[32];
  uint32_t pt[4][4], dst[4][4];
  mbar_wait(bars + 8 * kKvFull, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int q0 = (qt_lo + i) * kKQ;
    // S^T = K Q^T, dP^T = V dO^T
    mbar_wait(bars + 8 * (kKvTileFull + st), ph);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    issue_ss<D>(sc, opaque(desc_kmajor(ka)),
                opaque(desc_kmajor(sq + st * L::kTile)), kKRows, kKQ);
    issue_ss<D>(dp, opaque(desc_kmajor(va)),
                opaque(desc_kmajor(sdo + st * L::kTile)), kKRows, kKQ);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    // P^T and dS^T, rounded to bf16; a column's (lse, Dsum) pair with its
    // neighbour's in one 16-byte load
    const float4* rows4 =
        reinterpret_cast<const float4*>(rows_s + st * kRowBytes);
    const int qc = q0 + c0;
    grad.tile(
        sc, dp, edge(q0),
        [&](int j, int e) {
          const int qrow = qc + 8 * j + (e & 1), r = e >> 1;
          return qrow >= qlo[r] && qrow <= qhi[r];
        },
        [&](int j, int e, float& l, float& d) {
          const float4 pair = rows4[(c0 + 8 * j) / 2];
          l = (e & 1) ? pair.z : pair.x;
          d = (e & 1) ? pair.w : pair.y;
        });
    pack(sc, pt);
    pack(dp, dst);
    // dV += P^T dO, dK += dS^T Q
    fence_regs(gv);
    fence_regs(gk);
    fence_regs(pt);
    fence_regs(dst);
    wgmma_fence();
    issue_rs<D>(gv, pt, opaque(desc_mnmajor(sdo + st * L::kTile, kKQ * 128)));
    issue_rs<D>(gk, dst, opaque(desc_mnmajor(sq + st * L::kTile, kKQ * 128)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(gv);
    fence_regs(gk);
    fence_regs(pt);
    fence_regs(dst);
    if (tid == 0) mbar_arrive(bars + 8 * (kKvTileEmpty + st));
    if (loader && i + kStages < ntiles) {
      mbar_wait(bars + 8 * (kKvTileEmpty + st), ph);
      load(i + kStages);
    }
  }

  // dk = scale dK, dv = dV: bf16 into dk, dv when g = 1, else float32
  // into its q head's partials; keys past S not stored
  const long long head = (long long)s * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + 8 * r;
    if (key >= s) continue;
    if (part_k == nullptr) {
      uint32_t* ok = reinterpret_cast<uint32_t*>(dk + bhk * head +
                                                 (long long)key * D);
      uint32_t* ov = reinterpret_cast<uint32_t*>(dv + bhk * head +
                                                 (long long)key * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        ok[(8 * j + c0) / 2] = bf16x2(gk[4 * j + 2 * r] * scale,
                                      gk[4 * j + 2 * r + 1] * scale);
        ov[(8 * j + c0) / 2] = bf16x2(gv[4 * j + 2 * r],
                                      gv[4 * j + 2 * r + 1]);
      }
    } else {
      float2* ok = reinterpret_cast<float2*>(part_k + bh * head +
                                             (long long)key * D);
      float2* ov = reinterpret_cast<float2*>(part_v + bh * head +
                                             (long long)key * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        ok[(8 * j + c0) / 2] = make_float2(gk[4 * j + 2 * r] * scale,
                                           gk[4 * j + 2 * r + 1] * scale);
        ov[(8 * j + c0) / 2] = make_float2(gv[4 * j + 2 * r],
                                           gv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---- 3. the group sums (g > 1) ----

// out[b, hk] = bf16(sum over hh < g of part[b, hk g + hh]) for dk and dv,
// four elements a thread, heads in order
__global__ void __launch_bounds__(kThreads)
bwd_sm90_sum_kernel(const float4* __restrict__ part_k,
                    const float4* __restrict__ part_v,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int g, long long head4,
                    long long n4) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n4) return;
  const long long bhk = e / head4, off = e - bhk * head4;
  const long long first = bhk * g * head4 + off;
  float4 a = part_k[first], b = part_v[first];
  for (int hh = 1; hh < g; ++hh) {
    const float4 x = part_k[first + hh * head4],
                 y = part_v[first + hh * head4];
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
  }
  reinterpret_cast<uint2*>(dk)[e] = make_uint2(bf16x2(a.x, a.y),
                                               bf16x2(a.z, a.w));
  reinterpret_cast<uint2*>(dv)[e] = make_uint2(bf16x2(b.x, b.y),
                                               bf16x2(b.z, b.w));
}

// ---- host side ----

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, const __nv_bfloat16* o,
           const __nv_bfloat16* dout, const float* lse, __nv_bfloat16* dq,
           __nv_bfloat16* dk, __nv_bfloat16* dv, float2* rows, float* part,
           int b, int hq, int hkv, int s, int causal, float softcap,
           int window, float scale, cudaStream_t stream) {
  auto dq_kernel = bwd_sm90_dq_kernel<D>;
  auto kv_kernel = bwd_sm90_dkdv_kernel<D>;
  // runtime calls first: they make the device's context current on this
  // thread (autograd runs the backward on a thread of its own), which
  // cuTensorMapEncodeTiled (libcuda, below) needs
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqLayout<D>::kBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KvLayout<D>::kBytes);
  if (err != cudaSuccess) return (int)err;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // the dq pass reads Q, dO in 128-row boxes and K, V in 64-row ones; the
  // dk/dv pass the other way round
  CUtensorMap q128, do128, k64, v64, q64, do64, k128, v128;
  if (!tensor_map(encode, &q128, q, D, s, b * hq, kQRows) ||
      !tensor_map(encode, &do128, dout, D, s, b * hq, kQRows) ||
      !tensor_map(encode, &k64, k, D, s, b * hkv, kQKeys) ||
      !tensor_map(encode, &v64, v, D, s, b * hkv, kQKeys) ||
      !tensor_map(encode, &q64, q, D, s, b * hq, kKQ) ||
      !tensor_map(encode, &do64, dout, D, s, b * hq, kKQ) ||
      !tensor_map(encode, &k128, k, D, s, b * hkv, kKRows) ||
      !tensor_map(encode, &v128, v, D, s, b * hkv, kKRows))
    return (int)cudaErrorInvalidValue;
  // scores in log2 units, as the forward's
  const int capped = softcap > 0.f;
  const float zs = capped ? scale / softcap : scale * kLog2e;
  const float zc = softcap * kLog2e;
  const int nbh = b * hq, g = hq / hkv;
  const long long n = (long long)b * hq * s * D;
  float* part_k = g > 1 ? part : nullptr;
  float* part_v = g > 1 ? part + n : nullptr;
  dq_kernel<<<(s + kQRows - 1) / kQRows * nbh, kThreads, DqLayout<D>::kBytes,
              stream>>>(q128, do128, k64, v64, o, dout, lse, rows, dq, hq,
                        hkv, nbh, s, causal, window, capped, zs, zc, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<(s + kKRows - 1) / kKRows * nbh, kThreads, KvLayout<D>::kBytes,
              stream>>>(q64, do64, k128, v128, rows, dk, dv, part_k, part_v,
                        hq, hkv, nbh, s, causal, window, capped, zs, zc,
                        scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || part_k == nullptr) return (int)err;
  const long long head4 = (long long)s * D / 4, n4 = (long long)b * hkv * head4;
  bwd_sm90_sum_kernel<<<(unsigned)((n4 + kThreads - 1) / kThreads), kThreads,
                        0, stream>>>(
      reinterpret_cast<const float4*>(part_k),
      reinterpret_cast<const float4*>(part_v), dk, dv, g, head4, n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float2 entries of the (lse, Dsum) scratch of one (b, q head) at length s
long long flash_attention_bwd_sm90_rows(int s) { return s_pad(s); }

// softcap <= 0 means none, window <= 0 means none.  lse: the forward's
// [B, Hq, S] float32 (log2 units).  rows: scratch of B Hq
// flash_attention_bwd_sm90_rows(S) float2.  part: with Hq > Hkv, scratch of
// 2 B Hq S D float32 (the per-head partials of dk and dv), else unused
int flash_attention_bwd_bf16_sm90(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
    __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, float* rows,
    float* part, int b, int hq, int hkv, int s, int d, int causal,
    float softcap, int window, float scale, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || lse == nullptr || rows == nullptr ||
      (hq > hkv && part == nullptr))
    return (int)cudaErrorInvalidValue;
  float2* r2 = reinterpret_cast<float2*>(rows);
  switch (d) {
    case 64: return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, r2, part,
                               b, hq, hkv, s, causal, softcap, window, scale,
                               stream);
    case 128: return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, r2, part,
                                 b, hq, hkv, s, causal, softcap, window,
                                 scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
