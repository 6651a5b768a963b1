// The tensor-core route of the attention backward (bf16): the preprocess,
// dq and dk / dv wgmma kernels and their launch, as templates. The design
// is set out at the head of flash_attention_bwd.cu, whose C entry point
// instantiates the route with P and dS split into bf16 hi + lo;
// flash_attention_bwd_unsplit.cu instantiates it with them rounded to bf16
// alone (a yardstick of what the split costs). Two sources, so nvcc builds
// the two sets of instantiations in parallel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace repro_kernels {
namespace flash_bwd_tc {

using namespace repro_kernels::hopper;

struct RowStrides {
  int64_t b, s, h;   // element strides; the head dimension has stride 1
};

constexpr int kStages = 2;        // TMA ring depth of both kernels
constexpr int kStatPad = 128;     // lse / D rows padded to a multiple of this
constexpr int kBarPFull = 1;      // named barriers of the dk / dv kernel
constexpr int kBarPFree = 2;

// D = rowsum(dout * o) of every (b, s, h) row, and the forward's lse, into
// (B * Hq, Spad) fp32 rows padded past S (D 0, lse +inf: P = 0 there), so
// the dk / dv kernel's bulk loads of a query step start 16-byte aligned.
// Bytes-bound (o and dout read once): L lanes a row, rows in (b, s, h)
// order so neighbouring lanes read neighbouring bytes; with kVec each lane
// reads 8 elements (16 bytes) a step, else one.
template <int L, bool kVec>
__global__ void __launch_bounds__(256)
flash_bwd_preprocess_kernel(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ lse_pad,
                            float* __restrict__ delta, int S, int Spad, int Hq, int dhv,
                            RowStrides lo, RowStrides ldo, int64_t rows) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x) / L;
  const int part = threadIdx.x % L;
  const bool valid = row < rows;   // every lane stays for the shuffles
  const int h = static_cast<int>(row % Hq);
  const int64_t bs = row / Hq;
  const int s = static_cast<int>(bs % Spad);
  const int b = static_cast<int>(bs / Spad);
  float acc = 0.f;
  if (valid && s < S) {
    const __nv_bfloat16* orow = o + b * lo.b + s * lo.s + h * lo.h;
    const __nv_bfloat16* grow = dout + b * ldo.b + s * ldo.s + h * ldo.h;
    if constexpr (kVec) {
      for (int d = 8 * part; d < dhv; d += 8 * L) {
        const uint4 a = *reinterpret_cast<const uint4*>(orow + d);
        const uint4 c = *reinterpret_cast<const uint4*>(grow + d);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 af = __bfloat1622float2(a2[j]), cf = __bfloat1622float2(c2[j]);
          acc = fmaf(af.x, cf.x, acc);
          acc = fmaf(af.y, cf.y, acc);
        }
      }
    } else {
      for (int d = part; d < dhv; d += L)
        acc = fmaf(__bfloat162float(orow[d]), __bfloat162float(grow[d]), acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && part == 0) {
    const int64_t bh = static_cast<int64_t>(b) * Hq + h;
    delta[bh * Spad + s] = acc;
    lse_pad[bh * Spad + s] = s < S ? lse[bh * S + s] : INFINITY;
  }
}

// P = ex2(s * c - lse) over an accumulator fragment of scores (c = scale *
// log2(e), lse in the same log2 unit): this thread's rows r = (i / 2) % 2
// and columns 8 (i / 4) + (i % 2) relative to its first (col0). Rows carry
// their lse (the dq kernel: ``lse_row``); columns read theirs from shared
// memory (the dk / dv kernel's transposed tile: ``lse_col`` at col0). With
// kMask, an element outside [lo[r], hi[r]] (relative columns) gets P = 0.
template <bool kMask, int N>
__device__ __forceinline__ void probs_rows(float (&s)[N], float c, const float (&lse_row)[2],
                                           const int* lo, const int* hi) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i] * c;
    if constexpr (kMask) {
      const int col = 8 * (i >> 2) + (i & 1);
      if (col < lo[r] || col > hi[r]) x = -INFINITY;
    }
    s[i] = ex2(x - lse_row[r]);
  }
}

template <bool kMask, int N>
__device__ __forceinline__ void probs_cols(float (&s)[N], float c, const float* lse_col,
                                           const int* lo, const int* hi) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + (i & 1);
    float x = s[i] * c;
    if constexpr (kMask) {
      if (col < lo[r] || col > hi[r]) x = -INFINITY;
    }
    s[i] = ex2(x - lse_col[col]);
  }
}

// The dq kernel's block: kWG consumer warpgroups of 64 query rows each (two
// up to DeepSeek's 192 / 128; one at 256 / 256, where Q, dO and the K / V
// ring of two would pass 227 KiB), kBN = 64 keys a K / V stage. No producer
// warpgroup: thread 0 issues the TMA loads, so a 256-thread block keeps 255
// registers a thread; at 64 / 64 it is held to 128, two blocks an SM.
template <int DH, int DV>
struct DqTile {
  static constexpr int kWG = (DH <= 192 && DV <= 128) ? 2 : 1;
  static constexpr int kMinBlocks = (DH <= 64 && DV <= 64) ? 2 : 1;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kBM = 64 * kWG;
  static constexpr int kBN = 64;
  static constexpr int kQBytes = kBM * DH * 2, kOBytes = kBM * DV * 2;
  static constexpr int kKBytes = kBN * DH * 2, kVBytes = kBN * DV * 2;
  static constexpr int kQ = 0;
  static constexpr int kO = kQ + kQBytes;
  static constexpr int kK = kO + kOBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBar = kV + kStages * kVBytes;   // full[], empty[], q_full
  static constexpr int kAlloc = kBar + (2 * kStages + 1) * 8 + 1024;
  static_assert(kAlloc <= 227 * 1024, "a block's shared memory is past 227 KiB");
};

// dq: one block per (b * Hq + h, query tile), query tiles last-first (the
// causal diagonal's longest first). Per visible 64-key tile, each consumer
// warpgroup: S = Q K^T and dP = dO V^T (SS, both K-major), P = ex2(S c -
// lse), dS = P (dP - D), dQ += dS K (RS: dS as bf16 A fragments, hi + lo
// with kSplit; K MN-major). dq = scale dQ, written once.
template <int DH, int DV, bool kSplit>
__global__ void __launch_bounds__(DqTile<DH, DV>::kThreads, DqTile<DH, DV>::kMinBlocks)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse_pad, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int S, int Spad, int Hq, int Hkv,
                          int dh, float scale, float scale_log2, int causal, int window) {
  using L = DqTile<DH, DV>;
  constexpr int kBN = L::kBN, kBM = L::kBM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sO = base + L::kO, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar = base + L::kBar;
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (kStages + s); };
  const uint32_t q_full = bar + 16u * kStages;

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  // the key tiles the mask can reach from queries q0 .. q_last
  const int q_last = min(q0 + kBM, S) - 1;
  const int kt_end = causal ? q_last / kBN + 1 : (S + kBN - 1) / kBN;
  int kt_begin = 0;
  if (window > 0) {
    const int first_key = q0 - window + 1;   // q0 - k < window
    kt_begin = first_key > 0 ? first_key / kBN : 0;
  }
  const int n_tiles = kt_end - kt_begin;
  const int t = threadIdx.x;

  auto load_kv = [&](int it) {
    const int st = it % kStages;
    const int k0 = (kt_begin + it) * kBN;
    mbar_expect_tx(full(st), L::kKBytes + L::kVBytes);
#pragma unroll
    for (int c = 0; c < DH / 64; ++c)
      tma_load(sK + st * L::kKBytes + c * kBN * kSwizzleBytes, &tk, 64 * c, hk, k0, b, full(st));
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
      tma_load(sV + st * L::kVBytes + c * kBN * kSwizzleBytes, &tv, 64 * c, hk, k0, b, full(st));
  };

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * L::kWG);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(q_full, L::kQBytes + L::kOBytes);
#pragma unroll
    for (int c = 0; c < DH / 64; ++c)
      tma_load(sQ + c * kBM * kSwizzleBytes, &tq, 64 * c, h, q0, b, q_full);
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
      tma_load(sO + c * kBM * kSwizzleBytes, &tdo, 64 * c, h, q0, b, q_full);
    for (int it = 0; it < min(kStages, n_tiles); ++it) load_kv(it);
  }

  const int w = t >> 7;                  // warpgroup: query rows 64 w ..
  const int warp = (t >> 5) & 3;
  const int lane = t & 31;
  const int qa = q0 + 64 * w;
  const int qb = qa + 63;
  const int row_q0 = qa + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t idx = static_cast<int64_t>(bh) * Spad + row_q0 + 8 * r;
    lse_r[r] = lse_pad[idx];
    d_r[r] = delta[idx];
  }
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  const uint32_t q_rows = sQ + 64 * w * kSwizzleBytes;
  const uint32_t o_rows = sO + 64 * w * kSwizzleBytes;
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int k0 = (kt_begin + it) * kBN;
    mbar_wait(full(st), (it / kStages) & 1);
    const bool live = qa < S && (!causal || k0 <= qb) &&
                      (window <= 0 || qa - (k0 + kBN - 1) < window);
    if (live) {
      const uint32_t k_rows = sK + st * L::kKBytes, v_rows = sV + st * L::kVBytes;
      float s[kBN / 2], dp[kBN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint64_t da = smem_desc(q_rows + (kk >> 2) * kBM * kSwizzleBytes + (kk & 3) * 32,
                                      16, 1024);
        const uint64_t db = smem_desc(k_rows + (kk >> 2) * kBN * kSwizzleBytes + (kk & 3) * 32,
                                      16, 1024);
        wgmma_ss<kBN>(s, da, db, kk == 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint64_t da = smem_desc(o_rows + (kk >> 2) * kBM * kSwizzleBytes + (kk & 3) * 32,
                                      16, 1024);
        const uint64_t db = smem_desc(v_rows + (kk >> 2) * kBN * kSwizzleBytes + (kk & 3) * 32,
                                      16, 1024);
        wgmma_ss<kBN>(dp, da, db, kk == 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);

      if ((causal && k0 + kBN - 1 > qa) || (window > 0 && qb - k0 >= window) || k0 + kBN > S) {
        int lo[2], hi[2];   // visible keys of each row, relative to k0 + col0
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = row_q0 + 8 * r;
          lo[r] = (window > 0 ? qp - window + 1 : 0) - k0 - col0;
          hi[r] = (causal ? min(qp, S - 1) : S - 1) - k0 - col0;
        }
        probs_rows<true>(s, scale_log2, lse_r, lo, hi);
      } else {
        probs_rows<false>(s, scale_log2, lse_r, nullptr, nullptr);
      }
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) dp[i] = s[i] * (dp[i] - d_r[(i >> 1) & 1]);

      uint32_t ds_hi[kBN / 16][4];
      uint32_t ds_lo[kSplit ? kBN / 16 : 1][4];
      if constexpr (kSplit) to_a_frags(dp, ds_hi, ds_lo);
      else to_a_frags(dp, ds_hi);
      pin(acc);
      pin(ds_hi);
      if constexpr (kSplit) pin(ds_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t kb = k_rows + kk * 16 * kSwizzleBytes;
        wgmma_rs_mn<DH>(acc, ds_hi[kk], kb, kBN * kSwizzleBytes);
        if constexpr (kSplit) wgmma_rs_mn<DH>(acc, ds_lo[kk], kb, kBN * kSwizzleBytes);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      pin(ds_hi);
      if constexpr (kSplit) pin(ds_lo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
    if (t == 0 && it + kStages < n_tiles) {
      mbar_wait(empty(st), (it / kStages) & 1);
      load_kv(it + kStages);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row_q0 + 8 * r;
    if (qp >= S) continue;
    __nv_bfloat16* row = dq + (static_cast<int64_t>(b) * S + qp) * Hq * dh +
                         static_cast<int64_t>(h) * dh;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + col0;
      const float v0 = acc[4 * j + 2 * r] * scale, v1 = acc[4 * j + 2 * r + 1] * scale;
      if (c + 1 < dh && (dh & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < dh) row[c] = __float2bfloat16(v0);
        if (c + 1 < dh) row[c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// The dk / dv kernel's block: one 64-key tile (K, V) and a ring of 64-query
// steps (Q, dO, lse, D) in shared memory, and an fp32 exchange of P^T
// between its two consumer warpgroups (256 threads, no producer warpgroup).
template <int DH, int DV>
struct KvTile {
  static constexpr int kThreads = 256;
  static constexpr int kBN = 64;   // keys a block
  // queries a step: 128 where dh and dhv are at most 128 and not both 64
  // (at 64 / 64 the 64-query step's smaller block ran faster)
  static constexpr int kBM = (DH <= 128 && DV <= 128 && DH + DV > 128) ? 128 : 64;
  static constexpr int kKBytes = kBN * DH * 2, kVBytes = kBN * DV * 2;
  static constexpr int kQBytes = kBM * DH * 2, kOBytes = kBM * DV * 2;
  static constexpr int kStatBytes = kBM * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kQ = kV + kVBytes;
  static constexpr int kO = kQ + kStages * kQBytes;
  static constexpr int kL = kO + kStages * kOBytes;
  static constexpr int kD = kL + kStages * kStatBytes;
  static constexpr int kP = kD + kStages * kStatBytes;   // kBN x kBM fp32, by thread
  static constexpr int kBar = kP + kBN * kBM * 4;         // full[], empty[], kv_full
  static constexpr int kAlloc = kBar + (2 * kStages + 1) * 8 + 1024;
  static_assert(kAlloc <= 227 * 1024, "a block's shared memory is past 227 KiB");
};

// dk / dv: one block per (b * Hkv + hk, 64-key tile), key tiles first-first
// (under the causal mask the first keys see the most queries). It walks the
// G query heads of KV head hk and, for each, the 64-query steps the mask
// reaches, in that fixed order. Warpgroup 0 owns dV, warpgroup 1 dK, of the
// same 64 keys, so each holds one accumulator (at dh = dhv = 256 the two
// would be 256 registers a thread). Per step, in the transposed tile (keys
// as rows, queries as columns, every operand in its natural layout):
//   wg 0: S^T = K Q^T (SS), P^T = ex2(S^T c - lse), P^T to shared memory,
//         dV += P^T dO (RS; dO MN-major);
//   wg 1: dP^T = V dO^T (SS), dS^T = P^T (dP^T - D) with P^T from wg 0,
//         dK += dS^T Q (RS; Q MN-major).
// Two named barriers order the exchange (P^T written / read). Thread 128
// issues the TMA loads of the next steps once both warpgroups release a
// stage. dk = scale dK.
template <int DH, int DV, bool kSplit>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse_pad, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int S, int Spad, int Hq, int Hkv, int dh, int dhv, float scale,
                            float scale_log2, int causal, int window) {
  using L = KvTile<DH, DV>;
  constexpr int kBN = L::kBN, kBM = L::kBM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sK = base + L::kK, sV = base + L::kV, sQ = base + L::kQ, sO = base + L::kO;
  const float* sL = reinterpret_cast<const float*>(gbase + L::kL);
  const float* sD = reinterpret_cast<const float*>(gbase + L::kD);
  float* sP = reinterpret_cast<float*>(gbase + L::kP);
  const uint32_t bar = base + L::kBar;
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (kStages + s); };
  const uint32_t kv_full = bar + 16u * kStages;

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int hk = bkv - b * Hkv;
  const int G = Hq / Hkv;
  const int k0 = blockIdx.y * kBN;
  // the query steps the mask can reach from keys k0 .. k_last
  const int k_last = min(k0 + kBN, S) - 1;
  const int qt_begin = causal ? k0 / kBM : 0;
  int qt_end = (S + kBM - 1) / kBM;
  if (window > 0) qt_end = min(qt_end, (k_last + window - 1) / kBM + 1);
  const int nq = qt_end - qt_begin;
  const int n_steps = G * nq;
  const int t = threadIdx.x;

  auto load_step = [&](int it) {
    const int st = it % kStages;
    const int h = hk * G + it / nq;
    const int q0 = (qt_begin + it % nq) * kBM;
    mbar_expect_tx(full(st), L::kQBytes + L::kOBytes + 2 * L::kStatBytes);
#pragma unroll
    for (int c = 0; c < DH / 64; ++c)
      tma_load(sQ + st * L::kQBytes + c * kBM * kSwizzleBytes, &tq, 64 * c, h, q0, b, full(st));
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
      tma_load(sO + st * L::kOBytes + c * kBM * kSwizzleBytes, &tdo, 64 * c, h, q0, b,
               full(st));
    const int64_t row = (static_cast<int64_t>(b) * Hq + h) * Spad + q0;
    bulk_load(base + L::kL + st * L::kStatBytes, lse_pad + row, L::kStatBytes, full(st));
    bulk_load(base + L::kD + st * L::kStatBytes, delta + row, L::kStatBytes, full(st));
  };

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 128) {
    mbar_expect_tx(kv_full, L::kKBytes + L::kVBytes);
#pragma unroll
    for (int c = 0; c < DH / 64; ++c)
      tma_load(sK + c * kBN * kSwizzleBytes, &tk, 64 * c, hk, k0, b, kv_full);
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
      tma_load(sV + c * kBN * kSwizzleBytes, &tv, 64 * c, hk, k0, b, kv_full);
    for (int it = 0; it < min(kStages, n_steps); ++it) load_step(it);
  }

  const int warp = (t >> 5) & 3;
  const int lane = t & 31;
  const int tt = t & 127;
  const int row_k0 = k0 + 16 * warp + (lane >> 2);   // this thread's key rows: + 8 r
  const int col0 = 2 * (lane & 3);
  mbar_wait(kv_full, 0);

  if (t < 128) {
    // warpgroup 0: P^T and dV
    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    for (int it = 0; it < n_steps; ++it) {
      const int st = it % kStages;
      const int q0 = (qt_begin + it % nq) * kBM;
      mbar_wait(full(st), (it / kStages) & 1);
      const uint32_t q_rows = sQ + st * L::kQBytes, o_rows = sO + st * L::kOBytes;
      float s[kBM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint64_t da = smem_desc(sK + (kk >> 2) * kBN * kSwizzleBytes + (kk & 3) * 32,
                                      16, 1024);
        const uint64_t db = smem_desc(q_rows + (kk >> 2) * kBM * kSwizzleBytes + (kk & 3) * 32,
                                      16, 1024);
        wgmma_ss<kBM>(s, da, db, kk == 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      const float* lse_col = sL + st * kBM + col0;
      if ((causal && q0 < k0 + kBN - 1) || (window > 0 && q0 + kBM - 1 - k0 >= window) ||
          q0 + kBM > S || k0 + kBN > S) {
        int lo[2], hi[2];   // visible queries of each key row, relative to q0 + col0
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kr = row_k0 + 8 * r;
          lo[r] = (causal ? kr : 0) - q0 - col0;
          hi[r] = (kr < S ? (window > 0 ? min(kr + window - 1, S - 1) : S - 1) : -1) - q0 - col0;
        }
        probs_cols<true>(s, scale_log2, lse_col, lo, hi);
      } else {
        probs_cols<false>(s, scale_log2, lse_col, nullptr, nullptr);
      }
      if (it > 0) bar_sync(kBarPFree, 256);   // wg 1 has read the last step's P^T
#pragma unroll
      for (int i = 0; i < kBM / 2; ++i) sP[i * 128 + tt] = s[i];
      bar_arrive(kBarPFull, 256);

      uint32_t p_hi[kBM / 16][4];
      uint32_t p_lo[kSplit ? kBM / 16 : 1][4];
      if constexpr (kSplit) to_a_frags(s, p_hi, p_lo);
      else to_a_frags(s, p_hi);
      pin(acc);
      pin(p_hi);
      if constexpr (kSplit) pin(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk) {
        const uint32_t ob = o_rows + kk * 16 * kSwizzleBytes;
        wgmma_rs_mn<DV>(acc, p_hi[kk], ob, kBM * kSwizzleBytes);
        if constexpr (kSplit) wgmma_rs_mn<DV>(acc, p_lo[kk], ob, kBM * kSwizzleBytes);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      pin(p_hi);
      if constexpr (kSplit) pin(p_lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = row_k0 + 8 * r;
      if (kr >= S) continue;
      __nv_bfloat16* row = dv + (static_cast<int64_t>(b) * S + kr) * Hkv * dhv +
                           static_cast<int64_t>(hk) * dhv;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int c = 8 * j + col0;
        const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
        if (c + 1 < dhv && (dhv & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < dhv) row[c] = __float2bfloat16(v0);
          if (c + 1 < dhv) row[c + 1] = __float2bfloat16(v1);
        }
      }
    }
  } else {
    // warpgroup 1: dS^T and dK; thread 128 keeps the ring full
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    for (int it = 0; it < n_steps; ++it) {
      const int st = it % kStages;
      mbar_wait(full(st), (it / kStages) & 1);
      const uint32_t q_rows = sQ + st * L::kQBytes, o_rows = sO + st * L::kOBytes;
      float dp[kBM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint64_t da = smem_desc(sV + (kk >> 2) * kBN * kSwizzleBytes + (kk & 3) * 32,
                                      16, 1024);
        const uint64_t db = smem_desc(o_rows + (kk >> 2) * kBM * kSwizzleBytes + (kk & 3) * 32,
                                      16, 1024);
        wgmma_ss<kBM>(dp, da, db, kk == 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dp);

      const float* d_col = sD + st * kBM + col0;
      bar_sync(kBarPFull, 256);
#pragma unroll
      for (int i = 0; i < kBM / 2; ++i)
        dp[i] = sP[i * 128 + tt] * (dp[i] - d_col[8 * (i >> 2) + (i & 1)]);
      if (it + 1 < n_steps) bar_arrive(kBarPFree, 256);

      uint32_t ds_hi[kBM / 16][4];
      uint32_t ds_lo[kSplit ? kBM / 16 : 1][4];
      if constexpr (kSplit) to_a_frags(dp, ds_hi, ds_lo);
      else to_a_frags(dp, ds_hi);
      pin(acc);
      pin(ds_hi);
      if constexpr (kSplit) pin(ds_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk) {
        const uint32_t qb = q_rows + kk * 16 * kSwizzleBytes;
        wgmma_rs_mn<DH>(acc, ds_hi[kk], qb, kBM * kSwizzleBytes);
        if constexpr (kSplit) wgmma_rs_mn<DH>(acc, ds_lo[kk], qb, kBM * kSwizzleBytes);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      pin(ds_hi);
      if constexpr (kSplit) pin(ds_lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
      if (t == 128 && it + kStages < n_steps) {
        mbar_wait(empty(st), (it / kStages) & 1);
        load_step(it + kStages);
      }
      __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = row_k0 + 8 * r;
      if (kr >= S) continue;
      __nv_bfloat16* row = dk + (static_cast<int64_t>(b) * S + kr) * Hkv * dh +
                           static_cast<int64_t>(hk) * dh;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int c = 8 * j + col0;
        const float v0 = acc[4 * j + 2 * r] * scale, v1 = acc[4 * j + 2 * r + 1] * scale;
        if (c + 1 < dh && (dh & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < dh) row[c] = __float2bfloat16(v0);
          if (c + 1 < dh) row[c + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <typename Kernel>
int set_smem_tc(Kernel kernel, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// The three launches of one backward call; ls: element strides (b, s, h) of
// q, k, v, o, dout. A layout TMA refuses returns cudaErrorInvalidValue.
template <int DH, int DV, bool kSplit>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, const float* lse, float* scratch, int B, int S,
           int Hq, int Hkv, int dh, int dhv, const int64_t (&ls)[15], float scale, int causal,
           int window, cudaStream_t stream) {
  using Q = DqTile<DH, DV>;
  using K = KvTile<DH, DV>;
  const int Spad = (S + kStatPad - 1) / kStatPad * kStatPad;
  const int64_t rows = static_cast<int64_t>(B) * Hq * Spad;
  float* lse_pad = scratch;
  float* delta = scratch + rows;
  const __nv_bfloat16* o16 = static_cast<const __nv_bfloat16*>(o);
  const __nv_bfloat16* g16 = static_cast<const __nv_bfloat16*>(dout);
  const RowStrides lo{ls[9], ls[10], ls[11]}, lg{ls[12], ls[13], ls[14]};
  // 16-byte reads where every row of o and dout starts 16-byte aligned
  bool vec = dhv % 8 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  for (int i = 9; i < 15; ++i) vec = vec && ls[i] % 8 == 0;
  const int lanes = !vec ? 32 : dhv <= 64 ? 8 : dhv <= 128 ? 16 : 32;
  const unsigned grid_pre = static_cast<unsigned>((rows * lanes + 255) / 256);
  if (!vec)
    flash_bwd_preprocess_kernel<32, false><<<grid_pre, 256, 0, stream>>>(
        o16, g16, lse, lse_pad, delta, S, Spad, Hq, dhv, lo, lg, rows);
  else if (lanes == 8)
    flash_bwd_preprocess_kernel<8, true><<<grid_pre, 256, 0, stream>>>(
        o16, g16, lse, lse_pad, delta, S, Spad, Hq, dhv, lo, lg, rows);
  else if (lanes == 16)
    flash_bwd_preprocess_kernel<16, true><<<grid_pre, 256, 0, stream>>>(
        o16, g16, lse, lse_pad, delta, S, Spad, Hq, dhv, lo, lg, rows);
  else
    flash_bwd_preprocess_kernel<32, true><<<grid_pre, 256, 0, stream>>>(
        o16, g16, lse, lse_pad, delta, S, Spad, Hq, dhv, lo, lg, rows);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;

  // each kernel's maps, boxes of its own tile rows
  CUtensorMap mq, mk, mv, mdo, kq, kk, kv, kdo;
  if (!encode(&mq, q, dh, Hq, S, B, ls[2], ls[1], ls[0], Q::kBM) ||
      !encode(&mk, k, dh, Hkv, S, B, ls[5], ls[4], ls[3], Q::kBN) ||
      !encode(&mv, v, dhv, Hkv, S, B, ls[8], ls[7], ls[6], Q::kBN) ||
      !encode(&mdo, dout, dhv, Hq, S, B, ls[14], ls[13], ls[12], Q::kBM) ||
      !encode(&kq, q, dh, Hq, S, B, ls[2], ls[1], ls[0], K::kBM) ||
      !encode(&kk, k, dh, Hkv, S, B, ls[5], ls[4], ls[3], K::kBN) ||
      !encode(&kv, v, dhv, Hkv, S, B, ls[8], ls[7], ls[6], K::kBN) ||
      !encode(&kdo, dout, dhv, Hq, S, B, ls[14], ls[13], ls[12], K::kBM))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;

  e = set_smem_tc(flash_bwd_dq_wgmma_kernel<DH, DV, kSplit>, Q::kAlloc);
  if (e != 0) return e;
  const dim3 grid_q(static_cast<unsigned>(B * Hq), static_cast<unsigned>((S + Q::kBM - 1) / Q::kBM));
  flash_bwd_dq_wgmma_kernel<DH, DV, kSplit><<<grid_q, Q::kThreads, Q::kAlloc, stream>>>(
      mq, mk, mv, mdo, lse_pad, delta, static_cast<__nv_bfloat16*>(dq), S, Spad, Hq, Hkv, dh,
      scale, scale_log2, causal, window);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;

  e = set_smem_tc(flash_bwd_dkdv_wgmma_kernel<DH, DV, kSplit>, K::kAlloc);
  if (e != 0) return e;
  const dim3 grid_k(static_cast<unsigned>(B * Hkv), static_cast<unsigned>((S + K::kBN - 1) / K::kBN));
  flash_bwd_dkdv_wgmma_kernel<DH, DV, kSplit><<<grid_k, K::kThreads, K::kAlloc, stream>>>(
      kq, kk, kv, kdo, lse_pad, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, Spad, Hq, Hkv, dh, dhv, scale, scale_log2, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSplit>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout,
             void* dq, void* dk, void* dv, const float* lse, float* scratch, int B, int S,
             int Hq, int Hkv, int dh, int dhv, const int64_t (&ls)[15], float scale, int causal,
             int window, cudaStream_t s) {
#define REPRO_BWD_LAUNCH(DH, DV)                                                          \
  launch<DH, DV, kSplit>(q, k, v, o, dout, dq, dk, dv, lse, scratch, B, S, Hq, Hkv, dh, dhv, \
                         ls, scale, causal, window, s)
  // the smallest instantiation that holds dh and dhv (the forward's)
  if (dh > 192 || dhv > 128) return REPRO_BWD_LAUNCH(256, 256);
  if (dh > 128) return REPRO_BWD_LAUNCH(192, 128);
  if (dh > 64) return dhv > 64 ? REPRO_BWD_LAUNCH(128, 128) : REPRO_BWD_LAUNCH(128, 64);
  return dhv > 64 ? REPRO_BWD_LAUNCH(64, 128) : REPRO_BWD_LAUNCH(64, 64);
#undef REPRO_BWD_LAUNCH
}

// The C entry points' body (flash_attention_bwd.cu, _unsplit.cu): the
// arguments' checks, then the smallest instantiation that holds dh and dhv.
template <bool kSplit>
int entry(const void* q, const void* k, const void* v, const void* o, const void* dout,
          void* dq, void* dk, void* dv, const float* lse, float* scratch, int B, int S, int Hq,
          int Hkv, int dh, int dhv, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
          int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t osb,
          int64_t oss, int64_t osh, int64_t gsb, int64_t gss, int64_t gsh, float scale,
          int causal, int window, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (dh < 1 || dh > 256 || dhv < 1 || dhv > 256 || Hkv < 1 || Hq % Hkv != 0 ||
      lse == nullptr || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ls[15] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                          osb, oss, osh, gsb, gss, gsh};
  return dispatch<kSplit>(q, k, v, o, dout, dq, dk, dv, lse, scratch, B, S, Hq, Hkv, dh, dhv,
                          ls, scale, causal, window, static_cast<cudaStream_t>(stream));
}

}  // namespace flash_bwd_tc
}  // namespace repro_kernels
