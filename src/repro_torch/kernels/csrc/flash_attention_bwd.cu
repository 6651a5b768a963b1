// Flash attention backward (causal / sliding-window, GQA) for Hopper, sm_90a:
// the gradient of the LM's attention (models/layers.py attention_full) in
// training.
//
// Replaces no Pallas kernel: the TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py) has no VJP, and the reference trains
// through its plain chunked attention, whose gradient JAX's autodiff takes.
// On the card the port's attention forward is csrc/flash_attention.cu, so the
// gradient of that same function is this file, behind the autograd Function
// of kernels/ops.py. Inputs q (B, S, Hq, dh), k (B, S, Hkv, dh), v (B, S, Hkv,
// dhv), the forward's output o (B, S, Hq, dhv) and its cotangent do, read
// through (b, s, h) element strides with the last dimension contiguous;
// outputs dq, dk, dv contiguous in the inputs' shapes and dtype. Query head h
// reads KV head h / (Hq / Hkv). dh, dhv <= 256. With P = softmax(scale q.k)
// under the mask, the gradient is dP = do.v, D = rowsum(do * o), dS = P (dP
// - D), dq = scale dS k, dk = scale dS^T q, dv = P^T do: five products over
// the visible (query, key) pairs. What bounds it: operations (at TinyLlama's
// layer, B = 8, S = 2048, 32/4, dh 64: 3.4e11 flops, 0.35 ms at the bf16
// tensor-core peak, against 0.05 ms of bytes). Two routes, by dtype; neither
// is atomic: every output element is summed by one block in a fixed order,
// so two runs give the same bits (a restart from a checkpoint is bit for
// bit). Tiles the mask cannot reach are skipped; masked pairs get P = 0, so a
// row that sees no key gets dq = 0 and adds nothing to dk and dv.
//
// bf16: the tensor-core route, three kernels on one stream, seven wgmma
// products where the gradient needs five (S and dP are formed twice, once in
// each of the two output kernels), hand-written PTX (wgmma.cuh) as in the
// forward:
//   flash_bwd_preprocess_kernel  D = rowsum(do * o), and the forward's
//                          log-sum-exp (which the forward saves, in its log2
//                          unit, so no product recomputes it), into fp32 rows
//                          padded to 128 (D 0, lse +inf past S). Bytes-bound.
//   flash_bwd_dq_wgmma_kernel  one block per (b * Hq + h, query tile), tiles
//                          last-first; a consumer warpgroup a 64-row slice
//                          (two a block up to dh 192 / dhv 128, one at 256 /
//                          256). Per visible 64-key tile: S = Q K^T and dP =
//                          dO V^T (SS, both operands K-major), P = ex2(S c -
//                          lse) with c = scale log2(e), dS = P (dP - D), dQ +=
//                          dS K (RS, K MN-major). 3 products.
//   flash_bwd_dkdv_wgmma_kernel  one block per (b * Hkv + hk, 64-key tile),
//                          key tiles first-first (the first keys see the most
//                          queries); it walks the G query heads of hk and
//                          their visible query steps (64 queries, 128 at head
//                          dims in (64, 128]) in a fixed order. The tile is
//                          transposed (keys as rows), so every operand stays
//                          in its natural layout. Warpgroup 0: S^T = K Q^T
//                          (SS), P^T, dV += P^T dO (RS, dO MN-major).
//                          Warpgroup 1: dP^T = V dO^T (SS), dS^T = P^T (dP^T
//                          - D), dK += dS^T Q (RS, Q MN-major). 4 products.
// Registers are the limit past head dim 128: at dh = dhv = 256 the dK and dV
// accumulators are 128 fp32 registers a thread each. So the two warpgroups of
// a dk / dv block share one key tile and own one accumulator each, and P^T
// crosses from warpgroup 0 to 1 through 16-32 KiB of shared memory (fp32,
// thread-major, so each thread reads back its own fragment), ordered by two
// named barriers (P^T written; P^T read). Neither kernel has a producer
// warpgroup: one consumer thread keeps a two-stage TMA ring (128-byte
// swizzle, mbarriers) full, so a 256-thread block keeps up to 255 registers
// a thread (a 384-thread block is held to 168). TMA's zero fill pads head
// dims to the instantiation's (64, 128, 192, 256, as the forward's) and the
// ragged S tail; the lse and D of a query step come by bulk copy. Phase 1
// of chip_smoke.py prints each instantiation's registers and spills.
// Precision: P and dS enter their products (dV, dK, dQ) as bf16 hi +
// bf16 lo, which keeps them to ~2^-17 (the forward's split of P). Rounded to
// bf16 alone, dk and dv left chip_smoke.py's BWD_TOL at several shapes (dq
// stayed within it, by a thin margin); the split gives those three products
// twice the tensor work (phase 2 of chip_smoke.py times the route without
// it: flash_attention_bwd_unsplit).
//
// fp32 (and the bf16 route's yardstick): the first backward, FlashAttention-2
// with fp32 accumulation on the CUDA cores' FMA, two kernels on one stream:
//   flash_bwd_dq_kernel    one block per (b * Hq + h, 64-row query tile).
//                          Pass 1 recomputes the row's log-sum-exp over the
//                          key tiles the mask reaches and D = rowsum(do * o);
//                          both go to global scratch. Pass 2 walks the same
//                          key tiles: P = exp(scale q.k - lse), dP = do.v, dS
//                          = P (dP - D), dq += dS k; dq is written times
//                          scale.
//   flash_bwd_dkdv_kernel  one block per (b * Hkv + hk, BK-row key tile). It
//                          loops over the G query heads that read KV head hk
//                          and, for each, the query tiles the mask reaches,
//                          with that tile's lse and D from the first kernel:
//                          dv += P^T do, dk += dS^T q; dk times scale.
// It runs eight products (q.k three times, do.v twice), bf16 operands
// widened into fp32 shared memory. Thread (tr, tc) = (t / 16, t % 16) of 256
// owns score rows tr + 16 i and columns tc + 16 j, and output columns tc +
// 16 e: the 16 threads of a row are one half-warp, so a row's max and sums
// are shuffles. Rows in shared memory are padded to d + 1 floats, so a
// half-warp reading 16 rows at one column hits 16 banks. The key tile BK is
// 64 where dh and dhv are at most 128, else 32, so that the largest block
// (dh = dhv = 256: K, V, Q, do, P and dS tiles) takes 214,784 bytes of the
// 232,448 a block may opt in to, and the dk / dv accumulators (2 x 16 fp32
// each a thread) stay in registers. The tensor cores give no fp32 product
// without TF32, which the port avoids.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd_wgmma.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kThreads = 256;
constexpr int kRows = kBQ / 16;  // query rows per thread: tr + 16 i
constexpr float kNegInf = -1e30f;
constexpr int kMaxHeadDim = 256;
constexpr size_t kSmemMax = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Reductions over the 16 threads of a row (one half-warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Layout {
  int64_t b, s, h;   // element strides; the head dimension has stride 1
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;     // (B * Hq, S)
  float* delta;   // (B * Hq, S)
  int B, S, Hq, Hkv, dh, dhv;
  Layout lq, lk, lv, lo, ldo;
  float scale;
  int causal, window;
};

// rows [r0, r0 + R) of one head of x (stride layout l) into shared memory as
// fp32, ld floats a row; rows past S are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base, int64_t row_stride,
                                          int r0, int R, int d, int S) {
  for (int idx = threadIdx.x; idx < R * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int s = r0 + r;
    dst[r * ld + c] = s < S ? to_f32(base[static_cast<int64_t>(s) * row_stride + c]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal, int window) {
  return qp < S && kp < S && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// NQ / NV: output columns a thread owns of dh / dhv (tc + 16 e).
template <typename T, int BK, int NQ, int NV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Params p) {
  constexpr int kCols = BK / 16;
  constexpr int kLdS = BK + 1;
  extern __shared__ float smem[];
  const int dh = p.dh, dhv = p.dhv, S = p.S;
  const int ldq = dh + 1, ldv = dhv + 1;
  float* Qs = smem;                 // kBQ x ldq
  float* dOs = Qs + kBQ * ldq;      // kBQ x ldv
  float* Ks = dOs + kBQ * ldv;      // BK x ldq
  float* Vs = Ks + BK * ldq;        // BK x ldv
  float* dSs = Vs + BK * ldv;       // kBQ x kLdS

  const int bh = blockIdx.y;
  const int b = bh / p.Hq;
  const int h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int t = threadIdx.x;
  const int tr = t >> 4;
  const int tc = t & 15;

  const T* qb = static_cast<const T*>(p.q) + b * p.lq.b + h * p.lq.h;
  const T* ob = static_cast<const T*>(p.o) + b * p.lo.b + h * p.lo.h;
  const T* dob = static_cast<const T*>(p.dout) + b * p.ldo.b + h * p.ldo.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.lk.b + hk * p.lk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.lv.b + hk * p.lv.h;

  load_tile(Qs, ldq, qb, p.lq.s, q0, kBQ, dh, S);
  load_tile(dOs, ldv, dob, p.ldo.s, q0, kBQ, dhv, S);
  __syncthreads();

  // D = rowsum(do * o), o read once from global
  float Di[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = tr + 16 * i;
    const int s = q0 + r;
    float acc = 0.f;
    if (s < S)
      for (int d = tc; d < dhv; d += 16)
        acc = fmaf(dOs[r * ldv + d], to_f32(ob[static_cast<int64_t>(s) * p.lo.s + d]), acc);
    Di[i] = row_sum(acc);
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_end = p.causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  int kt_begin = 0;
  if (p.window > 0) {
    const int first_key = q0 - p.window + 1;   // q0 - k < window
    kt_begin = first_key > 0 ? first_key / BK : 0;
  }

  // pass 1: the log-sum-exp of each row's visible scaled scores
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(Ks, ldq, kb, p.lk.s, k0, BK, dh, S);
    __syncthreads();
    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(tr + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tc + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + tr + 16 * i;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        ok[j] = visible(qp, k0 + tc + 16 * j, S, p.causal, p.window);
        sc[i][j] = ok[j] ? sc[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) sum += ok[j] ? expf(sc[i][j] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }
  float lse[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
    const int s = q0 + tr + 16 * i;
    if (tc == 0 && s < S) {
      p.lse[static_cast<int64_t>(bh) * S + s] = lse[i];
      p.delta[static_cast<int64_t>(bh) * S + s] = Di[i];
    }
  }

  // pass 2: dq = scale * sum_j dS_ij k_j
  float acc[kRows][NQ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < NQ; ++e) acc[i][e] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the last tile's K, V and dS are no longer read
    load_tile(Ks, ldq, kb, p.lk.s, k0, BK, dh, S);
    load_tile(Vs, ldv, vb, p.lv.s, k0, BK, dhv, S);
    __syncthreads();
    float sc[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(tr + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tc + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll 4
    for (int d = 0; d < dhv; ++d) {
      float gv[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) gv[i] = dOs[(tr + 16 * i) * ldv + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = Vs[(tc + 16 * j) * ldv + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tc + 16 * j;
        const bool ok = visible(q0 + r, k0 + c, S, p.causal, p.window);
        const float pr = ok ? expf(sc[i][j] * p.scale - lse[i]) : 0.f;
        dSs[r * kLdS + c] = pr * (dp[i][j] - Di[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[kRows], kv[NQ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sv[i] = dSs[(tr + 16 * i) * kLdS + c];
#pragma unroll
      for (int e = 0; e < NQ; ++e) {
        const int d = tc + 16 * e;
        kv[e] = d < dh ? Ks[c * ldq + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < NQ; ++e) acc[i][e] = fmaf(sv[i], kv[e], acc[i][e]);
    }
  }

  T* dqb = static_cast<T*>(p.dq) + (static_cast<int64_t>(b) * S * p.Hq + h) * dh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + tr + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int e = 0; e < NQ; ++e) {
      const int d = tc + 16 * e;
      if (d < dh)
        dqb[static_cast<int64_t>(s) * p.Hq * dh + d] = from_f32<T>(acc[i][e] * p.scale);
    }
  }
}

template <typename T, int BK, int NQ, int NV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(Params p) {
  constexpr int kKeys = BK / 16;   // key rows per thread: tr + 16 a
  constexpr int kLdS = BK + 1;
  extern __shared__ float smem[];
  const int dh = p.dh, dhv = p.dhv, S = p.S;
  const int ldq = dh + 1, ldv = dhv + 1;
  float* Ks = smem;                 // BK x ldq
  float* Vs = Ks + BK * ldq;        // BK x ldv
  float* Qs = Vs + BK * ldv;        // kBQ x ldq
  float* dOs = Qs + kBQ * ldq;      // kBQ x ldv
  float* Ps = dOs + kBQ * ldv;      // kBQ x kLdS
  float* dSs = Ps + kBQ * kLdS;     // kBQ x kLdS
  float* lse_s = dSs + kBQ * kLdS;  // kBQ
  float* del_s = lse_s + kBQ;       // kBQ

  const int bh = blockIdx.y;
  const int b = bh / p.Hkv;
  const int hk = bh - b * p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int k0 = blockIdx.x * BK;
  const int t = threadIdx.x;
  const int tr = t >> 4;
  const int tc = t & 15;

  load_tile(Ks, ldq, static_cast<const T*>(p.k) + b * p.lk.b + hk * p.lk.h, p.lk.s, k0, BK, dh, S);
  load_tile(Vs, ldv, static_cast<const T*>(p.v) + b * p.lv.b + hk * p.lv.h, p.lv.s, k0, BK, dhv, S);

  float dk[kKeys][NQ], dv[kKeys][NV];
#pragma unroll
  for (int a = 0; a < kKeys; ++a) {
#pragma unroll
    for (int e = 0; e < NQ; ++e) dk[a][e] = 0.f;
#pragma unroll
    for (int e = 0; e < NV; ++e) dv[a][e] = 0.f;
  }

  // the query tiles the mask can reach from keys k0 .. k_last
  const int k_last = min(k0 + BK, S) - 1;
  const int qt_begin = p.causal ? k0 / kBQ : 0;
  int qt_end = (S + kBQ - 1) / kBQ;
  if (p.window > 0) qt_end = min(qt_end, (k_last + p.window - 1) / kBQ + 1);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int64_t row = static_cast<int64_t>(b) * p.Hq + h;
    const T* qb = static_cast<const T*>(p.q) + b * p.lq.b + h * p.lq.h;
    const T* dob = static_cast<const T*>(p.dout) + b * p.ldo.b + h * p.ldo.h;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();   // the last tile's Q, dO, P and dS are no longer read
      load_tile(Qs, ldq, qb, p.lq.s, q0, kBQ, dh, S);
      load_tile(dOs, ldv, dob, p.ldo.s, q0, kBQ, dhv, S);
      if (t < kBQ) {
        const int s = q0 + t;
        lse_s[t] = s < S ? p.lse[row * S + s] : 0.f;
        del_s[t] = s < S ? p.delta[row * S + s] : 0.f;
      }
      __syncthreads();

      float sc[kRows][kKeys], dp[kRows][kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < dh; ++d) {
        float qv[kRows], kv[kKeys];
#pragma unroll
        for (int i = 0; i < kRows; ++i) qv[i] = Qs[(tr + 16 * i) * ldq + d];
#pragma unroll
        for (int j = 0; j < kKeys; ++j) kv[j] = Ks[(tc + 16 * j) * ldq + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kKeys; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
#pragma unroll 4
      for (int d = 0; d < dhv; ++d) {
        float gv[kRows], vv[kKeys];
#pragma unroll
        for (int i = 0; i < kRows; ++i) gv[i] = dOs[(tr + 16 * i) * ldv + d];
#pragma unroll
        for (int j = 0; j < kKeys; ++j) vv[j] = Vs[(tc + 16 * j) * ldv + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kKeys; ++j) dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = tr + 16 * i;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int c = tc + 16 * j;
          const bool ok = visible(q0 + r, k0 + c, S, p.causal, p.window);
          const float pr = ok ? expf(sc[i][j] * p.scale - lse_s[r]) : 0.f;
          Ps[r * kLdS + c] = pr;
          dSs[r * kLdS + c] = pr * (dp[i][j] - del_s[r]);
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pv[kKeys], sv[kKeys], qv[NQ], gv[NV];
#pragma unroll
        for (int a = 0; a < kKeys; ++a) {
          pv[a] = Ps[r * kLdS + tr + 16 * a];
          sv[a] = dSs[r * kLdS + tr + 16 * a];
        }
#pragma unroll
        for (int e = 0; e < NQ; ++e) {
          const int d = tc + 16 * e;
          qv[e] = d < dh ? Qs[r * ldq + d] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          const int d = tc + 16 * e;
          gv[e] = d < dhv ? dOs[r * ldv + d] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kKeys; ++a) {
#pragma unroll
          for (int e = 0; e < NQ; ++e) dk[a][e] = fmaf(sv[a], qv[e], dk[a][e]);
#pragma unroll
          for (int e = 0; e < NV; ++e) dv[a][e] = fmaf(pv[a], gv[e], dv[a][e]);
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + (static_cast<int64_t>(b) * S * p.Hkv + hk) * dh;
  T* dvb = static_cast<T*>(p.dv) + (static_cast<int64_t>(b) * S * p.Hkv + hk) * dhv;
#pragma unroll
  for (int a = 0; a < kKeys; ++a) {
    const int s = k0 + tr + 16 * a;
    if (s >= S) continue;
#pragma unroll
    for (int e = 0; e < NQ; ++e) {
      const int d = tc + 16 * e;
      if (d < dh) dkb[static_cast<int64_t>(s) * p.Hkv * dh + d] = from_f32<T>(dk[a][e] * p.scale);
    }
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int d = tc + 16 * e;
      if (d < dhv) dvb[static_cast<int64_t>(s) * p.Hkv * dhv + d] = from_f32<T>(dv[a][e]);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, int BK, int NQ, int NV>
int launch(const Params& p, cudaStream_t stream) {
  const size_t ldq = p.dh + 1, ldv = p.dhv + 1;
  const size_t smem_dq = sizeof(float) * ((kBQ + BK) * (ldq + ldv) + kBQ * (BK + 1));
  const size_t smem_kv =
      sizeof(float) * ((kBQ + BK) * (ldq + ldv) + 2 * kBQ * (BK + 1) + 2 * kBQ);
  int e = set_smem(flash_bwd_dq_kernel<T, BK, NQ, NV>, smem_dq);
  if (e != 0) return e;
  e = set_smem(flash_bwd_dkdv_kernel<T, BK, NQ, NV>, smem_kv);
  if (e != 0) return e;
  const dim3 grid_q(static_cast<unsigned>((p.S + kBQ - 1) / kBQ),
                    static_cast<unsigned>(p.B * p.Hq));
  flash_bwd_dq_kernel<T, BK, NQ, NV><<<grid_q, kThreads, smem_dq, stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  const dim3 grid_k(static_cast<unsigned>((p.S + BK - 1) / BK),
                    static_cast<unsigned>(p.B * p.Hkv));
  flash_bwd_dkdv_kernel<T, BK, NQ, NV><<<grid_k, kThreads, smem_kv, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the smallest instantiation that holds dh and dhv
template <typename T>
int dispatch(const Params& p, cudaStream_t s) {
  if (p.dh <= 64 && p.dhv <= 64) return launch<T, 64, 4, 4>(p, s);
  if (p.dh <= 128 && p.dhv <= 128) return launch<T, 64, 8, 8>(p, s);
  if (p.dh <= 192 && p.dhv <= 128) return launch<T, 32, 12, 8>(p, s);
  return launch<T, 32, 16, 16>(p, s);
}

}  // namespace


// dtype 0 = fp32, 1 = bf16. lse and delta are (B * Hq, S) fp32 scratch.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    void* dq, void* dk, void* dv, float* lse, float* delta, int dtype, int B, int S,
    int Hq, int Hkv, int dh, int dhv, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    int64_t osb, int64_t oss, int64_t osh, int64_t gsb, int64_t gss, int64_t gsh,
    float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (dh < 1 || dh > kMaxHeadDim || dhv < 1 || dhv > kMaxHeadDim || Hkv < 1 ||
      Hq % Hkv != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv; p.lse = lse; p.delta = delta;
  p.B = B; p.S = S; p.Hq = Hq; p.Hkv = Hkv; p.dh = dh; p.dhv = dhv;
  p.lq = Layout{qsb, qss, qsh};
  p.lk = Layout{ksb, kss, ksh};
  p.lv = Layout{vsb, vss, vsh};
  p.lo = Layout{osb, oss, osh};
  p.ldo = Layout{gsb, gss, gsh};
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(p, s) : dispatch<__nv_bfloat16>(p, s);
}

// bf16 on the tensor cores: lse is the forward's (B * Hq, S) log-sum-exp in
// its log2 unit (flash_attention_fwd's), scratch 2 * B * Hq * Spad fp32 (Spad
// = S rounded up to 128) for the padded lse and D. q, k, v and dout as TMA
// reads them (base 16-byte aligned, strides multiples of 8 elements); o
// through its strides; dq, dk, dv contiguous. Returns the first CUDA error
// of the three launches (0 on success); an unsupported shape or a layout
// TMA refuses returns cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    void* dq, void* dk, void* dv, const float* lse, float* scratch, int B, int S, int Hq,
    int Hkv, int dh, int dhv, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t osb,
    int64_t oss, int64_t osh, int64_t gsb, int64_t gss, int64_t gsh, float scale,
    int causal, int window, void* stream) {
  return repro_kernels::flash_bwd_tc::entry<true>(
      q, k, v, o, dout, dq, dk, dv, lse, scratch, B, S, Hq, Hkv, dh, dhv, qsb, qss, qsh, ksb,
      kss, ksh, vsb, vss, vsh, osb, oss, osh, gsb, gss, gsh, scale, causal, window, stream);
}
