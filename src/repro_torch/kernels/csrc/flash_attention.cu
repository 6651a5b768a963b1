// Flash attention forward (causal / sliding-window, GQA) for Hopper, sm_90a:
// the attention of the LM prefill (models/layers.py attention_full).
//
// Replaces the Pallas kernel flash_attention
// (src/repro/kernels/flash_attention.py): q (B, S, Hq, dh), k (B, S, Hkv, dh),
// v (B, S, Hkv, dhv) -> o (B, S, Hq, dhv) in q's dtype. Query head h reads
// KV head h / (Hq / Hkv). Scores are (q * scale) . k in fp32; the mask keeps
// k_pos <= q_pos (causal) and q_pos - k_pos < window (window >= 1); masked
// scores are -1e30 and the online softmax carries (m, l, acc) in fp32 from
// m = -1e30, l = 0, as the TPU kernel does, so a row that sees no key comes
// out 0 (l floored at 1e-30). Inputs fp32 or bf16; dh, dhv <= 128.
//
// What bounds it: operations. At TinyLlama's prefill layer (B = 8, S = 2048,
// Hq = 32, Hkv = 4, dh = 64, causal) the two products are 1.37e11 flops over
// ~151 MB of q, k, v and o: 0.139 ms at the bf16 tensor-core peak, 0.045 ms
// of bytes. This kernel is the simple first port: fp32 FMA on the CUDA cores
// (the TPU kernel's fp32 arithmetic), no mma / wgmma, no TMA, so its ceiling
// is the 67 TFLOP/s fp32 rate (2.05 ms at that shape) and, below that, the
// shared-memory loads that feed the FMAs.
//
// Design: one block of 256 threads per (b * Hq + h, 64-row query tile); the
// grid walks query tiles last-first so the causal diagonal's longest tiles
// start first. The tile's queries, scaled, sit in shared memory as fp32; the
// block then loops over the 64-key tiles the mask can reach (under a causal
// mask none past the tile's last query, under a window none before its first
// query's window; the rest are skipped, like pl.when(tile_visible)), staging
// each K and V tile in shared memory as fp32. Thread (tr, tc) = (t / 16,
// t % 16) owns query rows tr + 16 i (i < 4), score columns tc + 16 j (j < 4)
// and output columns tc + 16 e: the 16 threads of a row are one half-warp,
// so row max and row sum are shuffles. P goes through shared memory into the
// P.V product. Q and K rows are padded to dh + 1 floats, so a half-warp
// reads 16 rows on 16 banks. The layout is read through element strides of
// (b, s, h) with the last dimension contiguous; o is written contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;
constexpr int kRows = 4;        // rows per thread: tr + 16 i
constexpr int kCols = 4;        // score columns per thread: tc + 16 j
constexpr int kLdP = kBK + 1;
constexpr float kNegInf = -1e30f;
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as a torch / jnp cast
}

// Reductions over the 16 threads of a row (one half-warp): xor offsets
// below 16 stay inside it, and every lane ends with the same bits.
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

// NE: output columns per thread, ceil(dhv / 16) rounded up to 4 or 8.
template <typename T, int NE>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Hq, int Hkv, int dh, int dhv, Layout lq, Layout lk,
                       Layout lv, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* Qs = smem;                 // kBQ x ld
  float* Ks = Qs + kBQ * ld;        // kBK x ld
  float* Vs = Ks + kBK * ld;        // kBK x dhv
  float* Ps = Vs + kBK * dhv;       // kBQ x kLdP

  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int t = threadIdx.x;
  const int tr = t >> 4;
  const int tc = t & 15;

  const T* qb = q + b * lq.b + h * lq.h;
  const T* kb = k + b * lk.b + hk * lk.h;
  const T* vb = v + b * lv.b + hk * lv.h;

  for (int idx = t; idx < kBQ * dh; idx += kThreads) {
    const int r = idx / dh;
    const int d = idx - r * dh;
    const int s = q0 + r;
    Qs[r * ld + d] = s < S ? to_f32(qb[s * lq.s + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NE];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }

  // the key tiles the mask can reach from queries q0 .. q_last
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_end = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  int kt_begin = 0;
  if (window > 0) {
    const int first_key = q0 - window + 1;   // q0 - k < window
    kt_begin = first_key > 0 ? first_key / kBK : 0;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the last tile's K, V and P are no longer read
    for (int idx = t; idx < kBK * dh; idx += kThreads) {
      const int r = idx / dh;
      const int d = idx - r * dh;
      const int s = k0 + r;
      Ks[r * ld + d] = s < S ? to_f32(kb[s * lk.s + d]) : 0.f;
    }
    for (int idx = t; idx < kBK * dhv; idx += kThreads) {
      const int r = idx / dhv;
      const int d = idx - r * dhv;
      const int s = k0 + r;
      Vs[idx] = s < S ? to_f32(vb[s * lv.s + d]) : 0.f;
    }
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
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(tr + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tc + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = tr + 16 * i;
      const int qp = q0 + r;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tc + 16 * j;
        ok[j] = kp < S && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
        if (!ok[j]) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[r * kLdP + tc + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows], vv[NE];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(tr + 16 * i) * kLdP + c];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int d = tc + 16 * e;
        vv[e] = d < dhv ? Vs[c * dhv + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

  T* ob = o + (static_cast<int64_t>(b) * S * Hq + h) * dhv;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + tr + 16 * i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = tc + 16 * e;
      if (d < dhv) ob[static_cast<int64_t>(s) * Hq * dhv + d] = from_f32<T>(acc[i][e] / denom);
    }
  }
}

template <typename T, int NE>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, int dh, int dhv, Layout lq, Layout lk, Layout lv,
           float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBQ + kBK) * (dh + 1) +
                       static_cast<size_t>(kBK) * dhv + static_cast<size_t>(kBQ) * kLdP);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, NE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B * Hq));
  flash_attention_kernel<T, NE><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Hq, Hkv, dh, dhv, lq, lk, lv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: element strides (b, s, h) each, head dimension contiguous; o
// (B, S, Hq, dhv) contiguous. dtype 0 = fp32, 1 = bf16 (all four tensors).
// window <= 0: no window. Returns the first CUDA error of the launch (0 on
// success); an unsupported shape returns cudaErrorInvalidValue.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B, int S,
    int Hq, int Hkv, int dh, int dhv, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (dh < 1 || dh > kMaxHeadDim || dhv < 1 || dhv > kMaxHeadDim || Hkv < 1 ||
      Hq % Hkv != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lq{qsb, qss, qsh}, lk{ksb, kss, ksh}, lv{vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = dhv > 64;
  if (dtype == 0) {
    return wide ? launch<float, 8>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, lq, lk, lv, scale, causal, window, s)
                : launch<float, 4>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, lq, lk, lv, scale, causal, window, s);
  }
  return wide ? launch<__nv_bfloat16, 8>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, lq, lk, lv, scale, causal, window, s)
              : launch<__nv_bfloat16, 4>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, lq, lk, lv, scale, causal, window, s);
}
