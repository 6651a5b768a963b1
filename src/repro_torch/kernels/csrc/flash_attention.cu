// Flash attention forward (causal / sliding-window, GQA) for Hopper, sm_90a:
// the attention of the LM prefill (models/layers.py attention_full).
//
// Replaces the Pallas kernel flash_attention
// (src/repro/kernels/flash_attention.py): q (B, S, Hq, dh), k (B, S, Hkv, dh),
// v (B, S, Hkv, dhv) -> o (B, S, Hq, dhv) in q's dtype. Query head h reads
// KV head h / (Hq / Hkv). Scores are q . k and scale in fp32 (the fp32
// kernel scales q first, the bf16 kernel the product); the mask keeps k_pos
// <= q_pos (causal) and q_pos - k_pos < window (window >= 1); masked pairs
// get p = 0 and the online softmax carries (m, l, acc) in fp32 from m =
// -1e30, l = 0, as the TPU kernel does, so a row that sees no key comes out
// 0 (l floored at 1e-30). Inputs fp32 or bf16; dh, dhv <= 256 (the TPU kernel
// takes the whole head dimension as one block).
//
// What bounds it: operations. At TinyLlama's prefill layer (B = 8, S = 2048,
// Hq = 32, Hkv = 4, dh = 64, causal) the two products are 1.37e11 flops over
// ~151 MB of q, k, v and o: 0.139 ms at the bf16 tensor-core peak, 0.045 ms
// of bytes. Two kernels live here, one per dtype.
//
// bf16: flash_attention_wgmma_kernel, on the tensor cores. One block per
// (b * Hq + h, query tile); blockIdx.x walks the heads and blockIdx.y the
// query tiles last-first, so the first wave holds the causal diagonal's
// longest tiles and neighbouring blocks share a KV head in L2. Warpgroup 0
// is the producer: one of its threads issues TMA loads (cp.async.bulk.tensor,
// 128-byte swizzle, completion on mbarriers) of the Q tile and of a ring of K
// / V stages of BN keys (3 stages when dh, dhv <= 64, else 2). The consumer
// warpgroups each own 64 query rows: two (384 threads, 128-row tiles) while
// dhv <= 128, one (256 threads, 64-row tiles) past it, where the O
// accumulator alone is 128 fp32 registers a thread: ptxas holds a 384-thread
// block to the launch's 168 registers, and two consumers at dhv = 256
// spilled and serialised the wgmma. BN is 128 while dh and dhv are at most
// 128; past that (Gemma3's 256, DeepSeek's 192 / 128) it is 64, so that Q and
// two stages fit the 227 KiB a block may have (160 KiB at 256 / 256, 128 KiB
// at 192 / 128). Per stage, each consumer:
//   S = Q . K^T   wgmma m64nBNk16, both operands K-major in shared memory,
//                 fp32 accumulators; then times scale * log2(e), so the
//                 softmax runs on ex2;
//   softmax       a row of the accumulator lives in one quad of lanes: row
//                 max is two shuffles. Only tiles that straddle the causal
//                 diagonal, the window edge or the ragged end take the
//                 masked body, a separate instantiation, so the others run
//                 none of its instructions; tiles a warpgroup cannot see are
//                 skipped;
//   O += P . V    wgmma with A from registers: the fp32 S fragment has the
//                 A fragment's layout, so P converts in place. P is split
//                 into hi = bf16(p) and lo = bf16(p - hi) and both go
//                 through the product (1.5x the tensor flops of one): P
//                 rounded to bf16 alone leaves outputs outside one bf16 ulp
//                 of the fp32 reference (tests/test_torch_kernels.py shows
//                 both), hi + lo keeps p to ~2^-17. A third part (p to
//                 ~2^-26) was tried at dhv = 256: it left as many outputs
//                 one bf16 ulp from the plain version's on the card and was
//                 slower, so two it is. V is B, MN-major, in its natural
//                 (keys, dhv) layout; no transpose.
// The consumers release a stage (one mbarrier arrival per warp) once both
// products have read it. The kernel is bound by the softmax's instructions
// (ex2 and the split of P), not by the tensor cores: the products of one
// warpgroup overlap the other's softmax (with one consumer, at dhv > 128,
// nothing overlaps them). Registers are the limit on doing more: a software
// pipeline that holds the next tile's scores beside P's hi and lo fragments
// spills. Phase 1 of chip_smoke.py prints each instantiation's spills.
// The TMA tensor maps describe q, k and v as (d, H, S, B) with the caller's
// strides, so the kernel reads the (b, s, h) layout in place; TMA's
// out-of-bounds zero fill pads d up to the instantiation's DH / DV (64, 128,
// 192 or 256) and fills the ragged S tail. Maps are encoded on the host
// through the runtime's driver entry point (no -lcuda) and passed as
// __grid_constant__ parameters. TMA needs a
// 16-byte-aligned base and strides that are multiples of 16 bytes; the
// Python wrapper copies an operand that breaks this. A barrier wait that
// never completes traps after ~10 s rather than hang the card. Hand-written
// PTX throughout (no CuTe), so the source builds in seconds.
//
// fp32: flash_attention_kernel, the first port's fp32 FMA kernel on the CUDA
// cores (the TPU kernel's fp32 arithmetic; ceiling the 67 TFLOP/s fp32 rate,
// 2.05 ms at the layer above). One block of 256 threads per (b * Hq + h,
// 64-row query tile); the grid walks query tiles last-first. The tile's
// queries, scaled, sit in shared memory as fp32; the block loops over the
// 64-key tiles the mask can reach (the rest are skipped, like
// pl.when(tile_visible)), staging each K and V tile in shared memory as
// fp32. Thread (tr, tc) = (t / 16, t % 16) owns query rows tr + 16 i (i <
// 4), score columns tc + 16 j (j < 4) and output columns tc + 16 e (e < NE,
// NE = 4, 8 or 16 for dhv <= 64, 128, 256): the 16
// threads of a row are one half-warp, so row max and row sum are shuffles. P
// goes through shared memory into the P.V product. Q and K rows are padded
// to dh + 1 floats, so a half-warp reads 16 rows on 16 banks. The layout is
// read through element strides of (b, s, h) with the last dimension
// contiguous; o is written contiguous. At dh = dhv = 256 its shared memory is
// 213,760 bytes (Q and K at 257 floats a row, V, P), under the 232,448 a
// block may opt in to.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is reached at run time
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
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// NE: output columns per thread, ceil(dhv / 16) rounded up to 4, 8 or 16.
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace {
namespace wg {

constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kSwizzleBytes = 128;   // one TMA box row: 64 bf16
constexpr float kNeg = -1e30f;

// A block's shape and its shared-memory layout, in bytes from a 1024-aligned
// base (the 128-byte swizzle repeats every 1024 bytes). A tile of R rows and
// D columns is D / 64 column blocks of R x 128 bytes, each one TMA box.
// kConsumers warpgroups of 64 query rows each follow the producer's: two, or
// one where DV is past 128 (a 256-thread block, 255 registers a thread). kBN
// keys a K / V stage: 128, or 64 where DH or DV is past 128.
template <int DH, int DV>
struct Smem {
  static constexpr int kConsumers = DV > 128 ? 1 : 2;
  static constexpr int kBM = 64 * kConsumers;          // query rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kBN = (DH > 128 || DV > 128) ? 64 : 128;
  static constexpr int kStages = (DH + DV <= 128) ? 3 : 2;
  static constexpr int kQBytes = kBM * DH * 2;
  static constexpr int kKBytes = kBN * DH * 2;
  static constexpr int kVBytes = kBN * DV * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBar = kV + kStages * kVBytes;   // full[], empty[], q
  static constexpr int kAlloc = kBar + (2 * kStages + 1) * 8 + 1024;
  static_assert(kAlloc <= 227 * 1024, "a block's shared memory is past 227 KiB");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity ``parity`` has completed. Traps after ~10 s
// (a lost arrival is a fault; trapping ends the launch with an error
// instead of hanging the card).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((spin & 1023u) == 0) {
      const uint64_t now = global_ns();
      if (spin == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// One box of a 4-d tensor map, coordinates (d, h, s, b), into shared memory;
// completion is counted on ``bar`` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (each >> 4), layout type 1 (128B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an in-flight wgmma reads or writes to this point of the
// program, so the compiler moves no access to them across a fence or wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

#define ACC8(i)                                                                  \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),           \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define OUT8(i)                                                                  \
  "=f"(d[(i)]), "=f"(d[(i) + 1]), "=f"(d[(i) + 2]), "=f"(d[(i) + 3]),           \
      "=f"(d[(i) + 4]), "=f"(d[(i) + 5]), "=f"(d[(i) + 6]), "=f"(d[(i) + 7])

// d (64 x 128, fp32) = a (64 x 16) . b (16 x 128) when ``first`` (d is only
// written), else d += a . b; a and b bf16 in shared memory, both K-major.
template <bool first>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (first) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : OUT8(0),
          OUT8(8),
          OUT8(16),
          OUT8(24),
          OUT8(32),
          OUT8(40),
          OUT8(48),
          OUT8(56)
        : "l"(da), "l"(db), "r"(0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : ACC8(0),
          ACC8(8),
          ACC8(16),
          ACC8(24),
          ACC8(32),
          ACC8(40),
          ACC8(48),
          ACC8(56)
        : "l"(da), "l"(db), "r"(1));
  }
}

// d (64 x 64, fp32) = a (64 x 16) . b (16 x 64) when ``first``, else d += a .
// b; a and b bf16 in shared memory, both K-major (the 64-key score tile).
template <bool first>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (first) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : OUT8(0),
          OUT8(8),
          OUT8(16),
          OUT8(24)
        : "l"(da), "l"(db), "r"(0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : ACC8(0),
          ACC8(8),
          ACC8(16),
          ACC8(24)
        : "l"(da), "l"(db), "r"(1));
  }
}

// d (64 x 64, fp32) += a (64 x 16, bf16 fragments in registers) . b (16 x 64,
// bf16 in shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0),
        ACC8(8),
        ACC8(16),
        ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += a (64 x 16, bf16 fragments in registers) . b (16 x 128,
// bf16 in shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0),
        ACC8(8),
        ACC8(16),
        ACC8(24),
        ACC8(32),
        ACC8(40),
        ACC8(48),
        ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += a (64 x 16, bf16 fragments in registers) . b (16 x 256,
// bf16 in shared memory, MN-major): O at dhv = 256, 128 registers a thread.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ACC8(0),
        ACC8(8),
        ACC8(16),
        ACC8(24),
        ACC8(32),
        ACC8(40),
        ACC8(48),
        ACC8(56),
        ACC8(64),
        ACC8(72),
        ACC8(80),
        ACC8(88),
        ACC8(96),
        ACC8(104),
        ACC8(112),
        ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8
#undef OUT8

template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(DV == 64 || DV == 128 || DV == 256, "DV is 64, 128 or 256");
  if constexpr (DV == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (DV == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

// S (64 x BN) = Q . K^T, one k16 step kk of DH / 16.
template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&s)[BN / 2], uint64_t dq, uint64_t dk,
                                         bool first) {
  static_assert(BN == 64 || BN == 128, "BN is 64 or 128");
  if constexpr (BN == 64) {
    if (first) wgmma_ss_n64<true>(s, dq, dk);
    else wgmma_ss_n64<false>(s, dq, dk);
  } else {
    if (first) wgmma_ss_n128<true>(s, dq, dk);
    else wgmma_ss_n128<false>(s, dq, dk);
  }
}

// The online softmax over one tile of scores s: this thread holds rows r =
// 0, 1 (row_q0, row_q0 + 8) at columns col0 + 8 (i / 4) + (i % 2) of the
// tile, i = 0 .. N - 1 (N = BN / 2), row r = (i / 2) % 2. Scores go to the log2 domain
// (times scale * log2(e)); with kMask, a score outside the row's visible
// columns [lo, hi] becomes -inf, so ex2 gives it p = 0 and it never sets
// the row max (m starts at -1e30, the TPU kernel's NEG_INF, so a row that
// has seen no key keeps it and its corr is 1). s becomes p in place; m and
// l advance; corr is the factor for the accumulator. The masked body is a
// template of its own so the unmasked tiles run none of its instructions.
template <bool kMask, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale_log2,
                                             const int* lo, const int* hi) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i] * scale_log2;
    if constexpr (kMask) {
      const int c = 8 * (i >> 2) + (i & 1);
      if (c < lo[r] || c > hi[r]) x = -INFINITY;
    }
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(s[i] - m[r]);
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// DH, DV: dh and dhv rounded up to an instantiation (TMA zero-fills the
// rest): <64 | 128, 64 | 128>, <192, 128>, <256, 256>.
template <int DH, int DV>
__global__ void __launch_bounds__(Smem<DH, DV>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv, int dhv,
                             float scale_log2, int causal, int window) {
  using L = Smem<DH, DV>;
  constexpr int kStages = L::kStages;
  constexpr int kBN = L::kBN, kBM = L::kBM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
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

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), L::kConsumerWarps);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full (a 256-thread block
    // has registers enough without moving them)
    if constexpr (L::kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int c = 0; c < DH / 64; ++c)
        tma_load(sQ + c * kBM * kSwizzleBytes, &tq, 64 * c, h, q0, b, q_full);
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int st = it % kStages;
        mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), L::kKBytes + L::kVBytes);
#pragma unroll
        for (int c = 0; c < DH / 64; ++c)
          tma_load(sK + st * L::kKBytes + c * kBN * kSwizzleBytes, &tk, 64 * c, hk, kt * kBN,
                   b, full(st));
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          tma_load(sV + st * L::kVBytes + c * kBN * kSwizzleBytes, &tv, 64 * c, hk, kt * kBN,
                   b, full(st));
      }
    }
  } else {
    if constexpr (L::kConsumers == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int t = threadIdx.x - 128;
    const int cw = t >> 7;                 // consumer warpgroup: query rows 64 cw ..
    const int warp = (t >> 5) & 3;         // its warp: 16 of them
    const int lane = t & 31;
    const int qa = q0 + 64 * cw;           // the warpgroup's first and last query
    const int qb = qa + 63;
    // this thread's rows: r = 0 -> row_q0, r = 1 -> row_q0 + 8; columns
    // 8 j + 2 (lane % 4) + {0, 1} of each n8 block j of an accumulator
    const int row_q0 = qa + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);

    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

    // Q: K-major, 8-row groups 1024 bytes apart (SBO); k16 step kk is 32
    // bytes into a 128-byte row, column block kk / 4
    const uint32_t q_rows = sQ + 64 * cw * kSwizzleBytes;
    mbar_wait(q_full, 0);

    for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
      const int st = it % kStages;
      const int k0 = kt * kBN;
      mbar_wait(full(st), (it / kStages) & 1);
      const bool live = qa < S && (!causal || k0 <= qb) &&
                        (window <= 0 || qa - (k0 + kBN - 1) < window);
      if (live) {
        float s[kBN / 2];
        const uint32_t k_rows = sK + st * L::kKBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t off = (kk >> 2) * kBM * kSwizzleBytes + (kk & 3) * 32;
          const uint32_t koff = (kk >> 2) * kBN * kSwizzleBytes + (kk & 3) * 32;
          const uint64_t dq = smem_desc(q_rows + off, 16, 1024);
          const uint64_t dk = smem_desc(k_rows + koff, 16, 1024);
          wgmma_qk<kBN>(s, dq, dk, kk == 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(s);

        // a tile some of whose pairs are masked takes the masked softmax
        float corr[2];
        if ((causal && k0 + kBN - 1 > qa) || (window > 0 && qb - k0 >= window) ||
            k0 + kBN > S) {
          int lo[2], hi[2];   // visible keys of each row, relative to k0 + col0
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int qp = row_q0 + 8 * r;
            lo[r] = (window > 0 ? qp - window + 1 : 0) - k0 - col0;
            hi[r] = (causal ? min(qp, S - 1) : S - 1) - k0 - col0;
          }
          softmax_tile<true>(s, m, l, corr, scale_log2, lo, hi);
        } else {
          softmax_tile<false>(s, m, l, corr, scale_log2, nullptr, nullptr);
        }
        constexpr int kSteps = kBN / 16;   // k16 steps of P . V
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

        // P as A fragments, hi and lo: k16 step kk is n8 blocks 2 kk and
        // 2 kk + 1 of S, i.e. registers 8 kk .. 8 kk + 7 in A's order
        uint32_t p_hi[kSteps][4], p_lo[kSteps][4];
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float a = s[8 * kk + 2 * j], c = s[8 * kk + 2 * j + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
            const float2 hf = __bfloat1622float2(hi);
            p_hi[kk][j] = bits(hi);
            p_lo[kk][j] = bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
          }

        // V: MN-major, keys 8-row groups 1024 bytes apart (SBO), column
        // blocks of 64 dhv kBN * 128 bytes apart (LBO); k16 step kk is 16
        // keys = 2048 bytes
        const uint32_t v_rows = sV + st * L::kVBytes;
        pin(acc);
        pin(p_hi);
        pin(p_lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const uint64_t dv = smem_desc(v_rows + kk * 16 * kSwizzleBytes,
                                        kBN * kSwizzleBytes, 1024);
          wgmma_pv<DV>(acc, p_hi[kk], dv);
          wgmma_pv<DV>(acc, p_lo[kk], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
        pin(p_hi);
        pin(p_lo);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int qp = row_q0 + 8 * r;
      if (qp >= S) continue;
      const float denom = fmaxf(lt, 1e-30f);
      __nv_bfloat16* orow = o + (static_cast<int64_t>(b) * S + qp) * Hq * dhv +
                            static_cast<int64_t>(h) * dhv;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int c = 8 * j + col0;
        const float v0 = acc[4 * j + 2 * r] / denom, v1 = acc[4 * j + 2 * r + 1] / denom;
        if (c + 1 < dhv && (dhv & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < dhv) orow[c] = __float2bfloat16(v0);
          if (c + 1 < dhv) orow[c + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (d, H, S, B) map over a bf16 tensor with element strides (sh, ss, sb),
// boxes of 64 x 1 x rows x 1, 128-byte swizzle, zero fill out of bounds.
bool encode(CUtensorMap* map, const void* ptr, int d, int H, int S, int B, int64_t sh,
            int64_t ss, int64_t sb, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encodes the maps (K and V boxes of the instantiation's kBN rows) and
// launches; a layout TMA refuses returns cudaErrorInvalidValue.
template <int DH, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Hq,
           int Hkv, int dh, int dhv, const int64_t (&ls)[9], float scale, int causal,
           int window, cudaStream_t stream) {
  using L = Smem<DH, DV>;
  constexpr int smem = L::kAlloc, bn = L::kBN, bm = L::kBM;
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, dh, Hq, S, B, ls[2], ls[1], ls[0], bm) ||
      !encode(&mk, k, dh, Hkv, S, B, ls[5], ls[4], ls[3], bn) ||
      !encode(&mv, v, dhv, Hkv, S, B, ls[8], ls[7], ls[6], bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<DH, DV>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(B * Hq), static_cast<unsigned>((S + bm - 1) / bm));
  flash_attention_wgmma_kernel<DH, DV><<<grid, L::kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, Hq, Hkv, dhv,
      scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace

// q, k, v: element strides (b, s, h) each, head dimension contiguous; o
// (B, S, Hq, dhv) contiguous. dtype 0 = fp32 (the FMA kernel), 1 = bf16 (the
// wgmma kernel; base 16-byte aligned, strides multiples of 8 elements).
// window <= 0: no window. Returns the first CUDA error of the launch (0 on
// success); an unsupported shape, or a layout TMA refuses, returns
// cudaErrorInvalidValue.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B, int S,
    int Hq, int Hkv, int dh, int dhv, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (dh < 1 || dh > kMaxHeadDim || dhv < 1 || dhv > kMaxHeadDim || Hkv < 1 ||
      Hq % Hkv != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Layout lq{qsb, qss, qsh}, lk{ksb, kss, ksh}, lv{vsb, vss, vsh};
    if (dhv > 128)
      return launch<float, 16>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, lq, lk, lv, scale, causal, window, s);
    return dhv > 64
               ? launch<float, 8>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, lq, lk, lv, scale, causal, window, s)
               : launch<float, 4>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, lq, lk, lv, scale, causal, window, s);
  }
  // the smallest instantiation that holds dh and dhv
  const int64_t ls[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  if (dh > 192 || dhv > 128)
    return wg::launch<256, 256>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, ls, scale, causal, window, s);
  if (dh > 128)
    return wg::launch<192, 128>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, ls, scale, causal, window, s);
  const bool wide_k = dh > 64, wide_v = dhv > 64;
  if (wide_k)
    return wide_v ? wg::launch<128, 128>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, ls, scale, causal, window, s)
                  : wg::launch<128, 64>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, ls, scale, causal, window, s);
  return wide_v ? wg::launch<64, 128>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, ls, scale, causal, window, s)
                : wg::launch<64, 64>(q, k, v, o, B, S, Hq, Hkv, dh, dhv, ls, scale, causal, window, s);
}
