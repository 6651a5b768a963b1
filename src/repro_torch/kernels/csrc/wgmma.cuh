// Hopper building blocks of the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu): mbarriers, TMA tile and bulk loads, named
// barriers, wgmma shared-memory descriptors for 128-byte-swizzled operands
// and the wgmma products (SS: both operands in shared memory; RS: A from
// registers), and the host-side tensor-map encoder. Hand-written PTX, so a
// source that includes this builds in seconds. sm_90a only (wgmma).
//
// Tiles are what TMA writes with the 128-byte swizzle: a tile of R rows and
// D columns (bf16) is D / 64 column blocks of R x 128 bytes, each one TMA
// box, from a 1024-aligned base. As a K-major operand (K along the row) a
// k16 step kk starts (kk / 4) column blocks and (kk % 4) * 32 bytes in, 8-row
// groups 1024 bytes apart (SBO); as an MN-major operand (K along the rows) a
// k16 step is 16 rows = 2048 bytes in, 64-column blocks R * 128 bytes apart
// (LBO). One tile serves both views.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_kernels {
namespace hopper {

constexpr int kSwizzleBytes = 128;   // one TMA box row: 64 bf16

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

// One k16 step of d (64 x N) = a . b^T, both K-major in shared memory (the
// forward's S = Q K^T; the backward's S, dP and their transposes); ``first``
// writes d, else adds to it.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         bool first) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  if constexpr (N == 64) {
    if (first) wgmma_ss_n64<true>(d, da, db);
    else wgmma_ss_n64<false>(d, da, db);
  } else {
    if (first) wgmma_ss_n128<true>(d, da, db);
    else wgmma_ss_n128<false>(d, da, db);
  }
}

// One contiguous run of ``bytes`` (a multiple of 16, 16-byte aligned at both
// ends) from global into shared memory; completion counted on ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Named barriers (ids 1..15; 0 is __syncthreads): ``sync`` waits until
// ``n`` threads have arrived or synced on ``id``, ``arrive`` counts this
// warp without waiting. The pair orders shared-memory stores before the
// arrival against loads after the sync.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// d (64 x N, fp32) += a (64 x 16, bf16 fragments in registers) . b (16 x N),
// b MN-major in shared memory from ``b_addr`` (the k16 step's first row):
// 64-column blocks ``lbo`` bytes apart, 8-row groups 1024 bytes apart. N =
// 192 runs as n128 over column blocks 0-1 and n64 over block 2: the
// accumulator's registers are the two fragments end to end.
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint32_t b_addr, uint32_t lbo) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "N is 64, 128, 192 or 256");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, smem_desc(b_addr, lbo, 1024));
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, smem_desc(b_addr, lbo, 1024));
  } else if constexpr (N == 256) {
    wgmma_rs_n256(d, a, smem_desc(b_addr, lbo, 1024));
  } else {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, smem_desc(b_addr, lbo, 1024));
    wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(&d[64]), a,
                 smem_desc(b_addr + 2 * lbo, lbo, 1024));
  }
}

// An fp32 accumulator fragment (64 x 16 k16 steps of it) as bf16 A fragments:
// k16 step kk is n8 blocks 2 kk and 2 kk + 1, registers 8 kk .. 8 kk + 7 in
// A's order. With ``lo``, also the remainder x - bf16(x) rounded to bf16, so
// hi + lo keeps x to ~2^-17.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&s)[N], uint32_t (&hi)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hi[kk][j] = bits(__floats2bfloat162_rn(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]));
}
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&s)[N], uint32_t (&hi)[N / 8][4],
                                           uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = s[8 * kk + 2 * j], c = s[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][j] = bits(h);
      lo[kk][j] = bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
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
inline bool encode(CUtensorMap* map, const void* ptr, int d, int H, int S, int B, int64_t sh,
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

}  // namespace hopper
}  // namespace repro_kernels
