// Dense PQ asymmetric-distance scan for Hopper, sm_90a: the PQ baseline's
// linear scan (baselines/pq.py pq_search).
//
// Replaces the Pallas kernel pq_adc (src/repro/kernels/pq_adc.py), whose
// vmap over queries becomes a written-out batch dimension: codes (n, M)
// uint8 against Q lookup tables (Q, M, K) -> scores (Q, n),
// score[q, i] = sum_m luts[q, m, codes[i, m]], summed m = 0..M-1 from 0.0,
// one add at a time (kernels/ref.py sums in the same order, so the two
// agree to the last bit). A single LUT is Q = 1. The TPU kernel's one-hot
// matmuls stand in for a per-lane gather the TPU lacks; here the LUT is
// indexed directly in shared memory.
//
// What bounds it: bytes, then shared memory. At n = 1M, Q = 512, M = 8 the
// (Q, n) f32 scores are 2.05 GB of the ~2.06 GB a pass must move (codes 8
// MB, LUTs 4.2 MB): 0.615 ms at 3.35 TB/s. Each score also costs M
// shared-memory lookups at data-dependent addresses: 4.1e9 at that shape,
// 1.28e8 warp loads, 0.49-0.55 ms over 132 SMs if every warp load is one
// wavefront (one access to each of the 32 banks).
//
// Two kernels:
//   - pq_adc_interleaved_kernel, where Q >= 16 and the LUTs fit: lanes run
//     over queries. A block stages the LUTs of 16 queries interleaved
//     query-minor, entry (c, m, q) at (c * M + m) * 16 + q, and a warp's
//     two half-warps score two streams of code rows, lane q of a half
//     against query q. A lookup of a half reads 16 consecutive words, so
//     the half hits 16 banks; half 1 runs one m behind half 0 (its codes
//     shifted one byte along the row stream, its m-th add one slot later),
//     so at each load the halves read m of opposite parity and sit in
//     opposite halves of the banks: every warp lookup is one wavefront,
//     whatever the codes. Each (query, row) is still one add chain from
//     0.0 in m order. A warp scores tiles of 64 rows (32 a half); their
//     code rows come in by cp.async into a per-warp double buffer, the
//     next tile's copies in flight while the current one is scored (half
//     1's rows 16 bytes past half 0's, so a code load is one wavefront).
//     The scores leave through a per-warp transpose in shared memory (rows
//     of 66 floats: the stores of a lookup step fall in 32 banks) as
//     256-byte runs of one query's row, streamed past L2's keep. The grid
//     is persistent: one block an SM, the 16-query groups of one row range
//     side by side, so a code row read from HBM is reread from L2.
//     M = 4, 8 or 16 (codes read as 32-bit words), a 4-byte aligned code
//     table. On the H100 the lookups alone and the score stores alone each
//     take most of a pass, and the two overlap only in part (PERF.md).
//   - pq_adc_kernel, the generic one (the route of a single LUT, Q < 16, an
//     M the interleaved kernel does not take, or LUTs past shared memory)
//     and the interleaved kernel's yardstick: a block stages the LUTs of up
//     to ``qb`` queries (qb * M * K * 4 bytes), one code row a thread held
//     in registers for M = 8 and scored against every staged query. A
//     warp's 32 lanes look up 32 rows' codes in one query's LUT segment, a
//     multiple of 32 words, so a lane's bank is its code mod 32: 3.15
//     wavefronts a warp lookup on uniform codes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using namespace repro_kernels;

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;

// Codes of one row in registers: MT = 8 (compile-time M).
template <int MT>
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ row,
                                           bool vec8, uint32_t (&c)[MT]) {
  if (vec8) {
    const uint2* words = reinterpret_cast<const uint2*>(row);
#pragma unroll
    for (int w = 0; w < MT / 8; ++w) {
      const uint2 v = __ldg(words + w);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        c[8 * w + b] = ((b < 4 ? v.x : v.y) >> (8 * (b & 3))) & 0xffu;
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m) c[m] = __ldg(row + m);
  }
}

// MT = 8 holds the codes in registers; MT = 0 reads them per query
// (runtime M, through L1).
template <int MT>
__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ luts,
              float* __restrict__ out, int Q, int n, int M, int K, int qb,
              int vec8) {
  extern __shared__ float lut_s[];
  const int q0 = blockIdx.y * qb;
  const int qn = min(qb, Q - q0);
  const int64_t lut_len = static_cast<int64_t>(M) * K;
  const float* src = luts + q0 * lut_len;
  for (int64_t j = threadIdx.x; j < qn * lut_len; j += kThreads) lut_s[j] = src[j];
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int64_t i = row0 + t * kThreads + threadIdx.x;
    if (i >= n) break;
    const uint8_t* row = codes + i * M;
    if constexpr (MT > 0) {
      uint32_t c[MT];
      load_codes<MT>(row, vec8 != 0, c);
      for (int q = 0; q < qn; ++q) {
        const float* l = lut_s + q * lut_len;
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) acc += l[m * K + c[m]];
        out[static_cast<int64_t>(q0 + q) * n + i] = acc;
      }
    } else {
      for (int q = 0; q < qn; ++q) {
        const float* l = lut_s + q * lut_len;
        float acc = 0.f;
        for (int m = 0; m < M; ++m) acc += l[m * K + __ldg(row + m)];
        out[static_cast<int64_t>(q0 + q) * n + i] = acc;
      }
    }
  }
}

template <int MT>
int launch(const uint8_t* codes, const float* luts, float* out, int Q, int n,
           int M, int K, int qb, int vec8, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(qb) * M * K * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_adc_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock),
                  static_cast<unsigned>((Q + qb - 1) / qb));
  pq_adc_kernel<MT><<<grid, kThreads, smem, stream>>>(codes, luts, out, Q, n, M,
                                                      K, qb, vec8);
  return static_cast<int>(cudaGetLastError());
}

// ---- the interleaved kernel -------------------------------------------------

constexpr int kQB = 16;                      // queries a block: a half-warp's lanes
constexpr int kScanWarps = 16;
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kHalfRows = 32;                // rows a half-warp scores a tile
constexpr int kTileRows = 2 * kHalfRows;
constexpr int kOutStride = kTileRows + 2;    // a query's row of the transpose; == 2 mod 32
constexpr int kHalfGap = 16;                 // bytes between the halves' code rows

// Shared memory of a block: the interleaved LUTs, then per warp its
// transpose and its two code buffers (kernels/pq_adc.py scan_smem_bytes
// repeats this sum to route).
__host__ __device__ constexpr int code_buffer_bytes(int M) { return kTileRows * M + kHalfGap; }

__host__ __device__ constexpr size_t scan_smem_bytes(int M, int K) {
  return static_cast<size_t>(M) * K * kQB * sizeof(float) +
         kScanWarps * (static_cast<size_t>(kQB) * kOutStride * sizeof(float) +
                       2 * code_buffer_bytes(M));
}

// The code rows of tile rows [row0, row0 + 64) into ``buf``: half 0's 32
// rows, kHalfGap bytes, half 1's; 16-byte copies from a 16-byte aligned
// table, else 4-byte. Rows past n read as code 0.
template <int MT, int BYTES>
__device__ __forceinline__ void copy_codes_by(uint8_t* buf, const uint8_t* __restrict__ codes,
                                              int64_t row0, int n, int lane) {
  const int64_t start = row0 * MT;
  const int64_t total = static_cast<int64_t>(n) * MT;
  for (int off = lane * BYTES; off < kTileRows * MT; off += 32 * BYTES) {
    const int64_t left = total - (start + off);
    const int src_bytes = left >= BYTES ? BYTES : (left > 0 ? static_cast<int>(left) : 0);
    cp_async<BYTES>(buf + off + (off >= kHalfRows * MT ? kHalfGap : 0),
                    src_bytes > 0 ? codes + start + off : codes, src_bytes);
  }
}

template <int MT>
__device__ __forceinline__ void copy_codes(uint8_t* buf, const uint8_t* __restrict__ codes,
                                           int64_t row0, int n, int lane, bool copy16) {
  if (copy16) {
    copy_codes_by<MT, 16>(buf, codes, row0, n, lane);
  } else {
    copy_codes_by<MT, 4>(buf, codes, row0, n, lane);
  }
}

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// One tile of a warp: the scores of its 64 rows against the block's 16
// queries into the warp's transpose ``tq`` (this lane's query row, offset
// so that half h writes row h * 32 + j at column h * 32 + j). A lookup is
// a byte extract, one multiply-add onto the slot's shared address (the
// shared window's base folded in once: left to the compiler, it added it
// per lookup) and the load.
template <int MT>
__device__ __forceinline__ void score_tile(const float* lut_s, const uint8_t* cb, float* tq,
                                           int q, int h) {
  constexpr int kWords = MT / 4;
  constexpr int kRowsPerLoad = 16 / MT;       // code rows a 16-byte shared load brings
  constexpr int kCodeBytes = MT * kQB * 4;    // bytes between codes c and c + 1
  const uint8_t* rows = cb + h * (kHalfRows * MT + kHalfGap);
  const int shift = 8 * h;                    // half 1's code stream runs one byte late
  // slot k's entry of code c at c * kCodeBytes + at[k]: half 1 adds m = k - 1,
  // and at slot 0 m = M - 1 of its last row
  uint32_t at[MT];
  const uint32_t lut_addr = static_cast<uint32_t>(__cvta_generic_to_shared(lut_s));
#pragma unroll
  for (int k = 0; k < MT; ++k) {
    const int m = h ? (k == 0 ? MT - 1 : k - 1) : k;
    at[k] = lut_addr + 4u * static_cast<uint32_t>(m * kQB + q);
  }
  uint32_t prev = 0u;                         // last code word of the lane's previous row
  float acc = 0.f;
#pragma unroll 2
  for (int j = 0; j < kHalfRows; j += kRowsPerLoad) {
    const uint4 v = *reinterpret_cast<const uint4*>(rows + j * MT);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < kRowsPerLoad; ++r) {
      uint32_t s[kWords];
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        s[i] = __funnelshift_l(i == 0 ? prev : w[r * kWords + i - 1], w[r * kWords + i], shift);
      }
      prev = w[r * kWords + kWords - 1];
      float e[MT];
#pragma unroll
      for (int k = 0; k < MT; ++k) {
        e[k] = ld_shared(__byte_perm(s[k >> 2], 0u, 0x4440u | (k & 3)) * kCodeBytes + at[k]);
      }
      const float done = (h ? acc : 0.f) + e[0];   // half 1: its last row's sum
      float a = (h ? 0.f : done) + e[1];
#pragma unroll
      for (int k = 2; k < MT; ++k) a += e[k];
      acc = a;
      // half 1's store at j = 0 lands on half 0's column 31, which half 0
      // writes again at j = 31
      tq[j + r] = h ? done : a;
    }
  }
  if (h) tq[kHalfRows] = acc + ld_shared((prev >> 24) * kCodeBytes + at[0]);
}

// copy16: 16-byte code copies; lut4: float4 LUT loads (K % 4 == 0, a
// 16-byte aligned LUT); out2: float2 score stores (n even).
template <int MT>
__global__ void __launch_bounds__(kScanThreads, 1)
pq_adc_interleaved_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ luts,
                          float* __restrict__ out, int Q, int n, int K, int groups, int copy16,
                          int lut4, int out2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = lane & 15;
  const int h = lane >> 4;
  float* tbuf = lut_s + static_cast<size_t>(MT) * K * kQB + warp * kQB * kOutStride;
  uint8_t* cbuf = reinterpret_cast<uint8_t*>(lut_s + static_cast<size_t>(MT) * K * kQB +
                                             kScanWarps * kQB * kOutStride) +
                  warp * 2 * code_buffer_bytes(MT);
  const int g = blockIdx.x % groups;
  const int part = blockIdx.x / groups;
  const int parts = gridDim.x / groups;
  const int q0 = g * kQB;
  const int qn = min(kQB, Q - q0);
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int stride = parts * kScanWarps;
  int t = part * kScanWarps + warp;

  if (t < tiles) copy_codes<MT>(cbuf, codes, static_cast<int64_t>(t) * kTileRows, n, lane, copy16);
  cp_async_commit();

  // the LUTs, entry (c, m, q) at (c * M + m) * 16 + q: lane (q, h) takes
  // m = 2p + h, so a warp's stores fill the 32 banks
  const bool have_q = q < qn;
  const float* lq = luts + static_cast<int64_t>(q0 + (have_q ? q : 0)) * MT * K;
  if (lut4) {
    const int k4 = K / 4;
    for (int it = warp; it < (MT / 2) * k4; it += kScanWarps) {
      const int m = 2 * (it / k4) + h;
      const int c = 4 * (it % k4);
      const float4 v = have_q ? __ldg(reinterpret_cast<const float4*>(lq + m * K + c))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      lut_s[((c + 0) * MT + m) * kQB + q] = v.x;
      lut_s[((c + 1) * MT + m) * kQB + q] = v.y;
      lut_s[((c + 2) * MT + m) * kQB + q] = v.z;
      lut_s[((c + 3) * MT + m) * kQB + q] = v.w;
    }
  } else {
    for (int it = warp; it < (MT / 2) * K; it += kScanWarps) {
      const int m = 2 * (it / K) + h;
      const int c = it % K;
      lut_s[(c * MT + m) * kQB + q] = have_q ? __ldg(lq + m * K + c) : 0.f;
    }
  }
  __syncthreads();

  float* tq = tbuf + q * kOutStride + h * (kHalfRows - 1);
  for (int b = 0; t < tiles; t += stride, b ^= 1) {
    const int next = t + stride;
    if (next < tiles) {
      copy_codes<MT>(cbuf + (b ^ 1) * code_buffer_bytes(MT), codes,
                     static_cast<int64_t>(next) * kTileRows, n, lane, copy16);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncwarp();
    score_tile<MT>(lut_s, cbuf + b * code_buffer_bytes(MT), tq, q, h);
    __syncwarp();

    // the transpose out, 256-byte runs of one query's row (128-byte where
    // n is odd), rows past n dropped
    const int64_t row0 = static_cast<int64_t>(t) * kTileRows;
    if (out2) {
#pragma unroll 4
      for (int i = lane; i < qn * kHalfRows; i += 32) {
        const int j = i / kHalfRows;
        const int c = 2 * (i % kHalfRows);
        if (row0 + c < n) {
          __stcs(reinterpret_cast<float2*>(out + static_cast<int64_t>(q0 + j) * n + row0 + c),
                 *reinterpret_cast<const float2*>(tbuf + j * kOutStride + c));
        }
      }
    } else {
      for (int i = lane; i < qn * kTileRows; i += 32) {
        const int j = i / kTileRows;
        const int c = i % kTileRows;
        if (row0 + c < n) __stcs(out + static_cast<int64_t>(q0 + j) * n + row0 + c,
                                 tbuf[j * kOutStride + c]);
      }
    }
    __syncwarp();
  }
}

template <int MT>
int launch_interleaved(const uint8_t* codes, const float* luts, float* out, int Q, int n,
                       int K, int parts, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(MT, K);
  const cudaError_t e = cudaFuncSetAttribute(pq_adc_interleaved_kernel<MT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = (Q + kQB - 1) / kQB;
  const int copy16 = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const int lut4 = K % 4 == 0 && (reinterpret_cast<uintptr_t>(luts) & 15) == 0;
  pq_adc_interleaved_kernel<MT><<<static_cast<unsigned>(groups) * parts, kScanThreads, smem,
                                  stream>>>(codes, luts, out, Q, n, K, groups, copy16, lut4,
                                            n % 2 == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The generic kernel: codes (n, M) u8, luts (Q, M, K) f32 -> out (Q, n)
// f32. All contiguous, on one device; qb queries share a block (qb * M * K
// * 4 bytes of shared memory); vec8 needs M % 8 == 0 and an 8-byte aligned
// codes pointer. Returns the first CUDA error of the launch (0 on success).
extern "C" int pq_adc_f32(const uint8_t* codes, const float* luts, float* out,
                          int Q, int n, int M, int K, int qb, int vec8,
                          void* stream) {
  if (Q <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 8) return launch<8>(codes, luts, out, Q, n, M, K, qb, vec8, s);
  return launch<0>(codes, luts, out, Q, n, M, K, qb, vec8, s);
}

// The interleaved kernel: the arguments and output of pq_adc_f32, which
// gives the same bits; M = 4, 8 or 16, a 4-byte aligned codes pointer,
// ``parts`` blocks for each group of 16 queries (the grid is groups *
// parts blocks). Returns the first CUDA error of the launch (0 on
// success), or cudaErrorInvalidValue for an M it does not take.
extern "C" int pq_adc_interleaved_f32(const uint8_t* codes, const float* luts, float* out,
                                      int Q, int n, int M, int K, int parts, void* stream) {
  if (Q <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 4:
      return launch_interleaved<4>(codes, luts, out, Q, n, K, parts, s);
    case 8:
      return launch_interleaved<8>(codes, luts, out, Q, n, K, parts, s);
    case 16:
      return launch_interleaved<16>(codes, luts, out, Q, n, K, parts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
