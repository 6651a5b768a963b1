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
// What bounds it: bytes. At n = 1M, Q = 512, M = 8 the (Q, n) f32 scores
// are 2.05 GB of the ~2.06 GB the scan must move (codes 8 MB, LUTs 4.2 MB);
// the M shared-memory lookups per score are the other cost.
//
// Design: a block stages the LUTs of up to ``qb`` queries in shared memory
// (qb * M * K * 4 bytes: 64 KB for 8 queries at M = 8, K = 256; dynamic
// shared memory above 48 KB). Its threads walk a tile of code rows, one row
// per thread at a time: the row is read once (8-byte loads where M % 8 == 0
// and the table is 8-byte aligned), its codes held in registers for M = 8
// (the served M; any other M reads its codes per query through L1), and
// scored against every staged query; neighbouring threads write
// neighbouring scores of one query row. gridDim.y runs over query groups.

#include "common.cuh"

namespace {

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

}  // namespace

// codes (n, M) u8, luts (Q, M, K) f32 -> out (Q, n) f32. All contiguous, on
// one device; qb queries share a block (qb * M * K * 4 bytes of shared
// memory); vec8 needs M % 8 == 0 and an 8-byte aligned codes pointer.
// Returns the first CUDA error of the launch (0 on success).
extern "C" int pq_adc_f32(const uint8_t* codes, const float* luts, float* out,
                          int Q, int n, int M, int K, int qb, int vec8,
                          void* stream) {
  if (Q <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 8) return launch<8>(codes, luts, out, Q, n, M, K, qb, vec8, s);
  return launch<0>(codes, luts, out, Q, n, M, K, qb, vec8, s);
}
