// Fused PQ code gather + ADC score + visited-bitmap mask for Hopper, sm_90a:
// the compressed (pq) scorer's beam-search inner loop.
//
// Replaces the Pallas kernel gather_adc_masked
// (src/repro/kernels/gather_adc.py). For each query row q and each id in
// ids[q, :], gather the M-byte code row codes[id] and score it against the
// query's (M, K) lookup table: sum_m luts[q, m, codes[id, m]], summed
// m = 0..M-1 from 0.0, one add at a time (kernels/ref.py sums in the same
// order, so the two agree to the last bit). Padding ids (< 0) and ids whose
// bit is set in the query's visited row give (+inf, -1); ids past n - 1
// read row n - 1. The TPU kernel's one-hot matmuls stand in for a per-lane
// gather the TPU lacks; here the LUT is indexed directly.
//
// What bounds it: bytes. A scored id costs one random M-byte code row (8 B
// at M = 8), one visited word and M LUT entries (4 B each; 32 B each at
// sector granularity). At the hop shape (Q = 64, R = 20, M = 8, K = 256) a
// query's at most 20 ids touch at most 160 of its LUT's 2,048 entries, so
// the call must move a few tens of KB: its bound is nanoseconds, and its
// time is the launch and the chain of dependent loads.
//
// Two kernels, one thread per (query, id) flattened over Q * R (a hop's
// 1,280 pairs are five blocks), neither staging the LUTs in shared memory:
// a hop reads at most 160 of a query's 2,048 entries, so every entry comes
// through the read-only cache (L2 holds every LUT of the batch). With
// M % 8 == 0 and an 8-byte aligned table the code row is read in 8-byte
// loads, else byte by byte; the M LUT loads of a row are in flight
// together.
//   - gather_adc_hop_kernel, the hop: a padding id stores (+inf, -1) at
//     once; otherwise the visited word goes out with the code row and its
//     bit is read last, at the store, so the chain is id -> (codes,
//     visited) -> LUT -> store, three loads deep.
//   - gather_adc_kernel, the generic one: the mask guards the code loads
//     (id -> visited -> codes -> LUT -> store, four deep). No path of the
//     port runs it: it is the hop kernel's yardstick, bit for bit and in
//     time (gather_adc.gather_adc_masked_generic).
// An 8-lane group a pair (the exact hop's layout, the entries gathered by
// shuffle) took longer than either on the H100 (PERF.md).

#include "common.cuh"

namespace {

using namespace repro_kernels;

constexpr int kThreads = 256;

template <bool VEC8>
__device__ __forceinline__ float adc_row(const uint8_t* __restrict__ row,
                                         const float* __restrict__ lut, int M,
                                         int K) {
  float acc = 0.f;
  if (VEC8) {
    const uint2* words = reinterpret_cast<const uint2*>(row);
    for (int c = 0; c < (M >> 3); ++c) {
      const uint2 v = __ldg(words + c);
      const float* l = lut + static_cast<int64_t>(8 * c) * K;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const uint32_t word = b < 4 ? v.x : v.y;
        const uint32_t code = (word >> (8 * (b & 3))) & 0xffu;
        acc += __ldg(l + b * K + code);
      }
    }
  } else {
    for (int m = 0; m < M; ++m) acc += __ldg(lut + m * K + __ldg(row + m));
  }
  return acc;
}

template <bool VEC8>
__global__ void __launch_bounds__(kThreads)
gather_adc_kernel(const int32_t* __restrict__ ids,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ luts,
                  const int32_t* __restrict__ visited,
                  float* __restrict__ out_d, int32_t* __restrict__ out_i,
                  int64_t total, int R, int n, int M, int K, int W) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= total) return;
  const int64_t q = o / R;
  const int32_t id = ids[o];
  const bool drop = id < 0 || is_visited(visited + q * W, W, id);
  float dist = INFINITY;
  if (!drop) {
    const uint8_t* row = codes + static_cast<int64_t>(min(id, n - 1)) * M;
    dist = adc_row<VEC8>(row, luts + q * M * K, M, K);
  }
  out_d[o] = dist;
  out_i[o] = drop ? -1 : id;
}

template <bool VEC8>
__global__ void __launch_bounds__(kThreads)
gather_adc_hop_kernel(const int32_t* __restrict__ ids,
                      const uint8_t* __restrict__ codes,
                      const float* __restrict__ luts,
                      const int32_t* __restrict__ visited,
                      float* __restrict__ out_d, int32_t* __restrict__ out_i,
                      int64_t total, int R, int n, int M, int K, int W) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= total) return;
  const int64_t q = o / R;
  const int32_t id = __ldg(ids + o);
  if (id < 0) {                    // a padding slot
    out_d[o] = INFINITY;
    out_i[o] = -1;
    return;
  }
  // the visited word goes out with the code row; its bit is read last
  const uint32_t word = static_cast<uint32_t>(__ldg(visited + q * W + min(id >> 5, W - 1)));
  const float dist = adc_row<VEC8>(codes + static_cast<int64_t>(min(id, n - 1)) * M,
                                   luts + q * M * K, M, K);
  const bool seen = ((word >> (id & 31)) & 1u) != 0u;
  out_d[o] = seen ? INFINITY : dist;
  out_i[o] = seen ? -1 : id;
}

}  // namespace

// ids (Q, R) i32, codes (n, M) u8, luts (Q, M, K) f32, visited (Q, W) i32
// -> out_d (Q, R) f32, out_i (Q, R) i32. All contiguous, on one device;
// vec8 needs M % 8 == 0 and an 8-byte aligned codes pointer; hop 1 runs
// the hop kernel, 0 the generic one (the same bits). Returns
// cudaGetLastError() after the launch.
extern "C" int gather_adc_f32(const int32_t* ids, const uint8_t* codes,
                              const float* luts, const int32_t* visited,
                              float* out_d, int32_t* out_i, int Q, int R, int n,
                              int M, int K, int W, int vec8, int hop, void* stream) {
  const int64_t total = static_cast<int64_t>(Q) * R;
  if (total > 0) {
    const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto kernel = hop ? (vec8 ? gather_adc_hop_kernel<true> : gather_adc_hop_kernel<false>)
                      : (vec8 ? gather_adc_kernel<true> : gather_adc_kernel<false>);
    kernel<<<grid, kThreads, 0, s>>>(ids, codes, luts, visited, out_d, out_i, total, R, n, M,
                                     K, W);
  }
  return static_cast<int>(cudaGetLastError());
}
