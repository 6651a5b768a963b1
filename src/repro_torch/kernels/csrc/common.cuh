// Pieces shared by the gather kernels: the metric codes, the warp sum, the
// visited-bitmap test of the mask epilogue, and the distance epilogue.
//
// The visited bitmap is (Q, ceil(n/32)) int32 words holding the reference's
// uint32 bits; a word is read as int32 and shifted unsigned, so bit 31 is
// tested like any other. Ids past the last word read the last word, as the
// reference's clamped gather does.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_kernels {

enum Metric { kL2 = 0, kIp = 1, kCos = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// True when ``id`` (>= 0) has its bit set in ``visited_row`` (W words).
__device__ __forceinline__ bool is_visited(const int32_t* __restrict__ visited_row,
                                           int W, int32_t id) {
  const int w = min(id >> 5, W - 1);
  const uint32_t word = static_cast<uint32_t>(visited_row[w]);
  return ((word >> (id & 31)) & 1u) != 0u;
}

// One term of the row reduction: x is the row's value, y the query's.
template <int METRIC>
__device__ __forceinline__ void accumulate(float x, float y, float& acc, float& rr) {
  if (METRIC == kL2) {
    const float df = x - y;
    acc = fmaf(df, df, acc);
  } else {
    acc = fmaf(x, y, acc);
    if (METRIC == kCos) rr = fmaf(x, x, rr);
  }
}

// The distance from the reduced sums (acc: squared diff or dot; rr: the
// row's squared norm; qq: the query's), cos with both norms clamped at
// 1e-12 as the reference's rsqrt form.
template <int METRIC>
__device__ __forceinline__ float finish_distance(float acc, float rr, float qq) {
  if (METRIC == kL2) return acc;
  if (METRIC == kIp) return -acc;
  return 1.f - acc * rsqrtf(fmaxf(qq, 1e-12f)) * rsqrtf(fmaxf(rr, 1e-12f));
}

}  // namespace repro_kernels
