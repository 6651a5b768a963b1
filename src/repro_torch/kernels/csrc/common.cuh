// Pieces shared by the gather kernels: the metric codes, the warp sum, the
// visited-bitmap test of the mask epilogue, the distance epilogue, and the
// 8-lane group layout (load4, group_tree, group_distances) in which the
// NN-Descent pass (gather_distance_pool.cu) and the beam's hop
// (gather_distance.cu) score rows with the generic gather kernel's bits,
// and the sq8 hop (gather_sq8.cu) uint8 rows with the generic sq8 kernel's
// (group_sq8_distance).
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

// The plain xor tree (warp_sum: 16, 8, 4, 2, 1) over a row's 32 lane
// partials when 8 lanes hold them, lane u of the group partials 4u..4u+3 in
// p[0..3]. Partial m's partner at step o is m ^ o: at 16 it lives in lane
// u ^ 4 (each lane keeps two sums and sends two), at 8 in u ^ 2 (one kept,
// one sent); lane u then holds the sum for m = 4(u & 1) + 2((u >> 2) & 1) +
// ((u >> 1) & 1), and the last three steps pair lanes u ^ 1, u ^ 4, u ^ 2.
// Every lane of the group ends with warp_sum's value, in 6 shuffles that
// serve 4 rows (one a group). ``mask`` names the lanes that take part: the
// whole warp, or only the calling group where other groups have left.
__device__ __forceinline__ float group_tree(const float (&p)[4], int u,
                                           unsigned mask = 0xffffffffu) {
  const bool hi4 = (u & 4) != 0;
  const float a0 = (hi4 ? p[2] : p[0]) + __shfl_xor_sync(mask, hi4 ? p[0] : p[2], 4);
  const float a1 = (hi4 ? p[3] : p[1]) + __shfl_xor_sync(mask, hi4 ? p[1] : p[3], 4);
  const bool hi2 = (u & 2) != 0;
  float b = (hi2 ? a1 : a0) + __shfl_xor_sync(mask, hi2 ? a0 : a1, 2);
  b += __shfl_xor_sync(mask, b, 1);
  b += __shfl_xor_sync(mask, b, 4);
  b += __shfl_xor_sync(mask, b, 2);
  return b;
}

// 4 consecutive values from ``src`` at column ``col`` (of d): one 16-byte
// load when VEC (d % 4 == 0, aligned), else guarded scalar loads.
template <bool VEC, bool GLOBAL>
__device__ __forceinline__ float4 load4(const float* src, int col, int d) {
  if (VEC) {
    if (col >= d) return make_float4(0.f, 0.f, 0.f, 0.f);
    return GLOBAL ? __ldg(reinterpret_cast<const float4*>(src + col))
                  : *reinterpret_cast<const float4*>(src + col);
  }
  float4 v;
  v.x = col < d ? (GLOBAL ? __ldg(src + col) : src[col]) : 0.f;
  v.y = col + 1 < d ? (GLOBAL ? __ldg(src + col + 1) : src[col + 1]) : 0.f;
  v.z = col + 2 < d ? (GLOBAL ? __ldg(src + col + 2) : src[col + 2]) : 0.f;
  v.w = col + 3 < d ? (GLOBAL ? __ldg(src + col + 3) : src[col + 3]) : 0.f;
  return v;
}

template <int METRIC>
__device__ __forceinline__ void add4(float4 x, float4 y, int col, int d, float (&acc)[4],
                                     float (&rr)[4], float (&qq)[4]) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
  const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (col + c < d) {
      accumulate<METRIC>(xs[c], ys[c], acc[c], rr[c]);
      if (METRIC == kCos) qq[c] = fmaf(ys[c], ys[c], qq[c]);
    }
  }
}

// The distance from a group's partials (group_tree each; rr and qq for
// cos only). cos as the generic kernels compile finish_distance: (acc *
// rq) * rr subtracted from 1 in one fma. Spelled out here: whether nvcc
// contracts the expression depends on the code around it, and in the
// group layout it did not.
template <int METRIC>
__device__ __forceinline__ float group_finish(const float (&acc)[4], const float (&rr)[4],
                                              const float (&qq)[4], int u, unsigned mask) {
  const float a = group_tree(acc, u, mask);
  if (METRIC != kCos) return finish_distance<METRIC>(a, 0.f, 0.f);
  const float r2 = group_tree(rr, u, mask);
  const float q2 = group_tree(qq, u, mask);
  return __fmaf_rn(-__fmul_rn(a, rsqrtf(fmaxf(q2, 1e-12f))), rsqrtf(fmaxf(r2, 1e-12f)), 1.f);
}

// The distances of an 8-lane group's ROWS pairs: xs + xo[i] is the
// candidate row of pair i (shared memory when XS, else global), qs + qo[i]
// its query row (global). Lane u loads columns 32k + 4u .. 32k + 4u + 3 of a
// row as one float4 (a group reads a 128-byte segment, the warp four), so it
// holds gather_distance.cu's generic lane partials 4u..4u+3, each summed in
// increasing column order; group_tree adds them as warp_sum does. All loads
// of a KB-chunk of columns are issued before any sum. Every lane of the
// group gets every distance; ``mask`` as group_tree's.
template <int METRIC, int KB, bool VEC, bool XS, int ROWS, typename Off>
__device__ __forceinline__ void group_distances(const float* xs, const Off (&xo)[ROWS],
                                                const float* qs, const Off (&qo)[ROWS],
                                                int d, int u, float (&dist)[ROWS],
                                                unsigned mask = 0xffffffffu) {
  float acc[ROWS][4], rr[ROWS][4], qq[ROWS][4];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = rr[i][c] = qq[i][c] = 0.f;
  }
  for (int jb = 0; jb < d; jb += 32 * KB) {
    float4 y[ROWS][KB], xg[ROWS][KB];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        y[i][k] = load4<VEC, true>(qs + qo[i], jb + 32 * k + 4 * u, d);
        if (!XS) xg[i][k] = load4<VEC, true>(xs + xo[i], jb + 32 * k + 4 * u, d);
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const int col = jb + 32 * k + 4 * u;
        add4<METRIC>(XS ? load4<VEC, false>(xs + xo[i], col, d) : xg[i][k], y[i][k], col, d,
                     acc[i], rr[i], qq[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) dist[i] = group_finish<METRIC>(acc[i], rr[i], qq[i], u, mask);
}

// How a group reads a uint8 row (group_sq8_distance). kWords16 and kWords4
// sum in the generic sq8 kernel's 4-byte-word order (d % 4 == 0 and the
// code table 4-byte aligned): kWords16 with 16-byte code loads and float4
// loads of query, scale and mn (d % 16 == 0, every pointer 16-byte
// aligned), kWords4 with 4-byte code loads and scalar float loads. kBytes
// sums in its byte order, with byte loads.
enum Sq8Loads { kWords16 = 0, kWords4 = 1, kBytes = 2 };

// Byte B of ``w`` as a float, exactly static_cast<float> of the byte: the
// bits of 2^23 + byte (one PRMT) less 2^23 (one FADD), no I2F.
template <int B>
__device__ __forceinline__ float byte_float(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | B)) - 8388608.f;
}

// The dequantized distance of one (uint8 row, query) pair in an 8-lane
// group, with gather_sq8.cu's generic kernel's bits: every lane of the
// group gets it. A dimension j dequantizes as fmaf(code, scale[j], mn[j]).
// In the word order the generic kernel's lane l sums columns 4w .. 4w + 3
// of each word w = l, l + 32, ...; so lane u of the group holds lane
// partials 4u + c' (c' = 0..3): bytes 128t + 16u + 4c' .. + 3 of each
// 128-byte chunk t, one 16-byte load. In the byte order lane l sums columns
// l, l + 32, ...: lane u holds columns 32t + 4u + c, as group_distances.
// The query's norm (cos) is summed in the byte order on both paths, as the
// generic kernel sums it from the float row. group_tree adds each set of
// 32 partials in warp_sum's pairs.
template <int METRIC, int LOADS>
__device__ __forceinline__ float group_sq8_distance(const uint8_t* __restrict__ row,
                                                    const float* __restrict__ qrow,
                                                    const float* __restrict__ scale,
                                                    const float* __restrict__ mn, int d,
                                                    int u, unsigned mask) {
  float acc[4], rr[4], qq[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = rr[c] = qq[c] = 0.f;
  if (LOADS != kBytes) {
    for (int jb = 0; jb < d; jb += 128) {
      const int col0 = jb + 16 * u;
      uint32_t w[4];
      float4 y[4], s[4], m[4];
      if (LOADS == kWords16) {   // d % 16 == 0: columns col0 .. col0 + 15 all in or all out
        const uint4 v = col0 < d ? __ldg(reinterpret_cast<const uint4*>(row + col0))
                                 : make_uint4(0u, 0u, 0u, 0u);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + 4 * c;
        if (LOADS == kWords4) {
          w[c] = col < d ? __ldg(reinterpret_cast<const uint32_t*>(row + col)) : 0u;
        }
        y[c] = load4<LOADS == kWords16, true>(qrow, col, d);
        s[c] = load4<LOADS == kWords16, true>(scale, col, d);
        m[c] = load4<LOADS == kWords16, true>(mn, col, d);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col0 + 4 * c < d) {   // d % 4 == 0: the word's 4 columns are in
          accumulate<METRIC>(fmaf(byte_float<0>(w[c]), s[c].x, m[c].x), y[c].x, acc[c], rr[c]);
          accumulate<METRIC>(fmaf(byte_float<1>(w[c]), s[c].y, m[c].y), y[c].y, acc[c], rr[c]);
          accumulate<METRIC>(fmaf(byte_float<2>(w[c]), s[c].z, m[c].z), y[c].z, acc[c], rr[c]);
          accumulate<METRIC>(fmaf(byte_float<3>(w[c]), s[c].w, m[c].w), y[c].w, acc[c], rr[c]);
        }
      }
    }
    if (METRIC == kCos) {
      for (int jb = 0; jb < d; jb += 32) {
        const int col = jb + 4 * u;
        const float4 v = load4<LOADS == kWords16, true>(qrow, col, d);
        const float ys[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (col + c < d) qq[c] = fmaf(ys[c], ys[c], qq[c]);
        }
      }
    }
  } else {
    for (int jb = 0; jb < d; jb += 32) {
      const int col = jb + 4 * u;
      float code[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        code[c] = col + c < d ? static_cast<float>(__ldg(row + col + c)) : 0.f;
      }
      const float4 y4 = load4<false, true>(qrow, col, d);
      const float4 s4 = load4<false, true>(scale, col, d);
      const float4 m4 = load4<false, true>(mn, col, d);
      const float ys[4] = {y4.x, y4.y, y4.z, y4.w};
      const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
      const float ms[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col + c < d) {
          accumulate<METRIC>(fmaf(code[c], ss[c], ms[c]), ys[c], acc[c], rr[c]);
          if (METRIC == kCos) qq[c] = fmaf(ys[c], ys[c], qq[c]);
        }
      }
    }
  }
  return group_finish<METRIC>(acc, rr, qq, u, mask);
}

// The instance of the group layout for a row of d columns: KB
// 32-column chunks a step (1 up to d = 32, 2 up to 64, else 4), float4
// loads when VEC. ``l.run<METRIC, KB, VEC>()`` launches the instance.
template <int METRIC, bool VEC, typename L>
void by_d(const L& l, int d) {
  if (d <= 32) {
    l.template run<METRIC, 1, VEC>();
  } else if (d <= 64) {
    l.template run<METRIC, 2, VEC>();
  } else {
    l.template run<METRIC, 4, VEC>();
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ``by_d`` for a metric code; VEC when d % 4 == 0 and every row pointer
// given is 16-byte aligned.
template <typename L>
void dispatch_group(const L& l, int metric, int d, bool aligned) {
  const bool vec = d % 4 == 0 && aligned;
  switch (metric) {
    case kL2:
      vec ? by_d<kL2, true>(l, d) : by_d<kL2, false>(l, d);
      break;
    case kIp:
      vec ? by_d<kIp, true>(l, d) : by_d<kIp, false>(l, d);
      break;
    default:
      vec ? by_d<kCos, true>(l, d) : by_d<kCos, false>(l, d);
      break;
  }
}

}  // namespace repro_kernels
