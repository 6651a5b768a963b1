// Fused uint8 gather + dequantized distance + visited-bitmap mask for Hopper,
// sm_90a: the scalar-quantized (sq8) rung of the quantization ladder.
//
// Replaces the Pallas kernel gather_sq8_masked
// (src/repro/kernels/gather_sq8.py). For each query row q and each id in
// ids[q, :], gather the uint8 row codes[id], dequantize it per dimension as
// code * scale[j] + mn[j], and reduce it against the query: l2 in the diff
// form, -dot, cos with both norms clamped at 1e-12 (rsqrt). Padding ids
// (< 0) and ids whose bit is set in the query's visited row give (+inf,
// -1). Ids past n - 1 read row n - 1.
//
// What bounds it: bytes. A scored id costs one random d-byte row (64 B at
// d = 64) against 4*d for the float gather, and 4*d flops. At the beam's
// hop shape (Q = 64, R = 20) a call moves ~0.05 MB: the bound is
// nanoseconds, and the kernel's time is the latency of its dependent loads
// and of the launch.
//
// Two kernels:
//   - gather_sq8_hop_kernel, the beam's sq8 hop: the hop layout of
//     gather_distance.cu's hop kernel. The Q x R (query, slot) pairs are
//     flattened over the grid, one 8-lane group a pair, 16 pairs a
//     128-thread block. A group loads its id; a padding id (most of a hop's
//     slots) stores (+inf, -1) at once and leaves; otherwise the visited
//     word, the code row's loads and the query, scale and mn loads (from
//     L1, no shared-memory staging, no block barrier) go out together, so a
//     hop is one dependent chain (id, then row). common.cuh's
//     group_sq8_distance holds the generic kernel's lane partials in the
//     group (a 16-byte code load a lane where d % 16 == 0) and adds them in
//     warp_sum's pairs, so the distances have the generic kernel's bits.
//     The visited bit is read last.
//   - gather_sq8_kernel, the generic one: one block per (query, tile of
//     32 ids), the query, scale and mn rows staged in shared memory, one
//     warp per id and 4 ids a warp in series; with d % 4 == 0 and a 4-byte
//     aligned table lane l reads the 4 codes of words l, l + 32, ... in
//     32-bit loads, else lanes stride over single bytes; the sums are warp
//     shuffles. No path of the port runs it: it is the hop kernel's
//     yardstick, bit for bit and in time
//     (gather_sq8.gather_sq8_masked_generic).

#include "common.cuh"

namespace {

using namespace repro_kernels;

constexpr int kWarps = 8;
constexpr int kIdsPerWarp = 4;
constexpr int kIdsPerBlock = kWarps * kIdsPerWarp;
constexpr int kHopThreads = 128;
constexpr int kHopPairs = kHopThreads / 8;   // (query, slot) pairs a hop block

template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(kWarps * 32)
gather_sq8_kernel(const float* __restrict__ queries,
                  const int32_t* __restrict__ ids,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ scale,
                  const float* __restrict__ mn,
                  const int32_t* __restrict__ visited,
                  float* __restrict__ out_d, int32_t* __restrict__ out_i,
                  int R, int n, int d, int W) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* sc_s = q_s + d;
  float* mn_s = sc_s + d;
  const int64_t q = blockIdx.x;
  const float* qrow = queries + q * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    q_s[j] = qrow[j];
    sc_s[j] = scale[j];
    mn_s[j] = mn[j];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float qq = 0.f;
  if (METRIC == kCos) {
    for (int j = lane; j < d; j += 32) qq = fmaf(q_s[j], q_s[j], qq);
    qq = warp_sum(qq);
  }

  const int r0 = blockIdx.y * kIdsPerBlock + warp * kIdsPerWarp;
  for (int t = 0; t < kIdsPerWarp; ++t) {
    const int r = r0 + t;
    if (r >= R) break;  // warp-uniform
    const int64_t o = q * R + r;
    const int32_t id = ids[o];
    const bool drop = id < 0 || is_visited(visited + q * W, W, id);
    float dist = INFINITY;
    if (!drop) {  // warp-uniform: every lane holds the same id
      const uint8_t* row = codes + static_cast<int64_t>(min(id, n - 1)) * d;
      float acc = 0.f, rr = 0.f;
      if (VEC4) {
        const uint32_t* row4 = reinterpret_cast<const uint32_t*>(row);
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        const float4* sc4 = reinterpret_cast<const float4*>(sc_s);
        const float4* mn4 = reinterpret_cast<const float4*>(mn_s);
        for (int w = lane; w < (d >> 2); w += 32) {
          const uint32_t p = __ldg(row4 + w);
          const float4 y = q4[w], s = sc4[w], m = mn4[w];
          accumulate<METRIC>(fmaf(static_cast<float>(p & 0xffu), s.x, m.x), y.x, acc, rr);
          accumulate<METRIC>(fmaf(static_cast<float>((p >> 8) & 0xffu), s.y, m.y), y.y, acc, rr);
          accumulate<METRIC>(fmaf(static_cast<float>((p >> 16) & 0xffu), s.z, m.z), y.z, acc, rr);
          accumulate<METRIC>(fmaf(static_cast<float>(p >> 24), s.w, m.w), y.w, acc, rr);
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          const float x = fmaf(static_cast<float>(__ldg(row + j)), sc_s[j], mn_s[j]);
          accumulate<METRIC>(x, q_s[j], acc, rr);
        }
      }
      acc = warp_sum(acc);
      if (METRIC == kCos) rr = warp_sum(rr);
      dist = finish_distance<METRIC>(acc, rr, qq);
    }
    if (lane == 0) {
      out_d[o] = dist;
      out_i[o] = drop ? -1 : id;
    }
  }
}

// The hop: one 8-lane group per (query, slot) pair o = q * R + r.
template <int METRIC, int LOADS>
__global__ void __launch_bounds__(kHopThreads)
gather_sq8_hop_kernel(const float* __restrict__ queries,
                      const int32_t* __restrict__ ids,
                      const uint8_t* __restrict__ codes,
                      const float* __restrict__ scale,
                      const float* __restrict__ mn,
                      const int32_t* __restrict__ visited,
                      float* __restrict__ out_d, int32_t* __restrict__ out_i,
                      int64_t pairs, int R, int n, int d, int W) {
  const int lane = threadIdx.x & 31;
  const int u = lane & 7;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kHopPairs + (threadIdx.x >> 3);
  if (o >= pairs) return;          // group-uniform
  const int32_t id = __ldg(ids + o);
  if (id < 0) {                    // group-uniform: a padding slot
    if (u == 0) {
      out_d[o] = INFINITY;
      out_i[o] = -1;
    }
    return;
  }
  const int64_t q = o / R;
  // the visited word goes out with the row's loads; its bit is read last
  const uint32_t word = static_cast<uint32_t>(__ldg(visited + q * W + min(id >> 5, W - 1)));
  const float dist = group_sq8_distance<METRIC, LOADS>(
      codes + static_cast<int64_t>(min(id, n - 1)) * d, queries + q * d, scale, mn, d, u,
      0xffu << (lane & 24));
  if (u == 0) {
    const bool seen = ((word >> (id & 31)) & 1u) != 0u;
    out_d[o] = seen ? INFINITY : dist;
    out_i[o] = seen ? -1 : id;
  }
}

template <int METRIC>
void launch(bool vec4, dim3 grid, size_t smem, cudaStream_t stream,
            const float* queries, const int32_t* ids, const uint8_t* codes,
            const float* scale, const float* mn, const int32_t* visited,
            float* out_d, int32_t* out_i, int R, int n, int d, int W) {
  const dim3 block(kWarps * 32);
  if (vec4) {
    gather_sq8_kernel<METRIC, true><<<grid, block, smem, stream>>>(
        queries, ids, codes, scale, mn, visited, out_d, out_i, R, n, d, W);
  } else {
    gather_sq8_kernel<METRIC, false><<<grid, block, smem, stream>>>(
        queries, ids, codes, scale, mn, visited, out_d, out_i, R, n, d, W);
  }
}

template <int LOADS>
void launch_hop(int metric, unsigned blocks, cudaStream_t s, const float* queries,
                const int32_t* ids, const uint8_t* codes, const float* scale, const float* mn,
                const int32_t* visited, float* out_d, int32_t* out_i, int64_t pairs, int R,
                int n, int d, int W) {
  switch (metric) {
    case kL2:
      gather_sq8_hop_kernel<kL2, LOADS><<<blocks, kHopThreads, 0, s>>>(
          queries, ids, codes, scale, mn, visited, out_d, out_i, pairs, R, n, d, W);
      break;
    case kIp:
      gather_sq8_hop_kernel<kIp, LOADS><<<blocks, kHopThreads, 0, s>>>(
          queries, ids, codes, scale, mn, visited, out_d, out_i, pairs, R, n, d, W);
      break;
    default:
      gather_sq8_hop_kernel<kCos, LOADS><<<blocks, kHopThreads, 0, s>>>(
          queries, ids, codes, scale, mn, visited, out_d, out_i, pairs, R, n, d, W);
      break;
  }
}

}  // namespace

// The generic kernel: queries (Q, d) f32, ids (Q, R) i32, codes (n, d) u8,
// scale/mn (d,) f32, visited (Q, W) i32 -> out_d (Q, R) f32, out_i (Q, R)
// i32. All contiguous, on one device; vec4 needs d % 4 == 0 and a 4-byte
// aligned codes pointer. Returns cudaGetLastError() after the launch.
extern "C" int gather_sq8_f32(const float* queries, const int32_t* ids,
                              const uint8_t* codes, const float* scale,
                              const float* mn, const int32_t* visited,
                              float* out_d, int32_t* out_i, int Q, int R, int n,
                              int d, int W, int metric, int vec4, void* stream) {
  if (Q > 0 && R > 0) {
    const dim3 grid(Q, (R + kIdsPerBlock - 1) / kIdsPerBlock);
    const size_t smem = 3 * static_cast<size_t>(d) * sizeof(float);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (metric) {
      case kL2:
        launch<kL2>(vec4 != 0, grid, smem, s, queries, ids, codes, scale, mn,
                    visited, out_d, out_i, R, n, d, W);
        break;
      case kIp:
        launch<kIp>(vec4 != 0, grid, smem, s, queries, ids, codes, scale, mn,
                    visited, out_d, out_i, R, n, d, W);
        break;
      default:
        launch<kCos>(vec4 != 0, grid, smem, s, queries, ids, codes, scale, mn,
                     visited, out_d, out_i, R, n, d, W);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The beam's sq8 hop on gather_sq8_hop_kernel: the arguments and outputs of
// gather_sq8_f32, which gives the same bits; the word or byte order (vec4
// there) follows from d and the code table's alignment here. Returns
// cudaGetLastError() after the launch.
extern "C" int gather_sq8_hop_f32(const float* queries, const int32_t* ids,
                                  const uint8_t* codes, const float* scale,
                                  const float* mn, const int32_t* visited,
                                  float* out_d, int32_t* out_i, int Q, int R, int n,
                                  int d, int W, int metric, void* stream) {
  const int64_t pairs = static_cast<int64_t>(Q) * R;
  if (pairs > 0) {
    const unsigned blocks = static_cast<unsigned>((pairs + kHopPairs - 1) / kHopPairs);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool words = d % 4 == 0 && (reinterpret_cast<uintptr_t>(codes) & 3) == 0;
    if (words && d % 16 == 0 && aligned16(codes) && aligned16(queries) && aligned16(scale) &&
        aligned16(mn)) {
      launch_hop<kWords16>(metric, blocks, s, queries, ids, codes, scale, mn, visited, out_d,
                           out_i, pairs, R, n, d, W);
    } else if (words) {
      launch_hop<kWords4>(metric, blocks, s, queries, ids, codes, scale, mn, visited, out_d,
                          out_i, pairs, R, n, d, W);
    } else {
      launch_hop<kBytes>(metric, blocks, s, queries, ids, codes, scale, mn, visited, out_d,
                         out_i, pairs, R, n, d, W);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
