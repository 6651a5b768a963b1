// Fused gather + distance (+ visited-bitmap mask) for Hopper, sm_90a.
//
// Replaces the Pallas kernels gather_distance / gather_distance_masked
// (src/repro/kernels/gather_distance.py). For each query row q and each id
// in ids[q, :], gather base[id] and reduce it against the query: l2 in the
// diff form sum((r - q)^2), ip as -dot, cos as 1 - dot * rsqrt(qq) *
// rsqrt(rr) with both norms clamped at 1e-12. Padding ids (< 0) give
// (+inf, -1); the masked variant also drops ids whose bit is set in the
// query's bit-packed visited row. Ids past n - 1 read row n - 1.
//
// What bounds it: bytes. Each scored id costs one random 4*d-byte row
// (256 B at d = 64) and 3*d flops, far below the card's flop rate. At the
// beam's hop shape (Q = 64, R = 20) the whole call moves ~0.35 MB, so the
// bound is tens of nanoseconds and the kernel's time is the latency of its
// dependent loads. The NN-Descent local join scores its pool with
// gather_distance_pool.cu, which gives the same bits.
//
// Three kernels:
//   - gather_distance_kernel, the generic one: one block per (query,
//     tile of 32 ids), the query row in shared memory, one warp per id at a
//     time and 4 ids a warp in series: lanes stride over d (lane l sums
//     columns l, l + 32, ...) and a warp_sum adds the 32 partials. No path
//     calls it: it is the yardstick of the pair and hop kernels.
//   - gather_distance_pairs_kernel, the unmasked gather (the rerank,
//     pq_search, HNSW's greedy descent at R = 1 and R = M, the hubs scan,
//     the SRS rerank): the hop kernel's layout without the visited word.
//     At R = 1 or 10 the generic kernel keeps 1 or 3 of a block's 8 warps
//     busy, each with up to 4 dependent chains in series; here every pair
//     is its own 8-lane group, the grid spans Q x R, and a padding id (most
//     of a late descent step) stores +inf at once.
//   - gather_distance_hop_kernel, the beam's masked hop: the Q x R pairs
//     flattened over the grid, one 8-lane group a pair (common.cuh's group
//     layout: lane u holds the generic lane partials 4u..4u+3, read as
//     float4, added by group_tree), so its distances have the generic
//     kernel's bits. A group loads its id; a padding id (most of a hop's
//     slots) stores (+inf, -1) at once; otherwise the visited word and the
//     row's float4 loads go out together, the query row's from L1, so a hop
//     is one dependent chain (id, then row) and not four.
// The l2 diff form needs no extra precision (the expanded form cancels for
// near-duplicate rows). The visited test and the distance epilogue are
// common.cuh's, shared with the sq8 and ADC gathers.

#include "common.cuh"

namespace {

using namespace repro_kernels;

constexpr int kWarps = 8;
constexpr int kIdsPerWarp = 4;
constexpr int kIdsPerBlock = kWarps * kIdsPerWarp;
constexpr int kHopThreads = 128;
constexpr int kHopPairs = kHopThreads / 8;   // (query, slot) pairs a hop block

template <int METRIC, bool MASKED>
__global__ void __launch_bounds__(kWarps * 32)
gather_distance_kernel(const float* __restrict__ queries,
                       const int32_t* __restrict__ ids,
                       const float* __restrict__ base,
                       const int32_t* __restrict__ visited,
                       float* __restrict__ out_d, int32_t* __restrict__ out_i,
                       int R, int n, int d, int W) {
  extern __shared__ float q_s[];
  const int64_t q = blockIdx.x;
  const float* qrow = queries + q * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) q_s[j] = qrow[j];
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
    const bool drop = id < 0 || (MASKED && is_visited(visited + q * W, W, id));
    float dist = INFINITY;
    if (!drop) {  // warp-uniform: every lane holds the same id
      const float* row = base + static_cast<int64_t>(min(id, n - 1)) * d;
      float acc = 0.f, rr = 0.f;
      for (int j = lane; j < d; j += 32) {
        accumulate<METRIC>(__ldg(row + j), q_s[j], acc, rr);
      }
      acc = warp_sum(acc);
      if (METRIC == kCos) rr = warp_sum(rr);
      dist = finish_distance<METRIC>(acc, rr, qq);
    }
    if (lane == 0) {
      out_d[o] = dist;
      if (MASKED) out_i[o] = drop ? -1 : id;
    }
  }
}

// The hop: one 8-lane group per (query, slot) pair o = q * R + r.
template <int METRIC, int KB, bool VEC>
__global__ void __launch_bounds__(kHopThreads)
gather_distance_hop_kernel(const float* __restrict__ queries,
                           const int32_t* __restrict__ ids,
                           const float* __restrict__ base,
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
  const int64_t xo[1] = {static_cast<int64_t>(min(id, n - 1)) * d};
  const int64_t qo[1] = {q * d};
  float dist[1];
  group_distances<METRIC, KB, VEC, false>(base, xo, queries, qo, d, u, dist,
                                          0xffu << (lane & 24));
  if (u == 0) {
    const bool seen = ((word >> (id & 31)) & 1u) != 0u;
    out_d[o] = seen ? INFINITY : dist[0];
    out_i[o] = seen ? -1 : id;
  }
}

// The unmasked gather: one 8-lane group per (query, slot) pair o = q * R + r,
// as the hop kernel without the visited word.
template <int METRIC, int KB, bool VEC>
__global__ void __launch_bounds__(kHopThreads)
gather_distance_pairs_kernel(const float* __restrict__ queries,
                             const int32_t* __restrict__ ids,
                             const float* __restrict__ base, float* __restrict__ out_d,
                             int64_t pairs, int R, int n, int d) {
  const int lane = threadIdx.x & 31;
  const int u = lane & 7;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kHopPairs + (threadIdx.x >> 3);
  if (o >= pairs) return;          // group-uniform
  const int32_t id = __ldg(ids + o);
  if (id < 0) {                    // group-uniform: a padding slot
    if (u == 0) out_d[o] = INFINITY;
    return;
  }
  const int64_t xo[1] = {static_cast<int64_t>(min(id, n - 1)) * d};
  const int64_t qo[1] = {(o / R) * d};
  float dist[1];
  group_distances<METRIC, KB, VEC, false>(base, xo, queries, qo, d, u, dist,
                                          0xffu << (lane & 24));
  if (u == 0) out_d[o] = dist[0];
}

template <bool MASKED>
void launch(int metric, dim3 grid, size_t smem, cudaStream_t stream,
            const float* queries, const int32_t* ids, const float* base,
            const int32_t* visited, float* out_d, int32_t* out_i, int R, int n,
            int d, int W) {
  const dim3 block(kWarps * 32);
  switch (metric) {
    case kL2:
      gather_distance_kernel<kL2, MASKED><<<grid, block, smem, stream>>>(
          queries, ids, base, visited, out_d, out_i, R, n, d, W);
      break;
    case kIp:
      gather_distance_kernel<kIp, MASKED><<<grid, block, smem, stream>>>(
          queries, ids, base, visited, out_d, out_i, R, n, d, W);
      break;
    default:
      gather_distance_kernel<kCos, MASKED><<<grid, block, smem, stream>>>(
          queries, ids, base, visited, out_d, out_i, R, n, d, W);
      break;
  }
}

struct HopLaunch {
  unsigned blocks;
  cudaStream_t s;
  const float* queries;
  const int32_t* ids;
  const float* base;
  const int32_t* visited;
  float* out_d;
  int32_t* out_i;
  int64_t pairs;
  int R, n, d, W;
  template <int METRIC, int KB, bool VEC>
  void run() const {
    gather_distance_hop_kernel<METRIC, KB, VEC><<<blocks, kHopThreads, 0, s>>>(
        queries, ids, base, visited, out_d, out_i, pairs, R, n, d, W);
  }
};

struct PairLaunch {
  unsigned blocks;
  cudaStream_t s;
  const float* queries;
  const int32_t* ids;
  const float* base;
  float* out_d;
  int64_t pairs;
  int R, n, d;
  template <int METRIC, int KB, bool VEC>
  void run() const {
    gather_distance_pairs_kernel<METRIC, KB, VEC><<<blocks, kHopThreads, 0, s>>>(
        queries, ids, base, out_d, pairs, R, n, d);
  }
};

}  // namespace

// The unmasked gather on gather_distance_pairs_kernel: queries (Q, d) f32,
// ids (Q, R) i32, base (n, d) f32 -> out_d (Q, R) f32, as
// gather_distance_f32 with masked == 0 gives them, bit for bit. All
// contiguous, on one device. Returns cudaGetLastError() after the launch.
extern "C" int gather_distance_pairs_f32(const float* queries, const int32_t* ids,
                                         const float* base, float* out_d, int Q, int R,
                                         int n, int d, int metric, void* stream) {
  const int64_t pairs = static_cast<int64_t>(Q) * R;
  if (pairs > 0) {
    const unsigned blocks = static_cast<unsigned>((pairs + kHopPairs - 1) / kHopPairs);
    dispatch_group(PairLaunch{blocks, static_cast<cudaStream_t>(stream), queries, ids, base,
                              out_d, pairs, R, n, d},
                   metric, d, aligned16(queries) && aligned16(base));
  }
  return static_cast<int>(cudaGetLastError());
}

// queries (Q, d) f32, ids (Q, R) i32, base (n, d) f32, visited (Q, W) i32 or
// null -> out_d (Q, R) f32 [, out_i (Q, R) i32]. All contiguous, on one
// device. Returns cudaGetLastError() after the launch.
extern "C" int gather_distance_f32(const float* queries, const int32_t* ids,
                                   const float* base, const int32_t* visited,
                                   float* out_d, int32_t* out_i, int Q, int R,
                                   int n, int d, int W, int metric, int masked,
                                   void* stream) {
  if (Q > 0 && R > 0) {
    const dim3 grid(Q, (R + kIdsPerBlock - 1) / kIdsPerBlock);
    const size_t smem = static_cast<size_t>(d) * sizeof(float);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (masked) {
      launch<true>(metric, grid, smem, s, queries, ids, base, visited, out_d,
                   out_i, R, n, d, W);
    } else {
      launch<false>(metric, grid, smem, s, queries, ids, base, visited, out_d,
                    out_i, R, n, d, W);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The beam's masked hop on gather_distance_hop_kernel: queries (Q, d) f32,
// ids (Q, R) i32, base (n, d) f32, visited (Q, W) i32 -> out_d (Q, R) f32,
// out_i (Q, R) i32, as gather_distance_f32 with masked != 0 gives them. All
// contiguous, on one device. Returns cudaGetLastError() after the launch.
extern "C" int gather_distance_hop_f32(const float* queries, const int32_t* ids,
                                       const float* base, const int32_t* visited,
                                       float* out_d, int32_t* out_i, int Q, int R,
                                       int n, int d, int W, int metric, void* stream) {
  const int64_t pairs = static_cast<int64_t>(Q) * R;
  if (pairs > 0) {
    const unsigned blocks = static_cast<unsigned>((pairs + kHopPairs - 1) / kHopPairs);
    dispatch_group(HopLaunch{blocks, static_cast<cudaStream_t>(stream), queries, ids, base,
                             visited, out_d, out_i, pairs, R, n, d, W},
                   metric, d, aligned16(queries) && aligned16(base));
  }
  return static_cast<int>(cudaGetLastError());
}
