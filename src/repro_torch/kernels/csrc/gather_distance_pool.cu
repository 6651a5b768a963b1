// The NN-Descent scoring pass for Hopper, sm_90a: for every row v and every
// id c in pool[v, :], the distance from base[v] to base[c].
//
// Replaces the Pallas kernel gather_distance
// (src/repro/kernels/gather_distance.py) where the local join calls it
// (src/repro/core/nndescent.py _score_chunked): the queries are the base's
// own rows. Ids < 0 give +inf; ids >= n read row n - 1. Each distance has
// the bits of gather_distance.cu's: lane l of its warp sums the columns
// j = l (mod 32) with sequential fmaf, and the 32 partials meet in the xor
// tree 16, 8, 4, 2, 1 (common.cuh warp_sum); here the same partials are
// summed in the same order, in another lane layout.
//
// What bounds it: bytes. One pass at n = 1M, C = 240, d = 64 scores ~230M
// pairs. Read one random 256-byte row a pair, that is ~59 GB from a 256 MB
// base against a 50 MB L2: each base row is read ~240 times a pass.
//
// Design: the rows are cut into windows of V consecutive vertices whose
// query rows and outputs fit in half the L2 (the wrapper's plan). Within a
// window the pairs are partitioned by candidate bucket (R consecutive base
// rows, R a power of two) with a counting sort of our own:
//   1. hist:    a shared-memory histogram of a chunk of pairs, flushed with
//               one global add per bucket; invalid ids write +inf here;
//   2. scan:    one block per window, exclusive scan of its bucket counts
//               into the window's segment of the entry list;
//   3. scatter: the chunk sorted by bucket in shared memory, one global
//               atomicAdd a bucket reserves its range, each run written
//               contiguously; an entry packs (row in bucket << pos_bits |
//               pair in window);
//   4. score:   one block per (window, bucket), window-major, so the blocks
//               in flight share one window. It stages the bucket's R rows in
//               shared memory (one contiguous read from HBM a window, marked
//               evict-first in L2 so the stream does not push out the
//               window's outputs), then 8-lane groups score 2 entries each
//               at a time: a group reads a query row as 128-byte float4
//               segments from L2 and the staged row from shared memory, and
//               group_tree adds the partials in 6 shuffles (the group
//               layout lives in common.cuh; the beam's hop kernel in
//               gather_distance.cu uses it too).
// The distance goes to its original position v * C + j.
//
// Staging pays while a window holds at least as many pairs as the base has
// rows (V * C >= n: a staged bucket serves, on average, at least as many
// pairs as it holds rows), and while R rows stage in shared memory with at
// most 8192 buckets (the partition's shared-memory histograms). Elsewhere (a
// base of several million rows, or rows so wide that a window holds few),
// the plan sends the pass to the direct kernel: one launch, each warp
// scoring 8 consecutive pairs in place in the same lane layout, so the bits
// are the same.

#include <algorithm>

#include "common.cuh"

namespace {

using namespace repro_kernels;

constexpr int kThreads = 256;        // score blocks
constexpr int kPartThreads = 1024;   // hist / scatter blocks
constexpr int kTile = 1024;          // entries a score block holds in shared memory
constexpr int kWarps = kThreads / 32;
constexpr int kGroupRows = 2;        // rows an 8-lane group scores together
constexpr int kRows = 4 * kGroupRows;  // entries a warp scores together

struct Plan {
  int n, d, C;
  int window;       // V: vertices a window (the last one may be shorter)
  int w0;           // first window of this call
  int log_rows;     // R = 1 << log_rows rows a bucket
  int n_buckets;    // ceil(n / R)
  int chunk;        // pairs a hist / scatter block
  int pos_bits;     // an entry is (row in bucket << pos_bits) | pair in window
  int div_shift;    // pair / C == (pair * div_magic) >> div_shift
  unsigned long long div_magic;
};

__device__ __forceinline__ int window_pairs(const Plan& p, int w) {
  return min(p.window, p.n - w * p.window) * p.C;
}

// hist: counts[wl, bucket] += valid ids of the chunk; out = +inf for ids < 0.
__global__ void __launch_bounds__(kPartThreads)
gather_distance_pool_hist_kernel(const int32_t* __restrict__ pool,
                                 float* __restrict__ out,
                                 int32_t* __restrict__ counts, Plan p) {
  extern __shared__ int32_t hist[];
  const int wl = blockIdx.y;
  const int w = p.w0 + wl;
  const int pairs = window_pairs(p, w);
  const int lo = blockIdx.x * p.chunk;
  if (lo >= pairs) return;  // block-uniform: the window is short
  const int hi = min(lo + p.chunk, pairs);
  for (int b = threadIdx.x; b < p.n_buckets; b += kPartThreads) hist[b] = 0;
  __syncthreads();
  const int64_t first = static_cast<int64_t>(w) * p.window * p.C;
  const int32_t* ids = pool + first;
  for (int i = lo + threadIdx.x; i < hi; i += kPartThreads) {
    const int32_t id = ids[i];
    if (id < 0) {
      out[first + i] = INFINITY;
    } else {
      atomicAdd(&hist[min(id, p.n - 1) >> p.log_rows], 1);
    }
  }
  __syncthreads();
  int32_t* wc = counts + static_cast<int64_t>(wl) * p.n_buckets;
  for (int b = threadIdx.x; b < p.n_buckets; b += kPartThreads) {
    if (hist[b] != 0) atomicAdd(&wc[b], hist[b]);
  }
}

// Exclusive scan of x[0..m) into y (may alias x) by the whole block (1024
// threads), each thread over a run of consecutive entries; returns the total.
__device__ int32_t block_exclusive_scan(const int32_t* x, int32_t* y, int m,
                                        int32_t base) {
  __shared__ int32_t warp_tot[32];
  const int per = (m + blockDim.x - 1) / blockDim.x;
  const int b0 = min(static_cast<int>(threadIdx.x) * per, m);
  const int b1 = min(b0 + per, m);
  int32_t sum = 0;
  for (int b = b0; b < b1; ++b) sum += x[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int32_t t = lane < nw ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += v;
    }
    if (lane < nw) warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  const int32_t total = warp_tot[(blockDim.x >> 5) - 1];
  int32_t run = base + (warp > 0 ? warp_tot[warp - 1] : 0) + incl - sum;
  for (int b = b0; b < b1; ++b) {
    const int32_t c = x[b];
    y[b] = run;
    run += c;
  }
  __syncthreads();  // warp_tot is reused by the next call
  return total;
}

// scan: one block per window; offsets = cursor = the window's segment start
// (wl * V * C) + the exclusive prefix sum of its bucket counts.
__global__ void __launch_bounds__(kPartThreads)
gather_distance_pool_scan_kernel(const int32_t* __restrict__ counts,
                                 int32_t* __restrict__ offsets,
                                 int32_t* __restrict__ cursor, Plan p) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * p.n_buckets;
  block_exclusive_scan(counts + row, offsets + row, p.n_buckets,
                       blockIdx.x * p.window * p.C);
  for (int b = threadIdx.x; b < p.n_buckets; b += blockDim.x) {
    cursor[row + b] = offsets[row + b];
  }
}

// scatter: entry (row in bucket << pos_bits | pair in window) into its
// bucket's range of the list. The block counts its chunk by bucket, reserves
// one range per bucket with one global atomicAdd, sorts the chunk by bucket
// in shared memory (scan, then shared atomics hand out the slots) and writes
// each bucket's run contiguously: 4-byte stores scattered over the list cost
// ~3x this on the H100. The order inside a bucket does not matter.
__global__ void __launch_bounds__(kPartThreads)
gather_distance_pool_scatter_kernel(const int32_t* __restrict__ pool,
                                    int32_t* __restrict__ cursor,
                                    int32_t* __restrict__ entries, Plan p) {
  extern __shared__ int32_t smem[];
  const int nb = p.n_buckets;
  int32_t* fill = smem;             // counts; then each run's next slot
  int32_t* dest = smem + nb;        // each run's first slot in ``entries``
  int32_t* sorted = smem + 2 * nb;  // the chunk's entries, by bucket
  const int wl = blockIdx.y;
  const int w = p.w0 + wl;
  const int pairs = window_pairs(p, w);
  const int lo = blockIdx.x * p.chunk;
  if (lo >= pairs) return;
  const int hi = min(lo + p.chunk, pairs);
  for (int b = threadIdx.x; b < nb; b += kPartThreads) fill[b] = 0;
  __syncthreads();
  const int32_t* ids = pool + static_cast<int64_t>(w) * p.window * p.C;
  for (int i = lo + threadIdx.x; i < hi; i += kPartThreads) {
    const int32_t id = ids[i];
    if (id >= 0) atomicAdd(&fill[min(id, p.n - 1) >> p.log_rows], 1);
  }
  __syncthreads();
  int32_t* wc = cursor + static_cast<int64_t>(wl) * nb;
  for (int b = threadIdx.x; b < nb; b += kPartThreads) {
    const int32_t c = fill[b];
    dest[b] = c != 0 ? atomicAdd(&wc[b], c) : 0;
  }
  block_exclusive_scan(fill, fill, nb, 0);  // (syncs) run b starts at fill[b]
  const int32_t row_mask = (1 << p.log_rows) - 1;
  for (int i = lo + threadIdx.x; i < hi; i += kPartThreads) {
    const int32_t id = ids[i];
    if (id >= 0) {
      const int32_t c = min(id, p.n - 1);
      sorted[atomicAdd(&fill[c >> p.log_rows], 1)] = ((c & row_mask) << p.pos_bits) | i;
    }
  }
  __syncthreads();  // run b is now [fill[b - 1], fill[b])
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < nb; b += kPartThreads / 32) {
    const int s0 = b > 0 ? fill[b - 1] : 0, s1 = fill[b], to = dest[b] - s0;
    for (int k = s0 + lane; k < s1; k += 32) entries[to + k] = sorted[k];
  }
}

// An L2 eviction policy (createpolicy) for the staged buckets: they stream
// through L2 once a window and go first, so they do not push out the
// window's outputs, which are written 4 bytes at a time in no order.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, uint64_t pol) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "l"(pol));
}

// score: one block per (window, bucket). The block stages the bucket's rows
// and a tile of its entries in shared memory; a warp scores kRows entries at
// a time, kGroupRows a group (group_distances).
template <int METRIC, int KB, bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_distance_pool_score_kernel(const float* __restrict__ base,
                                  const int32_t* __restrict__ counts,
                                  const int32_t* __restrict__ offsets,
                                  const int32_t* __restrict__ entries,
                                  float* __restrict__ out, Plan p) {
  extern __shared__ __align__(16) float rows_s[];
  const int64_t cell = blockIdx.x;  // wl * n_buckets + bucket
  const int count = counts[cell];
  if (count == 0) return;
  const int wl = static_cast<int>(cell / p.n_buckets);
  const int bucket = static_cast<int>(cell % p.n_buckets);
  const int w = p.w0 + wl;
  const int d = p.d;
  const int r0 = bucket << p.log_rows;
  const int nr = min(1 << p.log_rows, p.n - r0);
  int32_t* ent_s = reinterpret_cast<int32_t*>(rows_s + (static_cast<size_t>(d) << p.log_rows));

  // stage the bucket's rows (one contiguous read, all of it in flight) and
  // the first tile of its entries
  const float* src = base + static_cast<int64_t>(r0) * d;
  const int nval = nr * d;
  const int start = offsets[cell];
  const bool async = (nval & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (async) {
    const uint64_t first = evict_first_policy();
    for (int i = threadIdx.x; i < nval / 4; i += kThreads) {
      cp_async16(rows_s + 4 * i, src + 4 * i, first);
    }
  } else {
    for (int i = threadIdx.x; i < nval; i += kThreads) rows_s[i] = __ldg(src + i);
  }
  for (int i = threadIdx.x; i < min(count, kTile); i += kThreads) {
    ent_s[i] = entries[start + i];
  }
  if (async) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u = lane & 7;           // lane in the group
  const int grp = lane >> 3;        // group in the warp
  const int64_t out0 = static_cast<int64_t>(w) * p.window * p.C;
  const float* qbase = base + static_cast<int64_t>(w) * p.window * d;
  const int32_t pos_mask = (1 << p.pos_bits) - 1;

  for (int t0 = 0; t0 < count; t0 += kTile) {
    const int tn = min(count - t0, kTile);
    if (t0 > 0) {
      __syncthreads();
      for (int i = threadIdx.x; i < tn; i += kThreads) ent_s[i] = entries[start + t0 + i];
      __syncthreads();
    }
    for (int g0 = warp * kRows; g0 < tn; g0 += kWarps * kRows) {
      int32_t ent[kGroupRows];
      int qo[kGroupRows], xo[kGroupRows];
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) {
        const int at = g0 + grp * kGroupRows + i;
        const int32_t e = at < tn ? ent_s[at] : -1;   // -1: no entry, row 0 x row 0
        const uint32_t pair = static_cast<uint32_t>(e & pos_mask);
        ent[i] = e;
        qo[i] = e < 0 ? 0 : static_cast<int>((pair * p.div_magic) >> p.div_shift) * d;
        xo[i] = e < 0 ? 0 : (e >> p.pos_bits) * d;
      }
      float dist[kGroupRows];
      group_distances<METRIC, KB, VEC, true>(rows_s, xo, qbase, qo, d, u, dist);
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) {
        if (u == 0 && ent[i] >= 0) out[out0 + (ent[i] & pos_mask)] = dist[i];
      }
    }
  }
}

// direct: every pair scored in place, no partition. Each warp takes kRows
// consecutive pairs at a time (grid-stride), kGroupRows a group, candidate
// and query rows both from global memory. Ids < 0 write +inf.
template <int METRIC, int KB, bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_distance_pool_direct_kernel(const float* __restrict__ base,
                                   const int32_t* __restrict__ pool,
                                   float* __restrict__ out, int n, int d, int C) {
  const int lane = threadIdx.x & 31;
  const int u = lane & 7;
  const int grp = lane >> 3;
  const int64_t pairs = static_cast<int64_t>(n) * C;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps * kRows;
  for (int64_t g0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kRows;
       g0 < pairs; g0 += step) {  // warp-uniform
    int64_t at[kGroupRows], xo[kGroupRows], qo[kGroupRows];
    int32_t id[kGroupRows];
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      at[i] = g0 + grp * kGroupRows + i;
      id[i] = at[i] < pairs ? __ldg(pool + at[i]) : -1;
      xo[i] = static_cast<int64_t>(id[i] < 0 ? 0 : min(id[i], n - 1)) * d;
      qo[i] = (at[i] < pairs ? at[i] / C : 0) * d;
    }
    float dist[kGroupRows];
    group_distances<METRIC, KB, VEC, false>(base, xo, base, qo, d, u, dist);
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      if (u == 0 && at[i] < pairs) out[at[i]] = id[i] < 0 ? INFINITY : dist[i];
    }
  }
}

void set_smem(const void* kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
}

struct ScoreLaunch {
  dim3 grid;
  size_t smem;
  cudaStream_t s;
  const float* base;
  const int32_t *counts, *offsets, *entries;
  float* out;
  Plan p;
  template <int METRIC, int KB, bool VEC>
  void run() const {
    auto kernel = gather_distance_pool_score_kernel<METRIC, KB, VEC>;
    set_smem(reinterpret_cast<const void*>(kernel), smem);
    kernel<<<grid, kThreads, smem, s>>>(base, counts, offsets, entries, out, p);
  }
};

struct DirectLaunch {
  int blocks;
  cudaStream_t s;
  const float* base;
  const int32_t* pool;
  float* out;
  int n, d, C;
  template <int METRIC, int KB, bool VEC>
  void run() const {
    gather_distance_pool_direct_kernel<METRIC, KB, VEC><<<blocks, kThreads, 0, s>>>(
        base, pool, out, n, d, C);
  }
};

}  // namespace

// One call scores windows [w0, w0 + n_windows) of the pass with 4 kernel
// launches (hist, scan, scatter, score) after one memset. base (n, d) f32,
// pool (n, C) i32 -> out (n, C) f32. entries holds n_windows * window * C
// int32; counts, offsets and cursor n_windows * n_buckets int32 each. All
// contiguous, on one device. Returns cudaGetLastError() after the launches.
extern "C" int gather_distance_pool_f32(const float* base, const int32_t* pool,
                                        float* out, int32_t* entries,
                                        int32_t* counts, int32_t* offsets,
                                        int32_t* cursor, int n, int d, int C,
                                        int window, int w0, int n_windows,
                                        int log_rows, int n_buckets, int chunk,
                                        int pos_bits, unsigned long long div_magic,
                                        int div_shift, int metric,
                                        void* stream) {
  const Plan p{n, d, C, window, w0, log_rows, n_buckets, chunk, pos_bits, div_shift,
               div_magic};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(counts, 0, sizeof(int32_t) * n_windows * n_buckets, s);
  const int chunks = (window * C + chunk - 1) / chunk;
  const dim3 pgrid(chunks, n_windows);
  const size_t hsmem = sizeof(int32_t) * n_buckets;
  const size_t xsmem = sizeof(int32_t) * (2 * static_cast<size_t>(n_buckets) + chunk);
  set_smem(reinterpret_cast<const void*>(gather_distance_pool_scatter_kernel), xsmem);
  gather_distance_pool_hist_kernel<<<pgrid, kPartThreads, hsmem, s>>>(pool, out, counts, p);
  gather_distance_pool_scan_kernel<<<n_windows, kPartThreads, 0, s>>>(counts, offsets,
                                                                      cursor, p);
  gather_distance_pool_scatter_kernel<<<pgrid, kPartThreads, xsmem, s>>>(pool, cursor,
                                                                         entries, p);
  const dim3 sgrid(n_windows * n_buckets);
  const size_t ssmem = sizeof(float) * ((static_cast<size_t>(1) << log_rows) * d + kTile);
  dispatch_group(ScoreLaunch{sgrid, ssmem, s, base, counts, offsets, entries, out, p}, metric,
                 d, aligned16(base));
  return static_cast<int>(cudaGetLastError());
}

// The whole pass in one launch of the direct kernel: base (n, d) f32, pool
// (n, C) i32 -> out (n, C) f32, all contiguous, on one device. Returns
// cudaGetLastError() after the launch.
extern "C" int gather_distance_pool_direct_f32(const float* base, const int32_t* pool,
                                               float* out, int n, int d, int C, int metric,
                                               void* stream) {
  const int64_t steps = (static_cast<int64_t>(n) * C + kWarps * kRows - 1) / (kWarps * kRows);
  const int blocks = static_cast<int>(std::min<int64_t>(steps, 1 << 16));
  dispatch_group(DirectLaunch{blocks, static_cast<cudaStream_t>(stream), base, pool, out, n, d,
                              C},
                 metric, d, aligned16(base));
  return static_cast<int>(cudaGetLastError());
}
