// Batched distance matrix for Hopper, sm_90a: (B, q, d) x (B, n, d) ->
// (B, q, n) with an l2 / ip / cos epilogue. B = 1 is the plain matrix.
//
// Replaces the Pallas kernel distance_matrix
// (src/repro/kernels/distance_matrix.py). The reference is fp32: the cross
// term is an fp32 FMA product on the CUDA cores, never TF32. The epilogue
// writes max(xx - 2 x.y + yy, 0) (l2), -x.y (ip) or 1 - x.y rsqrt(xx)
// rsqrt(yy) with both norms clamped at 1e-12 (cos).
//
// What bounds it: for ground truth (q = 512 against n = 1M at d = 64) the
// flops, 2*q*n*d = 67 GFLOP, about 1.0 ms at the 67 TFLOP/s fp32 peak (the
// 2.1 GB of output is 0.63 ms at 3.35 TB/s). For the GD occlusion test
// (B = 65,536 matrices of 20 x 20 at d = 64 a block) the bytes of the
// gathered candidate rows. On an H100 SXM the 128 tile's FMA loop stays
// well below the fp32 peak even at d = 1024, and at d = 64 a tile's 8
// k-steps also carry its first loads and its 64 KB of stores. chip_smoke.py
// phase 5 prints both rates beside PyTorch's fp32 product (torch.mm, TF32
// off); PERF.md records them.
//
// Two routes; the wrapper picks one (distance_matrix.matrix_route) and the
// batch index and the n-tile share gridDim.x, so B is not limited by
// gridDim.z. The ragged q, n and d edges are masked in the kernels.
//
//   - distance_matrix_large_kernel (tile 128): a 128 x 128 output tile a
//     block, 256 threads, an 8 x 8 register tile a thread: rows ty*4 + i and
//     64 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j, so a k-step reads 4
//     float4 of shared memory for 64 FMAs. A warp covers 8 tx by 4 ty: each
//     of those reads is one shared-memory wavefront with no bank conflicts,
//     and each float4 store of a warp covers 4 whole 128-byte lines. Both operands are
//     K-contiguous (C = X Y^T): each k-step of kBK = 8 columns, a thread
//     loads one float4 of x and one of y into registers while the current
//     step's FMAs run, then stores them transposed ([k][m], rows padded to
//     132 floats so the two threads of a row write other banks) into the
//     other half of a double-buffered tile; one __syncthreads a step. Within
//     a step the k-row fragments are double-buffered in registers, so the
//     next row's shared-memory reads overlap this row's FMAs. The
//     row norms leave the product loop: thread t adds the squares of tile
//     row t (x for t < 128, y above) from the shared tile, kBK FMAs a step,
//     and the epilogue reads them from shared memory. At most 128
//     registers a thread, so two blocks fit an SM. Ordinary stores: the
//     caller's top-k reads a ground-truth chunk (512 x 16,384 x 4 B =
//     33.5 MB) back from L2.
//   - distance_matrix_kernel (tile 32): the 32 x 32 tile for the GD
//     batch of small matrices (q, n <= 32), where a wider tile would idle
//     most of its threads; 2 x 2 sums a thread, norms in the product loop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Metric { kL2 = 0, kIp = 1, kCos = 2 };

template <int METRIC>
__device__ __forceinline__ float finish(float acc, float xx, float yy) {
  if (METRIC == kL2) return fmaxf(xx - 2.f * acc + yy, 0.f);
  if (METRIC == kIp) return -acc;
  return 1.f - acc * rsqrtf(fmaxf(xx, 1e-12f)) * rsqrtf(fmaxf(yy, 1e-12f));
}

// ---- tile 32: the GD batch -------------------------------------------------

constexpr int kSmallBK = 16;

template <int BM, int BN, int TM, int TN, int METRIC>
__global__ void __launch_bounds__(kThreads)
distance_matrix_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       float* __restrict__ out, int q, int n, int d,
                       int n_tiles) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile / thread mismatch");
  __shared__ float xs[kSmallBK][BM + 4];
  __shared__ float ys[kSmallBK][BN + 4];

  const int64_t b = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = blockIdx.y * BM;
  x += b * q * d;
  y += b * n * d;
  out += b * q * n;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
  float xx[TM];
  float yy[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    xx[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) yy[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kSmallBK) {
    for (int e = tid; e < BM * kSmallBK; e += kThreads) {
      const int r = e / kSmallBK, kk = e % kSmallBK;
      const int gr = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < q && gk < d) ? x[static_cast<int64_t>(gr) * d + gk] : 0.f;
    }
    for (int e = tid; e < BN * kSmallBK; e += kThreads) {
      const int c = e / kSmallBK, kk = e % kSmallBK;
      const int gc = n0 + c, gk = k0 + kk;
      ys[kk][c] = (gc < n && gk < d) ? y[static_cast<int64_t>(gc) * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSmallBK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ys[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        xx[i] = fmaf(a[i], a[i], xx[i]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) yy[j] = fmaf(bv[j], bv[j], yy[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = m0 + ty * TM + i;
    if (gr >= q) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = n0 + tx * TN + j;
      if (gc >= n) continue;
      out[static_cast<int64_t>(gr) * n + gc] = finish<METRIC>(acc[i][j], xx[i], yy[j]);
    }
  }
}

// ---- tile 128: ground truth and every other large matrix -------------------

constexpr int kTile = 128;         // output rows and columns a block
constexpr int kBK = 8;             // columns of d a k-step
constexpr int kLd = kTile + 4;     // a staged k-row, padded against bank conflicts
constexpr int kHalf = kTile / 2;   // a thread's second row / column group

// 4 values of ``row`` from column k (masked past d, or all zeros for a row
// outside the matrix): one 16-byte load when VEC.
template <bool VEC>
__device__ __forceinline__ float4 stage_load(const float* __restrict__ row, bool in, int k,
                                             int d) {
  if (VEC) {
    return in && k < d ? __ldg(reinterpret_cast<const float4*>(row + k))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 v;
  v.x = in && k < d ? __ldg(row + k) : 0.f;
  v.y = in && k + 1 < d ? __ldg(row + k + 1) : 0.f;
  v.z = in && k + 2 < d ? __ldg(row + k + 2) : 0.f;
  v.w = in && k + 3 < d ? __ldg(row + k + 3) : 0.f;
  return v;
}

__device__ __forceinline__ void stage_store(float (*s)[kLd], int k, int r, float4 v) {
  s[k][r] = v.x;
  s[k + 1][r] = v.y;
  s[k + 2][r] = v.z;
  s[k + 3][r] = v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// VEC: d % 4 == 0, n % 4 == 0 and x, y, out 16-byte aligned (float4 loads
// and stores); else scalar ones.
template <int METRIC, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
distance_matrix_large_kernel(const float* __restrict__ x, const float* __restrict__ y,
                             float* __restrict__ out, int q, int n, int d, int n_tiles) {
  __shared__ __align__(16) float xs[2][kBK][kLd];
  __shared__ __align__(16) float ys[2][kBK][kLd];
  __shared__ __align__(16) float norm_s[2 * kTile];   // x rows, then y rows

  const int64_t b = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * kTile;
  const int m0 = blockIdx.y * kTile;
  x += b * q * d;
  y += b * n * d;
  out += b * q * n;

  const int tid = threadIdx.x;
  // staging: thread tid loads tile row tid / 2, columns 4 (tid % 2) .. + 3
  const int sr = tid >> 1;
  const int sk = (tid & 1) * 4;
  const bool x_in = m0 + sr < q;
  const bool y_in = n0 + sr < n;
  const float* xrow = x + static_cast<int64_t>(x_in ? m0 + sr : 0) * d;
  const float* yrow = y + static_cast<int64_t>(y_in ? n0 + sr : 0) * d;
  // the product: rows ty*4 + i (+ 64), columns tx*4 + j (+ 64); a warp
  // covers 8 tx by 4 ty, so each float4 read of a k-row is one wavefront
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  // the norms: thread tid sums row tid of x (tid < 128) or tid - 128 of y
  const float* nrow = tid < kTile ? &xs[0][0][tid] : &ys[0][0][tid - kTile];

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  float nrm = 0.f;

  const int steps = (d + kBK - 1) / kBK;
  float4 xv = stage_load<VEC>(xrow, x_in, sk, d);
  float4 yv = stage_load<VEC>(yrow, y_in, sk, d);
  stage_store(xs[0], sk, sr, xv);
  stage_store(ys[0], sk, sr, yv);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool next = s + 1 < steps;
    if (next) {   // in flight while the FMAs below run (ptxas keeps these
      // loads at the loop's top in this form; where it sank them to the
      // stores below, each step waited on them)
      xv = stage_load<VEC>(xrow, x_in, (s + 1) * kBK + sk, d);
      yv = stage_load<VEC>(yrow, y_in, (s + 1) * kBK + sk, d);
    }
    const float* nr = nrow + cur * kBK * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) nrm = fmaf(nr[kk * kLd], nr[kk * kLd], nrm);
    // the k-row fragments double-buffered: row kk + 1's 4 float4 reads are
    // in flight while row kk's 64 FMAs run
    float4 fa[2][2], fb[2][2];
    fa[0][0] = ld4(&xs[cur][0][ty * 4]);
    fa[0][1] = ld4(&xs[cur][0][kHalf + ty * 4]);
    fb[0][0] = ld4(&ys[cur][0][tx * 4]);
    fb[0][1] = ld4(&ys[cur][0][kHalf + tx * 4]);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const int f = kk & 1;
      if (kk + 1 < kBK) {
        fa[f ^ 1][0] = ld4(&xs[cur][kk + 1][ty * 4]);
        fa[f ^ 1][1] = ld4(&xs[cur][kk + 1][kHalf + ty * 4]);
        fb[f ^ 1][0] = ld4(&ys[cur][kk + 1][tx * 4]);
        fb[f ^ 1][1] = ld4(&ys[cur][kk + 1][kHalf + tx * 4]);
      }
      const float a[8] = {fa[f][0].x, fa[f][0].y, fa[f][0].z, fa[f][0].w,
                          fa[f][1].x, fa[f][1].y, fa[f][1].z, fa[f][1].w};
      const float bv[8] = {fb[f][0].x, fb[f][0].y, fb[f][0].z, fb[f][0].w,
                           fb[f][1].x, fb[f][1].y, fb[f][1].z, fb[f][1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
    if (next) {
      stage_store(xs[cur ^ 1], sk, sr, xv);
      stage_store(ys[cur ^ 1], sk, sr, yv);
    }
    __syncthreads();
  }
  norm_s[tid] = nrm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : kHalf) + ty * 4 + (i & 3);
    const int gr = m0 + r;
    if (gr >= q) continue;
    const float xx = norm_s[r];
    float* orow = out + static_cast<int64_t>(gr) * n + n0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * kHalf + tx * 4;
      const float4 yy = ld4(&norm_s[kTile + c]);
      const float v[4] = {finish<METRIC>(acc[i][4 * h], xx, yy.x),
                          finish<METRIC>(acc[i][4 * h + 1], xx, yy.y),
                          finish<METRIC>(acc[i][4 * h + 2], xx, yy.z),
                          finish<METRIC>(acc[i][4 * h + 3], xx, yy.w)};
      if (VEC) {   // n % 4 == 0: the 4 columns are all in or all out
        if (n0 + c < n) {
          *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n0 + c + j < n) orow[c + j] = v[j];
        }
      }
    }
  }
}

// ---- launch ----------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int METRIC>
void launch_metric(int tile, int B, int q, int n, int d, cudaStream_t stream,
                   const float* x, const float* y, float* out) {
  const int n_tiles = (n + tile - 1) / tile;
  const dim3 grid(static_cast<unsigned>(B) * n_tiles, (q + tile - 1) / tile);
  if (tile == 32) {
    distance_matrix_kernel<32, 32, 2, 2, METRIC><<<grid, kThreads, 0, stream>>>(
        x, y, out, q, n, d, n_tiles);
  } else if (d % 4 == 0 && n % 4 == 0 && aligned16(x) && aligned16(y) && aligned16(out)) {
    distance_matrix_large_kernel<METRIC, true><<<grid, kThreads, 0, stream>>>(
        x, y, out, q, n, d, n_tiles);
  } else {
    distance_matrix_large_kernel<METRIC, false><<<grid, kThreads, 0, stream>>>(
        x, y, out, q, n, d, n_tiles);
  }
}

}  // namespace

// x (B, q, d) f32, y (B, n, d) f32 -> out (B, q, n) f32, all contiguous on
// one device. tile is the route: 32 (the GD batch) or 128. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue (1) for another
// tile.
extern "C" int distance_matrix_f32(const float* x, const float* y, float* out,
                                   int B, int q, int n, int d, int metric,
                                   int tile, void* stream) {
  if (tile != 32 && tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && q > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (metric) {
      case kL2:
        launch_metric<kL2>(tile, B, q, n, d, s, x, y, out);
        break;
      case kIp:
        launch_metric<kIp>(tile, B, q, n, d, s, x, y, out);
        break;
      default:
        launch_metric<kCos>(tile, B, q, n, d, s, x, y, out);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
