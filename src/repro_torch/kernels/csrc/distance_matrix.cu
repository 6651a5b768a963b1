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
// (B = 65,536 matrices of 20 x 20 at d = 64 a call, x is y) the bytes: the
// gathered rows once (335.5 MB) and the matrices out (104.9 MB), 0.13 ms
// at 3.35 TB/s; its 3.4 GFLOP are 0.05 ms. chip_smoke.py phase 5 prints
// both rates beside PyTorch's calls; PERF.md records them.
//
// Three kernels. The wrapper picks the route (distance_matrix.matrix_route
// and small_plan); the ragged q, n and d edges are handled in the kernels.
//
//   - distance_matrix_small_kernel, the route wherever q, n <= 32 (the GD
//     batch): one warp a matrix, 8 warps a block, a persistent grid whose
//     warps walk over the matrices. A warp stages its matrix's rows in
//     shared memory with cp.async (16-byte copies where d % 4 == 0 and x, y
//     are 16-byte aligned, else 4-byte ones), every copy of a stage sent
//     before any wait, double-buffered per warp so the next stage's copies
//     are in flight under this stage's FMAs; a stage is a chunk of kc
//     columns of one matrix (kc = 64 at the GD shape, the whole row). When
//     x and y are one tensor (the GD call) one copy serves both sides.
//     Rows are padded to a stride with stride / 4 odd, so the float4 reads
//     of neighbouring rows fall in different bank groups. Lane t holds the
//     4 x 4 outputs (rows bi + RB*i, columns bj + CB*j) of block t of the
//     RB x CB blocks (RB = ceil(q/4), CB = ceil(n/4); a second block t + 32
//     where RB*CB > 32), none on padding. Where x is y and q <= 20 (the GD
//     call) the dot products are symmetric bit for bit, so lane t sums a 4
//     x 2 half of one block on or above the diagonal and writes each sum to
//     (r, c) and (c, r), each with its own epilogue: 30 of 32 lanes at 20 x
//     20 and half the FMAs. Lane r sums row r's norm. The outputs go
//     through shared memory and out as float4 stores across the warp: a
//     matrix's q*n outputs are contiguous. Its sums are the 32 x 32 tile's:
//     each dot product and norm one fmaf chain over k = 0..d-1, the same
//     epilogue, so the two give the same bits. At the GD shape loads and
//     stores alone take about as long as the FMAs alone (PERF.md), and the
//     two overlap across the 16 warps of an SM.
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
//     33.5 MB) back from L2. The batch index and the n-tile share
//     gridDim.x, so B is not limited by gridDim.z.
//   - distance_matrix_kernel (tile 32): the first 32 x 32 tile a block for q,
//     n <= 32, 2 x 2 sums a thread, norms in the product loop. No path of
//     the port runs it: it is the small route's yardstick, bit for bit and
//     in time (distance_matrix.distance_matrix_tile32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using repro_kernels::cp_async;
using repro_kernels::cp_async_commit;
using repro_kernels::cp_async_wait_prior;

constexpr int kThreads = 256;

enum Metric { kL2 = 0, kIp = 1, kCos = 2 };

template <int METRIC>
__device__ __forceinline__ float finish(float acc, float xx, float yy) {
  if (METRIC == kL2) return fmaxf(xx - 2.f * acc + yy, 0.f);
  if (METRIC == kIp) return -acc;
  return 1.f - acc * rsqrtf(fmaxf(xx, 1e-12f)) * rsqrtf(fmaxf(yy, 1e-12f));
}

// ---- tile 32: the small route's yardstick ----------------------------------

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

// ---- the small route: one warp a matrix ------------------------------------

constexpr int kSmallWarps = 8;
constexpr int kNormSlots = 64;   // a warp's norms: x rows at 0.., y rows at 32..

// One stage of a warp: columns [c0, c0 + width) of the ``rows`` rows of its
// matrix (x rows, then y rows unless x is y) into ``buf``, row r at r *
// stride, zero-filled up to a multiple of 4 columns. VEC: 16-byte copies
// (d % 4 == 0, x and y 16-byte aligned, so width % 4 == 0), else 4-byte.
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* buf, const float* xm, const float* ym,
                                           int q, int rows, int d, int c0, int width,
                                           int stride, int lane) {
  const int step = VEC ? 4 : 1;
  const int per = VEC ? width / 4 : (width + 3) & ~3;   // copies a row
  if (per == 0) return;
  auto copy = [&](int r, int p) {
    const float* row = (r < q ? xm + static_cast<int64_t>(r) * d
                              : ym + static_cast<int64_t>(r - q) * d) + c0;
    const int col = p * step;
    if (VEC) {
      cp_async<16>(buf + r * stride + col, row + col, 16);
    } else {
      const bool in = col < width;
      cp_async<4>(buf + r * stride + col, in ? row + col : row, in ? 4 : 0);
    }
  };
  if (per <= 32) {   // 32 / per rows a pass, one copy a lane
    const int rpp = 32 / per;
    const int r0 = lane / per, p = lane - r0 * per;
    if (r0 < rpp) {
      for (int r = r0; r < rows; r += rpp) copy(r, p);
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      for (int p = lane; p < per; p += 32) copy(r, p);
    }
  }
}

template <int METRIC>
__device__ __forceinline__ float finish_small(float acc, float xx, float yy) {
  if (METRIC != kCos) return finish<METRIC>(acc, xx, yy);
  // cos as distance_matrix_kernel compiles finish: (acc * rx) * ry
  // subtracted from 1 in one fma. Spelled out, as whether nvcc contracts
  // the expression depends on the code around it.
  return __fmaf_rn(-__fmul_rn(acc, rsqrtf(fmaxf(xx, 1e-12f))), rsqrtf(fmaxf(yy, 1e-12f)),
                   1.f);
}

// SYM (x is y, q <= 20): the dot products are symmetric bit for bit (an
// fmaf's product is exact, so fmaf(a, b, c) == fmaf(b, a, c)), so a lane
// sums a 4 x 2 half of one of the RB (RB + 1) / 2 blocks on or above the
// diagonal (rows bi + RB*i, columns bj + RB*(2h + j), bi <= bj) and writes
// each output twice, (r, c) and (c, r), each with its own epilogue: 30 of
// 32 lanes at 20 x 20, half the FMAs. Duplicates on the diagonal blocks
// write equal values.
constexpr int kSymMaxRB = 5;

// B matrices of (q, d) x (n, d), q, n <= 32; ``same``: y is x. A warp's
// shared memory: two stage buffers of rows * stride floats, the matrix's
// q*n outputs (rounded up to 4) and kNormSlots norms. PASSES: output blocks
// a lane (2 where RB*CB > 32; 1 for SYM). VEC: as stage_rows.
template <int METRIC, int PASSES, bool VEC, bool SYM>
__global__ void __launch_bounds__(kSmallWarps * 32, 2)
distance_matrix_small_kernel(const float* __restrict__ x, const float* __restrict__ y,
                             float* __restrict__ out, int B, int q, int n, int d, int same,
                             int kc, int stride) {
  constexpr int NC = SYM ? 2 : 4;   // columns a lane's block
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = same ? q : q + n;
  const int buf_floats = rows * stride;
  const int qn = q * n;
  const int out_floats = (qn + 3) & ~3;
  float* ws = smem + warp * (2 * buf_floats + out_floats + kNormSlots);
  float* out_s = ws + 2 * buf_floats;
  float* norm_s = out_s + out_floats;

  const int chunks = max(1, (d + kc - 1) / kc);   // d = 0: one empty stage
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kSmallWarps;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kSmallWarps + warp;
  if (first >= B) return;   // warp-uniform; no block barrier follows
  const int64_t stages = ((B - 1 - first) / warps + 1) * chunks;

  // this lane's output block of each pass: rows r[i], columns c[j]; the
  // staged row of each (clamped: a row past q or n is read, never stored)
  const int RB = (q + 3) / 4, CB = (n + 3) / 4;
  const int yoff = same ? 0 : q;
  bool active[PASSES];
  int r_[PASSES][4], c_[PASSES][NC], xr[PASSES][4], yr[PASSES][NC];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int blk = p * 32 + lane;
    int bi = 0, bj = 0, c0 = 0, cstep = CB;
    if (SYM) {   // half h of block t of the blocks on or above the diagonal
      active[p] = blk < RB * (RB + 1);
      int t = active[p] ? blk >> 1 : 0;
      while (t >= RB - bi) {
        t -= RB - bi;
        ++bi;
      }
      bj = bi + t;
      c0 = RB * 2 * (blk & 1);
      cstep = RB;
    } else {
      active[p] = blk < RB * CB;
      bi = active[p] ? blk / CB : 0;
      bj = active[p] ? blk % CB : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r_[p][i] = bi + RB * i;
      xr[p][i] = min(r_[p][i], q - 1) * stride;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      c_[p][j] = bj + c0 + cstep * j;
      yr[p][j] = (yoff + min(c_[p][j], n - 1)) * stride;
    }
  }

  auto load_stage = [&](int64_t s) {
    const int64_t m = first + (s / chunks) * warps;
    const int c0 = static_cast<int>(s % chunks) * kc;
    stage_rows<VEC>(ws + (s & 1) * buf_floats, x + m * q * d, y + m * n * d, q, rows, d, c0,
                    min(kc, d - c0), stride, lane);
  };

  float acc[PASSES][4][NC];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[p][i][j] = 0.f;
    }
  }
  float nx = 0.f, ny = 0.f;   // lane r: the norm of x row r, of y row r

  load_stage(0);
  cp_async_commit();
  for (int64_t s = 0; s < stages; ++s) {
    if (s + 1 < stages) load_stage(s + 1);   // into the buffer stage s - 1 read
    cp_async_commit();
    cp_async_wait_prior();              // this lane's copies of stage s
    __syncwarp();                       // ... and every lane's
    const float* bs = ws + (s & 1) * buf_floats;
    const int c = static_cast<int>(s % chunks);
    const int w4 = (min(kc, d - c * kc) + 3) & ~3;
    if (lane < q) {
      const float* r = bs + lane * stride;
      for (int k = 0; k < w4; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(r + k);
        nx = fmaf(v.x, v.x, nx);
        nx = fmaf(v.y, v.y, nx);
        nx = fmaf(v.z, v.z, nx);
        nx = fmaf(v.w, v.w, nx);
      }
    }
    if (!same && lane < n) {
      const float* r = bs + (q + lane) * stride;
      for (int k = 0; k < w4; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(r + k);
        ny = fmaf(v.x, v.x, ny);
        ny = fmaf(v.y, v.y, ny);
        ny = fmaf(v.z, v.z, ny);
        ny = fmaf(v.w, v.w, ny);
      }
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      if (!active[p]) continue;
      for (int k = 0; k < w4; k += 4) {   // the product
        float4 a[4], b[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(bs + xr[p][i] + k);
#pragma unroll
        for (int j = 0; j < NC; ++j) b[j] = *reinterpret_cast<const float4*>(bs + yr[p][j] + k);
        // columns k .. k + 3 in order: each sum's fmaf chain runs over k
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[p][i][j] = fmaf(a[i].x, b[j].x, acc[p][i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[p][i][j] = fmaf(a[i].y, b[j].y, acc[p][i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[p][i][j] = fmaf(a[i].z, b[j].z, acc[p][i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[p][i][j] = fmaf(a[i].w, b[j].w, acc[p][i][j]);
        }
      }
    }
    __syncwarp();   // every lane is done reading this buffer
    if (c != chunks - 1) continue;

    // the matrix is done: norms to shared memory, the outputs through
    // shared memory, then out as one contiguous span
    if (lane < q) norm_s[lane] = nx;
    if (lane < n) norm_s[32 + lane] = same ? nx : ny;
    nx = ny = 0.f;
    __syncwarp();
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r_[p][i];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = c_[p][j];
          if (active[p] && r < q && col < n) {
            out_s[r * n + col] = finish_small<METRIC>(acc[p][i][j], norm_s[r], norm_s[32 + col]);
            if (SYM) {   // the mirror output, (col, r): its own epilogue
              out_s[col * n + r] =
                  finish_small<METRIC>(acc[p][i][j], norm_s[col], norm_s[32 + r]);
            }
          }
          acc[p][i][j] = 0.f;
        }
      }
    }
    __syncwarp();
    float* om = out + (first + (s / chunks) * warps) * qn;
    if ((qn & 3) == 0) {   // om is 16-byte aligned: out is, and qn % 4 == 0
      for (int e = lane * 4; e < qn; e += 128) {
        *reinterpret_cast<float4*>(om + e) = *reinterpret_cast<const float4*>(out_s + e);
      }
    } else {
      for (int e = lane; e < qn; e += 32) om[e] = out_s[e];
    }
    // out_s is written again only after the next stage's __syncwarp
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

template <int METRIC, int PASSES, bool SYM>
void launch_small(bool vec, unsigned blocks, size_t smem, cudaStream_t stream,
                  const float* x, const float* y, float* out, int B, int q, int n, int d,
                  int same, int kc, int stride) {
  auto kernel = vec ? distance_matrix_small_kernel<METRIC, PASSES, true, SYM>
                    : distance_matrix_small_kernel<METRIC, PASSES, false, SYM>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  kernel<<<blocks, kSmallWarps * 32, smem, stream>>>(x, y, out, B, q, n, d, same, kc, stride);
}

template <int METRIC>
void launch_small_metric(bool vec, unsigned blocks, size_t smem, cudaStream_t stream,
                         const float* x, const float* y, float* out, int B, int q, int n,
                         int d, int same, int kc, int stride) {
  if (same && (q + 3) / 4 <= kSymMaxRB) {
    launch_small<METRIC, 1, true>(vec, blocks, smem, stream, x, y, out, B, q, n, d, same, kc,
                                  stride);
  } else if (((q + 3) / 4) * ((n + 3) / 4) > 32) {
    launch_small<METRIC, 2, false>(vec, blocks, smem, stream, x, y, out, B, q, n, d, same, kc,
                                   stride);
  } else {
    launch_small<METRIC, 1, false>(vec, blocks, smem, stream, x, y, out, B, q, n, d, same, kc,
                                   stride);
  }
}

}  // namespace

// x (B, q, d) f32, y (B, n, d) f32 -> out (B, q, n) f32, all contiguous on
// one device. tile picks the kernel: 128 (the large route) or 32 (the
// 32 x 32 tile, q, n <= 32: the small route's yardstick). Returns
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

// The small route (distance_matrix_small_kernel): x (B, q, d) f32, y (B, n,
// d) f32 -> out (B, q, n) f32, all contiguous on one device, 1 <= q, n <=
// 32; same != 0 when y is x. kc columns a stage (a multiple of 4), rows
// padded to ``stride`` floats (a multiple of 4), ``blocks`` blocks of 8
// warps (distance_matrix.small_plan and matrix_route). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue (1) for a
// plan the kernel does not take.
extern "C" int distance_matrix_small_f32(const float* x, const float* y, float* out, int B,
                                         int q, int n, int d, int metric, int same, int kc,
                                         int stride, int blocks, void* stream) {
  const size_t warp_floats = 2 * static_cast<size_t>(same ? q : q + n) * stride +
                             ((q * n + 3) & ~3) + kNormSlots;
  const size_t smem = kSmallWarps * warp_floats * sizeof(float);
  if (q < 1 || q > 32 || n < 1 || n > 32 || d < 0 || kc < 4 || kc % 4 != 0 ||
      stride < kc || stride % 4 != 0 || blocks < 1 || (same && q != n) ||
      smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B > 0) {
    const bool vec = d % 4 == 0 && aligned16(x) && aligned16(y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned nb = static_cast<unsigned>(blocks);
    switch (metric) {
      case kL2:
        launch_small_metric<kL2>(vec, nb, smem, s, x, y, out, B, q, n, d, same, kc, stride);
        break;
      case kIp:
        launch_small_metric<kIp>(vec, nb, smem, s, x, y, out, B, q, n, d, same, kc, stride);
        break;
      default:
        launch_small_metric<kCos>(vec, nb, smem, s, x, y, out, B, q, n, d, same, kc, stride);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
