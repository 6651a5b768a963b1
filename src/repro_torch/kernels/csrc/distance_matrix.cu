// Batched distance matrix for Hopper, sm_90a: (B, q, d) x (B, n, d) ->
// (B, q, n) with an l2 / ip / cos epilogue. B = 1 is the plain matrix.
//
// Replaces the Pallas kernel distance_matrix
// (src/repro/kernels/distance_matrix.py). The reference is fp32: the cross
// term is an fp32 FMA product on the CUDA cores, never TF32. Row norms are
// accumulated in the same pass over d, then the epilogue writes
// max(xx - 2 x.y + yy, 0) (l2), -x.y (ip) or 1 - x.y rsqrt(xx) rsqrt(yy)
// with both norms clamped at 1e-12 (cos).
//
// What bounds it: for ground truth (q = 512 against n = 1M at d = 64) the
// flops, 2*q*n*d = 67 GFLOP, about 1.0 ms at the 67 TFLOP/s fp32 peak. For
// the GD occlusion test (B = 1M matrices of 20 x 20 at d = 64) the bytes of
// the gathered candidate rows, about 5.1 GB.
//
// Design: one block per (batch entry, BM x BN output tile); the batch index
// and the n-tile share gridDim.x so B is not limited by gridDim.z. 256
// threads each hold a TM x TN sub-tile of sums in registers; x and y tiles
// of BK = 16 columns of d are staged through shared memory, transposed so a
// thread's TM (TN) operands are contiguous. The ragged q, n and d edges are
// masked in the kernel. A 64 x 64 tile serves large matrices; a 32 x 32 tile
// serves the GD batch of small matrices, where a 64-wide tile would idle
// 90% of its threads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 16;
constexpr int kThreads = 256;

enum Metric { kL2 = 0, kIp = 1, kCos = 2 };

template <int BM, int BN, int TM, int TN, int METRIC>
__global__ void __launch_bounds__(kThreads)
distance_matrix_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       float* __restrict__ out, int q, int n, int d,
                       int n_tiles) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile / thread mismatch");
  __shared__ float xs[kBK][BM + 4];
  __shared__ float ys[kBK][BN + 4];

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

  for (int k0 = 0; k0 < d; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int gr = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < q && gk < d) ? x[static_cast<int64_t>(gr) * d + gk] : 0.f;
    }
    for (int e = tid; e < BN * kBK; e += kThreads) {
      const int c = e / kBK, kk = e % kBK;
      const int gc = n0 + c, gk = k0 + kk;
      ys[kk][c] = (gc < n && gk < d) ? y[static_cast<int64_t>(gc) * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
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
      float v;
      if (METRIC == kL2) {
        v = fmaxf(xx[i] - 2.f * acc[i][j] + yy[j], 0.f);
      } else if (METRIC == kIp) {
        v = -acc[i][j];
      } else {
        v = 1.f - acc[i][j] * rsqrtf(fmaxf(xx[i], 1e-12f)) *
                      rsqrtf(fmaxf(yy[j], 1e-12f));
      }
      out[static_cast<int64_t>(gr) * n + gc] = v;
    }
  }
}

template <int BM, int BN, int TM, int TN>
void launch(int metric, int B, int q, int n, int d, cudaStream_t stream,
            const float* x, const float* y, float* out) {
  const int n_tiles = (n + BN - 1) / BN;
  const dim3 grid(static_cast<unsigned>(B) * n_tiles, (q + BM - 1) / BM);
  switch (metric) {
    case kL2:
      distance_matrix_kernel<BM, BN, TM, TN, kL2><<<grid, kThreads, 0, stream>>>(
          x, y, out, q, n, d, n_tiles);
      break;
    case kIp:
      distance_matrix_kernel<BM, BN, TM, TN, kIp><<<grid, kThreads, 0, stream>>>(
          x, y, out, q, n, d, n_tiles);
      break;
    default:
      distance_matrix_kernel<BM, BN, TM, TN, kCos><<<grid, kThreads, 0, stream>>>(
          x, y, out, q, n, d, n_tiles);
      break;
  }
}

}  // namespace

// x (B, q, d) f32, y (B, n, d) f32 -> out (B, q, n) f32, all contiguous on
// one device. small != 0 selects the 32 x 32 tile. Returns
// cudaGetLastError() after the launch.
extern "C" int distance_matrix_f32(const float* x, const float* y, float* out,
                                   int B, int q, int n, int d, int metric,
                                   int small, void* stream) {
  if (B > 0 && q > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (small) {
      launch<32, 32, 2, 2>(metric, B, q, n, d, s, x, y, out);
    } else {
      launch<64, 64, 4, 4>(metric, B, q, n, d, s, x, y, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
