// K4's 64 x 64 __dp4a tile of an int8 GEMM [M, K] x [N, K]^T, shared by K4
// (csrc/qconv.cu) and the K4' epilogue variants (csrc/qmm_variants.cu).
//
// A thread block owns a 64 x 64 output tile and walks K in 64-byte steps,
// staging both operands' 64-byte strips in shared memory (rows padded to
// 17 words); each thread keeps 4 x 4 int32 accumulators and adds with
// __dp4a (exact).  K must be a multiple of 16 (16-byte loads); M and N may
// be ragged.  w is [N][K]: each output channel's K-vector contiguous.  The
// epilogue is a functor ``epi(m, n, acc)`` called once for each output in
// range, with the exact int32 sum.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQmmThreads = 256;
constexpr int kQmmBM = 64, kQmmBN = 64, kQmmBK = 64;  // kQmmBK in bytes
constexpr int kQmmWords = kQmmBK / 4, kQmmPitch = kQmmWords + 1;

__device__ __forceinline__ void qmm_load_strip(int (*dst)[kQmmPitch], const int8_t* src, int rows, int row0, int k,
                                               int k0) {
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;  // 64 rows x 4 words of 16 bytes
  int4 v = make_int4(0, 0, 0, 0);
  if (row0 + r < rows && k0 + q * 16 < k)
    v = __ldg(reinterpret_cast<const int4*>(src + static_cast<int64_t>(row0 + r) * k + k0 + q * 16));
  dst[r][q * 4 + 0] = v.x;
  dst[r][q * 4 + 1] = v.y;
  dst[r][q * 4 + 2] = v.z;
  dst[r][q * 4 + 3] = v.w;
}

// the tile of block (blockIdx.x, blockIdx.y); block kQmmThreads
template <class Epi>
__device__ __forceinline__ void qmm_tile(const int8_t* x, const int8_t* w, int m, int n, int k, const Epi& epi) {
  __shared__ int xs[kQmmBM][kQmmPitch];
  __shared__ int ws[kQmmBN][kQmmPitch];
  const int m0 = blockIdx.x * kQmmBM, n0 = blockIdx.y * kQmmBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // 4 columns tx*4.., 4 rows ty*4..
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kQmmBK) {
    __syncthreads();
    qmm_load_strip(xs, x, m, m0, k, k0);
    qmm_load_strip(ws, w, n, n0, k, k0);
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < kQmmWords; ++kw) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = xs[ty * 4 + i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[tx * 4 + j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = m0 + ty * 4 + i;
    if (mm >= m) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (nn >= n) break;
      epi(mm, nn, acc[i][j]);
    }
  }
}

}  // namespace
