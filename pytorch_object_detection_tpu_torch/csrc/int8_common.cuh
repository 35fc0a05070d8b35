// Pieces shared by the port's __dp4a int8 kernels: the f32 requant
// epilogue (int8_epilogue.cuh) and a __dp4a tile of int8 dot products.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"

namespace {

constexpr int kP = 8;  // output positions per thread per dot_tile
constexpr int kQ = 4;  // output channels per thread per dot_tile

// acc[p][q] += dot(act[p][0:k], w[(q * wstride) + 0:k]) over 16-byte words;
// act and w 16-byte aligned, k a multiple of 16
__device__ __forceinline__ void dot_tile(int (&acc)[kP][kQ], const int8_t* const (&act)[kP],
                                         const int8_t* __restrict__ w, int wstride, int k) {
  for (int kk = 0; kk < k; kk += 16) {
    int4 wv[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) wv[q] = __ldg(reinterpret_cast<const int4*>(w + q * wstride + kk));
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int4 av = *reinterpret_cast<const int4*>(act[p] + kk);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        int s = acc[p][q];
        s = __dp4a(av.x, wv[q].x, s);
        s = __dp4a(av.y, wv[q].y, s);
        s = __dp4a(av.z, wv[q].z, s);
        s = __dp4a(av.w, wv[q].w, s);
        acc[p][q] = s;
      }
    }
  }
}

__device__ __forceinline__ void zero(int (&acc)[kP][kQ]) {
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[p][q] = 0;
}

}  // namespace
