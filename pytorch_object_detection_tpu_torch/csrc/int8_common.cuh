// Pieces shared by the port's int8 kernels: the f32 requant epilogue and a
// __dp4a tile of int8 dot products.
//
// Every epilogue multiply and add is a separate __fmul_rn / __fadd_rn (the
// sources also build with -fmad=false): one fused multiply-add moves a value
// an ulp across a requant boundary.  __int2float_rn rounds an int32 sum to
// nearest, as the reference's astype does; rintf rounds half to even.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 8;  // output positions per thread per dot_tile
constexpr int kQ = 4;  // output channels per thread per dot_tile

__device__ __forceinline__ float epilogue(int acc, float a, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), a), b);
}

// round half to even, clip to +-127
__device__ __forceinline__ int8_t clip8(float y) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(y), -127.0f), 127.0f)));
}

// relu, round half to even, clip to 127 (the value is >= 0 after relu)
__device__ __forceinline__ int8_t requant_relu(float y) {
  return static_cast<int8_t>(static_cast<int>(fminf(rintf(fmaxf(y, 0.0f)), 127.0f)));
}

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
