// The f32 requant epilogue shared by the port's int8 kernels.
//
// Every epilogue multiply and add is a separate __fmul_rn / __fadd_rn (the
// sources also build with -fmad=false): one fused multiply-add moves a value
// an ulp across a requant boundary.  __int2float_rn rounds an int32 sum to
// nearest, as the reference's astype does; rintf rounds half to even.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace
