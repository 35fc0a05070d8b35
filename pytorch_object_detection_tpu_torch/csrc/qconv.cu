// K4: int8 GEMM [M, K] x [K, N] with the fused requant epilogue; the 1x1
// convs of the HisFPN laterals (tf1, tf2, tf3) run through it.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_qconv.py:qmatmul (both of
// its pallas_calls: with and without the int8 residual) and :qconv1x1, which
// reshapes NHWC to [B*H*W, C].  The TPU kernel takes a (tile_m x K) strip of
// x and a (K x tile_n) strip of w into VMEM and runs one MXU dot per tile,
// with the epilogue on the accumulator in VMEM, so device memory sees int8
// only.  The same data rule holds here:
//
//   y   = acc * A[n] + B[n]            (acc: exact int32 sum, converted to f32)
//   y  += res[m, n] * res_scale        (residual variant only)
//   y   = max(y, 0)                    (relu flag)
//   out = clip(rint(y), -127, 127)     (round half to even)
//
// The GEMM is csrc/qmm_tile.cuh's 64 x 64 __dp4a tile (shared with the K4'
// epilogue variants of csrc/qmm_variants.cu); this file is its epilogue.
//
// Bound on the card: int8 multiply-adds, on the CUDA cores (dp4a) rather
// than the tensor cores; the operands cross device memory about once
// (x once per 64 output channels, w once per 64 rows, both from L2).  An
// mma.sync / wgmma version is the next step.
//
// Bit-exactness with the plain version (torch._int_mm + the same epilogue):
// |acc| reaches 127^2 * 2048 > 2^24 for tf1, so the int32 -> f32
// conversion rounds (__int2float_rn, as the reference's astype does); each
// multiply and add is a separate __fmul_rn / __fadd_rn under -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"
#include "qmm_tile.cuh"

namespace {

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* a;
  const float* b;
  const int8_t* res;  // nullptr: no residual
  const float* res_scale;
  int8_t* out;
  int m, n, k, relu;
};

struct Requant {
  Args g;
  float rs;
  __device__ __forceinline__ void operator()(int m, int n, int acc) const {
    const int64_t at = static_cast<int64_t>(m) * g.n + n;
    float y = epilogue(acc, __ldg(g.a + n), __ldg(g.b + n));
    if (g.res != nullptr) y = __fadd_rn(y, __fmul_rn(static_cast<float>(g.res[at]), rs));
    if (g.relu) y = fmaxf(y, 0.0f);
    g.out[at] = clip8(y);
  }
};

// grid (ceil(M / 64), ceil(N / 64)), block kQmmThreads
__global__ void __launch_bounds__(kQmmThreads) qmm_kernel(const Args g) {
  const Requant epi{g, g.res != nullptr ? __ldg(g.res_scale) : 0.0f};
  qmm_tile(g.x, g.w, g.m, g.n, g.k, epi);
}

}  // namespace

// x [M, K], w [N, K], res [M, N] (or null), out [M, N]: int8, row-major,
// contiguous, 16-byte aligned, K % 16 == 0.  a, b f32 [N]; res_scale one
// f32 on the device (read only with res).  Returns a cudaError_t (0 = launched).
extern "C" int qmm_launch(const void* x, const void* w, const void* a, const void* b, const void* res,
                          const void* res_scale, void* out, int m, int n, int k, int relu, void* stream) {
  Args g;
  g.x = static_cast<const int8_t*>(x);
  g.w = static_cast<const int8_t*>(w);
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.res = static_cast<const int8_t*>(res);
  g.res_scale = static_cast<const float*>(res_scale);
  g.out = static_cast<int8_t*>(out);
  g.m = m;
  g.n = n;
  g.k = k;
  g.relu = relu;
  const dim3 grid((m + kQmmBM - 1) / kQmmBM, (n + kQmmBN - 1) / kQmmBN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  qmm_kernel<<<grid, kQmmThreads, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
