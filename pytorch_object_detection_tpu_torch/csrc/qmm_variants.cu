// K4': K4's int8 GEMM tile with three epilogues, to time how much of K4 is
// its epilogue and how much the __dp4a products.  A timing harness, not a
// serving path (ops/qmm_variants.py runs it).
//
// Replaces scripts/dev_qmm_variants.py's three Pallas kernels (built by its
// ``build``), on the same shape, the stage-1 conv3 of a B=64 ResNet-50 at
// 512x512: x [1048576, 64] x w [64, 256] int8 -> int8:
//
//   full:  y = acc * a + b + res * 0.5; y = max(y, 0); clip(rint(y), +-127)
//   nores: y = max(acc * a + b, 0); clip(rint(y), +-127)
//   shift: (acc >> 8) as int8, wrapping (two's complement), as astype does
//
// Each is csrc/qmm_tile.cuh's 64 x 64 tile (K4's, unchanged) with its own
// epilogue functor; every multiply and add is a separate __fmul_rn /
// __fadd_rn under -fmad=false, so the results equal the plain versions bit
// for bit.
//
// Bound on the card: device memory (x, res and out are 64, 256 and 256 MB
// against 1.1 G int8 multiply-adds on the tensor cores' scale); here the
// products run on the CUDA cores with __dp4a, which is what the timing is
// to show.
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
  const int8_t* res;
  int8_t* out;
  int m, n, k;
};

struct Full {
  Args g;
  __device__ __forceinline__ void operator()(int m, int n, int acc) const {
    const int64_t at = static_cast<int64_t>(m) * g.n + n;
    const float y = __fadd_rn(epilogue(acc, __ldg(g.a + n), __ldg(g.b + n)),
                              __fmul_rn(static_cast<float>(g.res[at]), 0.5f));
    g.out[at] = clip8(fmaxf(y, 0.0f));
  }
};

struct NoRes {
  Args g;
  __device__ __forceinline__ void operator()(int m, int n, int acc) const {
    g.out[static_cast<int64_t>(m) * g.n + n] = clip8(fmaxf(epilogue(acc, __ldg(g.a + n), __ldg(g.b + n)), 0.0f));
  }
};

struct Shift {
  Args g;
  __device__ __forceinline__ void operator()(int m, int n, int acc) const {
    g.out[static_cast<int64_t>(m) * g.n + n] = static_cast<int8_t>(static_cast<uint8_t>((acc >> 8) & 0xff));
  }
};

template <class Epi>
__global__ void __launch_bounds__(kQmmThreads) qmm_variant_kernel(const Args g) {
  const Epi epi{g};
  qmm_tile(g.x, g.w, g.m, g.n, g.k, epi);
}

}  // namespace

// variant 0 full (res required), 1 nores, 2 shift.  x [M, K], w [N, K], res
// and out [M, N] int8, contiguous, 16-byte aligned, K % 16 == 0; a, b f32
// [N].  Returns a cudaError_t (0 = launched).
extern "C" int qmm_variant_launch(int variant, const void* x, const void* w, const void* a, const void* b,
                                  const void* res, void* out, int m, int n, int k, void* stream) {
  const Args g{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(a),
               static_cast<const float*>(b), static_cast<const int8_t*>(res), static_cast<int8_t*>(out), m, n, k};
  const dim3 grid((m + kQmmBM - 1) / kQmmBM, (n + kQmmBN - 1) / kQmmBN);
  if (grid.y > 65535 || variant < 0 || variant > 2 || (variant == 0 && res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) qmm_variant_kernel<Full><<<grid, kQmmThreads, 0, s>>>(g);
  if (variant == 1) qmm_variant_kernel<NoRes><<<grid, kQmmThreads, 0, s>>>(g);
  if (variant == 2) qmm_variant_kernel<Shift><<<grid, kQmmThreads, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}
