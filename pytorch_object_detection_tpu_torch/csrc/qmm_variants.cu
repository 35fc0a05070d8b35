// K4': K4's int8 GEMM tile with three epilogues, to time how much of K4 is
// its epilogue and how much the tensor-core products.  A timing harness, not
// a serving path (ops/qmm_variants.py runs it).
//
// Replaces scripts/dev_qmm_variants.py's three Pallas kernels (built by its
// ``build``), on the same shape, the stage-1 conv3 of a B=64 ResNet-50 at
// 512x512: x [1048576, 64] x w [64, 256] int8 -> int8:
//
//   full:  y = acc * a + b + res * 0.5; y = max(y, 0); clip(rint(y), +-127)
//   nores: y = max(acc * a + b, 0); clip(rint(y), +-127)
//   shift: (acc >> 8) as int8, wrapping (two's complement), as astype does
//
// Each is csrc/qmm_tile.cuh's 128 x 128 tile (K4's, on the int8 tensor
// cores) with its own epilogue functor; every multiply and add is a separate
// __fmul_rn / __fadd_rn under -fmad=false, so the results equal the plain
// versions bit for bit.
//
// Bound on the card: device memory (x, res and out are 64, 256 and 256 MB
// against 17 G int8 multiply-adds, 0.017 ms at the tensor cores' peak), so
// the three times show what K4's epilogue and its stores cost.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
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

// outputs (m, n) .. (m, n + cnt - 1) of each epilogue
struct Full {
  Args g;
  __device__ __forceinline__ void operator()(int m, int n, int cnt, const int (&acc)[16]) const {
    const int64_t at = static_cast<int64_t>(m) * g.n + n;
    int8_t r[16], o[16];
    load16(r, g.res + at, cnt);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = min(n + j, g.n - 1);
      const float y = __fadd_rn(epilogue(acc[j], __ldg(g.a + c), __ldg(g.b + c)),
                                __fmul_rn(static_cast<float>(r[j]), 0.5f));
      o[j] = clip8(fmaxf(y, 0.0f));
    }
    store16(g.out + at, o, cnt);
  }
};

struct NoRes {
  Args g;
  __device__ __forceinline__ void operator()(int m, int n, int cnt, const int (&acc)[16]) const {
    int8_t o[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = min(n + j, g.n - 1);
      o[j] = clip8(fmaxf(epilogue(acc[j], __ldg(g.a + c), __ldg(g.b + c)), 0.0f));
    }
    store16(g.out + static_cast<int64_t>(m) * g.n + n, o, cnt);
  }
};

struct Shift {
  Args g;
  __device__ __forceinline__ void operator()(int m, int n, int cnt, const int (&acc)[16]) const {
    int8_t o[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) o[j] = static_cast<int8_t>(static_cast<uint8_t>((acc[j] >> 8) & 0xff));
    store16(g.out + static_cast<int64_t>(m) * g.n + n, o, cnt);
  }
};

constexpr int kBN = 128;

// grid (ceil(M / 128), ceil(N / 128)), block kMmaThreads, dynamic smem QmmShape<128>::kSmem
template <class Epi>
__global__ void __launch_bounds__(kMmaThreads) qmm_variant_kernel(const Args g) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Epi epi{g};
  qmm_tile<kBN>(g.x, g.w, g.m, g.n, g.k, 0, (g.k + kStepBytes - 1) / kStepBytes, smem, epi);
}

// the kernel's dynamic shared memory above 48 KB, asked for once
template <class Epi>
int launch(const Args& g, cudaStream_t s) {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      qmm_variant_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, QmmShape<kBN>::kSmem));
  if (err != 0) return err;
  const dim3 grid((g.m + kQmmBM - 1) / kQmmBM, (g.n + kBN - 1) / kBN);
  qmm_variant_kernel<Epi><<<grid, kMmaThreads, QmmShape<kBN>::kSmem, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant 0 full (res required), 1 nores, 2 shift.  x [M, K], w [N, K], res
// and out [M, N] int8, contiguous, 16-byte aligned, K % 16 == 0; a, b f32
// [N].  Returns a cudaError_t (0 = launched).
extern "C" int qmm_variant_launch(int variant, const void* x, const void* w, const void* a, const void* b,
                                  const void* res, void* out, int m, int n, int k, void* stream) {
  const Args g{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(a),
               static_cast<const float*>(b), static_cast<const int8_t*>(res), static_cast<int8_t*>(out), m, n, k};
  if ((n + kBN - 1) / kBN > 65535 || variant < 0 || variant > 2 || (variant == 0 && res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) return launch<Full>(g, s);
  if (variant == 1) return launch<NoRes>(g, s);
  return launch<Shift>(g, s);
}
