// K16: out = act((x @ w^T) * scale + shift (+ residual)), bf16 in and out, the
// product accumulated in f32 on the tensor cores and the epilogue in f32
// registers before the single bf16 store.  The fused ResNet-50's conv1 and
// conv3 (nn/fused_resnet.resnet50_fused_forward) run through it: a 1x1
// stride-1 conv over an NHWC map is this GEMM with M = B*H*W, and conv3
// takes the block's shortcut as the residual and the ReLU.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_fused.py:matmul_bn_act
// (both of its pallas_calls, with and without the residual) and
// :conv1x1_bn_act.  The TPU kernel keeps a (block_m x K) strip of x and a
// (K x block_n) strip of w in VMEM and runs one MXU dot, so the frozen BN,
// the residual add and the ReLU cost no extra pass over device memory.
// The same rule holds here; the TPU tiling rules (block_m dividing M, K and
// N multiples of 128) do not: M, N and K may be anything (a K that is not a
// multiple of 8, or an operand that is not 16-byte aligned, takes the
// word-by-word loads).
//
// Layouts: x [M, K], w [N, K] (the port's OIHW 1x1 weight: each output
// channel's K-vector contiguous, the .col B operand of mma.sync as it is),
// residual and out [M, N], all bf16 row-major; scale, shift f32 [N].
//
// Design: csrc/bf16_mma.cuh's tile, 128 x 128 (128 x 64 where N <= 64, the
// ResNet's first stage), 8 warps of m16n8k16 bf16 mma.sync, K in steps of
// 32 double-buffered through shared memory.
//
// Bound on the card: at 512x512 the 32 GEMMs of a B=8 forward move 1.82 GB
// and do 73.6 G multiply-adds, about 80 per byte, under the card's ~295
// bf16 operations per byte: device memory bounds them.  A wgmma/TMA
// pipeline is the next step; this tile aims to be right first.
//
// Numerics: each epilogue multiply and add is a separate f32 operation
// (-fmad=false), in the reference's order; the product's sum runs in
// another order than the plain version's f32 matmul, so an output may
// differ from it by one bf16 rounding step.
#include "bf16_mma.cuh"

namespace {

struct Args {
  const uint16_t* x;
  const uint16_t* w;
  const float* scale;
  const float* shift;
  const uint16_t* res;  // nullptr: no residual
  uint16_t* out;
  int m, n, k, act;
  bool vec;
};

template <class T>
__global__ void __launch_bounds__(kThreads) matmul_bn_act_kernel(const Args g) {
  __shared__ __align__(16) typename T::Smem sm;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int rows = g.m - m0 < T::BM ? static_cast<int>(g.m - m0) : T::BM;
  const PlainOperand la{g.x, m0, rows, g.k, g.k, g.vec};
  const PlainOperand lb{g.w, n0, min(T::BN, g.n - n0), g.k, g.k, g.vec};
  typename T::Acc acc;
  T::mainloop(acc, sm, la, lb, g.k);

  const bool aligned = (g.n % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + T::row(mt, 2 * h);
      if (m >= g.m) continue;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int n = n0 + T::col(nt, 0);
        if (n >= g.n) continue;
        const bool both = n + 1 < g.n;
        const int64_t at = m * g.n + n;
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j == 1 && !both) {
            y[1] = 0.0f;
            continue;
          }
          float v = __fadd_rn(__fmul_rn(acc[mt][nt][2 * h + j], __ldg(g.scale + n + j)), __ldg(g.shift + n + j));
          if (g.res != nullptr) v = __fadd_rn(v, bf2f(g.res[at + j]));
          y[j] = g.act ? fmaxf(v, 0.0f) : v;
        }
        store_pair(g.out, at, y[0], y[1], both, aligned);
      }
    }
}

using Wide = Tile<128, 128, 2, 4>;
using Narrow = Tile<128, 64, 4, 2>;

}  // namespace

// Returns a cudaError_t (0 = launched).  res may be null.
extern "C" int matmul_bn_act_launch(const void* x, const void* w, const void* scale, const void* shift,
                                    const void* res, void* out, int m, int n, int k, int act, void* stream) {
  Args g;
  g.x = static_cast<const uint16_t*>(x);
  g.w = static_cast<const uint16_t*>(w);
  g.scale = static_cast<const float*>(scale);
  g.shift = static_cast<const float*>(shift);
  g.res = static_cast<const uint16_t*>(res);
  g.out = static_cast<uint16_t*>(out);
  g.m = m;
  g.n = n;
  g.k = k;
  g.act = act;
  g.vec = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 64) {
    const dim3 grid((m + Narrow::BM - 1) / Narrow::BM, (n + Narrow::BN - 1) / Narrow::BN);
    matmul_bn_act_kernel<Narrow><<<grid, kThreads, 0, s>>>(g);
  } else {
    const dim3 grid((m + Wide::BM - 1) / Wide::BM, (n + Wide::BN - 1) / Wide::BN);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    matmul_bn_act_kernel<Wide><<<grid, kThreads, 0, s>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}
