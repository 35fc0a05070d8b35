// Kernel C: one whole int8 ResNet bottleneck per launch, stride 1 or 2.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_qblock.py:qbottleneck
// (stride-1 blocks) and :qbottleneck_s2 (the three stride-2 blocks).  Those
// keep one image's NHWC map in VMEM and walk row chunks with a static Python
// loop, computing conv1 -> conv2 -> conv3 + shortcut with the a1/a2
// intermediates in VMEM, so HBM sees the block input once and its output
// once.  The same data rule holds here:
//
//   conv1  1x1,            a1 = requant(relu(acc1 * A1 + B1))   (int8, smem)
//   conv2  3x3 pad 1 / s,  a2 = requant(relu(acc2 * A2 + B2))   (int8, smem)
//   conv3  1x1 + shortcut, out = requant(relu((acc3 * A3 + B3) + short))
//   short  = accd * Ad + Bd     (projection: 1x1 conv at stride s), or
//            x * short_mul      (identity; short_mul is one f32 at ad[0])
//
// One thread block owns one (image, band of `rows` output rows).  It
// recomputes conv1 on the band's input rows plus the 3x3 halo
// ((rows-1)*s + 3 input rows) into shared memory, with a zero column on
// each side and zero rows outside the image: conv2 pads in the a1 domain,
// as the reference does.  Then conv2 over the band into shared memory, then
// conv3 + shortcut straight to global memory.  Nothing passes between
// blocks.  A thread computes 8 positions x 4 output channels per step with
// __dp4a over 16-byte words (int32 accumulation, exact), so channel counts
// must be multiples of 16.  Weights are [Cout][taps][Cin] int8 (each output
// channel's K-vector contiguous) and are read through L1/L2.
//
// Bound on the card: int8 multiply-adds on the CUDA cores (dp4a, not the
// tensor cores) and the weight reads from L2; device memory sees about one
// byte per input and output element.  A tensor-core (mma/wgmma) version
// with weights staged in shared memory is the next step.
//
// Bit-exactness with the plain version: |acc| reaches 127^2 * 4608 > 2^24,
// so the int32 -> f32 conversion rounds (to nearest, __int2float_rn, as
// the reference's astype does); every epilogue multiply and add is a
// separate __fmul_rn/__fadd_rn, so no FMA contraction moves a value across
// a requant boundary; rintf rounds half to even.  The projection shortcut
// adds (acc3*A3 + B3) + (accd*Ad + Bd), the XLA oracle's association
// (nn/resnet_int8.py:549-554), not the Pallas kernel's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qblock_band.cuh"

namespace {

// grid (bands, batch), block kThreads, dynamic smem a1 + a2
__global__ void __launch_bounds__(kThreads) qblock_kernel(const QBlockArgs g) {
  extern __shared__ __align__(16) int8_t smem[];
  qblock_band(g, blockIdx.x, blockIdx.y, smem);
}

}  // namespace

// x [B, H, W, Cin] int8 NHWC contiguous; out [B, Ho, Wo, Cout] with
// Ho = (H - 1) / stride + 1 (likewise Wo).  w1 [Cw][Cin], w2 [Cw][3][3][Cw],
// w3 [Cout][Cw], wd [Cout][Cin] int8 (wd null: identity, ad -> short_mul);
// epilogue vectors f32.  Channel counts multiples of 16.  Dynamic shared
// memory ((rows-1)*stride + 3) * (W+2) * Cw + rows * Wo * Cw bytes.
// Returns a cudaError_t (0 = launched).
extern "C" int qblock_launch(const void* x, const void* w1, const void* w2, const void* w3,
                             const void* wd, const void* a1, const void* b1, const void* a2,
                             const void* b2, const void* a3, const void* b3, const void* ad,
                             const void* bd, void* out, int batch, int h, int w, int cin, int cw,
                             int cout, int stride, int rows, void* stream) {
  QBlockArgs g;
  g.x = static_cast<const int8_t*>(x);
  g.w1 = static_cast<const int8_t*>(w1);
  g.w2 = static_cast<const int8_t*>(w2);
  g.w3 = static_cast<const int8_t*>(w3);
  g.wd = static_cast<const int8_t*>(wd);
  g.a1 = static_cast<const float*>(a1);
  g.b1 = static_cast<const float*>(b1);
  g.a2 = static_cast<const float*>(a2);
  g.b2 = static_cast<const float*>(b2);
  g.a3 = static_cast<const float*>(a3);
  g.b3 = static_cast<const float*>(b3);
  g.ad = static_cast<const float*>(ad);
  g.bd = static_cast<const float*>(bd);
  g.out = static_cast<int8_t*>(out);
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cw = cw;
  g.cout = cout;
  g.stride = stride;
  g.ho = (h - 1) / stride + 1;
  g.wo = (w - 1) / stride + 1;
  g.rows = rows;
  const size_t smem = static_cast<size_t>((rows - 1) * stride + 3) * (w + 2) * cw +
                      static_cast<size_t>(rows) * g.wo * cw;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(qblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((g.ho + rows - 1) / rows, batch);
  qblock_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
