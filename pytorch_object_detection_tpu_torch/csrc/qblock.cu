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

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const int8_t* x;
  const int8_t* w1;
  const int8_t* w2;
  const int8_t* w3;
  const int8_t* wd;  // nullptr: identity shortcut
  const float *a1, *b1, *a2, *b2, *a3, *b3, *ad, *bd;
  int8_t* out;
  int h, w, cin, cw, cout, stride, ho, wo, rows;
};

// grid (bands, batch), block kThreads, dynamic smem a1 + a2
__global__ void __launch_bounds__(kThreads) qblock_kernel(const Args g) {
  extern __shared__ __align__(16) int8_t smem[];
  const int s = g.stride, W = g.w, H = g.h, cw = g.cw, cin = g.cin;
  const int wp = W + 2;
  const int rows_a1 = (g.rows - 1) * s + 3;
  const int r0 = blockIdx.x * g.rows;  // first output row of the band
  const int in0 = r0 * s - 1;          // input row of a1's first smem row
  const int r_eff = min(g.rows, g.ho - r0);
  const int8_t* x_img = g.x + static_cast<int64_t>(blockIdx.y) * H * W * cin;
  int8_t* a1s = smem;                           // [rows_a1][W + 2][cw]
  int8_t* a2s = smem + rows_a1 * wp * cw;       // [r_eff * wo][cw]
  const int tid = threadIdx.x;

  // conv2's zero padding: a1 columns -1 and W
  const int chunks = cw / 16;
  for (int i = tid; i < rows_a1 * 2 * chunks; i += kThreads) {
    const int c = i % chunks, rc = i / chunks;
    const int col = (rc & 1) ? W + 1 : 0;
    *reinterpret_cast<int4*>(a1s + ((rc >> 1) * wp + col) * cw + c * 16) = make_int4(0, 0, 0, 0);
  }

  // conv1 on rows [in0, in0 + rows_a1), zero outside the image
  {
    const int npos = rows_a1 * W, groups = cw / kQ;
    const int items = (npos + kP - 1) / kP * groups;
    for (int it = tid; it < items; it += kThreads) {
      const int o = (it % groups) * kQ, p0 = (it / groups) * kP;
      const int8_t* act[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = min(p0 + p, npos - 1);
        const int ir = min(max(in0 + pos / W, 0), H - 1);
        act[p] = x_img + (static_cast<int64_t>(ir) * W + pos % W) * cin;
      }
      int acc[kP][kQ];
      zero(acc);
      dot_tile(acc, act, g.w1 + static_cast<int64_t>(o) * cin, cin, cin);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = p0 + p;
        if (pos >= npos) break;
        const int i = pos / W, ir = in0 + i;
        const bool inside = ir >= 0 && ir < H;
        char4 v;
        v.x = inside ? requant_relu(epilogue(acc[p][0], g.a1[o + 0], g.b1[o + 0])) : 0;
        v.y = inside ? requant_relu(epilogue(acc[p][1], g.a1[o + 1], g.b1[o + 1])) : 0;
        v.z = inside ? requant_relu(epilogue(acc[p][2], g.a1[o + 2], g.b1[o + 2])) : 0;
        v.w = inside ? requant_relu(epilogue(acc[p][3], g.a1[o + 3], g.b1[o + 3])) : 0;
        *reinterpret_cast<char4*>(a1s + (i * wp + pos % W + 1) * cw + o) = v;
      }
    }
  }
  __syncthreads();

  // conv2 3x3 / s over the band's output rows
  const int npos = r_eff * g.wo;
  {
    const int groups = cw / kQ;
    const int items = (npos + kP - 1) / kP * groups;
    for (int it = tid; it < items; it += kThreads) {
      const int o = (it % groups) * kQ, p0 = (it / groups) * kP;
      const int8_t* base[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = min(p0 + p, npos - 1);
        base[p] = a1s + ((pos / g.wo) * s * wp + (pos % g.wo) * s) * cw;
      }
      int acc[kP][kQ];
      zero(acc);
      for (int t = 0; t < 9; ++t) {
        const int off = ((t / 3) * wp + t % 3) * cw;
        const int8_t* act[kP];
#pragma unroll
        for (int p = 0; p < kP; ++p) act[p] = base[p] + off;
        dot_tile(acc, act, g.w2 + static_cast<int64_t>(o) * 9 * cw + t * cw, 9 * cw, cw);
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = p0 + p;
        if (pos >= npos) break;
        char4 v;
        v.x = requant_relu(epilogue(acc[p][0], g.a2[o + 0], g.b2[o + 0]));
        v.y = requant_relu(epilogue(acc[p][1], g.a2[o + 1], g.b2[o + 1]));
        v.z = requant_relu(epilogue(acc[p][2], g.a2[o + 2], g.b2[o + 2]));
        v.w = requant_relu(epilogue(acc[p][3], g.a2[o + 3], g.b2[o + 3]));
        *reinterpret_cast<char4*>(a2s + pos * cw + o) = v;
      }
    }
  }
  __syncthreads();

  // conv3 + shortcut -> the block output
  {
    const int groups = g.cout / kQ;
    const int items = (npos + kP - 1) / kP * groups;
    int8_t* out_img = g.out + (static_cast<int64_t>(blockIdx.y) * g.ho + r0) * g.wo * g.cout;
    for (int it = tid; it < items; it += kThreads) {
      const int o = (it % groups) * kQ, p0 = (it / groups) * kP;
      const int8_t* act[kP];
      const int8_t* xin[kP];  // the shortcut's input position (row r*s, column c*s)
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = min(p0 + p, npos - 1);
        act[p] = a2s + pos * cw;
        xin[p] = x_img + (static_cast<int64_t>(r0 + pos / g.wo) * s * W + (pos % g.wo) * s) * cin;
      }
      int acc[kP][kQ];
      zero(acc);
      dot_tile(acc, act, g.w3 + static_cast<int64_t>(o) * cw, cw, cw);
      float y[kP][kQ];
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int q = 0; q < kQ; ++q) y[p][q] = epilogue(acc[p][q], g.a3[o + q], g.b3[o + q]);
      if (g.wd != nullptr) {
        zero(acc);
        dot_tile(acc, xin, g.wd + static_cast<int64_t>(o) * cin, cin, cin);
#pragma unroll
        for (int p = 0; p < kP; ++p)
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            y[p][q] = __fadd_rn(y[p][q], epilogue(acc[p][q], g.ad[o + q], g.bd[o + q]));
      } else {
        const float short_mul = g.ad[0];
#pragma unroll
        for (int p = 0; p < kP; ++p)
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            y[p][q] = __fadd_rn(y[p][q], __fmul_rn(static_cast<float>(xin[p][o + q]), short_mul));
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = p0 + p;
        if (pos >= npos) break;
        char4 v;
        v.x = requant_relu(y[p][0]);
        v.y = requant_relu(y[p][1]);
        v.z = requant_relu(y[p][2]);
        v.w = requant_relu(y[p][3]);
        *reinterpret_cast<char4*>(out_img + static_cast<int64_t>(pos) * g.cout + o) = v;
      }
    }
  }
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
  Args g;
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
