// K11: stride-1 SAME 3x3 int8 conv with the fused requant epilogue; conv2 of
// every stride-1 bottleneck on the per-conv int8 backend runs through it.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_qconv.py:qconv3x3.  The
// TPU kernel keeps one whole zero-padded image in VMEM across its row and
// output-channel grid steps and accumulates nine shifted MXU dots, so device
// memory sees each activation once.  The data rule is the same here:
//
//   y   = acc * A[n] + B[n]            (acc: exact int32 sum over 9 * Cin)
//   out = clip(rint(max(y, 0)), -127, 127)
//
// but an SM has 227 KB of shared memory, not a whole image's worth, so the
// form is an implicit GEMM over bands: one thread block owns one (image,
// band of `rows` output rows, 64 output channels).  It stages the band's
// input rows plus a one-row halo above and below in shared memory, with a
// zero column on each side and zero rows outside the map (SAME padding in
// the int8 domain), then each thread computes 8 positions x 4 output
// channels per step with __dp4a over 16-byte words (int8_common.cuh's
// dot_tile), nine taps in turn.  Channel counts must be multiples of 16;
// H and W are free.  Weights are [Cout][3][3][Cin] (each output channel's
// taps contiguous) and are read through L1/L2.
//
// Bound on the card: int8 multiply-adds on the CUDA cores (dp4a, not the
// tensor cores); device memory sees the input once per 64 output channels
// (plus the halo rows) and the output once.  A tensor-core version with the
// weights staged in shared memory is the next step.
//
// Bit-exactness with the plain version (torch._int_mm over an im2col, then
// the same epilogue): |acc| reaches 127^2 * 9 * 512 > 2^24, so the int32 ->
// f32 conversion rounds (__int2float_rn, as the reference's astype does);
// the multiply and add are separate __fmul_rn / __fadd_rn under -fmad=false;
// rintf rounds half to even.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 64;

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* a;
  const float* b;
  int8_t* out;
  int h, w_, cin, cout, rows;
};

// grid (bands, ceil(Cout / 64), batch), block kThreads, dynamic smem
// (rows + 2) * (W + 2) * Cin
__global__ void __launch_bounds__(kThreads) qconv3_kernel(const Args g) {
  extern __shared__ __align__(16) int8_t xs[];
  const int W = g.w_, cin = g.cin, wp = W + 2;
  const int r0 = blockIdx.x * g.rows;  // first output row of the band
  const int r_eff = min(g.rows, g.h - r0);
  const int n0 = blockIdx.y * kTileN;
  const int tile_n = min(kTileN, g.cout - n0);
  const int8_t* x_img = g.x + static_cast<int64_t>(blockIdx.z) * g.h * W * cin;

  // input rows r0 - 1 .. r0 + r_eff, columns -1 .. W; zero outside the map
  const int chunks = cin / 16;
  const int words = (r_eff + 2) * wp * chunks;
  for (int i = threadIdx.x; i < words; i += kThreads) {
    const int c = i % chunks, pc = i / chunks;
    const int col = pc % wp, row = pc / wp;
    const int ir = r0 - 1 + row, ic = col - 1;
    int4 v = make_int4(0, 0, 0, 0);
    if (ir >= 0 && ir < g.h && ic >= 0 && ic < W)
      v = __ldg(reinterpret_cast<const int4*>(x_img + (static_cast<int64_t>(ir) * W + ic) * cin) + c);
    *reinterpret_cast<int4*>(xs + (row * wp + col) * cin + c * 16) = v;
  }
  __syncthreads();

  const int npos = r_eff * W, groups = tile_n / kQ;
  const int items = (npos + kP - 1) / kP * groups;
  int8_t* out_img = g.out + (static_cast<int64_t>(blockIdx.z) * g.h + r0) * W * g.cout;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int o = n0 + (it % groups) * kQ, p0 = (it / groups) * kP;
    const int8_t* base[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int pos = min(p0 + p, npos - 1);
      base[p] = xs + ((pos / W) * wp + pos % W) * cin;  // tap (0, 0) of the window
    }
    int acc[kP][kQ];
    zero(acc);
    for (int t = 0; t < 9; ++t) {
      const int off = ((t / 3) * wp + t % 3) * cin;
      const int8_t* act[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) act[p] = base[p] + off;
      dot_tile(acc, act, g.w + static_cast<int64_t>(o) * 9 * cin + t * cin, 9 * cin, cin);
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int pos = p0 + p;
      if (pos >= npos) break;
      char4 v;
      v.x = requant_relu(epilogue(acc[p][0], g.a[o + 0], g.b[o + 0]));
      v.y = requant_relu(epilogue(acc[p][1], g.a[o + 1], g.b[o + 1]));
      v.z = requant_relu(epilogue(acc[p][2], g.a[o + 2], g.b[o + 2]));
      v.w = requant_relu(epilogue(acc[p][3], g.a[o + 3], g.b[o + 3]));
      *reinterpret_cast<char4*>(out_img + static_cast<int64_t>(pos) * g.cout + o) = v;
    }
  }
}

}  // namespace

// x [B, H, W, Cin], out [B, H, W, Cout] int8 NHWC contiguous, 16-byte
// aligned; w [Cout][3][3][Cin] int8; a, b f32 [Cout]; Cin and Cout multiples
// of 16.  Dynamic shared memory (rows + 2) * (W + 2) * Cin bytes.  Returns a
// cudaError_t (0 = launched).
extern "C" int qconv3_launch(const void* x, const void* w, const void* a, const void* b, void* out, int batch,
                             int h, int w_, int cin, int cout, int rows, void* stream) {
  Args g;
  g.x = static_cast<const int8_t*>(x);
  g.w = static_cast<const int8_t*>(w);
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.out = static_cast<int8_t*>(out);
  g.h = h;
  g.w_ = w_;
  g.cin = cin;
  g.cout = cout;
  g.rows = rows;
  const size_t smem = static_cast<size_t>(rows + 2) * (w_ + 2) * cin;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(qconv3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((h + rows - 1) / rows, (cout + kTileN - 1) / kTileN, batch);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  qconv3_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
