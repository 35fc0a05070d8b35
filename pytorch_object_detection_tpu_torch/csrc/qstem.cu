// K1: the exact uint8 ResNet stem with its 3x3/2 max pool, one launch.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_qstem.py:qstem_conv with
// pool=True.  That kernel takes the space-to-depth form of the channel-
// padded raw frame (a 4x4/1 conv over 16 channels, one MXU dot per row band),
// and bends its layout around Mosaic (raw 5D views, row-pair merges, bands).
// None of that carries over.  What does: the frame's normalize affine and the
// BN fold live in the int8 weights and the f32 epilogue
// (nn/resnet_int8.quantize_stem_s2d), so the conv input is v = u - 128 with
// no quantization at all; the 3x3/2 pool commutes with the monotone requant
// and runs on the int8 conv tile, so the full-size conv output never reaches
// device memory.
//
// Here the conv is the direct 7x7/2 form over the four channels (R, G, B and
// a fourth whose weights are 0): the s2d rewrite is an exact rearrangement
// of the same int8 taps plus zero taps, so both give the same int32 sums
// (the JAX package tests this, tests/test_quant.py:1043).  Each tap is one
// __dp4a of a pixel's 4 channels against a 4-channel weight word.  Taps
// outside the frame read the v-domain border fill pad4[c] =
// round(255*mean[c] - 128), not 0 (x_f = 0 there in the reference).
//
//   acc  = sum over 49 taps of dp4a(v(2y-3+ky, 2x-3+kx), w[ky][kx][o])
//   conv = clip(rint(max(acc * A[o] + B[o], 0)), -127, 127)   (int8, >= 0)
//   out  = max over the 3x3/2 pad-1 window of conv (outside: -128)
//
// One thread block owns (image, 8 x 8 pooled positions).  It loads the
// frame patch under them (39 x 39 pixels, v-domain words) and the weights
// into shared memory, computes the 17 x 17 conv positions the pool windows
// cover (conv rows/cols outside the map are -128), then the pool.  |acc| <=
// 147 * 128 * 127 < 2^24, so the f32 conversion is exact.
//
// Bound on the card: at 512^2 and B=8 the frames (6.3 MB) and the pooled
// output (8.4 MB) take about 4.4 us at 3.35 TB/s and the 4.9 G
// multiply-adds 5 us at the int8 tensor-core peak; this kernel does them on
// the CUDA cores with dp4a, plus the 13 % of conv positions recomputed at
// tile edges, so the multiply-adds bound it.
//
// Bit-exactness with the plain version (the s2d oracle): separate
// __fmul_rn / __fadd_rn under -fmad=false, rintf for round half to even.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCout = 64;
constexpr int kTaps = 49;
constexpr int kPR = 8, kPC = 8;                    // pooled rows / cols per block
constexpr int kCR = 2 * kPR + 1, kCC = 2 * kPC + 1;  // conv tile the pool windows cover
constexpr int kIR = 2 * kCR + 5, kIC = 2 * kCC + 5;  // frame patch under the conv tile

struct Args {
  const uint8_t* u;     // [B, H, W, cin]
  const int* w;         // [64][49] words: output channel, tap, 4 int8 channel weights
  const float* a;       // [64]
  const float* b;       // [64]
  const int8_t* pad4;   // [4] border values
  int8_t* out;          // [B, Hp, Wp, 64]
  int h, w_, cin, hc, wc, hp, wp;
};

__device__ __forceinline__ int vmax(int a, int b) {
  return static_cast<int>(__vmaxs4(static_cast<unsigned>(a), static_cast<unsigned>(b)));
}

// grid (ceil(Wp / 8), ceil(Hp / 8), B), block kThreads
__global__ void __launch_bounds__(kThreads) qstem_kernel(const Args g) {
  __shared__ int patch[kIR * kIC];
  __shared__ __align__(16) int ws[kTaps * kCout];
  __shared__ float as[kCout], bs[kCout];
  __shared__ __align__(16) int8_t conv[kCR * kCC * kCout];
  const int tid = threadIdx.x;
  const int py0 = blockIdx.y * kPR, px0 = blockIdx.x * kPC;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // conv tile origin
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // frame patch origin
  const uint8_t* img = g.u + static_cast<int64_t>(blockIdx.z) * g.h * g.w_ * g.cin;
  const int pad_word = (g.pad4[0] & 0xff) | ((g.pad4[1] & 0xff) << 8) | ((g.pad4[2] & 0xff) << 16) |
                       ((g.pad4[3] & 0xff) << 24);

  // [out][tap] in device memory -> [tap][out] here: a tap's 8-channel group is one 32-byte read
  for (int i = tid; i < kTaps * kCout; i += kThreads) ws[i] = __ldg(g.w + (i % kCout) * kTaps + i / kCout);
  if (tid < kCout) {
    as[tid] = __ldg(g.a + tid);
    bs[tid] = __ldg(g.b + tid);
  }
  for (int i = tid; i < kIR * kIC; i += kThreads) {
    const int y = iy0 + i / kIC, x = ix0 + i % kIC;
    int v = pad_word;
    if (y >= 0 && y < g.h && x >= 0 && x < g.w_) {
      const uint8_t* px = img + (static_cast<int64_t>(y) * g.w_ + x) * g.cin;
      const int c3 = g.cin == 4 ? px[3] - 128 : 0;  // a 3-channel frame's fourth channel is u = 128
      v = ((px[0] - 128) & 0xff) | (((px[1] - 128) & 0xff) << 8) | (((px[2] - 128) & 0xff) << 16) |
          ((c3 & 0xff) << 24);
    }
    patch[i] = v;
  }
  __syncthreads();

  // conv tile: item = (group of 8 output channels, conv position)
  constexpr int kPos = kCR * kCC;
  for (int it = tid; it < kPos * (kCout / 8); it += kThreads) {
    const int grp = it / kPos, pos = it % kPos;
    const int i = pos / kCC, j = pos % kCC;
    const int cy = cy0 + i, cx = cx0 + j;
    int2 packed = make_int2(static_cast<int>(0x80808080u), static_cast<int>(0x80808080u));  // -128: outside
    if (cy >= 0 && cy < g.hc && cx >= 0 && cx < g.wc) {
      int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int ky = 0; ky < 7; ++ky) {
        const int* prow = patch + (2 * i + ky) * kIC + 2 * j;
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          const int v = prow[kx];
          const int4* wv = reinterpret_cast<const int4*>(ws + (ky * 7 + kx) * kCout + grp * 8);
          const int4 w0 = wv[0], w1 = wv[1];
          acc[0] = __dp4a(v, w0.x, acc[0]);
          acc[1] = __dp4a(v, w0.y, acc[1]);
          acc[2] = __dp4a(v, w0.z, acc[2]);
          acc[3] = __dp4a(v, w0.w, acc[3]);
          acc[4] = __dp4a(v, w1.x, acc[4]);
          acc[5] = __dp4a(v, w1.y, acc[5]);
          acc[6] = __dp4a(v, w1.z, acc[6]);
          acc[7] = __dp4a(v, w1.w, acc[7]);
        }
      }
      int8_t q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = requant_relu(epilogue(acc[k], as[grp * 8 + k], bs[grp * 8 + k]));
      packed.x = (q[0] & 0xff) | ((q[1] & 0xff) << 8) | ((q[2] & 0xff) << 16) | ((q[3] & 0xff) << 24);
      packed.y = (q[4] & 0xff) | ((q[5] & 0xff) << 8) | ((q[6] & 0xff) << 16) | ((q[7] & 0xff) << 24);
    }
    *reinterpret_cast<int2*>(conv + pos * kCout + grp * 8) = packed;
  }
  __syncthreads();

  // 3x3/2 pool: item = (pooled position, 16-byte word of channels)
  for (int it = tid; it < kPR * kPC * (kCout / 16); it += kThreads) {
    const int q = it % (kCout / 16), p = it / (kCout / 16);
    const int pi = p / kPC, pj = p % kPC;
    const int py = py0 + pi, px = px0 + pj;
    if (py >= g.hp || px >= g.wp) continue;
    int4 m = *reinterpret_cast<const int4*>(conv + ((2 * pi) * kCC + 2 * pj) * kCout + q * 16);
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        const int4 v = *reinterpret_cast<const int4*>(conv + ((2 * pi + dy) * kCC + 2 * pj + dx) * kCout + q * 16);
        m = make_int4(vmax(m.x, v.x), vmax(m.y, v.y), vmax(m.z, v.z), vmax(m.w, v.w));
      }
    *reinterpret_cast<int4*>(g.out + ((static_cast<int64_t>(blockIdx.z) * g.hp + py) * g.wp + px) * kCout +
                             q * 16) = m;
  }
}

}  // namespace

// u [B, H, W, cin] uint8 (cin 3 or 4) NHWC contiguous; w [64][7][7][4]
// int8 (the quantized 7x7 taps, 4-byte aligned); a, b f32 [64]; pad4 [4]
// int8; out
// [B, Hp, Wp, 64] int8 with Hc = (H - 1) / 2 + 1, Hp = (Hc - 1) / 2 + 1
// (likewise W).  Returns a cudaError_t (0 = launched).
extern "C" int qstem_launch(const void* u, const void* w, const void* a, const void* b, const void* pad4,
                            void* out, int batch, int h, int w_, int cin, void* stream) {
  Args g;
  g.u = static_cast<const uint8_t*>(u);
  g.w = static_cast<const int*>(w);
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.pad4 = static_cast<const int8_t*>(pad4);
  g.out = static_cast<int8_t*>(out);
  g.h = h;
  g.w_ = w_;
  g.cin = cin;
  g.hc = (h - 1) / 2 + 1;
  g.wc = (w_ - 1) / 2 + 1;
  g.hp = (g.hc - 1) / 2 + 1;
  g.wp = (g.wc - 1) / 2 + 1;
  const dim3 grid((g.wp + kPC - 1) / kPC, (g.hp + kPR - 1) / kPR, batch);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  qstem_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
