// K12: one whole int8 MNBlock (the MNFCOS building block) in one launch; the
// five pyramid blocks and the head's ten block calls of the int8 MNFCOS run
// through it.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_qmnblock.py:qmnblock.
// The TPU kernel keeps one whole level image in VMEM per grid step and walks
// it in row chunks, so device memory sees the block's input and output once,
// int8, and none of its three int32 accumulators.  The data rule is the same
// here (models/mnfcos_int8._mnblock_i8, operation for operation):
//
//   a1  = clip8((dw(x) * (s_in * swdw[c]) + bdw[c]) / s_a1)    k x k, dilation d, "same" zero padding
//   z   = (a1 @ w1) * (s_a1 * sw1[n]) + b1[n]                    1x1, C -> cmid
//   a2  = clip8(z * sigmoid(z) / s_a2)
//   y   = (a2 @ w2) * (s_a2 * sw2[c]) + b2[c]                    1x1, cmid -> C
//   out = clip8(y / s_out + x * (s_in / s_out))
//
// but an SM has 227 KB of shared memory, not a level's worth, so one thread
// block owns one (image, 8 x 8 pixel tile): it stages the tile's input with
// its d * (k - 1) / 2 halo in shared memory (zero outside the map), computes
// the depthwise conv and its requant into a1 [64, C] in shared memory, then
// pw1 in 64-channel slices of w1 (each slice staged in shared memory) with
// SiLU and the requant into a2 [64, cmid], then pw2 in 64-channel slices of
// w2 with the residual, straight to device memory.  a2 and the weight slices
// reuse the input tile's space once the depthwise is done (the residual is
// read again from device memory, through L2).  Each thread of the 1x1 GEMMs
// holds 4 x 4 int32 sums (rows ty + 16 i, channels tx + 16 j, so a warp's
// shared-memory reads hit 32 banks) and adds with __dp4a (exact).  C must be
// a multiple of 16 (16-byte loads), cmid = alpha * C; H and W are free.
//
// Bound on the card: int8 multiply-adds (pw1 and pw2 are 99 % of them), on
// the CUDA cores (__dp4a) rather than the tensor cores; device memory sees
// the input once (plus the halo) and the output once, the weights once per
// tile from L2.  Next steps: mma.sync / wgmma for the two 1x1 convs, and more
// blocks on the small levels (a 4 x 4 map fills a quarter of a tile).
//
// Bit-exactness with the plain version (ops/qmnblock.qmnblock_plain): the
// depthwise sum is exact in int32 (127 * 127 * 49 < 2^24, so its f32 is
// exact); the 1x1 sums are exact in int32 and below 2^24 at C <= 1024; each
// multiply, add and divide is a separate __fmul_rn / __fadd_rn / __fdiv_rn
// in the plain version's order under -fmad=false (one fused multiply-add
// moves a value an ulp across a requant boundary); the sigmoid is
// 1 / (1 + expf(-z)), the form of PyTorch's CUDA sigmoid, with the
// full-precision expf; rintf rounds half to even.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;            // the output tile is kTile x kTile pixels
constexpr int kM = kTile * kTile;   // GEMM rows per block
constexpr int kN = 64;              // output channels per GEMM slice

struct Args {
  const int8_t* x;     // [B, H, W, C]
  const int8_t* wdw;   // [k][k][C]
  const float* swdw;   // [C]
  const float* bdw;    // [C]
  const int8_t* w1;    // [cmid][C]
  const float* sw1;    // [cmid]
  const float* b1;     // [cmid]
  const int8_t* w2;    // [C][cmid]
  const float* sw2;    // [C]
  const float* b2;     // [C]
  const float* s_in;   // one f32 each, on the device
  const float* s_a1;
  const float* s_a2;
  const float* s_out;
  int8_t* out;         // [B, H, W, C]
  int h, w, c, cmid, k, d, tiles_x;
};

__host__ __device__ inline size_t region_bytes(int c, int cmid, int k, int d) {
  const size_t span = kTile + d * (k - 1);
  const size_t tile = span * span * c;
  const size_t gemm = 4 * (static_cast<size_t>(kM) * (cmid / 4 + 1) + static_cast<size_t>(kN) * ((c > cmid ? c : cmid) / 4 + 1));
  return ((tile > gemm ? tile : gemm) + 15) / 16 * 16;
}

__host__ __device__ inline size_t smem_bytes(int c, int cmid, int k, int d) {
  return region_bytes(c, cmid, k, d) + 4 * static_cast<size_t>(kM) * (c / 4 + 1);
}

// rows n0 .. n0 + kN - 1 of w [rows][kbytes] into ws (pitch words per row); zero past the last row
__device__ __forceinline__ void stage_slice(int* ws, int pitch, const int8_t* __restrict__ w, int rows, int kbytes,
                                            int n0) {
  const int q16 = kbytes / 16;
  for (int i = threadIdx.x; i < kN * q16; i += kThreads) {
    const int r = i / q16, q = i % q16;
    int4 v = make_int4(0, 0, 0, 0);
    if (n0 + r < rows) v = __ldg(reinterpret_cast<const int4*>(w + static_cast<int64_t>(n0 + r) * kbytes) + q);
    int* dst = ws + r * pitch + q * 4;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

// acc[i][j] = dot(rows_a row ty + 16 i, ws row tx + 16 j) over kwords words of 4 int8
__device__ __forceinline__ void gemm_rows(int (&acc)[4][4], const int* rows_a, int pitch_a, const int* ws, int pitch_w,
                                          int kwords, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll 4
  for (int kw = 0; kw < kwords; ++kw) {
    int av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = rows_a[(ty + 16 * i) * pitch_a + kw];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ws[(tx + 16 * j) * pitch_w + kw];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
  }
}

// grid (tiles, batch), block kThreads, dynamic smem smem_bytes(c, cmid, k, d)
__global__ void __launch_bounds__(kThreads) qmnblock_kernel(const Args g) {
  extern __shared__ __align__(16) int8_t smem[];
  const int c = g.c, cmid = g.cmid, k = g.k, d = g.d;
  const int hd = d * (k - 1) / 2, span = kTile + 2 * hd;
  const int oy0 = (blockIdx.x / g.tiles_x) * kTile, ox0 = (blockIdx.x % g.tiles_x) * kTile;
  const int64_t img = static_cast<int64_t>(blockIdx.y) * g.h * g.w * c;
  const int8_t* x_img = g.x + img;
  int8_t* out_img = g.out + img;
  const int pitch1 = c / 4 + 1, pitch2 = cmid / 4 + 1, pitch_w = (c > cmid ? c : cmid) / 4 + 1;
  int8_t* tile = smem;                                    // [span][span][C], then reused:
  int* a2s = reinterpret_cast<int*>(smem);                // [kM][pitch2] words
  int* ws = a2s + kM * pitch2;                            // [kN][pitch_w] words
  int* a1s = reinterpret_cast<int*>(smem + region_bytes(c, cmid, k, d));  // [kM][pitch1] words

  // the input tile and its halo, zero outside the map ("same" padding in the int8 domain)
  const int q16 = c / 16;
  for (int i = threadIdx.x; i < span * span * q16; i += kThreads) {
    const int q = i % q16, pix = i / q16;
    const int iy = oy0 - hd + pix / span, ix = ox0 - hd + pix % span;
    int4 v = make_int4(0, 0, 0, 0);
    if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w)
      v = __ldg(reinterpret_cast<const int4*>(x_img + (static_cast<int64_t>(iy) * g.w + ix) * c) + q);
    reinterpret_cast<int4*>(tile + pix * c)[q] = v;
  }
  __syncthreads();

  const float s_in = __ldg(g.s_in), s_a1 = __ldg(g.s_a1), s_a2 = __ldg(g.s_a2), s_out = __ldg(g.s_out);

  // the depthwise conv, 4 channels a thread at a time, and its requant into a1
  const int q4 = c / 4;
  for (int i = threadIdx.x; i < kM * q4; i += kThreads) {
    const int q = i % q4, p = i / q4;
    const int py = p / kTile, px = p % kTile;
    int acc[4] = {0, 0, 0, 0};
    for (int ky = 0; ky < k; ++ky) {
      const int8_t* row = tile + ((py + ky * d) * span + px) * c + 4 * q;
      const int8_t* wrow = g.wdw + ky * k * c + 4 * q;
      for (int kx = 0; kx < k; ++kx) {
        const char4 xv = *reinterpret_cast<const char4*>(row + kx * d * c);
        const char4 wv = __ldg(reinterpret_cast<const char4*>(wrow + kx * c));
        acc[0] += xv.x * wv.x;
        acc[1] += xv.y * wv.y;
        acc[2] += xv.z * wv.z;
        acc[3] += xv.w * wv.w;
      }
    }
    int8_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = 4 * q + j;
      r[j] = clip8(__fdiv_rn(epilogue(acc[j], __fmul_rn(s_in, __ldg(g.swdw + ch)), __ldg(g.bdw + ch)), s_a1));
    }
    *reinterpret_cast<char4*>(a1s + p * pitch1 + q) = make_char4(r[0], r[1], r[2], r[3]);
  }
  __syncthreads();  // a1 complete; the tile's space is free for a2 and the weight slices

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int acc[4][4];

  // pw1, SiLU and the requant into a2, one 64-channel slice of w1 at a time
  for (int n0 = 0; n0 < cmid; n0 += kN) {
    stage_slice(ws, pitch_w, g.w1, cmid, c, n0);
    __syncthreads();
    gemm_rows(acc, a1s, pitch1, ws, pitch_w, c / 4, tx, ty);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= cmid) break;
      const float a = __fmul_rn(s_a1, __ldg(g.sw1 + n)), b = __ldg(g.b1 + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float z = epilogue(acc[i][j], a, b);
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
        reinterpret_cast<int8_t*>(a2s + (ty + 16 * i) * pitch2)[n] = clip8(__fdiv_rn(__fmul_rn(z, sig), s_a2));
      }
    }
    __syncthreads();  // the slice is read; a2 written
  }

  // pw2 and the residual, one 64-channel slice of w2 at a time, straight to device memory
  const float short_mul = __fdiv_rn(s_in, s_out);
  for (int n0 = 0; n0 < c; n0 += kN) {
    stage_slice(ws, pitch_w, g.w2, c, cmid, n0);
    __syncthreads();
    gemm_rows(acc, a2s, pitch2, ws, pitch_w, cmid / 4, tx, ty);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= c) break;
      const float a = __fmul_rn(s_a2, __ldg(g.sw2 + n)), b = __ldg(g.b2 + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty + 16 * i;
        const int oy = oy0 + p / kTile, ox = ox0 + p % kTile;
        if (oy >= g.h || ox >= g.w) continue;
        const int64_t at = (static_cast<int64_t>(oy) * g.w + ox) * c + n;
        const float y = epilogue(acc[i][j], a, b);
        out_img[at] = clip8(__fadd_rn(__fdiv_rn(y, s_out), __fmul_rn(static_cast<float>(__ldg(x_img + at)), short_mul)));
      }
    }
    __syncthreads();  // the slice is read before the next one is staged
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs.
extern "C" size_t qmnblock_smem_bytes(int c, int cmid, int k, int d) { return smem_bytes(c, cmid, k, d); }

// table: x, wdw, swdw, bdw, w1, sw1, b1, w2, sw2, b2, s_in, s_a1, s_a2, s_out,
// out (device pointers; x and out int8 NHWC [B, H, W, C] contiguous, 16-byte
// aligned; C a multiple of 16, cmid = alpha * C; k odd; the scales one f32
// each).  Returns a cudaError_t (0 = launched).
extern "C" int qmnblock_launch(const void* const* table, int batch, int h, int w, int c, int cmid, int k, int d,
                               void* stream) {
  Args g;
  g.x = static_cast<const int8_t*>(table[0]);
  g.wdw = static_cast<const int8_t*>(table[1]);
  g.swdw = static_cast<const float*>(table[2]);
  g.bdw = static_cast<const float*>(table[3]);
  g.w1 = static_cast<const int8_t*>(table[4]);
  g.sw1 = static_cast<const float*>(table[5]);
  g.b1 = static_cast<const float*>(table[6]);
  g.w2 = static_cast<const int8_t*>(table[7]);
  g.sw2 = static_cast<const float*>(table[8]);
  g.b2 = static_cast<const float*>(table[9]);
  g.s_in = static_cast<const float*>(table[10]);
  g.s_a1 = static_cast<const float*>(table[11]);
  g.s_a2 = static_cast<const float*>(table[12]);
  g.s_out = static_cast<const float*>(table[13]);
  g.out = static_cast<int8_t*>(const_cast<void*>(table[14]));
  g.h = h;
  g.w = w;
  g.c = c;
  g.cmid = cmid;
  g.k = k;
  g.d = d;
  g.tiles_x = (w + kTile - 1) / kTile;
  const size_t smem = smem_bytes(c, cmid, k, d);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(qmnblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(g.tiles_x * ((h + kTile - 1) / kTile), batch);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  qmnblock_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
