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
// It is kernel C's conv2 phase (csrc/qblock_tile.cuh) with its input read
// from device memory instead of computed by conv1.  A thread block owns one
// tile of 8 x tw output positions (tw 8 or 16) of one image and one of
// `split` slices of the output channels:
//   1. the input halo, (8 + 2) x (tw + 2) positions x Cin, comes by cp.async
//      16-byte copies into swz rows of shared memory, zeros outside the map
//      (SAME padding in the int8 domain), under the first weight copies;
//   2. conv2's implicit GEMM over the 9 taps on the int8 tensor cores
//      (MmaTile, mma.sync m16n8k32), weight K-slices [Cout][3][3][Cin]
//      through the cp.async ring;
//   3. the epilogue into the drained ring as int8, then the output in
//      16-byte words.
// ops/qconv.pick_conv3_tile chooses (tw, split): the fewest blocks that
// fill the card with two an SM, channel slices first on the small maps.
// Channel counts must be multiples of 16; H and W are free.
//
// Bound on the card: int8 multiply-adds at every stage shape (9 * Cin of
// them per output byte); device memory sees the input once per channel
// slice (plus the halo, from L2) and the output once, the weights once per
// tile from L2.
//
// Bit-exactness with the plain version (torch._int_mm over an im2col, then
// the same epilogue): int32 sums are exact in any order; |acc| reaches
// 127^2 * 9 * 512 > 2^24, so the int32 -> f32 conversion rounds
// (__int2float_rn, as the reference's astype does); the multiply and add are
// separate __fmul_rn / __fadd_rn under -fmad=false; rintf rounds half to
// even.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qblock_tile.cuh"

namespace {

// the tile's input halo from (oy0 - 1, ox0 - 1) into a1, zeros outside the
// map; one cp.async group, which the GEMM's first wait covers
__device__ __forceinline__ void stage_halo(const Args& g, const Tile& t) {
  const uint32_t a1 = smem_u32(t.a1);
  for (int i = threadIdx.x; i < t.mh * t.cpr; i += kMmaThreads) {
    const int pos = i / t.cpr, c = i - pos * t.cpr;
    const int iy = t.iy0 + pos / t.hw, ix = t.ix0 + pos % t.hw;
    const bool ok = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
    const int8_t* src = t.x_img + (static_cast<int64_t>(iy) * g.w + ix) * g.cin + 16 * c;
    cp_async16(a1 + swz(pos, c, t.cpr), ok ? static_cast<const void*>(src) : g.x, ok);
  }
  cp_async_commit();
}

// conv2's GEMM on the halo, this block's cout / s channels: requant into the
// drained ring (swz rows of NC / 16 chunks), then 16-byte words out
template <class T>
__device__ __forceinline__ void conv3x3_out(const Args& g, const Tile& t) {
  conv3x3_gemm<T>(g, t, g.cout, [&](const T& mm, int n0, int c, int nb) {
    constexpr int kChunks = T::NC / 16;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = T::row(mt, 2 * hf);
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int n = T::col(nt, 0);
          if (n0 + n >= c) continue;
          const int ch = nb + n0 + n;
          char2 v;
          v.x = requant_relu(epilogue(mm.acc[mt][nt][2 * hf], __ldg(g.a2 + ch), __ldg(g.b2 + ch)));
          v.y = requant_relu(epilogue(mm.acc[mt][nt][2 * hf + 1], __ldg(g.a2 + ch + 1), __ldg(g.b2 + ch + 1)));
          *reinterpret_cast<char2*>(t.ring_ptr + swz(r, n >> 4, kChunks) + (n & 15)) = v;
        }
      }
    __syncthreads();
    const int twm = t.tw - 1;
    for (int gi = threadIdx.x; gi < T::MC * kChunks; gi += kMmaThreads) {
      const int r = gi / kChunks, k = gi % kChunks;
      const int oy = t.oy0 + (r >> g.tw_log2), ox = t.ox0 + (r & twm);
      if (oy >= g.ho || ox >= g.wo || n0 + 16 * k >= c) continue;
      *reinterpret_cast<int4*>(g.out + ((static_cast<int64_t>(t.img) * g.ho + oy) * g.wo + ox) * g.cout + nb + n0 +
                               16 * k) = *reinterpret_cast<const int4*>(t.ring_ptr + swz(r, k, kChunks));
    }
    __syncthreads();  // the ring is free for the next chunk's copies
  });
}

// grid (tiles * split), block kMmaThreads, dynamic smem conv3_smem_bytes(tw, cin)
__global__ void __launch_bounds__(kMmaThreads, 2) qconv3_kernel(const Args g) {
  extern __shared__ __align__(128) int8_t smem[];
  Tile t = tile_at(g, blockIdx.x / g.split, blockIdx.x % g.split, g.split, smem);
  t.a2 = nullptr;  // no a2: the ring follows the halo
  t.ring_ptr = smem + t.mh * g.cw;
  t.ring = smem_u32(t.ring_ptr);
  stage_halo(g, t);
  const int c = g.cout / t.s;
  if (t.p == 128) {
    if (c % 128 == 0) {
      conv3x3_out<T128x128>(g, t);
    } else {
      conv3x3_out<T128x64>(g, t);
    }
  } else {
    if (c % 128 == 0) {
      conv3x3_out<T64x128>(g, t);
    } else {
      conv3x3_out<T64x64>(g, t);
    }
  }
}

// the halo, then the ring (ops/qconv.conv3_smem_bytes)
size_t conv3_smem_bytes(int tw, int cin) { return static_cast<size_t>(kTH + 2) * (tw + 2) * cin + kRingBytes; }

}  // namespace

// x [B, H, W, Cin], out [B, H, W, Cout] int8 NHWC contiguous, 16-byte
// aligned; w [Cout][3][3][Cin] int8; a, b f32 [Cout]; Cin and Cout multiples
// of 16 (of 16 * split for Cout); tiles of 8 x tw (8 or 16) output
// positions, split (1, 2, 4 or 8) channel slices each.  Returns a
// cudaError_t (0 = launched).
extern "C" int qconv3_launch(const void* x, const void* w, const void* a, const void* b, void* out, int batch,
                             int h, int w_, int cin, int cout, int tw, int split, void* stream) {
  Args g = {};
  g.x = static_cast<const int8_t*>(x);
  g.w2 = static_cast<const int8_t*>(w);
  g.a2 = static_cast<const float*>(a);
  g.b2 = static_cast<const float*>(b);
  g.out = static_cast<int8_t*>(out);
  g.h = h;
  g.w = w_;
  g.cin = cin;
  g.cw = cin;  // conv2's K: the input's channels
  g.cout = cout;
  g.stride = 1;
  if (!set_tiles(g, batch, tw, split)) return static_cast<int>(cudaErrorInvalidValue);
  static int optin = -1;
  if (optin < 0) {
    const cudaError_t err = opt_in_smem(qconv3_kernel, &optin);
    if (err != cudaSuccess) {
      optin = -1;
      return static_cast<int>(err);
    }
  }
  const size_t smem = conv3_smem_bytes(tw, cin);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned blocks = static_cast<unsigned>(batch * g.tiles_x * g.tiles_y * split);
  qconv3_kernel<<<blocks, kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
