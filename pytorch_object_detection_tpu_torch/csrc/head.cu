// K15: one pyramid level through the whole bf16 HISHead, [B, H, W, f] in,
// the packed [B, H, W, nc + 5] map out (cls logits | cnt | raw reg, before
// ScaleExp): the inverted-bottleneck stem (pw1 -> GN + ReLU -> depthwise
// 3x3 -> GN + SiLU -> pw2 + bias + residual), both towers (3x3 conv ->
// GN + ReLU) and the prediction convs.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_head.py:hishead_level_fused
// (its _hishead_kernel).  The TPU kernel holds one image's level and all
// its intermediates in VMEM and makes four passes over them, one per
// GroupNorm, whose statistics must cover the whole map before its consumer
// runs.  Here a block cannot see the whole map, and blocks cannot wait for
// each other, so the level is a chain of five kernels, each GroupNorm's
// statistics carried across a launch boundary as per-tile partial sums:
//
//   1. fhead_pw1:    t1 = bf16(x @ pw1); per-tile sums of the f32 values
//   2. fhead_dw:     GN1 folded from those sums (prologue), ReLU, 9-tap
//                    depthwise on a one-pixel halo in bf16 -> t2; sums
//   3. fhead_pw2:    GN2 folded, SiLU on the way into shared memory,
//                    y = bf16(t2' @ pw2 + bias + x)
//   4. fhead_towers: both tower convs as one implicit GEMM over one shared
//                    3x3 im2col of y (N = 2f) -> tw; per-tile f32 sums
//   5. fhead_pred:   each tower's GN folded, ReLU on the way in, the
//                    cls and cnt|reg convs as implicit GEMMs -> the map
//
// The four GEMM stages use csrc/bf16_mma.cuh's mma.sync tile.  t1 (later
// overwritten by tw), t2 and y live in one scratch buffer per call, and
// the partial sums in a second one: device memory holds them where the
// TPU kernel held them in VMEM.
//
// Numerics: the JAX kernel's steps, each bf16 operation computed in f32
// and rounded once (bf16r): GN1 statistics from the f32 pw1 values and t1
// stored in bf16; the GroupNorm vectors from E[x^2] - mean^2 over
// n = H*W*(C/32), rounded to bf16 before use; ReLU(GN1) and the depthwise
// taps in bf16, accumulated in bf16 in (ky, kx) order, GN2 statistics from
// the bf16 values; SiLU as v * bf16(sigmoid_f32(v)); the towers'
// statistics in f32 and their maps in bf16.  The partial sums are added in
// another order than the reference's, and expf is not XLA's, so an output
// may differ from the plain version by a few bf16 steps.
//
// Bound on the card: 1.50 M multiply-adds per pixel at f = 256, 20
// classes, against 512 input and 50 output bytes: the tensor cores bound
// it (the towers' 9f-deep GEMM is 78 % of the work).
#include "bf16_mma.cuh"

namespace {

constexpr int kGroups = 32;
constexpr int kMaxF2 = 512;   // f <= 256: the folded GroupNorm vectors in shared memory
constexpr int kDwPix = 64;    // pixels per fhead_dw block
constexpr float kEps = 1e-5f;

using Wide = Tile<128, 128, 2, 4>;
using Slim = Tile<128, 32, 8, 1>;  // the prediction convs: N = nc or 5
constexpr int kBM = Wide::BM;
static_assert(Slim::BM == kBM, "one row tiling for every stage");

struct Args {
  const uint16_t* x;     // [B*HW, f]
  const uint16_t* pw1;   // [f2, f]
  const float* dw;       // [9, f2]
  const uint16_t* pw2;   // [f, f2]
  const uint16_t* tow;   // [2f, 9f]: the cls tower's output channels, then the reg tower's
  const uint16_t* pcls;  // [nc, 9f]
  const uint16_t* pcr;   // [5, 9f]: cnt, then the 4 reg channels
  const float* gn;       // [8, f2]: scale, bias of gn1, gn2, cls_gn0, reg_gn0
  const float* bias;     // [3, wb]: pw2's, cls_pred's, cnt|reg_pred's
  uint16_t* out;         // [B*HW, nc + 5]
  uint16_t* t1;          // [B*HW, f2]: pw1's map, then the towers' (cls | reg)
  uint16_t* t2;          // [B*HW, f2]
  uint16_t* y;           // [B*HW, f]
  float *p1s, *p1q;      // [B, tiles, f2] partial sums / sums of squares
  float *p2s, *p2q;      // [B, dw_tiles, f2]
  float *p3s, *p3q;      // [B, tiles, 2f]
  int b, h, w, hw, f, f2, nc, wb, tiles, dw_tiles;
};

// Per-channel (mul, add) of one image's GroupNorm from a producer's per-tile
// partial sums: channels coff .. coff + c of rows [b, 0:tiles, :] of psum /
// psq (row length ``stride``), n values per group; mul and add rounded to
// bf16, as the JAX kernel casts them (pallas_head.py:39-51).  All threads
// of the block take part; mul_s, add_s hold c floats, gm, gi 32.
__device__ void fold_gn(const float* __restrict__ psum, const float* __restrict__ psq, int tiles, int stride,
                        int coff, int c, int b, float n, const float* __restrict__ scale,
                        const float* __restrict__ bias, float* mul_s, float* add_s, float* gm, float* gi) {
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float* ps = psum + static_cast<int64_t>(b) * tiles * stride + coff + ch;
    const float* pq = psq + static_cast<int64_t>(b) * tiles * stride + coff + ch;
    float s = 0.0f, q = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      s += ps[static_cast<int64_t>(t) * stride];
      q += pq[static_cast<int64_t>(t) * stride];
    }
    mul_s[ch] = s;
    add_s[ch] = q;
  }
  __syncthreads();
  const int cg = c / kGroups;
  if (threadIdx.x < kGroups) {
    float s = 0.0f, q = 0.0f;
    for (int j = 0; j < cg; ++j) {
      s += mul_s[threadIdx.x * cg + j];
      q += add_s[threadIdx.x * cg + j];
    }
    const float mean = s / n;
    const float var = q / n - mean * mean;
    gm[threadIdx.x] = mean;
    gi[threadIdx.x] = 1.0f / sqrtf(var + kEps);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float mul = gi[ch / cg] * scale[ch];
    mul_s[ch] = bf16r(mul);
    add_s[ch] = bf16r(bias[ch] - gm[ch / cg] * mul);
  }
  __syncthreads();
}

// t2 rows as pw2's A operand: GN2 (bf16 mul, then bf16 add) and
// SiLU = v * bf16(sigmoid_f32(v)), each op rounded to bf16
struct GnSiluOperand {
  const uint16_t* p;
  int64_t row0;
  int rows, k;
  const float* mul;
  const float* add;
  __device__ __forceinline__ uint4 operator()(int r, int kk) const {
    if (r >= rows || kk >= k) return zero4();
    float v[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(p + (row0 + r) * k + kk)), v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float u = bf16r(bf16r(v[j] * mul[kk + j]) + add[kk + j]);
      v[j] = bf16r(u * bf16r(1.0f / (1.0f + expf(-u))));
    }
    return pack8(v);
  }
};

// The 3x3 SAME im2col of channels coff .. coff + c of an NHWC map (row
// length ld) for output pixels p0 + r of image b; depth index
// (ky * 3 + kx) * c + ch, the JAX kernel's tap-major order.  With gn_relu,
// each loaded value goes through ReLU(GN) in bf16 first; the padding stays
// 0 (it is added after the transform, as _im2col_rows does).
struct Im2colOperand {
  const uint16_t* src;
  int ld, coff, c, h, w, hw, b, p0, rows;
  const float* mul;
  const float* add;
  bool gn_relu;
  __device__ __forceinline__ uint4 operator()(int r, int kk) const {
    if (r >= rows || kk >= 9 * c) return zero4();
    const int tap = kk / c, ch = kk - tap * c, p = p0 + r;
    const int sy = p / w + tap / 3 - 1, sx = p % w + tap % 3 - 1;
    if (sy < 0 || sy >= h || sx < 0 || sx >= w) return zero4();
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
        src + (static_cast<int64_t>(b) * hw + sy * w + sx) * ld + coff + ch));
    if (!gn_relu) return raw;
    float v[8];
    unpack8(raw, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(bf16r(bf16r(v[j] * mul[ch + j]) + add[ch + j]), 0.0f);
    return pack8(v);
  }
};

// the block's image, first pixel and valid rows: grid.x = B * tiles
struct RowTile {
  int b, tile, p0, rows;
  int64_t row0;  // global row of tile row 0
  __device__ RowTile(const Args& g) {
    b = blockIdx.x / g.tiles;
    tile = blockIdx.x % g.tiles;
    p0 = tile * kBM;
    rows = min(kBM, g.hw - p0);
    row0 = static_cast<int64_t>(b) * g.hw + p0;
  }
};

// acc as bf16 into out[row0 + r, 0:n] (row length ld), rows < rows
template <class T>
__device__ __forceinline__ void store_tile(const typename T::Acc& acc, uint16_t* out, int64_t row0, int rows, int n0,
                                           int n, int ld) {
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = T::row(mt, 2 * h);
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int col = n0 + T::col(nt, 0);
        if (col < n)
          store_pair(out, (row0 + r) * ld + col, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1], col + 1 < n, true);
      }
    }
}

// grid (B * tiles, ceil(f2 / 128))
__global__ void __launch_bounds__(kThreads) fhead_pw1(const Args g) {
  __shared__ __align__(16) Wide::Smem sm;
  __shared__ float red[2 * Wide::WARPS_M * Wide::BN];
  const RowTile rt(g);
  const int n0 = blockIdx.y * Wide::BN;
  const PlainOperand la{g.x, rt.row0, rt.rows, g.f, g.f, true};
  const PlainOperand lb{g.pw1, n0, min(Wide::BN, g.f2 - n0), g.f, g.f, true};
  Wide::Acc acc;
  Wide::mainloop(acc, sm, la, lb, g.f);
  store_tile<Wide>(acc, g.t1, rt.row0, rt.rows, n0, g.f2, g.f2);
  const int64_t part = static_cast<int64_t>(rt.b * g.tiles + rt.tile) * g.f2;
  Wide::column_stats(acc, rt.rows, red, g.p1s + part, g.p1q + part, n0, g.f2);
}

// grid (B * dw_tiles), block f2 / 2 threads: two channels a thread over
// kDwPix pixels
__global__ void __launch_bounds__(kMaxF2 / 2) fhead_dw(const Args g) {
  __shared__ float mul_s[kMaxF2], add_s[kMaxF2], gm[kGroups], gi[kGroups];
  const int b = blockIdx.x / g.dw_tiles, tile = blockIdx.x % g.dw_tiles;
  fold_gn(g.p1s, g.p1q, g.tiles, g.f2, 0, g.f2, b, static_cast<float>(g.hw * (g.f2 / kGroups)), g.gn,
          g.gn + g.f2, mul_s, add_s, gm, gi);
  const int c = 2 * threadIdx.x;
  float tap0[9], tap1[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    tap0[i] = bf16r(g.dw[i * g.f2 + c]);
    tap1[i] = bf16r(g.dw[i * g.f2 + c + 1]);
  }
  const float m0 = mul_s[c], m1 = mul_s[c + 1], a0 = add_s[c], a1 = add_s[c + 1];
  float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
  const int64_t img = static_cast<int64_t>(b) * g.hw;
  const int pend = min(g.hw, (tile + 1) * kDwPix);
  for (int p = tile * kDwPix; p < pend; ++p) {
    const int py = p / g.w, px = p % g.w;
    float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int sy = py + ky - 1, sx = px + kx - 1;
        if (sy < 0 || sy >= g.h || sx < 0 || sx >= g.w) continue;  // padding: a 0 tap adds nothing
        const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(g.t1 + (img + sy * g.w + sx) * g.f2 + c));
        const float u0 = fmaxf(bf16r(bf16r(bf2f(static_cast<uint16_t>(v & 0xffffu)) * m0) + a0), 0.0f);
        const float u1 = fmaxf(bf16r(bf16r(bf2f(static_cast<uint16_t>(v >> 16)) * m1) + a1), 0.0f);
        acc0 = bf16r(acc0 + bf16r(u0 * tap0[ky * 3 + kx]));
        acc1 = bf16r(acc1 + bf16r(u1 * tap1[ky * 3 + kx]));
      }
    store_pair(g.t2, (img + p) * g.f2 + c, acc0, acc1, true, true);
    s0 += acc0;
    s1 += acc1;
    q0 += acc0 * acc0;
    q1 += acc1 * acc1;
  }
  const int64_t part = static_cast<int64_t>(b * g.dw_tiles + tile) * g.f2 + c;
  g.p2s[part] = s0;
  g.p2s[part + 1] = s1;
  g.p2q[part] = q0;
  g.p2q[part + 1] = q1;
}

// grid (B * tiles, ceil(f / 128))
__global__ void __launch_bounds__(kThreads) fhead_pw2(const Args g) {
  __shared__ __align__(16) Wide::Smem sm;
  __shared__ float mul_s[kMaxF2], add_s[kMaxF2], gm[kGroups], gi[kGroups];
  const RowTile rt(g);
  fold_gn(g.p2s, g.p2q, g.dw_tiles, g.f2, 0, g.f2, rt.b, static_cast<float>(g.hw * (g.f2 / kGroups)),
          g.gn + 2 * g.f2, g.gn + 3 * g.f2, mul_s, add_s, gm, gi);
  const int n0 = blockIdx.y * Wide::BN;
  const GnSiluOperand la{g.t2, rt.row0, rt.rows, g.f2, mul_s, add_s};
  const PlainOperand lb{g.pw2, n0, min(Wide::BN, g.f - n0), g.f2, g.f2, true};
  Wide::Acc acc;
  Wide::mainloop(acc, sm, la, lb, g.f2);
  // y = acc + bias + x (pallas_head.py:159-161)
#pragma unroll
  for (int mt = 0; mt < Wide::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = Wide::row(mt, 2 * h);
      if (r >= rt.rows) continue;
#pragma unroll
      for (int nt = 0; nt < Wide::NT; ++nt) {
        const int n = n0 + Wide::col(nt, 0);
        if (n >= g.f) continue;
        const int64_t at = (rt.row0 + r) * g.f + n;
        const float v0 = __fadd_rn(__fadd_rn(acc[mt][nt][2 * h], g.bias[n]), bf2f(g.x[at]));
        const float v1 = __fadd_rn(__fadd_rn(acc[mt][nt][2 * h + 1], g.bias[n + 1]), bf2f(g.x[at + 1]));
        store_pair(g.y, at, v0, v1, true, true);
      }
    }
}

// grid (B * tiles, ceil(2f / 128))
__global__ void __launch_bounds__(kThreads) fhead_towers(const Args g) {
  __shared__ __align__(16) Wide::Smem sm;
  __shared__ float red[2 * Wide::WARPS_M * Wide::BN];
  const RowTile rt(g);
  const int n0 = blockIdx.y * Wide::BN, n = 2 * g.f;
  const Im2colOperand la{g.y, g.f, 0, g.f, g.h, g.w, g.hw, rt.b, rt.p0, rt.rows, nullptr, nullptr, false};
  const PlainOperand lb{g.tow, n0, min(Wide::BN, n - n0), 9 * g.f, 9 * g.f, true};
  Wide::Acc acc;
  Wide::mainloop(acc, sm, la, lb, 9 * g.f);
  store_tile<Wide>(acc, g.t1, rt.row0, rt.rows, n0, n, n);
  const int64_t part = static_cast<int64_t>(rt.b * g.tiles + rt.tile) * n;
  Wide::column_stats(acc, rt.rows, red, g.p3s + part, g.p3q + part, n0, n);
}

// grid (B * tiles, ceil(max(nc, 5) / 32), 2): z = 0 the cls conv on the cls
// tower, z = 1 the cnt|reg conv on the reg tower
__global__ void __launch_bounds__(kThreads) fhead_pred(const Args g) {
  __shared__ __align__(16) Slim::Smem sm;
  __shared__ float mul_s[kMaxF2], add_s[kMaxF2], gm[kGroups], gi[kGroups];
  const int z = blockIdx.z, n = z ? 5 : g.nc, n0 = blockIdx.y * Slim::BN;
  if (n0 >= n) return;  // the whole block: no barrier is skipped by part of it
  const RowTile rt(g);
  fold_gn(g.p3s, g.p3q, g.tiles, 2 * g.f, z * g.f, g.f, rt.b, static_cast<float>(g.hw * (g.f / kGroups)),
          g.gn + (4 + 2 * z) * g.f2, g.gn + (5 + 2 * z) * g.f2, mul_s, add_s, gm, gi);
  const Im2colOperand la{g.t1, 2 * g.f, z * g.f, g.f, g.h, g.w, g.hw, rt.b, rt.p0, rt.rows, mul_s, add_s, true};
  const PlainOperand lb{z ? g.pcr : g.pcls, n0, min(Slim::BN, n - n0), 9 * g.f, 9 * g.f, true};
  Slim::Acc acc;
  Slim::mainloop(acc, sm, la, lb, 9 * g.f);
  const int ld = g.nc + 5, coff = z * g.nc;
  const float* bias = g.bias + (1 + z) * g.wb;
  const bool aligned = ld % 2 == 0 && coff % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < Slim::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = Slim::row(mt, 2 * h);
      if (r >= rt.rows) continue;
#pragma unroll
      for (int nt = 0; nt < Slim::NT; ++nt) {
        const int col = n0 + Slim::col(nt, 0);
        if (col >= n) continue;
        const bool both = col + 1 < n;
        const float v0 = __fadd_rn(acc[mt][nt][2 * h], bias[col]);
        const float v1 = both ? __fadd_rn(acc[mt][nt][2 * h + 1], bias[col + 1]) : 0.0f;
        store_pair(g.out, (rt.row0 + r) * ld + coff + col, v0, v1, both, aligned);
      }
    }
}

int tiles_of(int hw) { return (hw + kBM - 1) / kBM; }
int dw_tiles_of(int hw) { return (hw + kDwPix - 1) / kDwPix; }

}  // namespace

// Scratch one call needs: sizes[0] bf16 elements, sizes[1] f32 elements.
extern "C" void hishead_scratch_sizes(int b, int h, int w, int f, long long* sizes) {
  const long long hw = static_cast<long long>(h) * w, f2 = 2LL * f;
  sizes[0] = b * hw * (2 * f2 + f);
  sizes[1] = 2LL * b * f2 * (2 * tiles_of(static_cast<int>(hw)) + dw_tiles_of(static_cast<int>(hw)));
}

// x [B, H, W, f] bf16 NHWC -> out [B, H, W, nc + 5] bf16; the weights in the
// layouts of Args, f a multiple of 32 up to 256, every pointer 16-byte
// aligned.  Returns a cudaError_t (0 = all five launched).
extern "C" int hishead_launch(const void* x, const void* pw1, const void* dw, const void* pw2, const void* tow,
                              const void* pcls, const void* pcr, const void* gn, const void* bias, int wb, void* out,
                              void* scratch_bf16, void* scratch_f32, int b, int h, int w, int f, int nc,
                              void* stream) {
  Args g;
  g.x = static_cast<const uint16_t*>(x);
  g.pw1 = static_cast<const uint16_t*>(pw1);
  g.dw = static_cast<const float*>(dw);
  g.pw2 = static_cast<const uint16_t*>(pw2);
  g.tow = static_cast<const uint16_t*>(tow);
  g.pcls = static_cast<const uint16_t*>(pcls);
  g.pcr = static_cast<const uint16_t*>(pcr);
  g.gn = static_cast<const float*>(gn);
  g.bias = static_cast<const float*>(bias);
  g.out = static_cast<uint16_t*>(out);
  g.b = b;
  g.h = h;
  g.w = w;
  g.hw = h * w;
  g.f = f;
  g.f2 = 2 * f;
  g.nc = nc;
  g.wb = wb;
  g.tiles = tiles_of(g.hw);
  g.dw_tiles = dw_tiles_of(g.hw);
  if (f % kGroups || g.f2 > kMaxF2 || nc < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(b) * g.hw;
  g.t1 = static_cast<uint16_t*>(scratch_bf16);
  g.t2 = g.t1 + rows * g.f2;
  g.y = g.t2 + rows * g.f2;
  const int64_t n1 = static_cast<int64_t>(b) * g.tiles * g.f2, n2 = static_cast<int64_t>(b) * g.dw_tiles * g.f2;
  g.p1s = static_cast<float*>(scratch_f32);
  g.p1q = g.p1s + n1;
  g.p2s = g.p1q + n1;
  g.p2q = g.p2s + n2;
  g.p3s = g.p2q + n2;
  g.p3q = g.p3s + n1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned gx = static_cast<unsigned>(b) * g.tiles;
  cudaError_t err;
  fhead_pw1<<<dim3(gx, (g.f2 + Wide::BN - 1) / Wide::BN), kThreads, 0, s>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  fhead_dw<<<static_cast<unsigned>(b) * g.dw_tiles, g.f2 / 2, 0, s>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  fhead_pw2<<<dim3(gx, (g.f + Wide::BN - 1) / Wide::BN), kThreads, 0, s>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  fhead_towers<<<dim3(gx, (2 * g.f + Wide::BN - 1) / Wide::BN), kThreads, 0, s>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  fhead_pred<<<dim3(gx, ((nc > 5 ? nc : 5) + Slim::BN - 1) / Slim::BN, 2), kThreads, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}
