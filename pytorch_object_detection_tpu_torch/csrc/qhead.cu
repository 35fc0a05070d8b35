// K7 and K9: one level of the int8 HISHead per call.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_qhead.py:qhishead_level
// (K7) and :qhishead_level2 (K9).  The TPU kernels keep a whole level in VMEM
// (z1/z2/tower pre-norm scratch, 12 MB per image at 64x64) and walk it in
// seven passes, each GroupNorm's statistics complete before its consumer
// runs.  A Hopper SM has 227 KB of shared memory and no ordered grid, so each
// pass is its own kernel on one stream, with the pre-norm maps in device
// memory as f32 (not bf16: no sub-step rounding before the normalize):
//
//   pw1     z1 = float(x @ w1) * A1                       (1x1, C -> 2C) + GN1 sums
//   stats   mean, rstd of GN1 per (image, group)
//   dw      x1q = clip8(relu(gn1(z1)) * inv_x1) on the tile and a 1-pixel halo,
//           z2 = float(dw3x3(x1q)) * Adw                  + GN2 sums
//   stats   GN2
//   pw2     x2q = clip8(silu(gn2(z2)) * inv_x2),
//           yq = clip8(((x2q @ w2) * A2 + B2) + x * res_mul)        (2C -> C)
//   towers  zc = float(conv3x3(yq, wc)) * Ac, zr = ... wr * Ar  (C -> 2 x C, one
//           read of yq; [zc | zr] reuses z2's buffer)    + GNc/GNr sums
//   stats   GNc, GNr
//   pred    cq, rq = clip8(relu(gn(z)) * inv) on the tile and halo,
//           cls = float(conv3x3(cq, wpc)) * Apc + bpc, cr = ... (rq, wcr) * Acr + bcr
//
// Every tile kernel owns an 8x8 tile of one image (K7) or the same tile of
// two images (K9, even batches).  K9 never writes z1: its pw1 pass only sums,
// and its dw pass recomputes pw1 on the tile and halo from the int8 input
// (100/64 of the pw1 work again: 14 % more work than K7 at C=256), and its
// larger shared-memory tiles (two images) leave fewer blocks per SM.  It is
// slower than K7 on an H100 (1.19x at the COCO P3 shape, chip_smoke.py
// phase 6); the JAX rule that picks it stays, as in the JAX package.  The zero padding
// of each 3x3 conv sits in the int8 domain after the normalize (halo
// positions outside the map are 0), as the reference pads x1q, yq, cq, rq.
//
// GroupNorm statistics are exact and deterministic: a pre-norm value is
// int32 acc times a per-channel scale, so each tile sums acc and acc^2 per
// channel in int64 (shared-memory integer atomics: any order gives the same
// sum), and the stats kernel combines the tiles in a fixed order in double:
// mean = sum_c A_c S1_c / n, var = sum_c A_c^2 S2_c / n - mean^2, rounded to
// f32 with rstd = 1 / sqrt(var + 1e-5).  |acc| <= 2304 * 127^2 < 2^26.
//
// Bound on the card: int8 multiply-adds, 1.50 M per position at C=256,
// nc=20 (78 % in the tower convs), 8.2 G per 512^2 image; run here with
// __dp4a on the CUDA cores through the tile of int8_common.cuh (weights
// [out][taps][in] streamed through L1/L2), not the tensor cores.
//
// Against the plain version (models/head_int8's per-op oracle): the convs
// are exact and the epilogues use separate __fmul_rn / __fadd_rn under
// -fmad=false, but the GroupNorm statistics are exact where the plain
// version's are f32 sums, and SiLU uses expf, so an int8 intermediate can
// move by one step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 8;             // output tile: kT x kT positions of one image
constexpr int kPos = kT * kT;
constexpr int kH = kT + 2;        // the tile and a 1-pixel halo
constexpr int kHalo = kH * kH;
constexpr int kStats = 256;       // floats per image: gn1, gn2, gnc, gnr x 32 groups x (mean, rstd)
constexpr float kEps = 1e-5f;

struct Args {
  const int8_t* x;  // [B, H, W, C]
  const int8_t *w1, *wdw, *w2, *wc, *wr, *wpc, *wcr;  // [2C][C], [9][2C], [C][2C], [C][9][C] x2, [nc][9][C], [5][9][C]
  const float *bpc, *bcr;
  const float *g1, *be1, *g2, *be2, *gc, *bec, *gr, *ber;
  const float *a1, *inv_x1, *adw, *inv_x2, *a2, *b2, *res_mul, *ac, *inv_c, *ar, *inv_r, *apc, *acr;
  float *cls, *cr;     // [B, H, W, nc], [B, H, W, 5]
  float* z1;           // [B, H, W, 2C] pw1 pre-norm (K7); null for K9
  float* z2;           // [B, H, W, 2C] dw pre-norm, then [zc | zr]
  int8_t* yq;          // [B, H, W, C]
  long long *s1, *s2;  // [B, ntiles, 2C] per-tile sums of acc and acc^2
  float* stats;        // [B, kStats]
  int h, w, c, nc, nimg, tiles_x, ntiles;
};

struct Tile {
  int r0, c0, th, tw, npos, tile, b0;
};

__device__ __forceinline__ Tile tile_of(const Args& g) {
  Tile t;
  t.r0 = blockIdx.y * kT;
  t.c0 = blockIdx.x * kT;
  t.th = min(kT, g.h - t.r0);
  t.tw = min(kT, g.w - t.c0);
  t.npos = t.th * t.tw;
  t.tile = blockIdx.y * g.tiles_x + blockIdx.x;
  t.b0 = blockIdx.z * g.nimg;
  return t;
}

__device__ __forceinline__ int64_t pixel(const Args& g, int b, int y, int x) {
  return (static_cast<int64_t>(b) * g.h + y) * g.w + x;
}

// mean and rstd of GroupNorm `gn` (0 gn1, 1 gn2, 2 the towers' 64 groups), group `grp`, image b
__device__ __forceinline__ const float* stat(const Args& g, int b, int gn, int grp) {
  return g.stats + static_cast<int64_t>(b) * kStats + gn * 64 + grp * 2;
}

// ((z - mean) * rstd) * gamma + beta, the reference's association
__device__ __forceinline__ float gn_affine(float z, const float* st, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(z, st[0]), st[1]), gamma), beta);
}

__device__ __forceinline__ float silu(float z) {
  return __fmul_rn(z, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))));
}

__device__ __forceinline__ int pack4(const int8_t (&q)[4]) {
  return (q[0] & 0xff) | ((q[1] & 0xff) << 8) | ((q[2] & 0xff) << 16) | ((q[3] & 0xff) << 24);
}

__device__ __forceinline__ int byte_of(int v, int i) { return static_cast<int8_t>((v >> (8 * i)) & 0xff); }

// acc[p][q] += dot(act[p][0:k], w[q][0:k]) over 16-byte words (dot_tile with one row pointer per output)
__device__ __forceinline__ void dot_rows(int (&acc)[kP][kQ], const int8_t* const (&act)[kP],
                                         const int8_t* const (&w)[kQ], int k) {
  for (int kk = 0; kk < k; kk += 16) {
    int4 wv[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) wv[q] = __ldg(reinterpret_cast<const int4*>(w[q] + kk));
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int4 av = *reinterpret_cast<const int4*>(act[p] + kk);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        int s = acc[p][q];
        s = __dp4a(av.x, wv[q].x, s);
        s = __dp4a(av.y, wv[q].y, s);
        s = __dp4a(av.z, wv[q].z, s);
        s = __dp4a(av.w, wv[q].w, s);
        acc[p][q] = s;
      }
    }
  }
}

// the tile's positions (pos < npos; 0 beyond) of nimg images of an [B, H, W, ch]
// int8 map into dst [nimg][kPos][ch]
__device__ void load_tile(int8_t* dst, const int8_t* src, int ch, const Args& g, const Tile& t) {
  const int c16 = ch / 16;
  for (int j = threadIdx.x; j < g.nimg * kPos * c16; j += kThreads) {
    const int cc = (j % c16) * 16, pos = (j / c16) % kPos, i = j / (c16 * kPos);
    int4 v = make_int4(0, 0, 0, 0);
    if (pos < t.npos)
      v = __ldg(reinterpret_cast<const int4*>(src + pixel(g, t.b0 + i, t.r0 + pos / t.tw, t.c0 + pos % t.tw) * ch + cc));
    *reinterpret_cast<int4*>(dst + (i * kPos + pos) * ch + cc) = v;
  }
}

// the tile and its halo (kH x kH; 0 outside the map) into dst [nimg][kHalo][ch]
__device__ void load_halo(int8_t* dst, const int8_t* src, int ch, const Args& g, const Tile& t) {
  const int c16 = ch / 16;
  for (int j = threadIdx.x; j < g.nimg * kHalo * c16; j += kThreads) {
    const int cc = (j % c16) * 16, hp = (j / c16) % kHalo, i = j / (c16 * kHalo);
    const int y = t.r0 - 1 + hp / kH, x = t.c0 - 1 + hp % kH;
    int4 v = make_int4(0, 0, 0, 0);
    if (y >= 0 && y < g.h && x >= 0 && x < g.w)
      v = __ldg(reinterpret_cast<const int4*>(src + pixel(g, t.b0 + i, y, x) * ch + cc));
    *reinterpret_cast<int4*>(dst + (i * kHalo + hp) * ch + cc) = v;
  }
}

__device__ __forceinline__ void zero_sums(unsigned long long* s, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) s[i] = 0ull;
}

// one item's (kP positions x kQ channels) sums into the block's per-channel sums
__device__ __forceinline__ void add_sums(unsigned long long* s1, unsigned long long* s2, int ch,
                                         const long long (&a)[kQ], const long long (&a2)[kQ]) {
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    atomicAdd(s1 + ch + k, static_cast<unsigned long long>(a[k]));
    atomicAdd(s2 + ch + k, static_cast<unsigned long long>(a2[k]));
  }
}

// the block's sums [nimg][2C] to the per-tile partials
__device__ void store_sums(const Args& g, const Tile& t, const unsigned long long* s1, const unsigned long long* s2) {
  const int c2 = 2 * g.c;
  for (int j = threadIdx.x; j < g.nimg * c2; j += kThreads) {
    const int64_t at = (static_cast<int64_t>(t.b0 + j / c2) * g.ntiles + t.tile) * c2 + j % c2;
    g.s1[at] = static_cast<long long>(s1[j]);
    g.s2[at] = static_cast<long long>(s2[j]);
  }
}

// grid (tiles_x, tiles_y, B / nimg); smem: x [nimg][kPos][C] int8, sums [2][nimg][2C] u64
__global__ void __launch_bounds__(kThreads) head_pw1(const Args g) {
  extern __shared__ __align__(16) int8_t smem[];
  const Tile t = tile_of(g);
  const int c = g.c, c2 = 2 * c;
  int8_t* xs = smem;
  unsigned long long* s1 = reinterpret_cast<unsigned long long*>(smem + g.nimg * kPos * c);
  unsigned long long* s2 = s1 + g.nimg * c2;
  zero_sums(s1, 2 * g.nimg * c2);
  load_tile(xs, g.x, c, g, t);
  __syncthreads();

  const int quads = c2 / kQ, groups = (t.npos + kP - 1) / kP;
  for (int it = threadIdx.x; it < g.nimg * groups * quads; it += kThreads) {
    const int o = (it % quads) * kQ, pg = ((it / quads) % groups) * kP, i = it / (quads * groups);
    const int8_t* act[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) act[p] = xs + (i * kPos + min(pg + p, t.npos - 1)) * c;
    int acc[kP][kQ];
    zero(acc);
    dot_tile(acc, act, g.w1 + static_cast<int64_t>(o) * c, c, c);
    long long a[kQ] = {0, 0, 0, 0}, a2[kQ] = {0, 0, 0, 0};
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int pos = pg + p;
      if (pos >= t.npos) break;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        a[k] += acc[p][k];
        a2[k] += static_cast<long long>(acc[p][k]) * acc[p][k];
      }
      if (g.z1 != nullptr) {
        const float4 z = make_float4(__fmul_rn(__int2float_rn(acc[p][0]), g.a1[o + 0]),
                                     __fmul_rn(__int2float_rn(acc[p][1]), g.a1[o + 1]),
                                     __fmul_rn(__int2float_rn(acc[p][2]), g.a1[o + 2]),
                                     __fmul_rn(__int2float_rn(acc[p][3]), g.a1[o + 3]));
        *reinterpret_cast<float4*>(g.z1 + pixel(g, t.b0 + i, t.r0 + pos / t.tw, t.c0 + pos % t.tw) * c2 + o) = z;
      }
    }
    add_sums(s1 + i * c2, s2 + i * c2, o, a, a2);
  }
  __syncthreads();
  store_sums(g, t, s1, s2);
}

// grid (ngroups, B): mean and rstd of one (image, group) from the per-tile
// sums, in a fixed order (the same result in every run).  which: 0 gn1 (A1),
// 1 gn2 (Adw), 2 the towers (64 groups: Ac over [0, C), Ar over [C, 2C))
__global__ void __launch_bounds__(kThreads) head_gn_stats(const Args g, int which) {
  __shared__ double r1[kThreads], r2[kThreads];
  const int c2 = 2 * g.c, gsz = c2 / (which == 2 ? 64 : 32), b = blockIdx.y, grp = blockIdx.x, tid = threadIdx.x;
  double t1 = 0.0, t2 = 0.0;
  for (int j = tid; j < gsz * g.ntiles; j += kThreads) {
    const int ch = grp * gsz + j % gsz;
    const double a = which == 0 ? g.a1[ch] : which == 1 ? g.adw[ch] : (ch < g.c ? g.ac[ch] : g.ar[ch - g.c]);
    const int64_t at = (static_cast<int64_t>(b) * g.ntiles + j / gsz) * c2 + ch;
    t1 += a * static_cast<double>(g.s1[at]);
    t2 += a * a * static_cast<double>(g.s2[at]);
  }
  r1[tid] = t1;
  r2[tid] = t2;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      r1[tid] += r1[tid + s];
      r2[tid] += r2[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const double n = static_cast<double>(g.h) * g.w * gsz;
    const double mean = r1[0] / n, var = fmax(r2[0] / n - mean * mean, 0.0);
    float* out = g.stats + static_cast<int64_t>(b) * kStats + which * 64 + grp * 2;
    out[0] = static_cast<float>(mean);
    out[1] = static_cast<float>(1.0 / sqrt(var + static_cast<double>(kEps)));
  }
}

// x1q of channels [o, o+4) from four pw1 pre-norm values (0 outside the map)
__device__ __forceinline__ int norm_x1(const Args& g, int b, int o, const float (&z)[4]) {
  const int gsz = 2 * g.c / 32;
  const float inv = *g.inv_x1;
  int8_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = requant_relu(__fmul_rn(gn_affine(z[k], stat(g, b, 0, (o + k) / gsz), g.g1[o + k], g.be1[o + k]), inv));
  return pack4(q);
}

// grid (tiles_x, tiles_y, B / nimg); smem: x1q [nimg][kHalo][2C] int8, sums
// [2][nimg][2C] u64, and for K9 x [nimg][kHalo][C] int8
__global__ void __launch_bounds__(kThreads) head_dw(const Args g) {
  extern __shared__ __align__(16) int8_t smem[];
  const Tile t = tile_of(g);
  const int c = g.c, c2 = 2 * c, quads = c2 / kQ;
  int8_t* x1 = smem;
  unsigned long long* s1 = reinterpret_cast<unsigned long long*>(smem + g.nimg * kHalo * c2);
  unsigned long long* s2 = s1 + g.nimg * c2;
  zero_sums(s1, 2 * g.nimg * c2);

  if (g.z1 == nullptr) {  // K9: pw1 again on the tile and halo, from the int8 input
    int8_t* xs = reinterpret_cast<int8_t*>(s2 + g.nimg * c2);
    load_halo(xs, g.x, c, g, t);
    __syncthreads();
    const int groups = (kHalo + kP - 1) / kP;
    for (int it = threadIdx.x; it < g.nimg * groups * quads; it += kThreads) {
      const int o = (it % quads) * kQ, pg = ((it / quads) % groups) * kP, i = it / (quads * groups);
      const int8_t* act[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) act[p] = xs + (i * kHalo + min(pg + p, kHalo - 1)) * c;
      int acc[kP][kQ];
      zero(acc);
      dot_tile(acc, act, g.w1 + static_cast<int64_t>(o) * c, c, c);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int hp = pg + p;
        if (hp >= kHalo) break;
        const int y = t.r0 - 1 + hp / kH, x = t.c0 - 1 + hp % kH;
        int word = 0;
        if (y >= 0 && y < g.h && x >= 0 && x < g.w) {
          float z[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) z[k] = __fmul_rn(__int2float_rn(acc[p][k]), g.a1[o + k]);
          word = norm_x1(g, t.b0 + i, o, z);
        }
        *reinterpret_cast<int*>(x1 + (i * kHalo + hp) * c2 + o) = word;
      }
    }
  } else {  // K7: normalize the stored pw1 map on the tile and halo
    for (int j = threadIdx.x; j < g.nimg * kHalo * quads; j += kThreads) {
      const int o = (j % quads) * kQ, hp = (j / quads) % kHalo, i = j / (quads * kHalo);
      const int y = t.r0 - 1 + hp / kH, x = t.c0 - 1 + hp % kH;
      int word = 0;
      if (y >= 0 && y < g.h && x >= 0 && x < g.w) {
        const float4 v = *reinterpret_cast<const float4*>(g.z1 + pixel(g, t.b0 + i, y, x) * c2 + o);
        const float z[4] = {v.x, v.y, v.z, v.w};
        word = norm_x1(g, t.b0 + i, o, z);
      }
      *reinterpret_cast<int*>(x1 + (i * kHalo + hp) * c2 + o) = word;
    }
  }
  __syncthreads();

  // the depthwise 3x3 on the tile
  const int groups = (t.npos + kP - 1) / kP;
  for (int it = threadIdx.x; it < g.nimg * groups * quads; it += kThreads) {
    const int o = (it % quads) * kQ, pg = ((it / quads) % groups) * kP, i = it / (quads * groups);
    int wv[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) wv[tap] = __ldg(reinterpret_cast<const int*>(g.wdw + tap * c2 + o));
    long long a[kQ] = {0, 0, 0, 0}, a2[kQ] = {0, 0, 0, 0};
    for (int p = 0; p < kP; ++p) {
      const int pos = pg + p;
      if (pos >= t.npos) break;
      const int ty = pos / t.tw, tx = pos % t.tw;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int v = *reinterpret_cast<const int*>(x1 + (i * kHalo + (ty + tap / 3) * kH + tx + tap % 3) * c2 + o);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += byte_of(v, k) * byte_of(wv[tap], k);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] += acc[k];
        a2[k] += static_cast<long long>(acc[k]) * acc[k];
      }
      const float4 z = make_float4(__fmul_rn(__int2float_rn(acc[0]), g.adw[o + 0]),
                                   __fmul_rn(__int2float_rn(acc[1]), g.adw[o + 1]),
                                   __fmul_rn(__int2float_rn(acc[2]), g.adw[o + 2]),
                                   __fmul_rn(__int2float_rn(acc[3]), g.adw[o + 3]));
      *reinterpret_cast<float4*>(g.z2 + pixel(g, t.b0 + i, t.r0 + ty, t.c0 + tx) * c2 + o) = z;
    }
    add_sums(s1 + i * c2, s2 + i * c2, o, a, a2);
  }
  __syncthreads();
  store_sums(g, t, s1, s2);
}

// grid (tiles_x, tiles_y, B / nimg); smem: x2q [nimg][kPos][2C] int8
__global__ void __launch_bounds__(kThreads) head_pw2(const Args g) {
  extern __shared__ __align__(16) int8_t smem[];
  const Tile t = tile_of(g);
  const int c = g.c, c2 = 2 * c, gsz = c2 / 32;
  const float inv = *g.inv_x2, res_mul = *g.res_mul;
  int8_t* x2 = smem;
  for (int j = threadIdx.x; j < g.nimg * kPos * (c2 / 4); j += kThreads) {
    const int o = (j % (c2 / 4)) * 4, pos = (j / (c2 / 4)) % kPos, i = j / ((c2 / 4) * kPos);
    int word = 0;
    if (pos < t.npos) {
      const int b = t.b0 + i;
      const float4 v =
          *reinterpret_cast<const float4*>(g.z2 + pixel(g, b, t.r0 + pos / t.tw, t.c0 + pos % t.tw) * c2 + o);
      const float z[4] = {v.x, v.y, v.z, v.w};
      int8_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q[k] = clip8(__fmul_rn(silu(gn_affine(z[k], stat(g, b, 1, (o + k) / gsz), g.g2[o + k], g.be2[o + k])), inv));
      word = pack4(q);
    }
    *reinterpret_cast<int*>(x2 + (i * kPos + pos) * c2 + o) = word;
  }
  __syncthreads();

  const int quads = c / kQ, groups = (t.npos + kP - 1) / kP;
  for (int it = threadIdx.x; it < g.nimg * groups * quads; it += kThreads) {
    const int o = (it % quads) * kQ, pg = ((it / quads) % groups) * kP, i = it / (quads * groups);
    const int8_t* act[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) act[p] = x2 + (i * kPos + min(pg + p, t.npos - 1)) * c2;
    int acc[kP][kQ];
    zero(acc);
    dot_tile(acc, act, g.w2 + static_cast<int64_t>(o) * c2, c2, c2);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int pos = pg + p;
      if (pos >= t.npos) break;
      const int64_t px = pixel(g, t.b0 + i, t.r0 + pos / t.tw, t.c0 + pos % t.tw);
      const int res = *reinterpret_cast<const int*>(g.x + px * c + o);
      int8_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q[k] = clip8(__fadd_rn(epilogue(acc[p][k], g.a2[o + k], g.b2[o + k]),
                               __fmul_rn(static_cast<float>(byte_of(res, k)), res_mul)));
      *reinterpret_cast<int*>(g.yq + px * c + o) = pack4(q);
    }
  }
}

// grid (tiles_x, tiles_y, B / nimg); smem: yq [nimg][kHalo][C] int8, sums [2][nimg][2C] u64
__global__ void __launch_bounds__(kThreads) head_towers(const Args g) {
  extern __shared__ __align__(16) int8_t smem[];
  const Tile t = tile_of(g);
  const int c = g.c, c2 = 2 * c;
  int8_t* ys = smem;
  unsigned long long* s1 = reinterpret_cast<unsigned long long*>(smem + g.nimg * kHalo * c);
  unsigned long long* s2 = s1 + g.nimg * c2;
  zero_sums(s1, 2 * g.nimg * c2);
  load_halo(ys, g.yq, c, g, t);
  __syncthreads();

  // outputs [0, C): the cls tower (wc, Ac); [C, 2C): the reg tower (wr, Ar)
  const int quads = c2 / kQ, groups = (t.npos + kP - 1) / kP;
  for (int it = threadIdx.x; it < g.nimg * groups * quads; it += kThreads) {
    const int o = (it % quads) * kQ, pg = ((it / quads) % groups) * kP, i = it / (quads * groups);
    const bool cls = o < c;
    const int8_t* wt = (cls ? g.wc : g.wr) + static_cast<int64_t>(cls ? o : o - c) * 9 * c;
    const float* av = cls ? g.ac + o : g.ar + (o - c);
    const int8_t* base[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int pos = min(pg + p, t.npos - 1);
      base[p] = ys + (i * kHalo + (pos / t.tw) * kH + pos % t.tw) * c;
    }
    int acc[kP][kQ];
    zero(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3) * kH + tap % 3) * c;
      const int8_t* act[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) act[p] = base[p] + off;
      dot_tile(acc, act, wt + tap * c, 9 * c, c);
    }
    long long a[kQ] = {0, 0, 0, 0}, a2[kQ] = {0, 0, 0, 0};
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int pos = pg + p;
      if (pos >= t.npos) break;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        a[k] += acc[p][k];
        a2[k] += static_cast<long long>(acc[p][k]) * acc[p][k];
      }
      const float4 z = make_float4(__fmul_rn(__int2float_rn(acc[p][0]), av[0]),
                                   __fmul_rn(__int2float_rn(acc[p][1]), av[1]),
                                   __fmul_rn(__int2float_rn(acc[p][2]), av[2]),
                                   __fmul_rn(__int2float_rn(acc[p][3]), av[3]));
      *reinterpret_cast<float4*>(g.z2 + pixel(g, t.b0 + i, t.r0 + pos / t.tw, t.c0 + pos % t.tw) * c2 + o) = z;
    }
    add_sums(s1 + i * c2, s2 + i * c2, o, a, a2);
  }
  __syncthreads();
  store_sums(g, t, s1, s2);
}

__host__ __device__ __forceinline__ int pred_cols(int nc) { return 4 * ((nc + 3) / 4 + 2); }

// grid (tiles_x, tiles_y, B / nimg); smem: [cq | rq] [nimg][kHalo][2C] int8,
// then the int32 sums [nimg][kPos][pred_cols(nc)]: cls in the first
// ceil(nc/4) quads, cnt|reg in the last two (5 of 8 used)
__global__ void __launch_bounds__(kThreads) head_pred(const Args g) {
  extern __shared__ __align__(16) int8_t smem[];
  const Tile t = tile_of(g);
  const int c = g.c, c2 = 2 * c, gsz = c / 32, ncol = pred_cols(g.nc), qc = (g.nc + 3) / 4;
  int8_t* ts = smem;
  int* sums = reinterpret_cast<int*>(smem + g.nimg * kHalo * c2);
  const float inv_c = *g.inv_c, inv_r = *g.inv_r;
  for (int j = threadIdx.x; j < g.nimg * kPos * ncol; j += kThreads) sums[j] = 0;
  for (int j = threadIdx.x; j < g.nimg * kHalo * (c2 / 4); j += kThreads) {
    const int o = (j % (c2 / 4)) * 4, hp = (j / (c2 / 4)) % kHalo, i = j / ((c2 / 4) * kHalo);
    const int y = t.r0 - 1 + hp / kH, x = t.c0 - 1 + hp % kH;
    int word = 0;
    if (y >= 0 && y < g.h && x >= 0 && x < g.w) {
      const int b = t.b0 + i;
      const float4 v = *reinterpret_cast<const float4*>(g.z2 + pixel(g, b, y, x) * c2 + o);
      const float z[4] = {v.x, v.y, v.z, v.w};
      const bool cls = o < c;
      int8_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ch = o + k;
        const float gamma = cls ? g.gc[ch] : g.gr[ch - c], beta = cls ? g.bec[ch] : g.ber[ch - c];
        q[k] = requant_relu(__fmul_rn(gn_affine(z[k], stat(g, b, 2, ch / gsz), gamma, beta), cls ? inv_c : inv_r));
      }
      word = pack4(q);
    }
    *reinterpret_cast<int*>(ts + (i * kHalo + hp) * c2 + o) = word;
  }
  __syncthreads();

  // items split by tap too (the pred convs have few outputs); integer sums, so the order is free
  const int quads = qc + 2, groups = (t.npos + kP - 1) / kP;
  for (int it = threadIdx.x; it < g.nimg * groups * quads * 9; it += kThreads) {
    const int tap = it % 9, oq = (it / 9) % quads, pg = ((it / (9 * quads)) % groups) * kP;
    const int i = it / (9 * quads * groups);
    const bool cls = oq < qc;
    const int n = cls ? g.nc : 5, o = (cls ? oq : oq - qc) * 4;
    const int8_t* wrow[kQ];
#pragma unroll
    for (int k = 0; k < kQ; ++k)
      wrow[k] = (cls ? g.wpc : g.wcr) + static_cast<int64_t>(min(o + k, n - 1)) * 9 * c + tap * c;
    const int8_t* act[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int pos = min(pg + p, t.npos - 1);
      act[p] = ts + (i * kHalo + (pos / t.tw + tap / 3) * kH + pos % t.tw + tap % 3) * c2 + (cls ? 0 : c);
    }
    int acc[kP][kQ];
    zero(acc);
    dot_rows(acc, act, wrow, c);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (pg + p >= t.npos) break;
#pragma unroll
      for (int k = 0; k < kQ; ++k)
        if (o + k < n) atomicAdd(sums + (i * kPos + pg + p) * ncol + oq * 4 + k, acc[p][k]);
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < g.nimg * kPos * ncol; j += kThreads) {
    const int col = j % ncol, pos = (j / ncol) % kPos, i = j / (ncol * kPos);
    if (pos >= t.npos) continue;
    const int64_t px = pixel(g, t.b0 + i, t.r0 + pos / t.tw, t.c0 + pos % t.tw);
    if (col < g.nc) {
      g.cls[px * g.nc + col] = epilogue(sums[j], g.apc[col], g.bpc[col]);
    } else if (col >= 4 * qc && col < 4 * qc + 5) {
      const int k = col - 4 * qc;
      g.cr[px * 5 + k] = epilogue(sums[j], g.acr[k], g.bcr[k]);
    }
  }
}

cudaError_t launch(const void* fn, dim3 grid, size_t smem, void** args, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  return cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, stream);
}

// byte offsets of the scratch buffers, each 256-byte aligned
struct Scratch {
  size_t z1, z2, yq, s1, s2, stats, total;
};

Scratch carve(int batch, int h, int w, int c, int pair) {
  const size_t npix = static_cast<size_t>(batch) * h * w;
  const size_t ntiles = static_cast<size_t>((w + kT - 1) / kT) * ((h + kT - 1) / kT);
  const auto up = [](size_t n) { return (n + 255) / 256 * 256; };
  Scratch s;
  s.z1 = 0;
  s.z2 = s.z1 + (pair ? 0 : up(npix * 2 * c * sizeof(float)));
  s.yq = s.z2 + up(npix * 2 * c * sizeof(float));
  s.s1 = s.yq + up(npix * c);
  s.s2 = s.s1 + up(batch * ntiles * 2 * c * sizeof(long long));
  s.stats = s.s2 + up(batch * ntiles * 2 * c * sizeof(long long));
  s.total = s.stats + up(static_cast<size_t>(batch) * kStats * sizeof(float));
  return s;
}

}  // namespace

// Bytes of scratch qhead_launch needs for these sizes (pair = 1: K9).
extern "C" size_t qhead_scratch_bytes(int batch, int h, int w, int c, int pair) {
  return carve(batch, h, w, c, pair).total;
}

// Pointers in the order of ops/qhead.py's table: x, w1, wdw, w2, wc, wr, wpc,
// wcr, bpc, bcr, gn1..gnr (gamma, beta each), A1, inv_x1, Adw, inv_x2, A2,
// B2, res_mul, Ac, inv_c, Ar, inv_r, Apc, Acr, cls, cr.  x NHWC contiguous
// and 16-byte aligned, c % 32 == 0; pair = 1 (K9) needs an even batch.
// scratch: qhead_scratch_bytes() bytes of device memory.  Runs the level's
// kernels on `stream`.  Returns a cudaError_t (0 = launched).
extern "C" int qhead_launch(void* const* ptrs, int batch, int h, int w, int c, int nc, int pair, void* scratch,
                            void* stream) {
  Args g;
  int k = 0;
  const auto i8 = [&]() { return static_cast<const int8_t*>(ptrs[k++]); };
  const auto f32 = [&]() { return static_cast<const float*>(ptrs[k++]); };
  g.x = i8();
  g.w1 = i8();
  g.wdw = i8();
  g.w2 = i8();
  g.wc = i8();
  g.wr = i8();
  g.wpc = i8();
  g.wcr = i8();
  g.bpc = f32();
  g.bcr = f32();
  g.g1 = f32();
  g.be1 = f32();
  g.g2 = f32();
  g.be2 = f32();
  g.gc = f32();
  g.bec = f32();
  g.gr = f32();
  g.ber = f32();
  g.a1 = f32();
  g.inv_x1 = f32();
  g.adw = f32();
  g.inv_x2 = f32();
  g.a2 = f32();
  g.b2 = f32();
  g.res_mul = f32();
  g.ac = f32();
  g.inv_c = f32();
  g.ar = f32();
  g.inv_r = f32();
  g.apc = f32();
  g.acr = f32();
  g.cls = static_cast<float*>(ptrs[k++]);
  g.cr = static_cast<float*>(ptrs[k++]);
  if ((pair && batch % 2) || c % 32) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = carve(batch, h, w, c, pair);
  char* base = static_cast<char*>(scratch);
  g.z1 = pair ? nullptr : reinterpret_cast<float*>(base + s.z1);
  g.z2 = reinterpret_cast<float*>(base + s.z2);
  g.yq = reinterpret_cast<int8_t*>(base + s.yq);
  g.s1 = reinterpret_cast<long long*>(base + s.s1);
  g.s2 = reinterpret_cast<long long*>(base + s.s2);
  g.stats = reinterpret_cast<float*>(base + s.stats);
  g.h = h;
  g.w = w;
  g.c = c;
  g.nc = nc;
  g.nimg = pair ? 2 : 1;
  g.tiles_x = (w + kT - 1) / kT;
  g.ntiles = g.tiles_x * ((h + kT - 1) / kT);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t c2 = 2 * c, sums = 2 * g.nimg * c2 * sizeof(unsigned long long);
  const dim3 tiles(g.tiles_x, (h + kT - 1) / kT, batch / g.nimg);
  void* args[] = {&g};
  int which = 0;
  void* sargs[] = {&g, &which};
  cudaError_t err;
  const auto stats = [&](int gn) {
    which = gn;
    return launch(reinterpret_cast<const void*>(head_gn_stats), dim3(gn == 2 ? 64 : 32, batch), 0, sargs, st);
  };
  if ((err = launch(reinterpret_cast<const void*>(head_pw1), tiles, g.nimg * kPos * c + sums, args, st))) return err;
  if ((err = stats(0))) return err;
  const size_t dw = g.nimg * kHalo * c2 + sums + (pair ? g.nimg * kHalo * c : 0);
  if ((err = launch(reinterpret_cast<const void*>(head_dw), tiles, dw, args, st))) return err;
  if ((err = stats(1))) return err;
  if ((err = launch(reinterpret_cast<const void*>(head_pw2), tiles, g.nimg * kPos * c2, args, st))) return err;
  if ((err = launch(reinterpret_cast<const void*>(head_towers), tiles, g.nimg * kHalo * c + sums, args, st)))
    return err;
  if ((err = stats(2))) return err;
  const size_t pred = g.nimg * kHalo * c2 + g.nimg * kPos * pred_cols(nc) * sizeof(int);
  return static_cast<int>(launch(reinterpret_cast<const void*>(head_pred), tiles, pred, args, st));
}
