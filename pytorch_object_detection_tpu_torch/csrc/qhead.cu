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
// Design.  A level is cut into tiles of 8x8 positions (smaller at its right
// and bottom edges, and on maps under 8 a side).  A thread block of a pass
// owns one tile of `ipb` images (its M rows: ipb x the tile's positions,
// at most 64, or 128 for K9) and one slice of the pass's output channels
// (grid: tiles x image groups x slices).  ops/qhead.pick_head_tile chooses
// ipb and the slices per pass: the largest image groups, then the fewest
// slices, that reach one block per SM, so the small levels (P5-P7 at B=8)
// run on many blocks, and at 4x4 and 1x1 several images share a block.
// The GEMM-shaped passes run csrc/qmma_tile.cuh's MmaTile (mma.sync
// m16n8k32 s8, ldmatrix fragments): their A operand sits in shared memory
// (pw1: the x rows; pw2: x2q, made there by the GN2 + SiLU prologue; the
// towers and pred: the halo of yq, cq or rq, read as an implicit GEMM over
// the 9 taps through a table of each row's halo position, its rows
// XOR-swizzled by swz()), and the weights' K slices stream through a ring
// of 4 cp.async stages.  The int32 sums go through shared memory, so the
// pre-norm maps and yq leave as 16-byte words and each (image, channel)'s
// GroupNorm sums are taken in one pass over its rows.  pred is one block
// per 32 classes and one for cnt|reg.  The depthwise pass (0.3 % of the
// multiply-adds) stays on the CUDA cores.  K9 (image pairs) never writes
// z1: its pw1 pass only sums, and its dw pass recomputes pw1 on the tile
// and halo from the int8 input, a tensor-core GEMM too.  The zero padding
// of each 3x3 conv sits in the int8 domain after the normalize (halo
// positions outside the map are 0), as the reference pads x1q, yq, cq, rq.
//
// GroupNorm statistics are exact and deterministic: a pre-norm value is
// int32 acc times a per-channel scale, so each tile sums acc and acc^2 per
// (image, channel) in int64 (any order gives the same sum), and the stats
// kernel combines the tiles in a fixed order in double: mean = sum_c A_c
// S1_c / n, var = sum_c A_c^2 S2_c / n - mean^2, rounded to f32 with rstd =
// 1 / sqrt(var + 1e-5).  |acc| <= 2304 * 127^2 < 2^26.  So the outputs do
// not depend on the tiling: any ipb and slices give the same bits, K9's
// the same as K7's.
//
// Bound on the card: int8 multiply-adds, 1.50 M per position at C=256,
// nc=20 (78 % in the tower convs), 8.2 G per 512^2 image.
//
// Against the plain version (models/head_int8's per-op oracle): the convs
// are exact and the epilogues use separate __fmul_rn / __fadd_rn under
// -fmad=false, but the GroupNorm statistics are exact where the plain
// version's are f32 sums, and SiLU uses expf, so an int8 intermediate can
// move by one step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "qmma_tile.cuh"

namespace {

constexpr int kT = 8;        // tile: at most kT x kT positions of one image
constexpr int kStats = 256;  // floats per image: gn1, gn2, gnc, gnr x 32 groups x (mean, rstd)
constexpr float kEps = 1e-5f;
constexpr int kStages = 4;   // the weights' cp.async ring
constexpr int kPredNC = 32;  // pred's output columns per block
constexpr int kPos = 8;      // positions per thread item of the depthwise pass
enum { kPw1, kDw, kPw2, kTowers, kPred, kPasses };

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
  int batch, h, w, c, nc, tiles_x, ntiles;
  int hw, halo;        // halo rows of one image: (min(8, h) + 2) x hw, hw = min(8, w) + 2
};

// one pass's launch: images per block, channels per block (pred: unused)
struct Pass {
  int ipb, slice;
};

// one block's tile, images and channel slice
struct Blk {
  int tile, r0, c0, th, tw, npos, b0, nimg, rows, nb;
};

__device__ __forceinline__ Blk blk_of(const Args& g, const Pass& p) {
  Blk t;
  t.tile = blockIdx.x;
  const int ty = t.tile / g.tiles_x;
  t.r0 = ty * kT;
  t.c0 = (t.tile - ty * g.tiles_x) * kT;
  t.th = min(kT, g.h - t.r0);
  t.tw = min(kT, g.w - t.c0);
  t.npos = t.th * t.tw;
  t.b0 = blockIdx.y * p.ipb;
  t.nimg = min(p.ipb, g.batch - t.b0);
  t.rows = t.nimg * t.npos;
  t.nb = blockIdx.z * p.slice;
  return t;
}

__device__ __forceinline__ int64_t pixel(const Args& g, int b, int y, int x) {
  return (static_cast<int64_t>(b) * g.h + y) * g.w + x;
}

// pixel of block row r (image r / npos, position r % npos of the tile)
__device__ __forceinline__ int64_t row_pixel(const Args& g, const Blk& t, int r) {
  const int i = r / t.npos, p = r - i * t.npos;
  return pixel(g, t.b0 + i, t.r0 + p / t.tw, t.c0 + p % t.tw);
}

// halo row hr (image hr / halo): its image and map position; false outside the map
__device__ __forceinline__ bool halo_at(const Args& g, const Blk& t, int hr, int& b, int& y, int& x) {
  const int i = hr / g.halo, hp = hr - i * g.halo;
  b = t.b0 + i;
  y = t.r0 - 1 + hp / g.hw;
  x = t.c0 - 1 + hp % g.hw;
  return y >= 0 && y < g.h && x >= 0 && x < g.w;
}

// mean and rstd of GroupNorm `gn` (0 gn1, 1 gn2, 2 the towers' 64 groups), group `grp`, image b
__device__ __forceinline__ const float* stat(const Args& g, int b, int gn, int grp) {
  return g.stats + static_cast<int64_t>(b) * kStats + gn * 64 + grp * 2;
}

// ((z - mean) * rstd) * gamma + beta, the reference's association; t = (mean, rstd, gamma, beta)
__device__ __forceinline__ float gn_affine(float z, const float4& t) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(z, t.x), t.y), t.z), t.w);
}

// z * (1 / (1 + exp(-z))); __frcp_rn rounds 1 / x once, as __fdiv_rn(1, x) does
__device__ __forceinline__ float silu(float z) { return __fmul_rn(z, __frcp_rn(__fadd_rn(1.0f, expf(-z)))); }

// (mean, rstd, gamma, beta) of GroupNorm `gn` (0 gn1, 1 gn2 over 2C
// channels; 2 the towers' 64 groups over [0, 2C)) for channels [ch0, ch0 +
// n) of each of the block's images, into tab [ipb][n] in shared memory;
// gamma and beta point at channel ch0's.  The caller syncs.
__device__ __forceinline__ void fill_gn(float4* tab, const Args& g, const Blk& t, int gn, int ch0, int n,
                                        const float* gamma, const float* beta) {
  const int gsz = (gn == 2 ? g.c : 2 * g.c) / 32;
  for (int j = threadIdx.x; j < t.nimg * n; j += kMmaThreads) {
    const int i = j / n, k = j - i * n;
    const float* st = stat(g, t.b0 + i, gn, (ch0 + k) / gsz);
    tab[j] = make_float4(st[0], st[1], gamma[k], beta[k]);
  }
}

__device__ __forceinline__ int pack4(const int8_t (&q)[4]) {
  return (q[0] & 0xff) | ((q[1] & 0xff) << 8) | ((q[2] & 0xff) << 16) | ((q[3] & 0xff) << 24);
}


__host__ __device__ __forceinline__ int align128(int n) { return (n + 127) / 128 * 128; }
__host__ __device__ __forceinline__ int ring_bytes(int nc) { return kStages * nc * kStepBytes; }
// the ring, reused after each chunk for its int32 sums (rows of nc + 8 words)
__host__ __device__ __forceinline__ int ring_or_sums(int mc, int nc) {
  return ring_bytes(nc) > mc * (nc + 8) * 4 ? ring_bytes(nc) : mc * (nc + 8) * 4;
}

// rows [0, nrows) of cpr 16-byte chunks into swz rows at dst, src(r) the
// row's first byte or null (zeros); waits for the copies and syncs
template <class Src>
__device__ __forceinline__ void load_rows(int8_t* dst, int nrows, int cpr, const Src& src, const void* safe) {
  const uint32_t d = smem_u32(dst);
  for (int j = threadIdx.x; j < nrows * cpr; j += kMmaThreads) {
    const int r = j / cpr, c = j - r * cpr;
    const int8_t* p = src(r);
    cp_async16(d + swz(r, c, cpr), p != nullptr ? static_cast<const void*>(p + 16 * c) : safe, p != nullptr);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// halo position of each block row at tap (0, 0), for the implicit GEMMs;
// rows past the block's repeat its last one (their sums are not used)
__device__ __forceinline__ void fill_rowpos(int* rowpos, int mc, const Args& g, const Blk& t) {
  for (int r = threadIdx.x; r < mc; r += kMmaThreads) {
    const int rr = min(r, t.rows - 1), i = rr / t.npos, p = rr - i * t.npos;
    rowpos[r] = i * g.halo + (p / t.tw) * g.hw + p % t.tw;
  }
}

// The weight rows of a pass, [nb + n0, nb + n0 + NC) of one K step at
// byte `kb` of each row, through slot `slot` of the ring: row(o) is output
// channel o's first byte, live(n) whether column n0 + n of the slice exists.
template <int NC, class Row, class Live>
__device__ __forceinline__ void stage_weights(uint32_t slot, const Row& row, const Live& live, int kb, int klen,
                                              const void* safe) {
  stage_rows<NC>(slot, [&](int r) { return row(r) + kb; }, live, [&](int c) { return kb + 16 * c < klen; }, safe);
}

// the accumulators into int32 rows of NC + 8 words (sum_at), then a sync
template <class T>
__device__ __forceinline__ void stage_acc(const T& mm, int* sums) {
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<int2*>(sums + sum_at(T::row(mt, 2 * hf), T::col(nt, 0), T::NC + 8)) =
            make_int2(mm.acc[mt][nt][2 * hf], mm.acc[mt][nt][2 * hf + 1]);
  __syncthreads();
}

// 16 staged sums of row r from column c
template <int NC>
__device__ __forceinline__ void read16(int (&v)[16], const int* sums, int r, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int4 q = *reinterpret_cast<const int4*>(sums + sum_at(r, c + 4 * j, NC + 8));
    v[4 * j] = q.x, v[4 * j + 1] = q.y, v[4 * j + 2] = q.z, v[4 * j + 3] = q.w;
  }
}

// z[pixel][ch0 + c] = float(acc) * scale[c] for the staged rows of the
// block and columns c < cols, 16 a thread; a_of(ch) points at 16 scales
template <int NC, class AOf>
__device__ __forceinline__ void store_z(const Args& g, const Blk& t, const int* sums, int cols, int ch0, float* z,
                                        const AOf& a_of) {
  constexpr int kGroups = NC / 16;
  for (int gi = threadIdx.x; gi < t.rows * kGroups; gi += kMmaThreads) {
    const int r = gi / kGroups, c = (gi - r * kGroups) * 16;
    if (c >= cols) continue;
    int v[16];
    read16<NC>(v, sums, r, c);
    const float* a = a_of(ch0 + c);
    float4* dst = reinterpret_cast<float4*>(z + row_pixel(g, t, r) * 2 * g.c + ch0 + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[j] = make_float4(__fmul_rn(__int2float_rn(v[4 * j]), a[4 * j]),
                           __fmul_rn(__int2float_rn(v[4 * j + 1]), a[4 * j + 1]),
                           __fmul_rn(__int2float_rn(v[4 * j + 2]), a[4 * j + 2]),
                           __fmul_rn(__int2float_rn(v[4 * j + 3]), a[4 * j + 3]));
  }
}

// each (image, staged column < cols)'s sums of acc and acc^2 over its rows
// to s1/s2 at channel ch0 + column: two lanes per item, each half the rows
template <int NC>
__device__ __forceinline__ void store_gn_sums(const Args& g, const Blk& t, const int* sums, int cols, int ch0) {
  const int items = t.nimg * NC * 2, half = (t.npos + 1) / 2;
  for (int base = 0; base < items; base += kMmaThreads) {
    const int it = base + threadIdx.x, pair = it >> 1, i = pair / NC, c = pair - i * NC;
    const bool live = it < items && c < cols;
    long long s = 0, q = 0;
    if (live) {
      const int r0 = i * t.npos + (it & 1) * half, r1 = min(r0 + half, (i + 1) * t.npos);
      for (int r = r0; r < r1; ++r) {
        const long long v = sums[sum_at(r, c, NC + 8)];
        s += v;
        q += v * v;
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    if (live && (it & 1) == 0) {
      const int64_t at = (static_cast<int64_t>(t.b0 + i) * g.ntiles + t.tile) * 2 * g.c + ch0 + c;
      g.s1[at] = s;
      g.s2[at] = q;
    }
  }
}

// grid (ntiles, image groups, slices of 2C); smem: x rows [MC][C], the ring / sums
template <int MC, int NC>
__global__ void __launch_bounds__(kMmaThreads, 2) head_pw1(const Args g, const Pass p) {
  using T = MmaTile<MC, NC, 2>;
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int c = g.c, cpr = c / 16;
  int8_t* xs = smem;
  int8_t* ring = smem + align128(MC * c + 64);
  load_rows(xs, MC, cpr, [&](int r) { return r < t.rows ? g.x + row_pixel(g, t, r) * c : nullptr; }, g.x);
  const uint32_t a = smem_u32(xs), rb = smem_u32(ring);
  for (int n0 = 0; n0 < p.slice; n0 += NC) {
    T mm;
    mm.zero();
    const auto wrow = [&](int r) { return g.w1 + static_cast<int64_t>(t.nb + n0 + r) * c; };
    const auto live = [&](int r) { return n0 + r < p.slice; };
    pipeline<kStages>(
        (c + kStepBytes - 1) / kStepBytes,
        [&](int s, int slot) { stage_weights<NC>(rb + slot * NC * kStepBytes, wrow, live, s * kStepBytes, c, g.w1); },
        [&](int s, int slot) {
          const uint32_t sb = rb + slot * NC * kStepBytes;
          mm.step([&](int r, int ch) { return a + swz(r, s * 4 + ch, cpr); },
                  [&](int r, int ch) { return sb + swz64(r, ch); }, t.rows);
        });
    int* sums = reinterpret_cast<int*>(ring);
    stage_acc(mm, sums);
    const int cols = min(NC, p.slice - n0), ch0 = t.nb + n0;
    if (g.z1 != nullptr) store_z<NC>(g, t, sums, cols, ch0, g.z1, [&](int ch) { return g.a1 + ch; });
    store_gn_sums<NC>(g, t, sums, cols, ch0);
    __syncthreads();  // the ring is free for the next chunk's copies
  }
}

// grid (ngroups, B): mean and rstd of one (image, group) from the per-tile
// sums, in a fixed order (the same result in every run).  which: 0 gn1 (A1),
// 1 gn2 (Adw), 2 the towers (64 groups: Ac over [0, C), Ar over [C, 2C))
__global__ void __launch_bounds__(256) head_gn_stats(const Args g, int which) {
  constexpr int kThreads = 256;
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

// The depthwise 3x3 on the tile over the block's channel slice, from x1q
// on the halo in shared memory (x1 [nimg * halo][slice]): z2 and the GN2
// sums (sums: [2][ipb][slice] u64 in shared memory, zeroed by the caller)
__device__ __forceinline__ void depthwise(const Args& g, const Blk& t, int slice, const int8_t* x1,
                                          unsigned long long* s1, unsigned long long* s2) {
  const int quads = slice / 4, groups = (t.npos + kPos - 1) / kPos;
  for (int it = threadIdx.x; it < t.nimg * groups * quads; it += kMmaThreads) {
    const int o = (it % quads) * 4, pg = ((it / quads) % groups) * kPos, i = it / (quads * groups);
    const int ch = t.nb + o;
    // each tap's 4 weights, one a word in its own byte lane: __dp4a(x, wm[tap][k]) = x_k * w_k, exact
    int wm[9][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int w = __ldg(reinterpret_cast<const int*>(g.wdw + tap * 2 * g.c + ch));
#pragma unroll
      for (int k = 0; k < 4; ++k) wm[tap][k] = w & (0xff << (8 * k));
    }
    long long a[4] = {0, 0, 0, 0}, a2[4] = {0, 0, 0, 0};
    for (int p = 0; p < kPos; ++p) {
      const int pos = pg + p;
      if (pos >= t.npos) break;
      const int ty = pos / t.tw, tx = pos % t.tw;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int hr = i * g.halo + (ty + tap / 3) * g.hw + tx + tap % 3;
        const int v = *reinterpret_cast<const int*>(x1 + hr * slice + o);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = __dp4a(v, wm[tap][k], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] += acc[k];
        a2[k] += static_cast<long long>(acc[k]) * acc[k];
      }
      const float4 z = make_float4(__fmul_rn(__int2float_rn(acc[0]), g.adw[ch + 0]),
                                   __fmul_rn(__int2float_rn(acc[1]), g.adw[ch + 1]),
                                   __fmul_rn(__int2float_rn(acc[2]), g.adw[ch + 2]),
                                   __fmul_rn(__int2float_rn(acc[3]), g.adw[ch + 3]));
      *reinterpret_cast<float4*>(g.z2 + pixel(g, t.b0 + i, t.r0 + ty, t.c0 + tx) * 2 * g.c + ch) = z;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      atomicAdd(s1 + i * slice + o + k, static_cast<unsigned long long>(a[k]));
      atomicAdd(s2 + i * slice + o + k, static_cast<unsigned long long>(a2[k]));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < t.nimg * slice; j += kMmaThreads) {
    const int i = j / slice, o = j - i * slice;
    const int64_t at = (static_cast<int64_t>(t.b0 + i) * g.ntiles + t.tile) * 2 * g.c + t.nb + o;
    g.s1[at] = static_cast<long long>(s1[j]);
    g.s2[at] = static_cast<long long>(s2[j]);
  }
}

// K7's dw: grid (ntiles, image groups, slices of 2C); smem: x1q [ipb * halo][slice], sums [2][ipb][slice] u64
__global__ void __launch_bounds__(kMmaThreads) head_dw(const Args g, const Pass p) {
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int slice = p.slice, quads = slice / 4;
  float4* tab = reinterpret_cast<float4*>(smem);
  int8_t* x1 = smem + align128(p.ipb * slice * 16);
  unsigned long long* s1 = reinterpret_cast<unsigned long long*>(x1 + align128(p.ipb * g.halo * slice));
  unsigned long long* s2 = s1 + p.ipb * slice;
  const float inv = *g.inv_x1;
  for (int i = threadIdx.x; i < 2 * p.ipb * slice; i += kMmaThreads) s1[i] = 0ull;
  fill_gn(tab, g, t, 0, t.nb, slice, g.g1 + t.nb, g.be1 + t.nb);
  __syncthreads();
  for (int j = threadIdx.x; j < t.nimg * g.halo * quads; j += kMmaThreads) {
    const int o = (j % quads) * 4, hr = j / quads;
    int b, y, x, word = 0;
    if (halo_at(g, t, hr, b, y, x)) {
      const float4 v = *reinterpret_cast<const float4*>(g.z1 + pixel(g, b, y, x) * 2 * g.c + t.nb + o);
      const float z[4] = {v.x, v.y, v.z, v.w};
      int8_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q[k] = requant_relu(__fmul_rn(gn_affine(z[k], tab[(hr / g.halo) * slice + o + k]), inv));
      word = pack4(q);
    }
    *reinterpret_cast<int*>(x1 + hr * slice + o) = word;
  }
  __syncthreads();
  depthwise(g, t, slice, x1, s1, s2);
}

// K9's dw: pw1 again on the tile and halo from the int8 input (a
// tensor-core GEMM, 128 halo rows at a time), its x1q into shared memory,
// then the depthwise pass.  grid as head_dw; smem: x halo [ipb * halo][C],
// x1q [ipb * halo][slice], sums [2][ipb][slice] u64, the ring
template <int NC>
__global__ void __launch_bounds__(kMmaThreads, 2) head_dw_pair(const Args g, const Pass p) {
  using T = MmaTile<128, NC, 2>;
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int c = g.c, cpr = c / 16, slice = p.slice, hrows = t.nimg * g.halo;
  float4* tab = reinterpret_cast<float4*>(smem);
  int8_t* xh = smem + align128(p.ipb * slice * 16);
  int8_t* x1 = xh + align128(p.ipb * g.halo * c + 64);
  unsigned long long* s1 = reinterpret_cast<unsigned long long*>(x1 + align128(p.ipb * g.halo * slice));
  unsigned long long* s2 = s1 + p.ipb * slice;
  const uint32_t rb = smem_u32(reinterpret_cast<int8_t*>(s1) + align128(2 * p.ipb * slice * 8));
  const float inv = *g.inv_x1;
  for (int i = threadIdx.x; i < 2 * p.ipb * slice; i += kMmaThreads) s1[i] = 0ull;
  fill_gn(tab, g, t, 0, t.nb, slice, g.g1 + t.nb, g.be1 + t.nb);  // load_rows syncs
  load_rows(xh, hrows, cpr, [&](int hr) {
    int b, y, x;
    return halo_at(g, t, hr, b, y, x) ? g.x + pixel(g, b, y, x) * c : nullptr;
  }, g.x);
  const uint32_t a = smem_u32(xh);
  for (int m0 = 0; m0 < hrows; m0 += 128) {
    for (int n0 = 0; n0 < slice; n0 += NC) {
      T mm;
      mm.zero();
      const auto wrow = [&](int r) { return g.w1 + static_cast<int64_t>(t.nb + n0 + r) * c; };
      const auto live = [&](int r) { return n0 + r < slice; };
      pipeline<kStages>(
          (c + kStepBytes - 1) / kStepBytes,
          [&](int s, int slot) { stage_weights<NC>(rb + slot * NC * kStepBytes, wrow, live, s * kStepBytes, c, g.w1); },
          [&](int s, int slot) {
            const uint32_t sb = rb + slot * NC * kStepBytes;
            mm.step([&](int r, int ch) { return a + swz(min(m0 + r, hrows - 1), s * 4 + ch, cpr); },
                    [&](int r, int ch) { return sb + swz64(r, ch); }, hrows - m0);
          });
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int hr = m0 + T::row(mt, 2 * hf);
          if (hr >= hrows) continue;
          int b, y, x;
          const bool inside = halo_at(g, t, hr, b, y, x);
          const float4* tr = tab + (hr / g.halo) * slice;
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt) {
            const int n = n0 + T::col(nt, 0);
            if (n >= slice) continue;
            const int ch = t.nb + n;
            char2 v = make_char2(0, 0);
            if (inside) {
              v.x = requant_relu(
                  __fmul_rn(gn_affine(__fmul_rn(__int2float_rn(mm.acc[mt][nt][2 * hf]), g.a1[ch]), tr[n]), inv));
              v.y = requant_relu(
                  __fmul_rn(gn_affine(__fmul_rn(__int2float_rn(mm.acc[mt][nt][2 * hf + 1]), g.a1[ch + 1]), tr[n + 1]),
                            inv));
            }
            *reinterpret_cast<char2*>(x1 + hr * slice + n) = v;
          }
        }
    }
  }
  __syncthreads();
  depthwise(g, t, slice, x1, s1, s2);
}

// grid (ntiles, image groups, slices of C); smem: x2q rows [MC][2C], the ring / sums
template <int MC, int NC>
__global__ void __launch_bounds__(kMmaThreads, 2) head_pw2(const Args g, const Pass p) {
  using T = MmaTile<MC, NC, 2>;
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int c = g.c, c2 = 2 * c, cpr = c2 / 16;
  const float inv = *g.inv_x2, res_mul = *g.res_mul;
  float4* tab = reinterpret_cast<float4*>(smem);
  int8_t* x2 = smem + align128(p.ipb * c2 * 16);
  int8_t* ring = x2 + align128(MC * c2 + 64);
  fill_gn(tab, g, t, 1, 0, c2, g.g2, g.be2);
  __syncthreads();
  for (int j = threadIdx.x; j < MC * (c2 / 4); j += kMmaThreads) {
    const int o = (j % (c2 / 4)) * 4, r = j / (c2 / 4);
    int word = 0;
    if (r < t.rows) {
      const float4* tr = tab + (r / t.npos) * c2 + o;
      const float4 v = *reinterpret_cast<const float4*>(g.z2 + row_pixel(g, t, r) * c2 + o);
      const float z[4] = {v.x, v.y, v.z, v.w};
      int8_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q[k] = clip8(__fmul_rn(silu(gn_affine(z[k], tr[k])), inv));
      word = pack4(q);
    }
    *reinterpret_cast<int*>(x2 + swz(r, o >> 4, cpr) + (o & 15)) = word;
  }
  __syncthreads();
  const uint32_t a = smem_u32(x2), rb = smem_u32(ring);
  for (int n0 = 0; n0 < p.slice; n0 += NC) {
    T mm;
    mm.zero();
    const auto wrow = [&](int r) { return g.w2 + static_cast<int64_t>(t.nb + n0 + r) * c2; };
    const auto live = [&](int r) { return n0 + r < p.slice; };
    pipeline<kStages>(
        (c2 + kStepBytes - 1) / kStepBytes,
        [&](int s, int slot) { stage_weights<NC>(rb + slot * NC * kStepBytes, wrow, live, s * kStepBytes, c2, g.w2); },
        [&](int s, int slot) {
          const uint32_t sb = rb + slot * NC * kStepBytes;
          mm.step([&](int r, int ch) { return a + swz(r, s * 4 + ch, cpr); },
                  [&](int r, int ch) { return sb + swz64(r, ch); }, t.rows);
        });
    int* sums = reinterpret_cast<int*>(ring);
    stage_acc(mm, sums);
    // yq, 16 channels of a position per thread: the residual read and yq written as 16-byte words
    constexpr int kGroups = NC / 16;
    for (int gi = threadIdx.x; gi < t.rows * kGroups; gi += kMmaThreads) {
      const int r = gi / kGroups, cc = (gi - r * kGroups) * 16;
      if (n0 + cc >= p.slice) continue;
      const int ch = t.nb + n0 + cc;
      int v[16];
      read16<NC>(v, sums, r, cc);
      const int64_t px = row_pixel(g, t, r);
      int8_t xv[16], q[16];
      unpack16(xv, *reinterpret_cast<const int4*>(g.x + px * c + ch));
#pragma unroll
      for (int k = 0; k < 16; ++k)
        q[k] = clip8(__fadd_rn(epilogue(v[k], g.a2[ch + k], g.b2[ch + k]),
                               __fmul_rn(static_cast<float>(xv[k]), res_mul)));
      *reinterpret_cast<int4*>(g.yq + px * c + ch) = pack16(q);
    }
    __syncthreads();  // the ring is free for the next chunk's copies
  }
}

// grid (ntiles, image groups, slices of 2C: [0, C) the cls tower wc/Ac,
// [C, 2C) the reg tower wr/Ar); smem: yq halo [ipb * halo][C], the rows'
// halo positions [MC], the ring / sums
template <int MC, int NC>
__global__ void __launch_bounds__(kMmaThreads, 2) head_towers(const Args g, const Pass p) {
  using T = MmaTile<MC, NC, 2>;
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int c = g.c, cpr = c / 16, per_tap = (c + kStepBytes - 1) / kStepBytes;
  int8_t* ys = smem;
  int* rowpos = reinterpret_cast<int*>(smem + align128(p.ipb * g.halo * c + 64));
  int8_t* ring = reinterpret_cast<int8_t*>(rowpos) + align128(MC * 4);
  fill_rowpos(rowpos, MC, g, t);
  load_rows(ys, t.nimg * g.halo, cpr, [&](int hr) {
    int b, y, x;
    return halo_at(g, t, hr, b, y, x) ? g.yq + pixel(g, b, y, x) * c : nullptr;
  }, g.yq);
  const uint32_t a = smem_u32(ys), rb = smem_u32(ring);
  for (int n0 = 0; n0 < p.slice; n0 += NC) {
    T mm;
    mm.zero();
    const auto wrow = [&](int r) {
      const int o = t.nb + n0 + r;
      return o < c ? g.wc + static_cast<int64_t>(o) * 9 * c : g.wr + static_cast<int64_t>(o - c) * 9 * c;
    };
    const auto live = [&](int r) { return n0 + r < p.slice; };
    pipeline<kStages>(
        9 * per_tap,
        [&](int s, int slot) {
          const int tap = s / per_tap, c0 = (s - tap * per_tap) * kStepBytes;
          stage_weights<NC>(rb + slot * NC * kStepBytes, [&](int r) { return wrow(r) + tap * c; }, live, c0, c, g.wc);
        },
        [&](int s, int slot) {
          const int tap = s / per_tap, k16 = (s - tap * per_tap) * 4, toff = (tap / 3) * g.hw + tap % 3;
          const uint32_t sb = rb + slot * NC * kStepBytes;
          mm.step([&](int r, int ch) { return a + swz(rowpos[r] + toff, k16 + ch, cpr); },
                  [&](int r, int ch) { return sb + swz64(r, ch); }, t.rows);
        });
    int* sums = reinterpret_cast<int*>(ring);
    stage_acc(mm, sums);
    const int cols = min(NC, p.slice - n0), ch0 = t.nb + n0;
    store_z<NC>(g, t, sums, cols, ch0, g.z2, [&](int ch) { return ch < c ? g.ac + ch : g.ar + (ch - c); });
    store_gn_sums<NC>(g, t, sums, cols, ch0);
    __syncthreads();  // the ring is free for the next chunk's copies
  }
}

// grid (ntiles, image groups, ceil(nc / 32) + 1): block z < ceil(nc / 32)
// computes classes [32 z, 32 z + 32) from cq, the last block cnt|reg from
// rq.  smem: cq or rq on the halo [ipb * halo][C], the rows' halo
// positions [MC], the ring
template <int MC>
__global__ void __launch_bounds__(kMmaThreads, 2) head_pred(const Args g, const Pass p) {
  using T = MmaTile<MC, kPredNC, MC == 128 ? 8 : 4>;
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int c = g.c, cpr = c / 16, per_tap = (c + kStepBytes - 1) / kStepBytes;
  const int q = blockIdx.z, qcls = (g.nc + kPredNC - 1) / kPredNC;
  const bool cls = q < qcls;
  const int half = cls ? 0 : c, n = cls ? min(kPredNC, g.nc - q * kPredNC) : 5;
  const float* gamma = cls ? g.gc : g.gr;
  const float* beta = cls ? g.bec : g.ber;
  const float inv = cls ? *g.inv_c : *g.inv_r;
  float4* tab = reinterpret_cast<float4*>(smem);
  int8_t* ts = smem + align128(p.ipb * c * 16);
  int* rowpos = reinterpret_cast<int*>(ts + align128(p.ipb * g.halo * c + 64));
  const uint32_t rb = smem_u32(reinterpret_cast<int8_t*>(rowpos) + align128(MC * 4));
  fill_rowpos(rowpos, MC, g, t);
  fill_gn(tab, g, t, 2, half, c, gamma, beta);
  __syncthreads();
  for (int j = threadIdx.x; j < t.nimg * g.halo * (c / 4); j += kMmaThreads) {
    const int o = (j % (c / 4)) * 4, hr = j / (c / 4);
    int b, y, x, word = 0;
    if (halo_at(g, t, hr, b, y, x)) {
      const float4 v = *reinterpret_cast<const float4*>(g.z2 + pixel(g, b, y, x) * 2 * c + half + o);
      const float z[4] = {v.x, v.y, v.z, v.w};
      int8_t qv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) qv[k] = requant_relu(__fmul_rn(gn_affine(z[k], tab[(hr / g.halo) * c + o + k]), inv));
      word = pack4(qv);
    }
    *reinterpret_cast<int*>(ts + swz(hr, o >> 4, cpr) + (o & 15)) = word;
  }
  __syncthreads();
  const int8_t* wbase = cls ? g.wpc + static_cast<int64_t>(q) * kPredNC * 9 * c : g.wcr;
  const uint32_t a = smem_u32(ts);
  T mm;
  mm.zero();
  pipeline<kStages>(
      9 * per_tap,
      [&](int s, int slot) {
        const int tap = s / per_tap, c0 = (s - tap * per_tap) * kStepBytes;
        stage_weights<kPredNC>(rb + slot * kPredNC * kStepBytes,
                               [&](int r) { return wbase + static_cast<int64_t>(r) * 9 * c + tap * c; },
                               [&](int r) { return r < n; }, c0, c, wbase);
      },
      [&](int s, int slot) {
        const int tap = s / per_tap, k16 = (s - tap * per_tap) * 4, toff = (tap / 3) * g.hw + tap % 3;
        const uint32_t sb = rb + slot * kPredNC * kStepBytes;
        mm.step([&](int r, int ch) { return a + swz(rowpos[r] + toff, k16 + ch, cpr); },
                [&](int r, int ch) { return sb + swz64(r, ch); }, t.rows);
      });
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = T::row(mt, 2 * hf);
      if (r >= t.rows) continue;
      const int64_t px = row_pixel(g, t, r);
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = T::col(nt, j);
          if (col >= n) continue;
          const int v = mm.acc[mt][nt][2 * hf + j];
          if (cls) {
            const int k = q * kPredNC + col;
            g.cls[px * g.nc + k] = epilogue(v, g.apc[k], g.bpc[k]);
          } else {
            g.cr[px * 5 + col] = epilogue(v, g.acr[col], g.bcr[col]);
          }
        }
    }
}

// shared memory of one block of pass `pass` (ops/qhead.head_smem_bytes)
int smem_of(int pass, int pair, int ipb, int rows_max, int halo, int c, int slice) {
  const int mc = rows_max <= 64 ? 64 : 128, nc = slice % 128 == 0 ? 128 : 64;
  switch (pass) {
    case kPw1:
      return align128(mc * c + 64) + ring_or_sums(mc, nc);
    case kDw:
      if (!pair) return align128(ipb * slice * 16) + align128(ipb * halo * slice) + 2 * ipb * slice * 8;
      return align128(ipb * slice * 16) + align128(ipb * halo * c + 64) + align128(ipb * halo * slice) +
             align128(2 * ipb * slice * 8) + ring_bytes(nc);
    case kPw2:
      return align128(ipb * 2 * c * 16) + align128(mc * 2 * c + 64) + ring_or_sums(mc, nc);
    case kTowers:  // 256 channels a chunk where the slice allows, at 64 rows
      return align128(ipb * halo * c + 64) + align128(mc * 4) +
             ring_or_sums(mc, mc == 64 && slice % 256 == 0 ? 256 : nc);
    default:
      return align128(ipb * c * 16) + align128(ipb * halo * c + 64) + align128(mc * 4) + ring_bytes(kPredNC);
  }
}

// the kernel of pass `pass` for M rows up to rows_max and a channel slice
const void* kernel_of(int pass, int pair, int rows_max, int slice) {
  const bool m64 = rows_max <= 64, n128 = slice % 128 == 0;
  switch (pass) {
    case kPw1:
      return m64 ? (n128 ? (const void*)head_pw1<64, 128> : (const void*)head_pw1<64, 64>)
                 : (n128 ? (const void*)head_pw1<128, 128> : (const void*)head_pw1<128, 64>);
    case kDw:
      if (!pair) return (const void*)head_dw;
      return n128 ? (const void*)head_dw_pair<128> : (const void*)head_dw_pair<64>;
    case kPw2:
      return m64 ? (n128 ? (const void*)head_pw2<64, 128> : (const void*)head_pw2<64, 64>)
                 : (n128 ? (const void*)head_pw2<128, 128> : (const void*)head_pw2<128, 64>);
    case kTowers:
      if (m64 && slice % 256 == 0) return (const void*)head_towers<64, 256>;
      return m64 ? (n128 ? (const void*)head_towers<64, 128> : (const void*)head_towers<64, 64>)
                 : (n128 ? (const void*)head_towers<128, 128> : (const void*)head_towers<128, 64>);
    default:
      return m64 ? (const void*)head_pred<64> : (const void*)head_pred<128>;
  }
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

// Shared memory of one block of pass `pass` (0 pw1, 1 dw, 2 pw2, 3 towers,
// 4 pred) with ipb images a block and `split` channel slices, for the
// level's h, w and c (the chooser's arithmetic, held against this).
extern "C" int qhead_smem_bytes(int pass, int pair, int ipb, int h, int w, int c, int split) {
  const int n = pass == kPw2 ? c : 2 * c;
  return smem_of(pass, pair, ipb, ipb * min(kT, h) * min(kT, w), (min(kT, h) + 2) * (min(kT, w) + 2), c,
                 pass == kPred ? kPredNC : n / split);
}

// Pointers in the order of ops/qhead.py's table: x, w1, wdw, w2, wc, wr, wpc,
// wcr, bpc, bcr, gn1..gnr (gamma, beta each), A1, inv_x1, Adw, inv_x2, A2,
// B2, res_mul, Ac, inv_c, Ar, inv_r, Apc, Acr, cls, cr.  x NHWC contiguous
// and 16-byte aligned, c % 32 == 0; pair = 1 (K9) needs an even batch.
// cfg: (images a block, channel slices) of pw1, dw, pw2, towers and pred
// (ops/qhead.pick_head_tile; pred's slices are ceil(nc / 32) + 1).
// scratch: qhead_scratch_bytes() bytes of device memory.  Runs the level's
// kernels on `stream`.  Returns a cudaError_t (0 = launched).
extern "C" int qhead_launch(void* const* ptrs, int batch, int h, int w, int c, int nc, int pair, const int* cfg,
                            void* scratch, void* stream) {
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
  g.batch = batch;
  g.h = h;
  g.w = w;
  g.c = c;
  g.nc = nc;
  g.tiles_x = (w + kT - 1) / kT;
  g.ntiles = g.tiles_x * ((h + kT - 1) / kT);
  g.hw = min(kT, w) + 2;
  g.halo = (min(kT, h) + 2) * g.hw;

  static int optin = -1;  // every kernel may take all the shared memory a block can opt in to
  if (optin < 0) {
    int dev = 0, bytes = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int ps = 0; ps < kPasses; ++ps)
      for (int pr = 0; pr < 2; ++pr)
        for (int rows = 64; rows <= 128; rows += 64)
          for (int slice = 64; slice <= 256; slice *= 2)
            if (err == cudaSuccess)
              err = cudaFuncSetAttribute(kernel_of(ps, pr, rows, slice), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    optin = bytes;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Pass pass[kPasses];
  void* args[2] = {&g, nullptr};
  for (int ps = 0; ps < kPasses; ++ps) {
    const int ipb = cfg[2 * ps], split = ps == kPred ? (nc + kPredNC - 1) / kPredNC + 1 : cfg[2 * ps + 1];
    const int n = ps == kPw2 ? c : 2 * c;
    const int rows_max = ipb * min(kT, h) * min(kT, w);
    if (ipb < 1 || (pair && ipb % 2) || rows_max > 128 || (batch + ipb - 1) / ipb > 65535 ||
        (ps != kPred && (split < 1 || n % split || (n / split) % 16)))
      return static_cast<int>(cudaErrorInvalidValue);
    pass[ps].ipb = ipb;
    pass[ps].slice = ps == kPred ? kPredNC : n / split;
  }
  const auto run = [&](int ps) {
    const int rows_max = pass[ps].ipb * min(kT, h) * min(kT, w);
    const int smem = smem_of(ps, pair, pass[ps].ipb, rows_max, g.halo, c, pass[ps].slice);
    if (smem > optin) return cudaErrorInvalidConfiguration;
    const void* fn = kernel_of(ps, pair, rows_max, pass[ps].slice);
    const int split = ps == kPred ? (nc + kPredNC - 1) / kPredNC + 1 : (ps == kPw2 ? c : 2 * c) / pass[ps].slice;
    const dim3 grid(g.ntiles, (batch + pass[ps].ipb - 1) / pass[ps].ipb, split);
    args[1] = &pass[ps];
    return cudaLaunchKernel(fn, grid, dim3(kMmaThreads), args, smem, st);
  };
  int which = 0;
  void* sargs[] = {&g, &which};
  const auto stats = [&](int gn) {
    which = gn;
    return cudaLaunchKernel(reinterpret_cast<const void*>(head_gn_stats), dim3(gn == 2 ? 64 : 32, batch), dim3(256),
                            sargs, 0, st);
  };
  cudaError_t err;
  if ((err = run(kPw1))) return err;
  if ((err = stats(0))) return err;
  if ((err = run(kDw))) return err;
  if ((err = stats(1))) return err;
  if ((err = run(kPw2))) return err;
  if ((err = run(kTowers))) return err;
  if ((err = stats(2))) return err;
  return static_cast<int>(run(kPred));
}
