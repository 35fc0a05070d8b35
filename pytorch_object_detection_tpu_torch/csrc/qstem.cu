// K1: the exact uint8 ResNet stem with its 3x3/2 max pool, one launch.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_qstem.py:qstem_conv with
// pool=True.  That kernel takes the space-to-depth form of the channel-
// padded raw frame (a 4x4/1 conv over 16 channels, one MXU dot per row band),
// and bends its layout around Mosaic (raw 5D views, row-pair merges, bands).
// What carries over is the s2d form itself and what stays out of device
// memory: the frame's normalize affine and the BN fold live in the int8
// weights and the f32 epilogue (nn/resnet_int8.quantize_stem_s2d), so the
// conv input is v = u - 128 with no quantization at all; the 3x3/2 pool
// commutes with the monotone requant and runs on the int8 conv tile, so the
// full-size conv output never reaches device memory.
//
//   acc  = sum over (ky, kx, c16) of v_s2d(i - 2 + ky, j - 2 + kx)[c16] * w[ky][kx][c16][o]
//   conv = clip(rint(max(acc * A[o] + B[o], 0)), -127, 127)   (int8, >= 0)
//   out  = max over the 3x3/2 pad-1 window of conv (outside: -128)
//
// with v_s2d the space-to-depth of the RGBX frame (16 channels in (dy, dx,
// c) order; a 3-channel frame's fourth channel is u = 128, v = 0) and, where
// an s2d pixel lies outside the frame, the border fill pad[16] =
// round(255 * mean - 128) (x_f = 0 there in the reference).
//
// Design.  The conv is an implicit GEMM on the int8 tensor cores through
// csrc/qmma_tile.cuh's MmaTile (mma.sync m16n8k32 s8, ldmatrix fragments):
// M = the block's conv positions, N = the 64 output channels, K = (ky, kx,
// c16) = 256, walked as 4 steps of 64 bytes (one ky each; a k32 slice is a
// kx pair, each of its 16-byte halves one s2d pixel).  A thread block owns
// (image, PR x PC pooled positions; ops/qstem.pick_stem_tile chooses them),
// so (2 PR + 1) x (2 PC + 1) conv positions.  It loads the frame rows under
// them in 16-byte chunks (4-byte words at a row's unaligned ends, so a
// 3-channel row needs no alignment), rearranges them into the s2d patch
// [rows][cols][16] in shared memory, and reads its A rows straight from
// there: the 64 bytes of step ky for conv position (i, j) are the 4 patch
// pixels (i + ky, j .. j + 3), consecutive positions 16 bytes apart, so
// nothing is im2col'd and an ldmatrix phase reads 128 contiguous bytes.
// The weights, [64][256] (output channel, K), stay resident in XOR-swizzled
// rows for the block.  Each chunk of 128 positions is requantized from the
// accumulator fragments into the block's int8 conv tile (-128 outside the
// conv map), then the pool runs on 16-byte words with __vmaxs4 and writes
// the pooled tile.  A tile's conv row and column at its top and left edges
// are also its neighbours', so the block recomputes them: of the tiles that
// fit two blocks an SM the chooser takes the one whose busiest SM computes
// the fewest conv positions, then the least recompute (16 x 16 pooled on
// the 512x512 and COCO canvases from B=2 up, 5.5 % and 6.0 %; 16 x 8 at
// B=1, where 16 x 16 leaves SMs idle).  The frame
// rows arrive by cp.async, all of a thread's copies in flight at once; in
// the GEMM each K step's fragments load while the previous step's mma run
// (two fragment sets in registers); the requant avoids int <-> float
// conversions (requant_relu_exact).
//
// Bound on the card: at 512^2 and B=8 the frames (6.3 MB) and the pooled
// output (8.4 MB) take about 4.4 us at 3.35 TB/s; the function's 4.9 G
// multiply-adds (7 x 7 taps over 3 channels, 147 a position and channel)
// take about 5.0 us at the int8 tensor-core peak, so the operations bound
// it.  The s2d GEMM issues 256 a position and channel (109 of them on zero
// taps: the fourth channel and the 8 x 8 window's outer row and column),
// 8.6 G, which alone would take 8.7 us at that peak.  |acc| <= 256 * 128 *
// 127 < 2^22, so the int32 sums are exact in any order and exact as f32.
//
// Bit-exactness with the plain version (the s2d oracle): exact int32 sums,
// separate __fmul_rn / __fadd_rn under -fmad=false, round half to even.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmma_tile.cuh"

namespace {

constexpr int kCout = 64;
constexpr int kK = 256;   // (ky, kx, c16)
constexpr int kMC = 128;  // conv positions a GEMM chunk
using Tile = MmaTile<kMC, kCout, 4>;

struct Args {
  const uint8_t* u;   // [B, H, W, cin]
  const int8_t* wt;   // [64][256]: output channel, (ky, kx, c16)
  const float* a;     // [64]
  const float* b;     // [64]
  const int8_t* pad;  // [16] border fill, v domain
  int8_t* out;        // [B, Hp, Wp, 64]
  int h, w, cin, hc, wc, hp, wp;
  int pr, pc, tiles_x;  // pooled rows, columns a block; tiles a row
};

__host__ __device__ __forceinline__ int align128(int n) { return (n + 127) / 128 * 128; }

// Shared memory of one block (ops/qstem.stem_smem_bytes), in byte offsets:
// the conv tile [CR * CC][64] (swz64 rows), which holds the staged frame
// rows [2 * PRS][pitch] before it exists; the s2d patch [PRS * PCS][16];
// the weights [64][256]; the GEMM rows' table; A, B [64] f32 and pad [16].
struct Layout {
  int cr, cc, prs, pcs, pitch, patch, weights, table, vecs, total;
};

__host__ __device__ __forceinline__ Layout layout_of(int pr, int pc, int cin) {
  Layout l;
  l.cr = 2 * pr + 1;
  l.cc = 2 * pc + 1;
  l.prs = l.cr + 3;
  l.pcs = l.cc + 3;
  l.pitch = 16 * ((2 * l.pcs * cin + 15) / 16 + 1);  // a staged row: its 16-byte chunks, misaligned start
  const int conv = l.cr * l.cc * kCout, staged = 2 * l.prs * l.pitch;
  l.patch = align128(conv > staged ? conv : staged);
  l.weights = l.patch + align128(l.prs * l.pcs * 16);
  l.table = l.weights + kCout * kK;
  l.vecs = l.table + align128((l.cr * l.cc + kMC - 1) / kMC * kMC * 4);
  l.total = l.vecs + align128(2 * kCout * 4 + 16);
  return l;
}

// 4 bytes from device memory to shared memory (L1-cached: a frame row's
// unaligned end)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

// requant_relu(epilogue(acc, a, b)) of int8_epilogue.cuh, bit for bit, with
// no int <-> float conversion (those issue at a quarter of the f32 rate,
// and the epilogue runs one per conv position and channel): |acc| < 2^22,
// so acc + 1.5 * 2^23 is an f32 of ulp 1 and subtracting 1.5 * 2^23 gives
// float(acc) exactly; adding 1.5 * 2^23 (even) to y clamped to [0, 127]
// rounds it half to even into the mantissa's low byte.  Clamping first
// gives the same value as rounding first: 0 below 0 and for a NaN, 127
// above 127, the same rounding in between
__device__ __forceinline__ int requant_relu_exact(int acc, float a, float b) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23, 0x4B400000
  const float x = __fsub_rn(__int_as_float(acc + 0x4B400000), kMagic);
  const float y = __fadd_rn(__fmul_rn(x, a), b);
  return __float_as_int(__fadd_rn(fminf(fmaxf(y, 0.0f), 127.0f), kMagic)) & 0xff;
}

__device__ __forceinline__ int vmax(int a, int b) {
  return static_cast<int>(__vmaxs4(static_cast<unsigned>(a), static_cast<unsigned>(b)));
}

// one K step (64 bytes: a ky) of a warp's fragments: A for its m16 tiles
// that hold live rows (pp: each one's patch pixel for this lane's row), B for
// its n16 pairs, as MmaTile::step addresses them
struct Frags {
  uint32_t a[2][Tile::MT][4], b[2][Tile::NT / 2][4];
};

__device__ __forceinline__ void load_frags(Frags& f, int ky, const int (&pp)[Tile::MT], uint32_t pa, uint32_t wb,
                                           int pcs, int live) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int np = 0; np < Tile::NT / 2; ++np)
      ldsm_x4(f.b[kk][np],
              wb + swz(Tile::wn() * Tile::WN + np * 16 + (l & 7) + ((l >> 4) << 3), 4 * ky + 2 * kk + ((l >> 3) & 1),
                       kK / 16));
#pragma unroll
    for (int mt = 0; mt < Tile::MT; ++mt)
      if (Tile::mt_row0(mt) < live) ldsm_x4(f.a[kk][mt], pa + 16 * (pp[mt] + ky * pcs + 2 * kk + (l >> 4)));
  }
}

__device__ __forceinline__ void mma_frags(Tile& mm, const Frags& f, int live) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int mt = 0; mt < Tile::MT; ++mt) {
      if (Tile::mt_row0(mt) >= live) continue;
#pragma unroll
      for (int np = 0; np < Tile::NT / 2; ++np) {
        mma_s8(mm.acc[mt][2 * np], f.a[kk][mt], f.b[kk][np][0], f.b[kk][np][1]);
        mma_s8(mm.acc[mt][2 * np + 1], f.a[kk][mt], f.b[kk][np][2], f.b[kk][np][3]);
      }
    }
}

// grid (tiles, B), block kMmaThreads
__global__ void __launch_bounds__(kMmaThreads, 2) qstem_kernel(const Args g) {
  extern __shared__ __align__(128) int8_t smem[];
  const Layout L = layout_of(g.pr, g.pc, g.cin);
  int8_t* conv = smem;   // the conv tile, once the patch is built
  int8_t* stage = smem;  // the frame rows, until then
  int8_t* patch = smem + L.patch;
  int8_t* wsm = smem + L.weights;
  int* table = reinterpret_cast<int*>(smem + L.table);  // GEMM row -> (conv tile position << 16) | patch pixel
  float* as = reinterpret_cast<float*>(smem + L.vecs);
  float* bs = as + kCout;
  int8_t* pad = reinterpret_cast<int8_t*>(bs + kCout);

  const int ty = blockIdx.x / g.tiles_x, tx = blockIdx.x - ty * g.tiles_x;
  const int py0 = ty * g.pr, px0 = tx * g.pc;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // conv tile origin
  const int sy0 = cy0 - 2, sx0 = cx0 - 2;          // s2d patch origin
  const uint8_t* img = g.u + static_cast<int64_t>(blockIdx.y) * g.h * g.w * g.cin;

  // the weights, in flight until the GEMM; the epilogue vectors and the border fill
  const uint32_t wb = smem_u32(wsm);
  for (int i = threadIdx.x; i < kCout * kK / 16; i += kMmaThreads)
    cp_async16(wb + swz(i >> 4, i & 15, kK / 16), g.wt + 16 * i, true);
  cp_async_commit();
  if (threadIdx.x < kCout) {
    as[threadIdx.x] = __ldg(g.a + threadIdx.x);
    bs[threadIdx.x] = __ldg(g.b + threadIdx.x);
  } else if (threadIdx.x < kCout + 16) {
    pad[threadIdx.x - kCout] = g.pad[threadIdx.x - kCout];
  }

  // 1. the frame rows under the patch, bytes [x_lo * cin, x_hi * cin) of
  // each, as the 16-byte chunks that cover them (staged row r, chunk k at r
  // * pitch + 16 k); a chunk that reaches past the row's 4-byte-aligned
  // cover copies only its words inside it.  All by cp.async, so every
  // thread's copies are in flight at once
  const int y_lo = max(2 * sy0, 0), y_hi = min(2 * (sy0 + L.prs), g.h);
  const int x_lo = max(2 * sx0, 0), x_hi = min(2 * (sx0 + L.pcs), g.w);
  const int nchunk = L.pitch / 16;
  if (x_lo < x_hi) {
    for (int i = threadIdx.x; i < (y_hi - y_lo) * nchunk; i += kMmaThreads) {
      const int r = i / nchunk, k = i - r * nchunk, y = y_lo + r;
      const uintptr_t s = reinterpret_cast<uintptr_t>(img + (static_cast<int64_t>(y) * g.w + x_lo) * g.cin);
      const uintptr_t e = s + static_cast<uintptr_t>(x_hi - x_lo) * g.cin;
      const uintptr_t w_lo = s & ~uintptr_t(3), w_hi = (e + 3) & ~uintptr_t(3);
      const uintptr_t ca = (s & ~uintptr_t(15)) + 16 * static_cast<uintptr_t>(k);
      if (ca >= w_hi) continue;
      const uint32_t dst = smem_u32(stage + (y - 2 * sy0) * L.pitch + 16 * k);
      if (ca >= w_lo && ca + 16 <= w_hi) {
        cp_async16(dst, reinterpret_cast<const void*>(ca), true);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (ca + 4 * j >= w_lo && ca + 4 * j < w_hi)
            cp_async4(dst + 4 * j, reinterpret_cast<const void*>(ca + 4 * j));
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. the s2d patch, v = u - 128 (u ^ 0x80): s2d pixel (ys, xs) holds frame
  // rows 2 ys, 2 ys + 1 (8 bytes each: columns 2 xs, 2 xs + 1, 4 channels);
  // outside the frame the border fill.  The GEMM rows' table: the tile's
  // conv positions inside the conv map, row by row
  const int hs = g.h / 2, ws = g.w / 2;
  const unsigned img_mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(img)) & 15;
  for (int i = threadIdx.x; i < L.prs * L.pcs; i += kMmaThreads) {
    const int si = i / L.pcs, sj = i - si * L.pcs, ys = sy0 + si, xs = sx0 + sj;
    int4 v = *reinterpret_cast<const int4*>(pad);
    if (ys >= 0 && ys < hs && xs >= 0 && xs < ws) {
      int q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // k = 2 dy + dx
        const int y = 2 * ys + (k >> 1), x = 2 * xs + (k & 1);
        const unsigned mis = (img_mis + static_cast<unsigned>(y * g.w + x_lo) * g.cin) & 15;  // the row's, step 1
        const int8_t* src = stage + (y - 2 * sy0) * L.pitch + mis + (x - x_lo) * g.cin;
        const int word = g.cin == 4 ? *reinterpret_cast<const int*>(src)
                                    : (src[0] & 0xff) | ((src[1] & 0xff) << 8) | ((src[2] & 0xff) << 16) | (0x80 << 24);
        q[k] = word ^ static_cast<int>(0x80808080u);
      }
      v = make_int4(q[0], q[1], q[2], q[3]);
    }
    *reinterpret_cast<int4*>(patch + 16 * i) = v;
  }
  const int ly0 = max(0, -cy0), ly1 = min(L.cr, g.hc - cy0);  // live conv rows, columns of the tile
  const int lx0 = max(0, -cx0), lx1 = min(L.cc, g.wc - cx0);
  const int lw = lx1 - lx0, m = (ly1 - ly0) * lw;
  for (int r = threadIdx.x; r < (m + kMC - 1) / kMC * kMC; r += kMmaThreads) {
    const int rr = min(r, m - 1), ci = ly0 + rr / lw, cj = lx0 + rr % lw;  // rows past m repeat the last
    table[r] = ((ci * L.cc + cj) << 16) | (ci * L.pcs + cj);
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. -128 (the pool's padding) on the tile's positions outside the conv
  // map: whole rows above and below the live ones, then the columns left
  // and right of them (none on an inner tile)
  const int neg = static_cast<int>(0x80808080u);
  const int out_rows = L.cr - (ly1 - ly0), out_cols = L.cc - lw;
  for (int i = threadIdx.x; i < 4 * (out_rows * L.cc + (ly1 - ly0) * out_cols); i += kMmaThreads) {
    const int k = i >> 2;
    int ci, cj;
    if (k < out_rows * L.cc) {
      const int r = k / L.cc;
      ci = r < ly0 ? r : r - ly0 + ly1;
      cj = k - r * L.cc;
    } else {
      const int r = (k - out_rows * L.cc) / out_cols, c = k - out_rows * L.cc - r * out_cols;
      ci = ly0 + r;
      cj = c < lx0 ? c : c - lx0 + lx1;
    }
    *reinterpret_cast<int4*>(conv + swz64(ci * L.cc + cj, i & 3)) = make_int4(neg, neg, neg, neg);
  }

  // 4. the implicit GEMM, 128 positions a chunk, requantized from the
  // fragments into the conv tile (two channels, two bytes, a store); each
  // thread's 8 columns' A and B in registers
  const uint32_t pa = smem_u32(patch);
  float va[2 * Tile::NT], vb[2 * Tile::NT];
#pragma unroll
  for (int nt = 0; nt < Tile::NT; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      va[2 * nt + i] = as[Tile::col(nt, i)];
      vb[2 * nt + i] = bs[Tile::col(nt, i)];
    }
  const int ln = threadIdx.x & 31;
  for (int m0 = 0; m0 < m; m0 += kMC) {
    Tile mm;
    mm.zero();
    int pp[Tile::MT];  // the patch pixel of this lane's A row in each m16 tile
#pragma unroll
    for (int mt = 0; mt < Tile::MT; ++mt) pp[mt] = table[m0 + Tile::mt_row0(mt) + (ln & 15)] & 0xffff;
    // step ky's fragments (two k32 slices: a kx pair each) load while step
    // ky - 1's mma run: the asm statements keep their order, so loads issued
    // first are in flight under the mma
    Frags f0, f1;
    load_frags(f0, 0, pp, pa, wb, L.pcs, m - m0);
    load_frags(f1, 1, pp, pa, wb, L.pcs, m - m0);
    mma_frags(mm, f0, m - m0);
    load_frags(f0, 2, pp, pa, wb, L.pcs, m - m0);
    mma_frags(mm, f1, m - m0);
    load_frags(f1, 3, pp, pa, wb, L.pcs, m - m0);
    mma_frags(mm, f0, m - m0);
    mma_frags(mm, f1, m - m0);
#pragma unroll
    for (int mt = 0; mt < Tile::MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = Tile::row(mt, 2 * hf);
        if (m0 + r >= m) continue;
        const int pos = table[m0 + r] >> 16;
#pragma unroll
        for (int nt = 0; nt < Tile::NT; ++nt) {
          const int col = Tile::col(nt, 0);
          const int q0 = requant_relu_exact(mm.acc[mt][nt][2 * hf], va[2 * nt], vb[2 * nt]);
          const int q1 = requant_relu_exact(mm.acc[mt][nt][2 * hf + 1], va[2 * nt + 1], vb[2 * nt + 1]);
          *reinterpret_cast<uint16_t*>(conv + swz64(pos, col >> 4) + (col & 15)) =
              static_cast<uint16_t>(q0 | (q1 << 8));
        }
      }
  }
  __syncthreads();

  // 5. the 3x3/2 pool: item = (pooled position, 16-byte word of channels)
  const int64_t obase = static_cast<int64_t>(blockIdx.y) * g.hp * g.wp;
  for (int it = threadIdx.x; it < g.pr * g.pc * 4; it += kMmaThreads) {
    const int q = it & 3, p = it >> 2, pi = p / g.pc, pj = p - pi * g.pc;
    const int py = py0 + pi, px = px0 + pj;
    if (py >= g.hp || px >= g.wp) continue;
    int4 mx = make_int4(neg, neg, neg, neg);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int4 v = *reinterpret_cast<const int4*>(conv + swz64((2 * pi + dy) * L.cc + 2 * pj + dx, q));
        mx = make_int4(vmax(mx.x, v.x), vmax(mx.y, v.y), vmax(mx.z, v.z), vmax(mx.w, v.w));
      }
    *reinterpret_cast<int4*>(g.out + (obase + static_cast<int64_t>(py) * g.wp + px) * kCout + 16 * q) = mx;
  }
}

}  // namespace

// Shared memory of one block of pr x pc pooled positions on a cin-channel
// frame (the chooser's arithmetic, ops/qstem.stem_smem_bytes, is held
// against this).
extern "C" int qstem_smem_bytes(int pr, int pc, int cin) { return layout_of(pr, pc, cin).total; }

// u [B, H, W, cin] uint8 (cin 3 or 4, H and W even) NHWC contiguous, 16-byte
// aligned; wt [64][256] int8 (the s2d taps, output channel major, (ky, kx,
// c16) order); a, b f32 [64]; pad [16] int8; out [B, Hp, Wp, 64] int8 with
// Hc = H / 2, Hp = (Hc - 1) / 2 + 1 (likewise W); pr x pc pooled positions
// a block (ops/qstem.pick_stem_tile).  Returns a cudaError_t (0 = launched).
extern "C" int qstem_launch(const void* u, const void* wt, const void* a, const void* b, const void* pad,
                            void* out, int batch, int h, int w, int cin, int pr, int pc, void* stream) {
  Args g;
  g.u = static_cast<const uint8_t*>(u);
  g.wt = static_cast<const int8_t*>(wt);
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.pad = static_cast<const int8_t*>(pad);
  g.out = static_cast<int8_t*>(out);
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.hc = h / 2;
  g.wc = w / 2;
  g.hp = (g.hc - 1) / 2 + 1;
  g.wp = (g.wc - 1) / 2 + 1;
  g.pr = pr;
  g.pc = pc;
  if ((cin != 3 && cin != 4) || h % 2 || w % 2 || h < 2 || w < 2 || pr < 1 || pc < 1 ||
      reinterpret_cast<uintptr_t>(u) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  g.tiles_x = (g.wp + pc - 1) / pc;
  const int64_t tiles = static_cast<int64_t>(g.tiles_x) * ((g.hp + pr - 1) / pr);
  if (tiles > 0x7fffffff || batch > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);

  static int optin = -1;  // the kernel may take all the shared memory a block can opt in to
  if (optin < 0) {
    int dev = 0, bytes = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(qstem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    optin = bytes;
  }
  const int smem = layout_of(pr, pc, cin).total;
  if (smem > optin) return static_cast<int>(cudaErrorInvalidConfiguration);
  qstem_kernel<<<dim3(static_cast<unsigned>(tiles), batch), kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
