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
// Design.  A tile is 8 x tw output positions (tw 8 or 16; cut at the map's
// right and bottom edges, and the whole map where it is smaller) of `ipb`
// images: its M rows are ipb x the tile's positions, at most 128, so on the
// 4x4 and 8x8 maps several images share a tile.  A cluster of `split`
// blocks (1, 2, 4 or 8) owns a tile, and block rank q computes:
//   1. the staged input: every image's tile plus the d * (k - 1) / 2 halo,
//      clipped to the map, and the depthwise weights, by cp.async;
//   2. the depthwise conv on the CUDA cores (exact int32, taps outside the
//      map add 0: "same" padding) and its requant, for the whole tile -> a1
//      [M][C] in shared memory (swz rows); a thread takes 8 positions of a
//      tile row and 4 channels, and reads each kernel row's input window
//      once into registers (k = 3, 5, 7 at dilation 1 or 2; other k one
//      position at a time); the cluster barrier;
//   3. pw1 on the int8 tensor cores for the q-th 1/split of the mid
//      channels, with SiLU and the requant -> a2 [M][cmid] (swz rows), its
//      slice pushed into every peer's a2 (distributed shared memory), the
//      cluster barrier;
//   4. pw2 on the tensor cores over the whole a2 for the q-th 1/split of the
//      output channels; the int32 sums go through shared memory, so the
//      residual x and the block output move as 16-byte words.
// Both 1x1 convs run csrc/qmma_tile.cuh's MmaTile (mma.sync m16n8k32 s8,
// ldmatrix fragments from a1 or a2, the weights' K steps through a ring of 4
// cp.async stages), as kernel C's conv1 -> conv2 -> conv3 (csrc/qblock_tile.cuh).
// The staged input, then the ring and the staged sums, share one region; a1
// and a2 stay.  ops/qmnblock.pick_mn_tile chooses (tw, ipb, split) from the
// card's limits: the least modelled time, clusters on the small maps and
// small batches, packed images on the 4x4 and 8x8 maps.  C must be a
// multiple of 16 and of 16 * split, cmid of 16 * split; H and W are free.
//
// Bound on the card: int8 multiply-adds (pw1 and pw2 are 99 % of them);
// device memory sees the input once plus the halo and the output once, the
// weights once per tile from L2.  The depthwise, on the CUDA cores, is
// computed by every block of a cluster.
//
// Bit-exactness with the plain version (ops/qmnblock.qmnblock_plain): the
// depthwise sum is exact in int32 (127 * 127 * 49 < 2^24, so its f32 is
// exact); the 1x1 sums are exact in int32, in any order, and below 2^24 at
// C <= 1024; each multiply, add and divide is a separate __fmul_rn /
// __fadd_rn / __fdiv_rn in the plain version's order under -fmad=false
// (one fused multiply-add moves a value an ulp across a requant boundary);
// the sigmoid is 1 / (1 + expf(-z)), the form of PyTorch's CUDA sigmoid,
// with the full-precision expf; rintf rounds half to even.  So the output
// does not depend on the tile, the images a tile or the split.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "qmma_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kTH = 8;      // tile rows (fewer where the map is shorter)
constexpr int kStages = 4;  // the weights' cp.async ring

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
  int batch, h, w, c, cmid, k, d, hd;
  int tw, ipb, split, tiles_x, ntiles;
};

__host__ __device__ inline int align128(int n) { return (n + 127) / 128 * 128; }

// the shared-memory layout of one block: the union region (the staged input
// and depthwise weights, then the ring and the staged sums), a1, a2
struct Layout {
  int region, a1, a2, total;
};

__host__ __device__ inline Layout layout(int h, int w, int c, int cmid, int k, int d, int tw, int ipb, int mc, int nc1,
                                         int nc2) {
  const int hd = d * (k - 1) / 2;
  const int th = h < kTH ? h : kTH, twc = w < tw ? w : tw;
  const int ry = h < th + 2 * hd ? h : th + 2 * hd, rx = w < twc + 2 * hd ? w : twc + 2 * hd;
  const int staged = align128(ipb * ry * rx * c) + align128(k * k * c);
  const int ring = kStages * (nc1 > nc2 ? nc1 : nc2) * kStepBytes;
  const int sums = mc * (nc2 + 8) * 4;
  Layout l;
  l.region = align128(staged > ring ? (staged > sums ? staged : sums) : (ring > sums ? ring : sums));
  l.a1 = align128(mc * c);
  l.a2 = align128(mc * cmid);
  l.total = l.region + l.a1 + l.a2;
  return l;
}

__host__ __device__ inline int nc1_of(int cmid, int split, int mc) {
  const int n = cmid / split;
  return mc == 64 && n % 256 == 0 ? 256 : (n % 128 == 0 ? 128 : 64);
}
__host__ __device__ inline int nc2_of(int c, int split) {
  const int n = c / split;
  return n % 128 == 0 ? 128 : (n % 64 == 0 ? 64 : 32);
}

// one block's tile, images and cluster rank
struct Blk {
  int r0, c0, th, tw, npos, b0, nimg, rows, q;
  int y0, x0, ny, nx;  // the staged input window (clipped to the map)
};

__device__ __forceinline__ Blk blk_of(const Args& g, int q) {
  Blk t;
  t.q = q;
  const int tile = blockIdx.x / g.split, ty = tile / g.tiles_x;
  t.r0 = ty * kTH;
  t.c0 = (tile - ty * g.tiles_x) * g.tw;
  t.th = min(kTH, g.h - t.r0);
  t.tw = min(g.tw, g.w - t.c0);
  t.npos = t.th * t.tw;
  t.b0 = blockIdx.y * g.ipb;
  t.nimg = min(g.ipb, g.batch - t.b0);
  t.rows = t.nimg * t.npos;
  t.y0 = max(0, t.r0 - g.hd);
  t.x0 = max(0, t.c0 - g.hd);
  t.ny = min(g.h, t.r0 + t.th + g.hd) - t.y0;
  t.nx = min(g.w, t.c0 + t.tw + g.hd) - t.x0;
  return t;
}

// pixel index of block row r (image r / npos, position r % npos of the tile)
__device__ __forceinline__ int64_t row_pixel(const Args& g, const Blk& t, int r) {
  const int i = r / t.npos, p = r - i * t.npos;
  return (static_cast<int64_t>(t.b0 + i) * g.h + t.r0 + p / t.tw) * g.w + t.c0 + p % t.tw;
}

// The depthwise conv of one block: its staged input windows and weights in
// shared memory, its a1 rows to write (swz rows of C / 16 chunks).
struct DwJob {
  const int8_t* xs;  // [nimg][ny][nx][C], the window of each image
  const int8_t* ws;  // [k][k][C]
  int8_t* a1;        // [MC][C]
  const float* swdw;
  const float* bdw;
  float s_in, s_a1;
  int c, h, w, hd, k, d;
  Blk t;
};

// the requant of 4 channels' depthwise sums into a1's row r
__device__ __forceinline__ void dw_store(const DwJob& j, int r, int ch, const int (&acc)[4], const float (&a)[4],
                                         const float (&b)[4]) {
  int8_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = clip8(__fdiv_rn(epilogue(acc[q], a[q], b[q]), j.s_a1));
  *reinterpret_cast<int*>(j.a1 + swz(r, ch >> 4, j.c / 16) + (ch & 15)) =
      (v[0] & 0xff) | ((v[1] & 0xff) << 8) | ((v[2] & 0xff) << 16) | ((v[3] & 0xff) << 24);
}

__device__ __forceinline__ void dw_scales(const DwJob& j, int ch, float (&a)[4], float (&b)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[q] = __fmul_rn(j.s_in, __ldg(j.swdw + ch + q));
    b[q] = __ldg(j.bdw + ch + q);
  }
}

// byte q of a word, sign-extended
__device__ __forceinline__ int sbyte(int v, int q) { return (v << (24 - 8 * q)) >> 24; }

// K x K taps at dilation D: an item is a segment of up to 8 positions of
// one tile row and 4 channels; each kernel row's input window (8 + (K - 1)
// D words, zero outside the map: "same" padding adds 0) is read once and
// every tap of the row takes its words from registers.
template <int K, int D>
__device__ __noinline__ void depthwise_seg(const DwJob j) {
  constexpr int kW = 8 + (K - 1) * D;
  const Blk& t = j.t;
  const int q4 = j.c / 4, nseg = (t.tw + 7) / 8;
  for (int it = threadIdx.x; it < t.nimg * t.th * nseg * q4; it += kMmaThreads) {
    const int qd = it % q4, rest = it / q4, sg = rest % nseg, py = (rest / nseg) % t.th, i = rest / nseg / t.th;
    const int ch = 4 * qd, oy = t.r0 + py, ox0 = t.c0 + 8 * sg;
    const int8_t* img = j.xs + static_cast<int64_t>(i) * t.ny * t.nx * j.c + ch;
    int acc[8][4];
#pragma unroll
    for (int px = 0; px < 8; ++px)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[px][q] = 0;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const int iy = oy - j.hd + ky * D;
      if (iy < 0 || iy >= j.h) continue;
      const int8_t* row = img + (iy - t.y0) * t.nx * j.c;
      int xb[kW][4];
#pragma unroll
      for (int x = 0; x < kW; ++x) {
        const int ix = ox0 - j.hd + x;
        const int v = ix >= t.x0 && ix < t.x0 + t.nx ? *reinterpret_cast<const int*>(row + (ix - t.x0) * j.c) : 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) xb[x][q] = sbyte(v, q);
      }
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const int wv = *reinterpret_cast<const int*>(j.ws + (ky * K + kx) * j.c + ch);
        int wb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wb[q] = sbyte(wv, q);
#pragma unroll
        for (int px = 0; px < 8; ++px)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[px][q] += xb[px + kx * D][q] * wb[q];
      }
    }
    float a[4], b[4];
    dw_scales(j, ch, a, b);
    const int npx = min(8, t.tw - 8 * sg), r0 = i * t.npos + py * t.tw + 8 * sg;
#pragma unroll
    for (int px = 0; px < 8; ++px)
      if (px < npx) dw_store(j, r0 + px, ch, acc[px], a, b);
  }
}

// any other odd k and dilation: one position and 4 channels an item
__device__ __noinline__ void depthwise_any(const DwJob j) {
  const Blk& t = j.t;
  const int q4 = j.c / 4;
  for (int it = threadIdx.x; it < t.rows * q4; it += kMmaThreads) {
    const int qd = it % q4, r = it / q4, ch = 4 * qd;
    const int i = r / t.npos, p = r - i * t.npos;
    const int oy = t.r0 + p / t.tw, ox = t.c0 + p % t.tw;
    const int8_t* img = j.xs + static_cast<int64_t>(i) * t.ny * t.nx * j.c + ch;
    int acc[4] = {0, 0, 0, 0};
    for (int ky = 0; ky < j.k; ++ky) {
      const int iy = oy - j.hd + ky * j.d;
      if (iy < 0 || iy >= j.h) continue;  // "same" padding: the tap adds 0
      const int8_t* row = img + (iy - t.y0) * t.nx * j.c;
      for (int kx = 0; kx < j.k; ++kx) {
        const int ix = ox - j.hd + kx * j.d;
        if (ix < 0 || ix >= j.w) continue;
        const int xv = *reinterpret_cast<const int*>(row + (ix - t.x0) * j.c);
        const int wv = *reinterpret_cast<const int*>(j.ws + (ky * j.k + kx) * j.c + ch);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += sbyte(xv, q) * sbyte(wv, q);
      }
    }
    float a[4], b[4];
    dw_scales(j, ch, a, b);
    dw_store(j, r, ch, acc, a, b);
  }
}

// columns [c0, c0 + n) of rows [0, rows) of `buf` (swz rows of cpr chunks)
// into every other block of the cluster, then the cluster barrier
__device__ __forceinline__ void push_slice(const Blk& t, int split, int8_t* buf, int rows, int cpr, int c0, int n) {
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();
  const int nch = n / 16, ch0 = c0 / 16;
  for (int i = threadIdx.x; i < rows * nch; i += kMmaThreads) {
    const int r = i / nch, off = swz(r, ch0 + i % nch, cpr);
    const int4 v = *reinterpret_cast<const int4*>(buf + off);
    for (int j = 1; j < split; ++j) {
      int8_t* peer = cluster.map_shared_rank(buf, (t.q + j) % split);
      *reinterpret_cast<int4*>(peer + off) = v;
    }
  }
  cluster.sync();
}

// grid (ntiles * split, ceil(B / ipb)) in clusters of split; dynamic smem layout().total
template <int MC, int NC1, int NC2>
__global__ void __launch_bounds__(kMmaThreads, MC == 64 ? 2 : 1) qmnblock_kernel(const Args g) {
  using T1 = MmaTile<MC, NC1, 2>;
  using T2 = MmaTile<MC, NC2, NC2 == 32 ? 4 : 2>;
  extern __shared__ __align__(128) int8_t smem[];
  const int c = g.c, cmid = g.cmid, k = g.k, d = g.d;
  const int q = g.split > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const Blk t = blk_of(g, q);
  const Layout lay = layout(g.h, g.w, c, cmid, k, d, g.tw, g.ipb, MC, NC1, NC2);
  int8_t* xs = smem;                                             // [nimg][ny][nx][C]
  int8_t* ws = smem + align128(g.ipb * min(g.h, min(kTH, g.h) + 2 * g.hd) *
                               min(g.w, min(g.tw, g.w) + 2 * g.hd) * c);  // [k][k][C]
  int8_t* ring = smem;                                           // after the depthwise
  int8_t* a1 = smem + lay.region;                                // [MC][C], swz rows
  int8_t* a2 = a1 + lay.a1;                                      // [MC][cmid], swz rows
  const int cpr1 = c / 16, cpr2 = cmid / 16;

  // 1. the input window of each image and the depthwise weights
  {
    const uint32_t xa = smem_u32(xs), wa = smem_u32(ws);
    const int q16 = c / 16, per_img = t.ny * t.nx;
    for (int j = threadIdx.x; j < t.nimg * per_img * q16; j += kMmaThreads) {
      const int ch = j % q16, pix = j / q16, i = pix / per_img, p = pix - i * per_img;
      const int iy = t.y0 + p / t.nx, ix = t.x0 + p % t.nx;
      cp_async16(xa + pix * c + 16 * ch,
                 g.x + ((static_cast<int64_t>(t.b0 + i) * g.h + iy) * g.w + ix) * c + 16 * ch, true);
    }
    for (int j = threadIdx.x; j < k * k * q16; j += kMmaThreads) cp_async16(wa + 16 * j, g.wdw + 16 * j, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  const float s_in = __ldg(g.s_in), s_a1 = __ldg(g.s_a1), s_a2 = __ldg(g.s_a2), s_out = __ldg(g.s_out);

  // 2. the depthwise conv and its requant into a1
  {
    const DwJob job{xs, ws, a1, g.swdw, g.bdw, s_in, s_a1, c, g.h, g.w, g.hd, k, d, t};
    switch (k * 4 + d) {
      case 3 * 4 + 1: depthwise_seg<3, 1>(job); break;
      case 3 * 4 + 2: depthwise_seg<3, 2>(job); break;
      case 5 * 4 + 1: depthwise_seg<5, 1>(job); break;
      case 5 * 4 + 2: depthwise_seg<5, 2>(job); break;
      case 7 * 4 + 1: depthwise_seg<7, 1>(job); break;
      case 7 * 4 + 2: depthwise_seg<7, 2>(job); break;
      default: depthwise_any(job);
    }
    for (int it = threadIdx.x; it < (MC - t.rows) * (c / 4); it += kMmaThreads) {  // rows past the block's: 0
      const int r = t.rows + it / (c / 4), ch = 4 * (it % (c / 4));
      *reinterpret_cast<int*>(a1 + swz(r, ch >> 4, cpr1) + (ch & 15)) = 0;
    }
    if (g.split > 1) {
      cg::this_cluster().sync();  // a1 complete; every block of the cluster runs before any push into it
    } else {
      __syncthreads();  // a1 complete; the region is free for the ring
    }
  }

  const uint32_t rb = smem_u32(ring);

  // 3. pw1 for this block's mid channels [nb1, nb1 + cs1), SiLU and the requant into a2
  const int cs1 = cmid / g.split, nb1 = q * cs1;
  {
    const uint32_t aa = smem_u32(a1);
    for (int n0 = 0; n0 < cs1; n0 += NC1) {
      T1 mm;
      mm.zero();
      const int8_t* wrow = g.w1 + static_cast<int64_t>(nb1 + n0) * c;
      pipeline<kStages>(
          (c + kStepBytes - 1) / kStepBytes,
          [&](int s, int slot) {
            const int kb = s * kStepBytes;
            stage_rows<NC1>(
                rb + slot * NC1 * kStepBytes, [&](int r) { return wrow + static_cast<int64_t>(r) * c + kb; },
                [&](int r) { return n0 + r < cs1; }, [&](int ch) { return kb + 16 * ch < c; }, g.w1);
          },
          [&](int s, int slot) {
            const uint32_t sb = rb + slot * NC1 * kStepBytes;
            mm.step_mt([&](int mt, int ch) { return aa + swz(T1::mt_row0(mt) + (threadIdx.x & 15), s * 4 + ch, cpr1); },
                       [&](int r, int ch) { return sb + swz64(r, ch); }, t.rows);
          });
#pragma unroll
      for (int nt = 0; nt < T1::NT; ++nt) {
        const int n = n0 + T1::col(nt, 0);
        if (n >= cs1) continue;
        const int ch = nb1 + n;
        const float a0 = __fmul_rn(s_a1, __ldg(g.sw1 + ch)), a1c = __fmul_rn(s_a1, __ldg(g.sw1 + ch + 1));
        const float b0 = __ldg(g.b1 + ch), b1c = __ldg(g.b1 + ch + 1);
#pragma unroll
        for (int mt = 0; mt < T1::MT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            int8_t v[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float z = epilogue(mm.acc[mt][nt][2 * hf + j], j ? a1c : a0, j ? b1c : b0);
              // sigmoid: __frcp_rn rounds 1 / x once, as __fdiv_rn(1, x) does
              const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-z)));
              v[j] = clip8(__fdiv_rn(__fmul_rn(z, sig), s_a2));
            }
            *reinterpret_cast<char2*>(a2 + swz(T1::row(mt, 2 * hf), ch >> 4, cpr2) + (ch & 15)) =
                make_char2(v[0], v[1]);
          }
      }
    }
    if (g.split > 1) {
      push_slice(t, g.split, a2, MC, cpr2, nb1, cs1);
    } else {
      __syncthreads();
    }
  }

  // 4. pw2 and the residual for this block's output channels [nb2, nb2 + cs2)
  const int cs2 = c / g.split, nb2 = q * cs2;
  const float short_mul = __fdiv_rn(s_in, s_out);
  const uint32_t aa = smem_u32(a2);
  int* sums = reinterpret_cast<int*>(ring);
  for (int n0 = 0; n0 < cs2; n0 += NC2) {
    T2 mm;
    mm.zero();
    const int8_t* wrow = g.w2 + static_cast<int64_t>(nb2 + n0) * cmid;
    pipeline<kStages>(
        (cmid + kStepBytes - 1) / kStepBytes,
        [&](int s, int slot) {
          const int kb = s * kStepBytes;
          stage_rows<NC2>(
              rb + slot * NC2 * kStepBytes, [&](int r) { return wrow + static_cast<int64_t>(r) * cmid + kb; },
              [&](int r) { return n0 + r < cs2; }, [&](int ch) { return kb + 16 * ch < cmid; }, g.w2);
        },
        [&](int s, int slot) {
          const uint32_t sb = rb + slot * NC2 * kStepBytes;
          mm.step_mt([&](int mt, int ch) { return aa + swz(T2::mt_row0(mt) + (threadIdx.x & 15), s * 4 + ch, cpr2); },
                     [&](int r, int ch) { return sb + swz64(r, ch); }, t.rows);
        });
    // the sums into the drained ring (sum_at rows), then 16 channels of a position per thread
#pragma unroll
    for (int mt = 0; mt < T2::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T2::NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<int2*>(sums + sum_at(T2::row(mt, 2 * hf), T2::col(nt, 0), NC2 + 8)) =
              make_int2(mm.acc[mt][nt][2 * hf], mm.acc[mt][nt][2 * hf + 1]);
    __syncthreads();
    constexpr int kGroups = NC2 / 16;
    for (int gi = threadIdx.x; gi < t.rows * kGroups; gi += kMmaThreads) {
      const int r = gi / kGroups, cc = (gi - r * kGroups) * 16;
      if (n0 + cc >= cs2) continue;
      const int ch = nb2 + n0 + cc;
      int v[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int4 s4 = *reinterpret_cast<const int4*>(sums + sum_at(r, cc + 4 * j, NC2 + 8));
        v[4 * j] = s4.x, v[4 * j + 1] = s4.y, v[4 * j + 2] = s4.z, v[4 * j + 3] = s4.w;
      }
      const int64_t at = row_pixel(g, t, r) * c + ch;
      int8_t xv[16], o[16];
      unpack16(xv, __ldg(reinterpret_cast<const int4*>(g.x + at)));
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float y = epilogue(v[j], __fmul_rn(s_a2, __ldg(g.sw2 + ch + j)), __ldg(g.b2 + ch + j));
        o[j] = clip8(__fadd_rn(__fdiv_rn(y, s_out), __fmul_rn(static_cast<float>(xv[j]), short_mul)));
      }
      *reinterpret_cast<int4*>(g.out + at) = pack16(o);
    }
    __syncthreads();  // the ring is free for the next chunk's copies
  }
}

using Kernel = void (*)(const Args);

Kernel kernel_of(int mc, int nc1, int nc2) {
#define QMN_K(M, N1)                                                                         \
  (nc2 == 128 ? &qmnblock_kernel<M, N1, 128> : nc2 == 64 ? &qmnblock_kernel<M, N1, 64> \
                                                          : &qmnblock_kernel<M, N1, 32>)
  if (mc == 64) return nc1 == 256 ? QMN_K(64, 256) : nc1 == 128 ? QMN_K(64, 128) : QMN_K(64, 64);
  return nc1 == 128 ? QMN_K(128, 128) : QMN_K(128, 64);
#undef QMN_K
}

int rows_max(int h, int w, int tw, int ipb) { return ipb * (h < kTH ? h : kTH) * (w < tw ? w : tw); }

}  // namespace

// Bytes of dynamic shared memory one block needs under tile (tw, ipb,
// split) (ops/qmnblock.mn_smem_bytes, held against this).
extern "C" int qmnblock_smem_bytes(int h, int w, int c, int cmid, int k, int d, int tw, int ipb, int split) {
  const int mc = rows_max(h, w, tw, ipb) <= 64 ? 64 : 128;
  return layout(h, w, c, cmid, k, d, tw, ipb, mc, nc1_of(cmid, split, mc), nc2_of(c, split)).total;
}

// table: x, wdw, swdw, bdw, w1, sw1, b1, w2, sw2, b2, s_in, s_a1, s_a2, s_out,
// out (device pointers; x and out int8 NHWC [B, H, W, C] contiguous, 16-byte
// aligned; C a multiple of 16 * split, cmid of 16 * split; k odd; the scales
// one f32 each).  tile: tw (8 or 16), ipb images a tile (ipb x the tile's
// positions at most 128), split blocks a cluster (1, 2, 4 or 8).  Returns a
// cudaError_t (0 = launched).
extern "C" int qmnblock_launch(const void* const* table, int batch, int h, int w, int c, int cmid, int k, int d,
                               int tw, int ipb, int split, void* stream) {
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
  g.batch = batch;
  g.h = h;
  g.w = w;
  g.c = c;
  g.cmid = cmid;
  g.k = k;
  g.d = d;
  g.hd = d * (k - 1) / 2;
  g.tw = tw;
  g.ipb = ipb;
  g.split = split;
  g.tiles_x = (w + tw - 1) / tw;
  g.ntiles = g.tiles_x * ((h + kTH - 1) / kTH);
  const int rows = rows_max(h, w, tw, ipb);
  if ((tw != 8 && tw != 16) || ipb < 1 || rows > 128 || (split != 1 && split != 2 && split != 4 && split != 8) ||
      c % (16 * split) || cmid % (16 * split) || k % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mc = rows <= 64 ? 64 : 128, nc1 = nc1_of(cmid, split, mc), nc2 = nc2_of(c, split);
  const int smem = layout(h, w, c, cmid, k, d, tw, ipb, mc, nc1, nc2).total;
  const Kernel fn = kernel_of(mc, nc1, nc2);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned groups = static_cast<unsigned>((batch + ipb - 1) / ipb);
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(g.ntiles) * split, groups);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
