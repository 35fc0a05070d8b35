// K5: one whole int8 HisBlock of the HisFPN, with its level glue, per call.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_qhis.py:qhisblock.  That
// kernel keeps one image's level in VMEM (x1/x2/a/m int8 scratch, 512 KB per
// image at 64x64) and walks it in phases: conv1/conv2 with the SE sums, the
// SE gate, the depthwise conv, conv3, conv4.  A Hopper SM has 227 KB of
// shared memory and no ordered grid, so the level does not fit and the SE
// mean (a reduction over the whole map) must be complete before any gated
// value is used.  So the block runs as three kernels on one stream, a
// producer and two consumers, with the intermediates in device memory
// (x1q, x2q, mq: mostly L2-resident at B=8):
//
//   produce  x    = combine: xa | clip8(xa*ca + xb*cb) | clip8(up2(xa)*ca + xb*cb)
//                              | clip8(pool2(xa)*ca + xb*cb)
//            x1q  = clip8(silu(conv1(x) * A1 + B1) * inv_x1)     (1x1, cin -> half)
//            x2q  = clip8(conv2(x) * A2 + B2)                    (1x1, cin -> half)
//            sum[b][c] += x1q  (int32: exact in any order; per-image runs, then atomics)
//   mid      g    = sigmoid(silu(mean @ se_w1 + se_b1) @ se_w2 + se_b2), f32, per
//                   image in every block's prologue, mean = float(sum) / (H*W) * premul
//            aq   = clip8(relu(dw3x3(x1q) * Adw + Bdw))
//            bq   = clip8(x1q * g)
//            mq   = clip8(relu(conv3x3([aq, bq]) * A3 + B3))      (cin -> half)
//   out      out  = clip8(silu(conv3x3_dil2([mq, x2q]) * A4 + B4) * inv_out)  (cin -> cin)
//
// Convs pad with zeros in the int8 domain, as the reference does.
//
// Design.  Every conv is a GEMM on the int8 tensor cores through
// csrc/qmma_tile.cuh's MmaTile (mma.sync m16n8k32 s8, ldmatrix fragments),
// its A operand in XOR-swizzled shared-memory rows (swz), the weights' K
// slices streamed through a ring of 4 cp.async stages.  The producer's
// block owns 64 or 128 consecutive positions of the batch (M) and one slice
// of the 2*half outputs of conv1|conv2 (N, w1's rows then w2's), K = cin;
// it builds its x rows once, with the combine glue applied as they are
// loaded: the coarser level's 2x upsample, or the finer level's 2x2 VALID
// max pool (four 16-byte loads and __vmaxs4, exact: the HisFPN's level
// pools need no launch of their own).  Each consumer's block owns one 8x8 tile (smaller at the map's
// edges and on maps under 8 a side) of `ipb` images (M: at most 64 rows)
// and one slice of its output channels: mid recomputes [aq, bq] on the
// tile and a 1-position halo from x1q (2-halo) and the SE gate, then runs
// conv3 as an implicit GEMM over the 9 taps of that halo (K = 9 cin, N =
// half) through a table of each row's halo position; out loads [mq, x2q]
// on the 2-halo by cp.async and runs conv4 the same way with the taps 2
// rows and 2 columns apart (K = 9 cin, N = cin).  A block that packs
// images keeps each one's halo, gate and zero padding apart.  The int32
// sums go through shared memory, so the epilogues write 16-byte words.
// ops/qhis.pick_his_tile chooses each kernel's rows or images a block and
// its channel slices, so the small levels (8x8, 4x4) at B=8 run on many
// blocks.  The depthwise 3x3 (0.1 % of the multiply-adds) stays on the
// CUDA cores, as byte-masked __dp4a.  mid is not fused into out: the dilation's 2-halo would make
// each 8x8 tile recompute conv3 on 12x12 positions, 2.25x its work.
//
// Bound on the card: int8 multiply-adds, about 951 k per position at cin =
// 256 (6.4 G per 512^2 image, 95 % in conv3 and conv4).  |acc| <= 127^2 *
// 2304 < 2^31, so the int32 sums are exact in any order and the outputs do
// not depend on the tiling: every tile the chooser can pick gives the same
// bits.
//
// Against the plain version (nn/fpn_int8's per-op oracle): the int8 convs are
// exact and the epilogues use separate __fmul_rn / __fadd_rn under
// -fmad=false, but SiLU and sigmoid use expf and the SE dots sum in another
// order than the plain matmul, so an output can differ by one int8 step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "qmma_tile.cuh"

namespace {

constexpr int kT = 8;       // consumers: tiles of at most kT x kT positions of one image
constexpr int kMC = 64;     // consumers: M rows a block (ipb x a tile's positions)
constexpr int kStages = 4;  // the weights' cp.async ring
enum { kProduce, kMid, kOut, kKernels };

struct Args {
  const int8_t* xa;  // [B, ha, wa, cin]
  const int8_t* xb;  // [B, H, W, cin] or null (combine none)
  const int8_t *w1, *w2;  // [half][cin]
  const float *a1, *b1, *a2, *b2;
  const int8_t* wdw;  // [9][half]
  const float *adw, *bdw;
  const float *se_w1, *se_b1, *se_w2, *se_b2;  // [half][r], [r], [r][half], [half]
  const int8_t* w3;  // [half][9][cin]
  const float *a3, *b3;
  const int8_t* w4;  // [cin][9][cin]
  const float *a4, *b4;
  const float* sc;  // inv_x1, inv_out, se_premul, ca, cb
  int8_t *x1q, *x2q, *mq;  // [B, H, W, half]
  int* se_sum;             // [B, half]
  int8_t* out;             // [B, H, W, cin]
  int batch, h, w, cin, half, r, combine;  // combine: 0 none, 1 add, 2 up_add, 3 pool_add
  int ha, wa;                              // xa's map: h x w, h / 2 x w / 2 (up_add), >= 2h x 2w (pool_add)
  int tiles_x, th, tw;                     // consumers: tiles a row; a full tile's rows, columns
};

// one kernel's launch: rows a block (produce) or images a block, and output channels a block
struct Pass {
  int ipb, slice;
};

// one consumer block's tile, images and channel slice
struct Blk {
  int r0, c0, th, tw, npos, b0, nimg, rows, nb;
};

__device__ __forceinline__ Blk blk_of(const Args& g, const Pass& p) {
  Blk t;
  const int ty = blockIdx.x / g.tiles_x;
  t.r0 = ty * kT;
  t.c0 = (blockIdx.x - ty * g.tiles_x) * kT;
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

// row hr of a halo of `pad` positions around the tile (image hr / its rows,
// rows of g.tw + 2 pad positions): its image and map position; false outside the map
__device__ __forceinline__ bool halo_at(const Args& g, const Blk& t, int pad, int hr, int& b, int& y, int& x) {
  const int wide = g.tw + 2 * pad, rows = (g.th + 2 * pad) * wide;
  const int i = hr / rows, hp = hr - i * rows;
  b = t.b0 + i;
  y = t.r0 - pad + hp / wide;
  x = t.c0 - pad + hp % wide;
  return y >= 0 && y < g.h && x >= 0 && x < g.w;
}

__device__ __forceinline__ float silu(float z) {
  return __fmul_rn(z, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))));
}

__device__ __forceinline__ float sigmoid(float z) { return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))); }

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((d & 0xff) << 24);
}

__device__ __forceinline__ int8_t byte_of(int v, int i) { return static_cast<int8_t>((v >> (8 * i)) & 0xff); }

// per-byte signed max of two 16-byte words
__device__ __forceinline__ int4 vmax16(const int4& a, const int4& b) {
  const auto m = [](int x, int y) {
    return static_cast<int>(__vmaxs4(static_cast<unsigned>(x), static_cast<unsigned>(y)));
  };
  return make_int4(m(a.x, b.x), m(a.y, b.y), m(a.z, b.z), m(a.w, b.w));
}

// clip8(a * ca + b * cb) on four bytes
__device__ __forceinline__ int combine4(int a, int b, float ca, float cb) {
  int8_t q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = clip8(__fadd_rn(__fmul_rn(static_cast<float>(byte_of(a, i)), ca),
                           __fmul_rn(static_cast<float>(byte_of(b, i)), cb)));
  return pack4(q[0], q[1], q[2], q[3]);
}

__host__ __device__ __forceinline__ int align128(int n) { return (n + 127) / 128 * 128; }
__host__ __device__ __forceinline__ int ring_bytes(int nc) { return kStages * nc * kStepBytes; }
// the ring, reused after each chunk for its int32 sums (rows of nc + 8 words)
__host__ __device__ __forceinline__ int ring_or_sums(int mc, int nc) {
  return ring_bytes(nc) > mc * (nc + 8) * 4 ? ring_bytes(nc) : mc * (nc + 8) * 4;
}

// output channels a GEMM chunk takes for a kernel's slice: 256 (out), 128, 64 or 32
__host__ __device__ __forceinline__ int chunk_of(int kernel, int slice) {
  if (kernel == kOut && slice % 256 == 0) return 256;
  return slice % 128 == 0 ? 128 : slice % 64 == 0 ? 64 : 32;
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

// halo position of each block row at tap (0, 0), for the implicit GEMMs
// (halo of `pad`); rows past the block's repeat its last one (their sums
// are not used)
__device__ __forceinline__ void fill_rowpos(int* rowpos, const Args& g, const Blk& t, int pad) {
  const int wide = g.tw + 2 * pad, rows = (g.th + 2 * pad) * wide;
  for (int r = threadIdx.x; r < kMC; r += kMmaThreads) {
    const int rr = min(r, t.rows - 1), i = rr / t.npos, p = rr - i * t.npos;
    rowpos[r] = i * rows + (p / t.tw) * wide + p % t.tw;
  }
}

// mm = the block's rows x output channels [o0, o0 + NC) of a 3x3 conv over
// the halo at shared address `a` (swz rows of cin bytes), weights wt
// [N][9][cin] (output channel o0 + n live where n < live); tap `tap` reads
// halo row rowpos[r] + toff(tap).  Ends with the ring drained and synced.
template <class T, class TOff>
__device__ __forceinline__ void conv3x3(T& mm, const Args& g, uint32_t a, const int* rowpos, uint32_t rb,
                                        const int8_t* wt, int o0, int live, const TOff& toff, int rows) {
  const int cin = g.cin, cpr = cin / 16, per_tap = (cin + kStepBytes - 1) / kStepBytes;
  mm.zero();
  pipeline<kStages>(
      9 * per_tap,
      [&](int s, int slot) {
        const int tap = s / per_tap, k0 = (s - tap * per_tap) * kStepBytes;
        stage_rows<T::NC>(
            rb + slot * T::NC * kStepBytes,
            [&](int r) { return wt + static_cast<int64_t>(o0 + r) * 9 * cin + tap * cin + k0; },
            [&](int r) { return r < live; }, [&](int c) { return k0 + 16 * c < cin; }, wt);
      },
      [&](int s, int slot) {
        const int tap = s / per_tap, k16 = (s - tap * per_tap) * 4, to = toff(tap);
        const uint32_t sb = rb + slot * T::NC * kStepBytes;
        mm.step([&](int r, int ch) { return a + swz(rowpos[r] + to, k16 + ch, cpr); },
                [&](int r, int ch) { return sb + swz64(r, ch); }, rows);
      });
}

// grid (ceil(B*H*W / MC), slices of 2 half); smem: x rows [MC][cin], the ring / sums
template <int MC, int NC>
__global__ void __launch_bounds__(kMmaThreads, 2) his_produce(const Args g, const Pass p) {
  using T = MmaTile<MC, NC, NC == 32 ? 4 : 2>;
  extern __shared__ __align__(128) int8_t smem[];
  const int cin = g.cin, cpr = cin / 16, half = g.half, hw = g.h * g.w;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * MC;
  const int rows = static_cast<int>(min(static_cast<int64_t>(MC), static_cast<int64_t>(g.batch) * hw - p0));
  const int nb = blockIdx.y * p.slice;
  const float ca = g.sc[3], cb = g.sc[4], inv_x1 = g.sc[0];
  int8_t* xs = smem;
  int8_t* ring = smem + align128(MC * cin + 64);

  // the block's x rows (positions p0 + r of the batch), the glue applied as they load
  for (int j = threadIdx.x; j < MC * cpr; j += kMmaThreads) {
    const int r = j / cpr, c = j - r * cpr;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < rows) {
      const int64_t at = (p0 + r) * cin + 16 * c;
      if (g.combine == 0) {
        v = __ldg(reinterpret_cast<const int4*>(g.xa + at));
      } else {
        int4 a;
        if (g.combine == 1) {
          a = __ldg(reinterpret_cast<const int4*>(g.xa + at));
        } else {
          const int64_t b = (p0 + r) / hw;
          const int q = static_cast<int>(p0 + r - b * hw), y = q / g.w, x = q % g.w;
          if (g.combine == 2) {  // the coarser level, 2x nearest upsample
            a = __ldg(reinterpret_cast<const int4*>(g.xa + ((b * g.ha + y / 2) * g.wa + x / 2) * cin + 16 * c));
          } else {  // the finer level, 2x2 VALID max pool
            const int4* r0 = reinterpret_cast<const int4*>(g.xa + ((b * g.ha + 2 * y) * g.wa + 2 * x) * cin + 16 * c);
            const int4* r1 = r0 + static_cast<int64_t>(g.wa) * cpr;
            a = vmax16(vmax16(__ldg(r0), __ldg(r0 + cpr)), vmax16(__ldg(r1), __ldg(r1 + cpr)));
          }
        }
        const int4 bb = __ldg(reinterpret_cast<const int4*>(g.xb + at));
        v = make_int4(combine4(a.x, bb.x, ca, cb), combine4(a.y, bb.y, ca, cb), combine4(a.z, bb.z, ca, cb),
                      combine4(a.w, bb.w, ca, cb));
      }
    }
    *reinterpret_cast<int4*>(xs + swz(r, c, cpr)) = v;
  }
  __syncthreads();

  const uint32_t a = smem_u32(xs), rb = smem_u32(ring);
  for (int n0 = 0; n0 < p.slice; n0 += NC) {
    const int o0 = nb + n0;  // output column of the chunk's first: [0, half) conv1, [half, 2 half) conv2
    const auto wrow = [&](int r) {
      const int o = o0 + r;
      return o < half ? g.w1 + static_cast<int64_t>(o) * cin : g.w2 + static_cast<int64_t>(o - half) * cin;
    };
    T mm;
    mm.zero();
    pipeline<kStages>(
        (cin + kStepBytes - 1) / kStepBytes,
        [&](int s, int slot) {
          stage_rows<NC>(
              rb + slot * NC * kStepBytes, [&](int r) { return wrow(r) + s * kStepBytes; },
              [&](int r) { return n0 + r < p.slice; }, [&](int c) { return s * kStepBytes + 16 * c < cin; }, g.w1);
        },
        [&](int s, int slot) {
          const uint32_t sb = rb + slot * NC * kStepBytes;
          mm.step([&](int r, int ch) { return a + swz(r, s * 4 + ch, cpr); },
                  [&](int r, int ch) { return sb + swz64(r, ch); }, rows);
        });
    int* sums = reinterpret_cast<int*>(ring);
    stage_acc(mm, sums);
    const int cols = min(NC, p.slice - n0);
    // x1q | x2q, 16 channels of a position a thread; x1q's values go back
    // into the thread's own staged sums for the SE sums below
    constexpr int kGroups = NC / 16;
    for (int gi = threadIdx.x; gi < rows * kGroups; gi += kMmaThreads) {
      const int r = gi / kGroups, cc = (gi - r * kGroups) * 16;
      if (cc >= cols) continue;
      const int o = o0 + cc;
      int v[16];
      read16<NC>(v, sums, r, cc);
      int8_t q[16];
      if (o < half) {
#pragma unroll
        for (int k = 0; k < 16; ++k) q[k] = clip8(__fmul_rn(silu(epilogue(v[k], g.a1[o + k], g.b1[o + k])), inv_x1));
        *reinterpret_cast<int4*>(g.x1q + (p0 + r) * half + o) = pack16(q);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<int4*>(sums + sum_at(r, cc + 4 * j, NC + 8)) =
              make_int4(q[4 * j], q[4 * j + 1], q[4 * j + 2], q[4 * j + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) q[k] = clip8(epilogue(v[k], g.a2[o - half + k], g.b2[o - half + k]));
        *reinterpret_cast<int4*>(g.x2q + (p0 + r) * half + o - half) = pack16(q);
      }
    }
    __syncthreads();
    // the SE sums of the chunk's x1q channels: two threads a channel, each
    // half the rows, one atomic per run of rows of one image
    const int hr = (rows + 1) / 2;
    for (int it = threadIdx.x; it < 2 * cols; it += kMmaThreads) {
      const int c = it >> 1, o = o0 + c;
      if (o >= half) continue;
      const int r1 = min(rows, (it & 1) * hr + hr);
      int r = (it & 1) * hr;
      while (r < r1) {
        const int64_t b = (p0 + r) / hw;
        const int end = static_cast<int>(min(static_cast<int64_t>(r1), (b + 1) * hw - p0));
        int s = 0;
        for (; r < end; ++r) s += sums[sum_at(r, c, NC + 8)];
        if (s != 0) atomicAdd(&g.se_sum[b * half + o], s);
      }
    }
    __syncthreads();  // the ring is free for the next chunk's copies
  }
}

// grid (ntiles, image groups, slices of half); smem: mean, gate, hid
// [ipb][half] f32, x1q on the 2-halo [ipb * halo2][half], [aq, bq] on the
// 1-halo [ipb * halo1][cin] (swz rows), the rows' halo positions [64], the ring / sums
template <int NC>
__global__ void __launch_bounds__(kMmaThreads, 2) his_mid(const Args g, const Pass p) {
  using T = MmaTile<kMC, NC, NC == 32 ? 4 : 2>;
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int half = g.half, cin = g.cin, cpr = cin / 16, hcpr = half / 16, r = g.r;
  const int w1h = g.tw + 2, h1 = (g.th + 2) * w1h, w2h = g.tw + 4, h2 = (g.th + 4) * w2h;
  float* mean = reinterpret_cast<float*>(smem);
  float* gate = mean + p.ipb * half;
  float* hid = gate + p.ipb * half;
  int8_t* x1 = smem + align128(p.ipb * 3 * half * 4);
  int8_t* cat = x1 + align128(p.ipb * h2 * half);
  int* rowpos = reinterpret_cast<int*>(cat + align128(p.ipb * h1 * cin + 64));
  int8_t* ring = reinterpret_cast<int8_t*>(rowpos) + align128(kMC * 4);

  // x1q on the 2-halo, in flight while the gate is computed
  const uint32_t x1a = smem_u32(x1);
  for (int j = threadIdx.x; j < t.nimg * h2 * hcpr; j += kMmaThreads) {
    const int hr = j / hcpr, c = j - hr * hcpr;
    int b, y, x;
    const bool in = halo_at(g, t, 2, hr, b, y, x);
    cp_async16(x1a + hr * half + 16 * c, in ? static_cast<const void*>(g.x1q + pixel(g, b, y, x) * half + 16 * c)
                                            : static_cast<const void*>(g.x1q), in);
  }
  cp_async_commit();
  fill_rowpos(rowpos, g, t, 1);

  // the SE gate of each image
  const float premul = g.sc[2], hw = static_cast<float>(g.h * g.w);
  for (int j = threadIdx.x; j < t.nimg * half; j += kMmaThreads) {
    const int i = j / half, c = j - i * half;
    mean[j] = __fmul_rn(__fdiv_rn(static_cast<float>(g.se_sum[(t.b0 + i) * half + c]), hw), premul);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < t.nimg * r; j += kMmaThreads) {
    const int i = j / r, k = j - i * r;
    const float* m = mean + i * half;
    float s = 0.0f;
    for (int c = 0; c < half; ++c) s = __fadd_rn(s, __fmul_rn(m[c], g.se_w1[c * r + k]));
    hid[i * half + k] = silu(__fadd_rn(s, g.se_b1[k]));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < t.nimg * half; j += kMmaThreads) {
    const int i = j / half, c = j - i * half;
    const float* hd = hid + i * half;
    float s = 0.0f;
    for (int k = 0; k < r; ++k) s = __fadd_rn(s, __fmul_rn(hd[k], g.se_w2[k * half + c]));
    gate[j] = sigmoid(__fadd_rn(s, g.se_b2[c]));
  }
  cp_async_wait<0>();
  __syncthreads();

  // [aq, bq] on the 1-halo; 0 outside the map.  The depthwise taps run as
  // byte-masked __dp4a: __dp4a(v, w & (0xff << 8k), acc) = acc + v_k * w_k,
  // exact; a thread's 4 channels change rarely, so their masked weights are
  // kept while they stay
  const int groups = half / 4;
  int wc = -1, wm[9][4];
  for (int it = threadIdx.x; it < t.nimg * h1 * groups; it += kMmaThreads) {
    const int hr = it / groups, c = (it - hr * groups) * 4;
    int b, y, x, a_word = 0, b_word = 0;
    if (halo_at(g, t, 1, hr, b, y, x)) {
      const int i = hr / h1, pos = hr - i * h1, pi = pos / w1h, pj = pos - pi * w1h;
      const int8_t* xi = x1 + i * h2 * half;
      if (c != wc) {
        wc = c;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int wv = __ldg(reinterpret_cast<const int*>(g.wdw + tap * half + c));
#pragma unroll
          for (int k = 0; k < 4; ++k) wm[tap][k] = wv & (0xff << (8 * k));
        }
      }
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int v = *reinterpret_cast<const int*>(xi + ((pi + tap / 3) * w2h + pj + tap % 3) * half + c);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = __dp4a(v, wm[tap][k], acc[k]);
      }
      const int center = *reinterpret_cast<const int*>(xi + ((pi + 1) * w2h + pj + 1) * half + c);
      const float* gi = gate + i * half + c;
      int8_t qa[4], qb[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        qa[k] = requant_relu(epilogue(acc[k], g.adw[c + k], g.bdw[c + k]));
        qb[k] = clip8(__fmul_rn(static_cast<float>(byte_of(center, k)), gi[k]));
      }
      a_word = pack4(qa[0], qa[1], qa[2], qa[3]);
      b_word = pack4(qb[0], qb[1], qb[2], qb[3]);
    }
    *reinterpret_cast<int*>(cat + swz(hr, c >> 4, cpr) + (c & 15)) = a_word;
    *reinterpret_cast<int*>(cat + swz(hr, (half + c) >> 4, cpr) + ((half + c) & 15)) = b_word;
  }
  __syncthreads();

  // conv3 3x3 pad 1 over [aq, bq] -> mq on the tile
  const uint32_t a = smem_u32(cat), rb = smem_u32(ring);
  for (int n0 = 0; n0 < p.slice; n0 += NC) {
    T mm;
    conv3x3(mm, g, a, rowpos, rb, g.w3, t.nb + n0, p.slice - n0,
            [&](int tap) { return (tap / 3) * w1h + tap % 3; }, t.rows);
    int* sums = reinterpret_cast<int*>(ring);
    stage_acc(mm, sums);
    const int cols = min(NC, p.slice - n0);
    constexpr int kGroups = NC / 16;
    for (int gi = threadIdx.x; gi < t.rows * kGroups; gi += kMmaThreads) {
      const int rr = gi / kGroups, cc = (gi - rr * kGroups) * 16;
      if (cc >= cols) continue;
      const int o = t.nb + n0 + cc;
      int v[16];
      read16<NC>(v, sums, rr, cc);
      int8_t q[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) q[k] = requant_relu(epilogue(v[k], g.a3[o + k], g.b3[o + k]));
      *reinterpret_cast<int4*>(g.mq + row_pixel(g, t, rr) * half + o) = pack16(q);
    }
    __syncthreads();  // the ring is free for the next chunk's copies
  }
}

// grid (ntiles, image groups, slices of cin); smem: [mq, x2q] on the 2-halo
// [ipb * halo2][cin] (swz rows), the rows' halo positions [64], the ring / sums
template <int NC>
__global__ void __launch_bounds__(kMmaThreads, 2) his_out(const Args g, const Pass p) {
  using T = MmaTile<kMC, NC, NC == 32 ? 4 : 2>;
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int half = g.half, cin = g.cin, cpr = cin / 16, hcpr = half / 16;
  const int w2h = g.tw + 4, h2 = (g.th + 4) * w2h;
  int8_t* hs = smem;
  int* rowpos = reinterpret_cast<int*>(smem + align128(p.ipb * h2 * cin + 64));
  int8_t* ring = reinterpret_cast<int8_t*>(rowpos) + align128(kMC * 4);
  fill_rowpos(rowpos, g, t, 2);
  const uint32_t a = smem_u32(hs), rb = smem_u32(ring);
  for (int j = threadIdx.x; j < t.nimg * h2 * cpr; j += kMmaThreads) {
    const int hr = j / cpr, c = j - hr * cpr;
    int b, y, x;
    const bool in = halo_at(g, t, 2, hr, b, y, x);
    const void* src = g.mq;
    if (in) {
      const int64_t px = pixel(g, b, y, x) * half;
      src = c < hcpr ? g.mq + px + 16 * c : g.x2q + px + 16 * (c - hcpr);
    }
    cp_async16(a + swz(hr, c, cpr), src, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float inv_out = g.sc[1];
  for (int n0 = 0; n0 < p.slice; n0 += NC) {
    T mm;
    conv3x3(mm, g, a, rowpos, rb, g.w4, t.nb + n0, p.slice - n0,
            [&](int tap) { return 2 * (tap / 3) * w2h + 2 * (tap % 3); }, t.rows);  // dilation 2
    int* sums = reinterpret_cast<int*>(ring);
    stage_acc(mm, sums);
    const int cols = min(NC, p.slice - n0);
    constexpr int kGroups = NC / 16;
    for (int gi = threadIdx.x; gi < t.rows * kGroups; gi += kMmaThreads) {
      const int rr = gi / kGroups, cc = (gi - rr * kGroups) * 16;
      if (cc >= cols) continue;
      const int o = t.nb + n0 + cc;
      int v[16];
      read16<NC>(v, sums, rr, cc);
      int8_t q[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) q[k] = clip8(__fmul_rn(silu(epilogue(v[k], g.a4[o + k], g.b4[o + k])), inv_out));
      *reinterpret_cast<int4*>(g.out + row_pixel(g, t, rr) * cin + o) = pack16(q);
    }
    __syncthreads();  // the ring is free for the next chunk's copies
  }
}

// shared memory of one block of `kernel` (ops/qhis.his_smem_bytes): ipb is
// the producer's rows a block, else images a block; th, tw a full tile's size
int smem_of(int kernel, int ipb, int th, int tw, int cin, int slice) {
  const int half = cin / 2, nc = chunk_of(kernel, slice);
  switch (kernel) {
    case kProduce:
      return align128(ipb * cin + 64) + ring_or_sums(ipb, nc);
    case kMid:
      return align128(ipb * 3 * half * 4) + align128(ipb * (th + 4) * (tw + 4) * half) +
             align128(ipb * (th + 2) * (tw + 2) * cin + 64) + align128(kMC * 4) + ring_or_sums(kMC, nc);
    default:
      return align128(ipb * (th + 4) * (tw + 4) * cin + 64) + align128(kMC * 4) + ring_or_sums(kMC, nc);
  }
}

const void* kernel_of(int kernel, int rows, int slice) {
  const int nc = chunk_of(kernel, slice);
  switch (kernel) {
    case kProduce:
      if (rows == 128)
        return nc == 128 ? (const void*)his_produce<128, 128>
                         : nc == 64 ? (const void*)his_produce<128, 64> : (const void*)his_produce<128, 32>;
      return nc == 128 ? (const void*)his_produce<64, 128>
                       : nc == 64 ? (const void*)his_produce<64, 64> : (const void*)his_produce<64, 32>;
    case kMid:
      return nc == 128 ? (const void*)his_mid<128> : nc == 64 ? (const void*)his_mid<64> : (const void*)his_mid<32>;
    default:
      return nc == 256   ? (const void*)his_out<256>
             : nc == 128 ? (const void*)his_out<128>
             : nc == 64  ? (const void*)his_out<64>
                         : (const void*)his_out<32>;
  }
}

// output channels of a kernel: conv1|conv2, conv3, conv4
int width_of(int kernel, int cin) { return kernel == kMid ? cin / 2 : cin; }

}  // namespace

// Shared memory of one block of kernel `kernel` (0 produce, 1 mid, 2 out)
// with ipb rows (produce) or images a block and `split` channel slices, for
// the level's h, w and cin (the chooser's arithmetic, held against this).
extern "C" int qhis_smem_bytes(int kernel, int ipb, int h, int w, int cin, int split) {
  return smem_of(kernel, ipb, min(kT, h), min(kT, w), cin, width_of(kernel, cin) / split);
}

// Pointers in the order of Args (see ops/qhis.py); the int8 maps NHWC
// contiguous and 16-byte aligned, xa [B, ha, wa, cin] (combine 2: ha = h /
// 2, wa = w / 2; 3: ha / 2 = h, wa / 2 = w; else h, w), weights
// [out][taps][in]; x1q, x2q, mq
// [B, H, W, half] int8 and se_sum [B, half] int32 are scratch (se_sum is
// zeroed here).  half % 16 == 0, cin == 2 * half, r <= half.  cfg: (rows a
// block, channel slices) of produce, (images a block, channel slices) of
// mid and out (ops/qhis.pick_his_tile).  Runs the three kernels on
// `stream`.  Returns a cudaError_t (0 = launched).
extern "C" int qhis_launch(void* const* ptrs, int batch, int h, int w, int cin, int half, int r, int combine,
                           int ha, int wa, const int* cfg, void* stream) {
  Args g;
  g.xa = static_cast<const int8_t*>(ptrs[0]);
  g.xb = static_cast<const int8_t*>(ptrs[1]);
  g.w1 = static_cast<const int8_t*>(ptrs[2]);
  g.w2 = static_cast<const int8_t*>(ptrs[3]);
  g.a1 = static_cast<const float*>(ptrs[4]);
  g.b1 = static_cast<const float*>(ptrs[5]);
  g.a2 = static_cast<const float*>(ptrs[6]);
  g.b2 = static_cast<const float*>(ptrs[7]);
  g.wdw = static_cast<const int8_t*>(ptrs[8]);
  g.adw = static_cast<const float*>(ptrs[9]);
  g.bdw = static_cast<const float*>(ptrs[10]);
  g.se_w1 = static_cast<const float*>(ptrs[11]);
  g.se_b1 = static_cast<const float*>(ptrs[12]);
  g.se_w2 = static_cast<const float*>(ptrs[13]);
  g.se_b2 = static_cast<const float*>(ptrs[14]);
  g.w3 = static_cast<const int8_t*>(ptrs[15]);
  g.a3 = static_cast<const float*>(ptrs[16]);
  g.b3 = static_cast<const float*>(ptrs[17]);
  g.w4 = static_cast<const int8_t*>(ptrs[18]);
  g.a4 = static_cast<const float*>(ptrs[19]);
  g.b4 = static_cast<const float*>(ptrs[20]);
  g.sc = static_cast<const float*>(ptrs[21]);
  g.x1q = static_cast<int8_t*>(ptrs[22]);
  g.x2q = static_cast<int8_t*>(ptrs[23]);
  g.mq = static_cast<int8_t*>(ptrs[24]);
  g.se_sum = static_cast<int*>(ptrs[25]);
  g.out = static_cast<int8_t*>(ptrs[26]);
  g.batch = batch;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.half = half;
  g.r = r;
  g.combine = combine;
  g.ha = ha;
  g.wa = wa;
  g.tiles_x = (w + kT - 1) / kT;
  g.th = min(kT, h);
  g.tw = min(kT, w);
  if (half % 16 || cin != 2 * half || r > half || r < 1 || combine < 0 || combine > 3 ||
      (combine == 2 ? ha * 2 != h || wa * 2 != w : combine == 3 ? ha / 2 != h || wa / 2 != w : ha != h || wa != w))
    return static_cast<int>(cudaErrorInvalidValue);

  static int optin = -1;  // every kernel may take all the shared memory a block can opt in to
  if (optin < 0) {
    int dev = 0, bytes = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int k = 0; k < kKernels; ++k)
      for (int rows = 64; rows <= 128; rows += 64)
        for (int slice = 32; slice <= 256; slice *= 2)
          if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel_of(k, rows, slice), cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    optin = bytes;
  }
  const int64_t npix = static_cast<int64_t>(batch) * h * w;
  const int ntiles = g.tiles_x * ((h + kT - 1) / kT);
  Pass pass[kKernels];
  dim3 grid[kKernels];
  for (int k = 0; k < kKernels; ++k) {
    const int ipb = cfg[2 * k], split = cfg[2 * k + 1], n = width_of(k, cin);
    if (split < 1 || n % split || (n / split) % 16) return static_cast<int>(cudaErrorInvalidValue);
    if (k == kProduce ? (ipb != 64 && ipb != 128) || (npix + ipb - 1) / ipb > 0x7fffffff
                      : ipb < 1 || ipb * g.th * g.tw > kMC || (batch + ipb - 1) / ipb > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    if (smem_of(k, ipb, g.th, g.tw, cin, n / split) > optin) return static_cast<int>(cudaErrorInvalidConfiguration);
    pass[k].ipb = ipb;
    pass[k].slice = n / split;
    grid[k] = k == kProduce ? dim3(static_cast<unsigned>((npix + ipb - 1) / ipb), split)
                            : dim3(ntiles, (batch + ipb - 1) / ipb, split);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(g.se_sum, 0, sizeof(int) * batch * half, s);
  void* args[2] = {&g, nullptr};
  for (int k = 0; k < kKernels && err == cudaSuccess; ++k) {
    args[1] = &pass[k];
    err = cudaLaunchKernel(kernel_of(k, pass[k].ipb, pass[k].slice), grid[k], dim3(kMmaThreads), args,
                           smem_of(k, pass[k].ipb, g.th, g.tw, cin, pass[k].slice), s);
  }
  return static_cast<int>(err);
}
