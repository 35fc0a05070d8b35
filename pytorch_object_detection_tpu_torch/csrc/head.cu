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
// each other, so the level is a chain of five kernels on one stream, each
// GroupNorm carried across a launch boundary:
//
//   1. fhead_pw1:    t1 = bf16(x @ pw1); GN1 partial sums of the f32 values
//   2. fhead_dw:     ReLU(GN1(t1)) on the tile and a one-pixel halo in
//                    shared memory, the 9-tap depthwise in bf16 -> t2; sums
//   3. fhead_pw2:    SiLU(GN2(t2)) rows in shared memory,
//                    y = bf16(t2' @ pw2 + bias + x)
//   4. fhead_towers: both tower convs as one implicit GEMM (N = 2f) over
//                    the halo of y in shared memory -> tw; f32 sums
//   5. fhead_pred:   ReLU(GN(tw)) of one tower on the halo in shared
//                    memory, the cls or cnt|reg conv as an implicit GEMM
//
// Design (K7's, csrc/qhead.cu, in bf16).  A level is cut into tiles of 8x8
// positions, or 8x16 for the GEMM passes where the map is wider than 8
// (smaller at its right and bottom edges, and on maps under 8 a side).  A
// block of a pass owns one tile of `ipb` images (M rows: ipb x the tile's
// positions, at most 64, or 128 on the wgmma kernels) and one slice of the
// pass's output channels; ops/head.pick_fhead_tile chooses the tile, ipb
// and the slices per pass from the card's limits, so the small levels run
// on many blocks and at 4x4 several images share one.  Each GEMM's A
// operand sits in shared memory as XOR-swizzled rows: pw1 the x rows, by
// cp.async; pw2 SiLU(GN2(t2)), made there once per element; the towers the
// halo of y, by cp.async; pred ReLU(GN(tw)) on the halo, made there once
// per element.  The towers and pred read it as an implicit GEMM over the 9
// taps (each lane's halo row in a register, the tap an offset).  On blocks
// of 128 rows (and for pred always) the GEMM runs wgmma.mma_async
// m64nNk16 (N = 128, pred 32 or 8): each warp's A fragments by ldmatrix,
// the weights from a shared-memory descriptor over a ring of 3 cp.async
// stages of 64 K values in 128-byte swizzled rows, as K16's (csrc/fused.cu);
// on 64-row blocks, csrc/qmma_tile.cuh's MmaTile with bf16 operands
// (mma.sync m16n8k16, f32 sums, every fragment of a K step loaded by
// ldmatrix before its first mma, the weights through a cp.async ring).
// The f32 sums go through shared memory, so the maps leave as 16-byte words
// and each (image, 8x8 tile, channel)'s GroupNorm sums are taken in one
// pass over its rows.  The depthwise pass stays on the CUDA cores, in
// bf16x2 arithmetic, on the tile and its halo of ReLU(GN1(t1)), made in
// shared memory once per element.
//
// GroupNorm.  Each producer block writes its tile's sums per (image,
// channel) and counts itself on the image's counter; the block that
// completes an image (its count reaches tiles x slices) folds that image's
// GroupNorm once, from every tile's sums in tile order, into per-channel
// (mul, add) vectors [B, 2f] that the consumer blocks read.  The counters are
// zeroed per call.
//
// Numerics: the JAX kernel's steps, each bf16 operation computed in f32
// and rounded once (bf16r), under -fmad=false (the depthwise pass takes
// its bf16 steps as bf16x2 operations, __hmul2_rn / __hadd2_rn: a bf16
// product or sum rounded once equals the f32 one rounded to bf16, as f32
// carries more than twice bf16's precision): GN1 statistics from the f32
// pw1 values and t1 stored in bf16; the GroupNorm vectors from E[x^2] -
// mean^2 over n = H*W*(C/32), rounded to bf16 before use; ReLU(GN1) and the
// depthwise taps in bf16, accumulated in bf16 in (ky, kx) order (a tap on
// the zero padding adds 0), GN2 statistics from the bf16 values; SiLU as v
// * bf16(sigmoid_f32(v)); the towers' statistics in f32 and their maps in
// bf16.  The partial sums are added in another order than the reference's,
// and expf is not XLA's, so an output may differ from the plain version by
// a few bf16 steps.  It does not depend on the blocks' tiles, images or
// slices: no GEMM's K is cut, wgmma and mma.sync sum a K step alike, and
// the GroupNorm sums are taken per 8x8 tile and folded in tile order
// whatever the tile.
//
// Bound on the card: 1.50 M multiply-adds per pixel at f = 256, 20
// classes, against 512 input and 50 output bytes: the tensor cores bound
// it (the towers' 9f-deep GEMM is 78 % of the work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmma_tile.cuh"

namespace {

constexpr int kT = 8;        // tile: at most kT x kT positions of one image
constexpr int kMC = 64;      // GEMM rows a block: ipb x the tile's positions
constexpr int kGroups = 32;
constexpr float kEps = 1e-5f;
constexpr int kStages = 4;   // the weights' cp.async ring
constexpr int kPredNC = 32;  // pred's output columns per block
constexpr int kPos = 8;      // positions per thread item of the depthwise pass
enum { kPw1, kDw, kPw2, kTowers, kPred, kPasses };
enum { kGn1, kGn2, kGnT, kFolds };  // GN1, GN2, the two towers' (64 groups over 2f)

__device__ __forceinline__ float bf2f(uint16_t h) { return __uint_as_float(static_cast<uint32_t>(h) << 16); }

__device__ __forceinline__ uint16_t f2bf(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }

// one bf16 operation: computed in f32, rounded once
__device__ __forceinline__ float bf16r(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(f2bf(f[2 * i])) | (static_cast<uint32_t>(f2bf(f[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// two bf16 in a 32-bit word (the lower address in the low half), and back
__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t w) {
  __nv_bfloat162 v;
  memcpy(&v, &w, 4);
  return v;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  uint32_t w;
  memcpy(&w, &v, 4);
  return w;
}

template <class T>
__device__ __forceinline__ const int8_t* bytes(const T* p) {
  return reinterpret_cast<const int8_t*>(p);
}

struct Args {
  const uint16_t* x;     // [B, H, W, f]
  const uint16_t* pw1;   // [2f][f]
  const float* dw;       // [9][2f]
  const uint16_t* pw2;   // [f][2f]
  const uint16_t* tow;   // [2f][9f]: the cls tower's output channels, then the reg tower's
  const uint16_t* pcls;  // [nc][9f]
  const uint16_t* pcr;   // [5][9f]: cnt, then the 4 reg channels
  const float* gn;       // [8][2f]: scale, bias of gn1, gn2, cls_gn0, reg_gn0
  const float* bias;     // [3][wb]: pw2's, cls_pred's, cnt|reg_pred's
  uint16_t* out;         // [B, H, W, nc + 5]
  uint16_t* t1;          // [B, H, W, 2f]: pw1's map, then the towers' (cls | reg)
  uint16_t* t2;          // [B, H, W, 2f]
  uint16_t* y;           // [B, H, W, f]
  float* part;           // [kFolds][B][ntiles][2][2f]: each tile's sums, sums of squares
  float* fold;           // [kFolds][B][2][2f]: each image's (mul, add)
  int* count;            // [kFolds][B]: producer blocks done per image
  int batch, h, w, f, f2, nc, wb;
  int pmax;              // tiles of a map in 8x8 tiles: the partial sums' rows an image
  int target[kFolds];    // an image's count once its GroupNorm's producer pass is done
};

// one pass's launch: images per block, channels per block (pred: kPredNC),
// its tiles of 8 x tw positions, and their halo: (min(8, h) + 2) x hw rows
// an image, hw = min(tw, w) + 2
struct Pass {
  int ipb, slice, tw, tiles_x, ntiles, hw, halo;
};

// one block's tile, images and channel slice
struct Blk {
  int tile, r0, c0, th, tw, npos, b0, nimg, rows, nb;
};

__device__ __forceinline__ Blk blk_of(const Args& g, const Pass& p) {
  Blk t;
  t.tile = blockIdx.x;
  const int ty = t.tile / p.tiles_x;
  t.r0 = ty * kT;
  t.c0 = (t.tile - ty * p.tiles_x) * p.tw;
  t.th = min(kT, g.h - t.r0);
  t.tw = min(p.tw, g.w - t.c0);
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
__device__ __forceinline__ bool halo_at(const Args& g, const Pass& p, const Blk& t, int hr, int& b, int& y, int& x) {
  const int i = hr / p.halo, hp = hr - i * p.halo;
  b = t.b0 + i;
  y = t.r0 - 1 + hp / p.hw;
  x = t.c0 - 1 + hp % p.hw;
  return y >= 0 && y < g.h && x >= 0 && x < g.w;
}

__host__ __device__ __forceinline__ int align128(int n) { return (n + 127) / 128 * 128; }
// a ring of 64-byte K steps for nc weight rows, `sub` steps a stage (4
// stages of one, or 3 of two: one barrier every 128 bytes of K)
__host__ __device__ __forceinline__ int ring_bytes(int nc, int sub) {
  return (sub == 2 ? 3 : kStages) * sub * nc * kStepBytes;
}
// the ring, reused after each chunk for its f32 sums (rows of nc + 8 words)
// and at the end for a GroupNorm fold (fold_bytes: 512 bytes of flags, then
// fold_image's sums and group statistics)
__host__ __device__ __forceinline__ int fold_bytes(int f2) { return 512 + align128((2 * f2 + 256) * 4); }
__host__ __device__ __forceinline__ int ring_or_sums(int nc, int f2, int sub) {
  const int a = ring_bytes(nc, sub), b = kMC * (nc + 8) * 4, c = fold_bytes(f2);
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
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
__device__ __forceinline__ void fill_rowpos(int* rowpos, int mc, const Pass& ps, const Blk& t) {
  for (int r = threadIdx.x; r < mc; r += kMmaThreads) {
    const int rr = min(r, t.rows - 1), i = rr / t.npos, p = rr - i * t.npos;
    rowpos[r] = i * ps.halo + (p / t.tw) * ps.hw + p % t.tw;
  }
}

// this lane's A rows of a tile T (one a m16 tile) from the rows' halo
// positions, into registers: the implicit GEMMs' steps then read no table
template <class T>
__device__ __forceinline__ void lane_rows(int (&hr)[T::MT], const int* rowpos) {
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) hr[mt] = rowpos[T::mt_row0(mt) + (threadIdx.x & 15)];
}

// The weight rows of a pass, [n0, n0 + NC) of one K step at byte `kb` of
// each row, through slot `slot` of the ring: row(r) is the r-th row's first
// byte, live(r) whether it exists.
template <int NC, class Row, class Live>
__device__ __forceinline__ void stage_weights(uint32_t slot, const Row& row, const Live& live, int kb, int klen,
                                              const void* safe) {
  stage_rows<NC>(slot, [&](int r) { return row(r) + kb; }, live, [&](int c) { return kb + 16 * c < klen; }, safe);
}

// One chunk's GEMM over `steps` 64-byte K steps through the ring at rb
// (ring_bytes(NC, SUB)), SUB steps a pipeline stage: issue(step, strip)
// stages a step's weights at strip (no commit), compute(step, strip) runs
// it once they have landed.
template <int NC, int SUB, class Issue, class Compute>
__device__ __forceinline__ void gemm_steps(uint32_t rb, int steps, const Issue& issue, const Compute& compute) {
  constexpr int kStrip = NC * kStepBytes, kSlot = SUB * kStrip;
  pipeline<SUB == 2 ? 3 : kStages>(
      (steps + SUB - 1) / SUB,
      [&](int s, int slot) {
#pragma unroll
        for (int j = 0; j < SUB; ++j)
          if (SUB * s + j < steps) issue(SUB * s + j, rb + slot * kSlot + j * kStrip);
      },
      [&](int s, int slot) {
#pragma unroll
        for (int j = 0; j < SUB; ++j)
          if (SUB * s + j < steps) compute(SUB * s + j, rb + slot * kSlot + j * kStrip);
      });
}

// the f32 sums into rows of NC + 8 words (sum_at), then a sync
template <class T>
__device__ __forceinline__ void stage_acc(const T& mm, float* sums) {
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(sums + sum_at(T::row(mt, 2 * hf), T::col(nt, 0), T::NC + 8)) =
            make_float2(mm.acc[mt][nt][2 * hf], mm.acc[mt][nt][2 * hf + 1]);
  __syncthreads();
}

// 16 staged sums of row r from column c
template <int NC>
__device__ __forceinline__ void read16(float (&v)[16], const float* sums, int r, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 q = *reinterpret_cast<const float4*>(sums + sum_at(r, c + 4 * j, NC + 8));
    v[4 * j] = q.x, v[4 * j + 1] = q.y, v[4 * j + 2] = q.z, v[4 * j + 3] = q.w;
  }
}

// map[pixel][ch0 + c] = bf16(sum) for the block's rows and columns c < cols,
// 16 a thread as two 16-byte words (map rows of ld channels)
template <int NC>
__device__ __forceinline__ void store_map(const Args& g, const Blk& t, const float* sums, int cols, int ch0,
                                          uint16_t* map, int ld) {
  constexpr int kG = NC / 16;
  for (int gi = threadIdx.x; gi < t.rows * kG; gi += kMmaThreads) {
    const int r = gi / kG, c = (gi - r * kG) * 16;
    if (c >= cols) continue;
    float v[16];
    read16<NC>(v, sums, r, c);
    uint4* dst = reinterpret_cast<uint4*>(map + row_pixel(g, t, r) * ld + ch0 + c);
    const float(&lo)[8] = *reinterpret_cast<const float(*)[8]>(v);
    const float(&hi)[8] = *reinterpret_cast<const float(*)[8]>(v + 8);
    dst[0] = pack8(lo);
    dst[1] = pack8(hi);
  }
}

// this tile's sums of one GroupNorm at [gn][b][tile][0 or 1][ch]
__device__ __forceinline__ float* part_at(const Args& g, int gn, int b, int tile) {
  return g.part + ((static_cast<int64_t>(gn) * g.batch + b) * g.pmax + tile) * 2 * g.f2;
}

// each (image, 8x8 sub-tile of the block's tile, staged column < cols)'s
// sum and sum of squares over its positions, to that 8x8 tile's partial
// row at channel ch0 + column: two lanes per item, each half the sub-tile's
// positions in its row order, added in a fixed order.  On the towers' 8x16
// tiles each half is summed as its own 8x8 tile is, so the partials, and
// the output, do not depend on the tile width.
template <int NC>
__device__ __forceinline__ void store_gn_sums(const Args& g, const Blk& t, const float* sums, int cols, int ch0,
                                              int gn) {
  const int nsub = (t.tw + kT - 1) / kT, items = t.nimg * nsub * NC * 2, tiles_x8 = (g.w + kT - 1) / kT;
  for (int base = 0; base < items; base += kMmaThreads) {
    const int it = base + threadIdx.x, pair = it >> 1, c = pair % NC, rest = pair / NC;
    const int sub = rest % nsub, i = rest / nsub;
    const bool live = it < items && c < cols;
    float s = 0.0f, q = 0.0f;
    if (live) {
      const int tw8 = min(kT, t.tw - sub * kT), np8 = t.th * tw8, half = (np8 + 1) / 2;
      const int q0 = (it & 1) * half, q1 = min(q0 + half, np8);
      for (int k = q0; k < q1; ++k) {
        const float v = sums[sum_at(i * t.npos + (k / tw8) * t.tw + sub * kT + k % tw8, c, NC + 8)];
        s = __fadd_rn(s, v);
        q = __fadd_rn(q, __fmul_rn(v, v));
      }
    }
    const float s1 = __shfl_xor_sync(0xffffffffu, s, 1), q1 = __shfl_xor_sync(0xffffffffu, q, 1);
    if (live && (it & 1) == 0) {
      float* pp = part_at(g, gn, t.b0 + i, (t.r0 / kT) * tiles_x8 + t.c0 / kT + sub);
      pp[ch0 + c] = __fadd_rn(s, s1);
      pp[g.f2 + ch0 + c] = __fadd_rn(q, q1);
    }
  }
}

// One image's GroupNorm `gn` folded from every tile's sums (in tile order)
// into its (mul, add) vectors, rounded to bf16 as the JAX kernel casts them
// (pallas_head.py:39-51).  scratch: fold_bytes(f2) of shared memory.
__device__ void fold_image(const Args& g, int gn, int b, float* scratch) {
  float* s_ = scratch;
  float* q_ = scratch + g.f2;
  float* gm = scratch + 2 * g.f2;
  float* gi = gm + 2 * kGroups;
  const float* base = part_at(g, gn, b, 0);
  for (int ch = threadIdx.x; ch < g.f2; ch += kMmaThreads) {
    float s = 0.0f, q = 0.0f;
    for (int tl = 0; tl < g.pmax; ++tl) {
      s = __fadd_rn(s, __ldcg(base + static_cast<int64_t>(tl) * 2 * g.f2 + ch));
      q = __fadd_rn(q, __ldcg(base + static_cast<int64_t>(tl) * 2 * g.f2 + g.f2 + ch));
    }
    s_[ch] = s;
    q_[ch] = q;
  }
  __syncthreads();
  // GN1 and GN2: 32 groups over 2f; the towers: 32 over each f
  const int ngr = gn == kGnT ? 2 * kGroups : kGroups, cg = g.f2 / ngr;
  const float n = static_cast<float>(g.h * g.w * cg);
  if (threadIdx.x < ngr) {
    float s = 0.0f, q = 0.0f;
    for (int j = 0; j < cg; ++j) {
      s = __fadd_rn(s, s_[threadIdx.x * cg + j]);
      q = __fadd_rn(q, q_[threadIdx.x * cg + j]);
    }
    const float mean = __fdiv_rn(s, n);
    const float var = __fsub_rn(__fdiv_rn(q, n), __fmul_rn(mean, mean));
    gm[threadIdx.x] = mean;
    gi[threadIdx.x] = __fdiv_rn(1.0f, sqrtf(__fadd_rn(var, kEps)));
  }
  __syncthreads();
  float* mul_out = g.fold + (static_cast<int64_t>(gn) * g.batch + b) * 2 * g.f2;
  for (int ch = threadIdx.x; ch < g.f2; ch += kMmaThreads) {
    float scale, bias;
    if (gn == kGnT) {  // rows 4, 5 (cls) over [0, f), 6, 7 (reg) over [f, 2f)
      const int z = ch >= g.f, k = ch - z * g.f;
      scale = g.gn[(4 + 2 * z) * g.f2 + k];
      bias = g.gn[(5 + 2 * z) * g.f2 + k];
    } else {
      scale = g.gn[2 * gn * g.f2 + ch];
      bias = g.gn[(2 * gn + 1) * g.f2 + ch];
    }
    const float mul = __fmul_rn(gi[ch / cg], scale);
    mul_out[ch] = bf16r(mul);
    mul_out[g.f2 + ch] = bf16r(__fsub_rn(bias, __fmul_rn(gm[ch / cg], mul)));
  }
  __syncthreads();
}

// After the block's partials of GroupNorm `gn` are written: count the block
// on each of its images, and fold the images whose count it completes.
__device__ __forceinline__ void finish_gn(const Args& g, const Blk& t, int gn, int8_t* scratch) {
  int* flag = reinterpret_cast<int*>(scratch);
  __threadfence();
  __syncthreads();
  if (threadIdx.x < t.nimg)
    flag[threadIdx.x] = atomicAdd(g.count + gn * g.batch + t.b0 + threadIdx.x, 1) == g.target[gn] - 1;
  __syncthreads();
  for (int i = 0; i < t.nimg; ++i) {
    if (flag[i]) {  // the same for the whole block
      __threadfence();
      fold_image(g, gn, t.b0 + i, reinterpret_cast<float*>(scratch + 512));
    }
  }
}

// (mul, add) of GroupNorm `gn` for channels [ch0, ch0 + n) of each of the
// block's images into tab [ipb][n]; the caller syncs
__device__ __forceinline__ void fill_tab(float2* tab, const Args& g, const Blk& t, int gn, int ch0, int n) {
  for (int j = threadIdx.x; j < t.nimg * n; j += kMmaThreads) {
    const int i = j / n, k = j - i * n;
    const float* f = g.fold + (static_cast<int64_t>(gn) * g.batch + t.b0 + i) * 2 * g.f2;
    tab[j] = make_float2(f[ch0 + k], f[g.f2 + ch0 + k]);
  }
}

// a wgmma shared-memory descriptor of a K-major operand in 128-byte swizzled
// rows (8-row atoms of 1024 bytes, 1024-byte aligned) starting at addr
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// byte offset of 16-byte chunk c of row r in 128-byte rows, 128-byte swizzle
__device__ __forceinline__ int swz128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// d += A (this warp's m16 x k16 fragment in registers; a warpgroup's 64
// rows) x B (N columns of 16 K values at the descriptor), f32 sums: N = 128,
// 32 and 8
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// One warpgroup's 64 rows x N columns of a GEMM whose A rows sit in shared
// memory at `a` (swz rows of cpr chunks; this lane's ldmatrix row hr):
// `taps` = 1, a plain GEMM over rowb bytes of K, or 9, the 3x3 implicit GEMM
// over a halo hw rows wide (tap (ky, kx) reads row hr + ky hw + kx), 9 x
// rowb bytes of K; 64 K values (128 bytes) a stage.  The weight rows
// wrow(r) for r < N (zeros where !live(r)) come through the ring at `ring`
// (3 stages of N x 128 bytes, 1024-aligned) in 128-byte swizzled rows,
// read by wgmma from a descriptor; each stage's wgmma finish before its
// slot is refilled (A fragments in registers: ptxas serializes wgmma whose
// A registers other instructions write inside a pipeline stage).  Both
// warpgroups of the block take every barrier.
template <int N, class WRow, class Live>
__device__ __forceinline__ void wg_gemm(float (&d)[N / 2], uint32_t a, int hr, int cpr, int rowb, int taps, int hw,
                                        uint32_t ring, const WRow& wrow, const Live& live, const void* safe) {
  constexpr int kStage = N * 128, kIssue = (N * 8 + kMmaThreads - 1) / kMmaThreads;
  const int tid = threadIdx.x, l = tid & 31, per_tap = (rowb + 127) / 128, steps = taps * per_tap;
  const auto issue = [&](int s, int slot) {
    const int tap = s / per_tap, k0 = (s - tap * per_tap) * 128, kb = tap * rowb + k0;
    const uint32_t bs = ring + slot * kStage;
#pragma unroll
    for (int i = 0; i < kIssue; ++i) {
      const int j = tid + i * kMmaThreads, r = j >> 3, c = j & 7;
      if ((N * 8) % kMmaThreads != 0 && j >= N * 8) break;
      const bool v = live(r) && k0 + 16 * c < rowb;  // zeros past K (f = 32: a half stage)
      cp_async16(bs + swz128(r, c), v ? static_cast<const void*>(wrow(r) + kb + 16 * c) : safe, v);
    }
  };
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < steps) issue(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the copies, seen by wgmma
    __syncthreads();
    if (s + 2 < steps) issue(s + 2, (s + 2) % 3);
    cp_async_commit();
    const int tap = s / per_tap, kc = (s - tap * per_tap) * 8, toff = taps == 9 ? (tap / 3) * hw + tap % 3 : 0;
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // a chunk past the row (zero weights there) reads the row's last
      ldsm_x4(af[kk], a + swz(hr + toff, min(kc + 2 * kk + (l >> 4), cpr - 1), cpr));
    const uint64_t db = sw128_desc(ring + (s % 3) * kStage);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, af[kk], db + 2 * kk);  // 16 bf16 = 32 bytes further along K
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // the slot is free for the next copies
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
  cp_async_wait<0>();
  __syncthreads();
}

constexpr int kWgStage = 128 * 128;  // bytes of a ring stage: 128 weight rows of 64 K values
constexpr int kWgRegion = (3 * kWgStage > 128 * 136 * 4 ? 3 * kWgStage : 128 * 136 * 4) + 1024;

// a 128-row block's wgmma sums (warpgroup g: rows 64 g ..) into rows of N + 8
// f32 (sum_at), then a sync: lane l holds rows 16 (warp % 4) + l / 4 (+ 8),
// columns 8 j + 2 (l % 4) (+ 1)
template <int N>
__device__ __forceinline__ void stage_wg(const float (&d)[N / 2], float* sums) {
  const int l = threadIdx.x & 31, row = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (l >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(sums + sum_at(row + 8 * hf, 8 * j + 2 * (l & 3), N + 8)) =
          make_float2(d[4 * j + 2 * hf], d[4 * j + 2 * hf + 1]);
  __syncthreads();
}

// One chunk of a plain GEMM for a block of MC rows: the A rows at `a` (swz
// rows of cpr chunks, rowb bytes of K) x the NC weight rows wrow(r) (zeros
// where !live(r)), the f32 sums into `sums` (rows of NC + 8 words), then a
// sync.  MC = 128: wgmma, the ring 1024-aligned at `ring` (kWgRegion bytes
// from it hold the sums too); MC = 64: MmaTile on mma.sync, SUB 64-byte K
// steps a ring stage, the sums over the ring.
template <int MC, int NC, int SUB, class WRow, class Live>
__device__ __forceinline__ void rows_gemm(uint32_t a, int cpr, int rowb, int rows, uint32_t ring, float* sums,
                                          const WRow& wrow, const Live& live, const void* safe) {
  if constexpr (MC == 128) {
    float d[NC / 2];
    const int r = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (threadIdx.x & 15);
    wg_gemm<NC>(d, a, r, cpr, rowb, 1, 0, ring, wrow, live, safe);
    stage_wg<NC>(d, sums);
  } else {
    using T = MmaTile<MC, NC, 2, float>;
    T mm;
    mm.zero();
    gemm_steps<NC, SUB>(
        ring, rowb / kStepBytes,
        [&](int s, uint32_t strip) { stage_weights<NC>(strip, wrow, live, s * kStepBytes, rowb, safe); },
        [&](int s, uint32_t strip) {
          mm.step_mt([&](int mt, int ch) { return a + swz(T::mt_row0(mt) + (threadIdx.x & 15), s * 4 + ch, cpr); },
                     [&](int r, int ch) { return strip + swz64(r, ch); }, rows);
        });
    stage_acc(mm, sums);
  }
}

// grid (ntiles, image groups, slices of 2f); smem: x rows [MC][f], the ring
// / sums (MC = 128: wgmma on tiles of 8 x 16)
template <int MC, int NC>
__global__ void __launch_bounds__(kMmaThreads, MC == 64 ? 2 : 1) fhead_pw1(const Args g, const Pass p) {
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int rowb = 2 * g.f, cpr = rowb / 16;
  int8_t* xs = smem;
  int8_t* region = smem + align128(MC * rowb);
  load_rows(xs, MC, cpr, [&](int r) { return r < t.rows ? bytes(g.x) + row_pixel(g, t, r) * rowb : nullptr; }, g.x);
  const uint32_t a = smem_u32(xs), raw = smem_u32(region), ring = MC == 128 ? (raw + 1023) & ~1023u : raw;
  float* sums = reinterpret_cast<float*>(region + (ring - raw));
  for (int n0 = 0; n0 < p.slice; n0 += NC) {
    rows_gemm<MC, NC, 2>(a, cpr, rowb, t.rows, ring, sums,
                         [&](int r) { return bytes(g.pw1) + static_cast<int64_t>(t.nb + n0 + r) * rowb; },
                         [&](int r) { return n0 + r < p.slice; }, g.pw1);
    const int cols = min(NC, p.slice - n0), ch0 = t.nb + n0;
    store_map<NC>(g, t, sums, cols, ch0, g.t1, g.f2);
    store_gn_sums<NC>(g, t, sums, cols, ch0, kGn1);
    __syncthreads();  // the ring is free for the next chunk's copies
  }
  finish_gn(g, t, kGn1, region);
}

// grid (ntiles, image groups, slices of 2f), block kMmaThreads; smem: the
// GN1 table [ipb][slice], u = ReLU(GN1(t1)) on the halo [ipb * halo][slice]
// bf16, each item's sums [npg][ipb][slice] x 2
__global__ void __launch_bounds__(kMmaThreads) fhead_dw(const Args g, const Pass p) {
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int slice = p.slice, npg = (t.npos + kPos - 1) / kPos, pairs = slice / 2;
  float2* tab = reinterpret_cast<float2*>(smem);
  int8_t* us = smem + align128(p.ipb * slice * 8);
  const int u_bytes = align128(p.ipb * p.halo * slice * 2) > fold_bytes(g.f2) ? align128(p.ipb * p.halo * slice * 2)
                                                                              : fold_bytes(g.f2);
  float* red_s = reinterpret_cast<float*>(us + u_bytes);
  float* red_q = red_s + ((kT * kT + kPos - 1) / kPos) * p.ipb * slice;
  fill_tab(tab, g, t, kGn1, t.nb, slice);
  __syncthreads();
  for (int j = threadIdx.x; j < t.nimg * p.halo * (slice / 8); j += kMmaThreads) {
    const int o = (j % (slice / 8)) * 8, hr = j / (slice / 8);
    int b, y, x;
    uint4 word = make_uint4(0u, 0u, 0u, 0u);
    if (halo_at(g, p, t, hr, b, y, x)) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(g.t1 + pixel(g, b, y, x) * g.f2 + t.nb + o));
      const float2* tr = tab + (hr / p.halo) * slice + o;
      uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // ReLU(t1 * mul + add), each op in bf16 (two channels a word)
        const __nv_bfloat162 m = __floats2bfloat162_rn(tr[2 * k].x, tr[2 * k + 1].x);
        const __nv_bfloat162 a = __floats2bfloat162_rn(tr[2 * k].y, tr[2 * k + 1].y);
        const __nv_bfloat162 u = __hmax2(__hadd2_rn(__hmul2_rn(as_bf2(w[k]), m), a), __float2bfloat162_rn(0.0f));
        w[k] = as_u32(u);
      }
      word = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(us + (hr * slice + o) * 2) = word;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < t.nimg * npg * pairs; it += kMmaThreads) {
    const int c = 2 * (it % pairs), pg = (it / pairs) % npg, i = it / (pairs * npg);
    const int ch = t.nb + c;
    __nv_bfloat162 tap[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      tap[k] = __floats2bfloat162_rn(__ldg(g.dw + k * g.f2 + ch), __ldg(g.dw + k * g.f2 + ch + 1));
    float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
    const int pend = min(t.npos, (pg + 1) * kPos);
    for (int pos = pg * kPos; pos < pend; ++pos) {
      const int ty = pos / t.tw, tx = pos % t.tw;
      // acc = acc + u * tap in (ky, kx) order, each op rounded to bf16 (two channels a word)
      __nv_bfloat162 acc = __float2bfloat162_rn(0.0f);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int hr = i * p.halo + (ty + k / 3) * p.hw + tx + k % 3;
        const uint32_t u = *reinterpret_cast<const uint32_t*>(us + (hr * slice + c) * 2);
        acc = __hadd2_rn(acc, __hmul2_rn(as_bf2(u), tap[k]));
      }
      const uint32_t word = as_u32(acc);
      *reinterpret_cast<uint32_t*>(g.t2 + pixel(g, t.b0 + i, t.r0 + ty, t.c0 + tx) * g.f2 + ch) = word;
      const float acc0 = __uint_as_float(word << 16), acc1 = __uint_as_float(word & 0xffff0000u);
      s0 = __fadd_rn(s0, acc0);
      s1 = __fadd_rn(s1, acc1);
      q0 = __fadd_rn(q0, __fmul_rn(acc0, acc0));
      q1 = __fadd_rn(q1, __fmul_rn(acc1, acc1));
    }
    const int at = (pg * p.ipb + i) * slice + c;
    red_s[at] = s0;
    red_s[at + 1] = s1;
    red_q[at] = q0;
    red_q[at + 1] = q1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < t.nimg * slice; j += kMmaThreads) {
    const int i = j / slice, k = j - i * slice;
    float s = 0.0f, q = 0.0f;
    for (int pg = 0; pg < npg; ++pg) {
      s = __fadd_rn(s, red_s[(pg * p.ipb + i) * slice + k]);
      q = __fadd_rn(q, red_q[(pg * p.ipb + i) * slice + k]);
    }
    float* pp = part_at(g, kGn2, t.b0 + i, t.tile);
    pp[t.nb + k] = s;
    pp[g.f2 + t.nb + k] = q;
  }
  finish_gn(g, t, kGn2, us);
}

// grid (ntiles, image groups, slices of f); smem: the GN2 table [ipb][2f],
// SiLU(GN2(t2)) rows [kMC][2f] bf16, the ring / sums (64-row blocks, two
// an SM: one block's SiLU prologue runs beside the other's GEMM)
template <int NC>
__global__ void __launch_bounds__(kMmaThreads, 2) fhead_pw2(const Args g, const Pass p) {
  constexpr int MC = kMC;
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int f2 = g.f2, rowb = 2 * f2, cpr = rowb / 16;
  float2* tab = reinterpret_cast<float2*>(smem);
  int8_t* as = smem + align128(p.ipb * f2 * 8);
  int8_t* region = as + align128(MC * rowb);
  fill_tab(tab, g, t, kGn2, 0, f2);
  __syncthreads();
  for (int j = threadIdx.x; j < MC * (f2 / 8); j += kMmaThreads) {
    const int o = (j % (f2 / 8)) * 8, r = j / (f2 / 8);
    uint4 word = make_uint4(0u, 0u, 0u, 0u);
    if (r < t.rows) {
      float v[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(g.t2 + row_pixel(g, t, r) * f2 + o)), v);
      const float2* tr = tab + (r / t.npos) * f2 + o;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float u = bf16r(__fadd_rn(bf16r(__fmul_rn(v[k], tr[k].x)), tr[k].y));
        v[k] = bf16r(__fmul_rn(u, bf16r(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-u))))));
      }
      word = pack8(v);
    }
    *reinterpret_cast<uint4*>(as + swz(r, o / 8, cpr)) = word;
  }
  __syncthreads();
  const uint32_t a = smem_u32(as), ring = smem_u32(region);
  float* sums = reinterpret_cast<float*>(region);
  for (int n0 = 0; n0 < p.slice; n0 += NC) {
    rows_gemm<MC, NC, 1>(a, cpr, rowb, t.rows, ring, sums,
                         [&](int r) { return bytes(g.pw2) + static_cast<int64_t>(t.nb + n0 + r) * rowb; },
                         [&](int r) { return n0 + r < p.slice; }, g.pw2);
    // y = acc + bias + x (pallas_head.py:159-161), 16 channels of a position per thread
    constexpr int kG = NC / 16;
    for (int gi = threadIdx.x; gi < t.rows * kG; gi += kMmaThreads) {
      const int r = gi / kG, cc = (gi - r * kG) * 16;
      if (n0 + cc >= p.slice) continue;
      const int ch = t.nb + n0 + cc;
      float v[16], xv[16];
      read16<NC>(v, sums, r, cc);
      const int64_t at = row_pixel(g, t, r) * g.f + ch;
      const uint4* xp = reinterpret_cast<const uint4*>(g.x + at);
      float(&xlo)[8] = *reinterpret_cast<float(*)[8]>(xv);
      float(&xhi)[8] = *reinterpret_cast<float(*)[8]>(xv + 8);
      unpack8(__ldg(xp), xlo);
      unpack8(__ldg(xp + 1), xhi);
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = __fadd_rn(__fadd_rn(v[k], __ldg(g.bias + ch + k)), xv[k]);
      uint4* dst = reinterpret_cast<uint4*>(g.y + at);
      const float(&lo)[8] = *reinterpret_cast<const float(*)[8]>(v);
      const float(&hi)[8] = *reinterpret_cast<const float(*)[8]>(v + 8);
      dst[0] = pack8(lo);
      dst[1] = pack8(hi);
    }
    __syncthreads();  // the ring is free for the next chunk's copies
  }
}

// grid (ntiles, image groups, slices of 2f: [0, f) the cls tower, [f, 2f)
// the reg tower); 64-row blocks (8x8 tiles); smem: y on the halo [ipb *
// halo][f] bf16, the rows' halo positions [kMC], the ring / sums
template <int NC>
__global__ void __launch_bounds__(kMmaThreads, 2) fhead_towers(const Args g, const Pass p) {
  constexpr int MC = kMC;
  using T = MmaTile<MC, NC, 2, float>;
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int rowb = 2 * g.f, cpr = rowb / 16, per_tap = rowb / kStepBytes;
  int8_t* ys = smem;
  int* rowpos = reinterpret_cast<int*>(smem + align128(p.ipb * p.halo * rowb));
  int8_t* ring = reinterpret_cast<int8_t*>(rowpos) + align128(MC * 4);
  fill_rowpos(rowpos, MC, p, t);
  load_rows(ys, t.nimg * p.halo, cpr, [&](int hr) {
    int b, y, x;
    return halo_at(g, p, t, hr, b, y, x) ? bytes(g.y) + pixel(g, b, y, x) * rowb : nullptr;
  }, g.y);
  int hr[T::MT];
  lane_rows<T>(hr, rowpos);
  const uint32_t a = smem_u32(ys), rb = smem_u32(ring);
  float* sums = reinterpret_cast<float*>(ring);
  for (int n0 = 0; n0 < p.slice; n0 += NC) {
    T mm;
    mm.zero();
    const auto wrow = [&](int r) { return bytes(g.tow) + static_cast<int64_t>(t.nb + n0 + r) * 9 * rowb; };
    const auto live = [&](int r) { return n0 + r < p.slice; };
    gemm_steps<NC, 2>(
        rb, 9 * per_tap,
        [&](int s, uint32_t strip) {
          const int tap = s / per_tap, c0 = (s - tap * per_tap) * kStepBytes;
          stage_weights<NC>(strip, [&](int r) { return wrow(r) + tap * rowb; }, live, c0, rowb, g.tow);
        },
        [&](int s, uint32_t strip) {
          const int tap = s / per_tap, k16 = (s - tap * per_tap) * 4, toff = (tap / 3) * p.hw + tap % 3;
          mm.step_mt([&](int mt, int ch) { return a + swz(hr[mt] + toff, k16 + ch, cpr); },
                     [&](int r, int ch) { return strip + swz64(r, ch); }, t.rows);
        });
    stage_acc(mm, sums);
    const int cols = min(NC, p.slice - n0), ch0 = t.nb + n0;
    store_map<NC>(g, t, sums, cols, ch0, g.t1, g.f2);
    store_gn_sums<NC>(g, t, sums, cols, ch0, kGnT);
    __syncthreads();  // the ring is free for the next chunk's copies
  }
  finish_gn(g, t, kGnT, ring);
}


// The towers on tiles of 8 x 16 (128 rows; warpgroup g takes rows 64 g ..
// 64 g + 63) in 128-channel chunks, on wgmma.mma_async m64n128k16: each
// warp's A fragments (its 16 rows, 16 K values) come from the halo of y
// by ldmatrix, as for mma.sync, and B from a shared-memory descriptor over
// a ring of 3 cp.async stages of 64 K values, 128-byte swizzled rows as
// K16's (csrc/fused.cu).  smem: y on the halo, the rows' halo positions
// [128], then the ring (1024-aligned), reused for the sums and the fold.

// grid (ntiles of 8 x 16, image groups, slices of 2f, each a multiple of 128)
__global__ void __launch_bounds__(kMmaThreads, 1) fhead_towers_wg(const Args g, const Pass p) {
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int rowb = 2 * g.f, cpr = rowb / 16;
  int8_t* ys = smem;
  int* rowpos = reinterpret_cast<int*>(smem + align128(p.ipb * p.halo * rowb));
  int8_t* region = reinterpret_cast<int8_t*>(rowpos) + align128(128 * 4);
  const uint32_t raw = smem_u32(region), ring = (raw + 1023) & ~1023u;
  float* sums = reinterpret_cast<float*>(region + (ring - raw));
  fill_rowpos(rowpos, 128, p, t);
  load_rows(ys, t.nimg * p.halo, cpr, [&](int hr) {
    int b, y, x;
    return halo_at(g, p, t, hr, b, y, x) ? bytes(g.y) + pixel(g, b, y, x) * rowb : nullptr;
  }, g.y);
  const int tid = threadIdx.x, l = tid & 31, wgi = tid >> 7, wq = (tid >> 5) & 3;
  const int hr = rowpos[wgi * 64 + wq * 16 + (l & 15)];  // this lane's A row (ldmatrix) at tap (0, 0)
  const uint32_t a = smem_u32(ys);
  for (int n0 = 0; n0 < p.slice; n0 += 128) {
    const int8_t* wbase = bytes(g.tow) + static_cast<int64_t>(t.nb + n0) * 9 * rowb;
    float d[64];
    wg_gemm<128>(d, a, hr, cpr, rowb, 9, p.hw, ring, [&](int r) { return wbase + static_cast<int64_t>(r) * 9 * rowb; },
                    [&](int r) { return n0 + r < p.slice; }, g.tow);
    stage_wg<128>(d, sums);
    const int cols = min(128, p.slice - n0), ch0 = t.nb + n0;
    store_map<128>(g, t, sums, cols, ch0, g.t1, g.f2);
    store_gn_sums<128>(g, t, sums, cols, ch0, kGnT);
    __syncthreads();  // the ring is free for the next chunk's copies
  }
  finish_gn(g, t, kGnT, region);
}

// grid (ntiles, image groups, ceil(nc / 32) + 1): block z < ceil(nc / 32)
// computes classes [32 z, 32 z + 32) from the cls tower, the last block
// cnt|reg from the reg tower, on tiles of 8 x tw, up to 128 rows, on
// wgmma (m64n32k16, or m64n8k16 for the 5 columns of cnt|reg): warpgroup g
// takes rows 64 g .. 64 g + 63.  smem: the tower's GN table [ipb][f],
// ReLU(GN(tw)) on the halo [ipb * halo][f] bf16, the rows' halo positions
// [128], the ring (3 stages of 32 rows of 64 K values, 1024-aligned)
__global__ void __launch_bounds__(kMmaThreads, 2) fhead_pred(const Args g, const Pass p) {
  extern __shared__ __align__(128) int8_t smem[];
  const Blk t = blk_of(g, p);
  const int f = g.f, rowb = 2 * f, cpr = rowb / 16;
  const int q = blockIdx.z, qcls = (g.nc + kPredNC - 1) / kPredNC;
  const bool cls = q < qcls;
  const int half = cls ? 0 : f, n = cls ? min(kPredNC, g.nc - q * kPredNC) : 5;
  float2* tab = reinterpret_cast<float2*>(smem);
  int8_t* ts = smem + align128(p.ipb * f * 8);
  int* rowpos = reinterpret_cast<int*>(ts + align128(p.ipb * p.halo * rowb));
  const uint32_t raw = smem_u32(reinterpret_cast<int8_t*>(rowpos) + align128(128 * 4)), ring = (raw + 1023) & ~1023u;
  fill_rowpos(rowpos, 128, p, t);
  fill_tab(tab, g, t, kGnT, half, f);
  __syncthreads();
  for (int j = threadIdx.x; j < t.nimg * p.halo * (f / 8); j += kMmaThreads) {
    const int o = (j % (f / 8)) * 8, hr = j / (f / 8);
    int b, y, x;
    uint4 word = make_uint4(0u, 0u, 0u, 0u);
    if (halo_at(g, p, t, hr, b, y, x)) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(g.t1 + pixel(g, b, y, x) * g.f2 + half + o));
      const float2* tr = tab + (hr / p.halo) * f + o;
      uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // ReLU(tw * mul + add), each op in bf16 (two channels a word)
        const __nv_bfloat162 m = __floats2bfloat162_rn(tr[2 * k].x, tr[2 * k + 1].x);
        const __nv_bfloat162 a = __floats2bfloat162_rn(tr[2 * k].y, tr[2 * k + 1].y);
        w[k] = as_u32(__hmax2(__hadd2_rn(__hmul2_rn(as_bf2(w[k]), m), a), __float2bfloat162_rn(0.0f)));
      }
      word = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(ts + swz(hr, o / 8, cpr)) = word;
  }
  __syncthreads();
  const int tid = threadIdx.x, l = tid & 31, wgi = tid >> 7, wq = (tid >> 5) & 3;
  const int hr = rowpos[wgi * 64 + wq * 16 + (l & 15)];  // this lane's A row (ldmatrix) at tap (0, 0)
  const int8_t* wbase = cls ? bytes(g.pcls) + static_cast<int64_t>(q) * kPredNC * 9 * rowb : bytes(g.pcr);
  const auto wrow = [&](int r) { return wbase + static_cast<int64_t>(r) * 9 * rowb; };
  const auto live = [&](int r) { return r < n; };
  const int ld = g.nc + 5, coff = cls ? q * kPredNC : g.nc;
  const float* bias = g.bias + (cls ? 1 : 2) * g.wb + (cls ? q * kPredNC : 0);
  // out = bf16(acc + bias) from the accumulators: lane l holds rows l / 4 (+ 8), columns 8 j + 2 (l % 4) (+ 1)
  const auto store = [&](const float* d, int nj) {
#pragma unroll 4
    for (int j = 0; j < nj; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wgi * 64 + wq * 16 + (l >> 2) + 8 * hf;
        if (r >= t.rows) continue;
        const int64_t px = row_pixel(g, t, r);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * (l & 3) + e;
          if (col < n) g.out[px * ld + coff + col] = f2bf(__fadd_rn(d[4 * j + 2 * hf + e], bias[col]));
        }
      }
  };
  if (cls) {
    float d[kPredNC / 2];
    wg_gemm<kPredNC>(d, smem_u32(ts), hr, cpr, rowb, 9, p.hw, ring, wrow, live, wbase);
    store(d, kPredNC / 8);
  } else {
    float d[4];
    wg_gemm<8>(d, smem_u32(ts), hr, cpr, rowb, 9, p.hw, ring, wrow, live, wbase);
    store(d, 1);
  }
}

// shared memory of one block of pass `pass` (ops/head.fhead_smem_bytes); mc
// the towers' GEMM rows (64, or 128 on tiles of 8 x 16)
int smem_of(int pass, int ipb, int halo, int f, int slice, int mc) {
  const int f2 = 2 * f, nc = slice % 128 == 0 ? 128 : 64;
  const int wg = kWgRegion > fold_bytes(f2) ? kWgRegion : fold_bytes(f2);  // a wgmma kernel's ring, sums, fold
  switch (pass) {
    case kPw1:
      return align128(mc * 2 * f) + (mc == 128 ? wg : ring_or_sums(nc, f2, 2));
    case kDw: {
      const int u = align128(ipb * halo * slice * 2), fb = fold_bytes(f2);
      return align128(ipb * slice * 8) + (u > fb ? u : fb) + 2 * ((kT * kT + kPos - 1) / kPos) * ipb * slice * 4;
    }
    case kPw2:
      return align128(ipb * f2 * 8) + align128(kMC * 2 * f2) + ring_or_sums(nc, f2, 1);
    case kTowers:
      return align128(ipb * halo * 2 * f) + align128(mc * 4) + (mc == 128 ? wg : ring_or_sums(nc, f2, 2));
    default:  // pred: its ring 1024-aligned
      return align128(ipb * f * 8) + align128(ipb * halo * 2 * f) + align128(128 * 4) + 3 * kPredNC * 128 + 1024;
  }
}

// the kernel of a pass for blocks of mc rows (128: wgmma, slices of 128
// channels) and a channel slice
const void* kernel_of(int pass, int slice, int mc) {
  const bool n128 = slice % 128 == 0;
  switch (pass) {
    case kPw1:
      if (mc == 128) return (const void*)fhead_pw1<128, 128>;
      return n128 ? (const void*)fhead_pw1<64, 128> : (const void*)fhead_pw1<64, 64>;
    case kDw:
      return (const void*)fhead_dw;
    case kPw2:
      return n128 ? (const void*)fhead_pw2<128> : (const void*)fhead_pw2<64>;
    case kTowers:
      if (mc == 128) return (const void*)fhead_towers_wg;
      return n128 ? (const void*)fhead_towers<128> : (const void*)fhead_towers<64>;
    default:
      return (const void*)fhead_pred;
  }
}

// the launch geometry of a pass on tiles of 8 x tw
Pass pass_of(int h, int w, int ipb, int slice, int tw) {
  Pass p;
  p.ipb = ipb;
  p.slice = slice;
  p.tw = tw;
  p.tiles_x = (w + tw - 1) / tw;
  p.ntiles = p.tiles_x * ((h + kT - 1) / kT);
  p.hw = (w < tw ? w : tw) + 2;
  p.halo = ((h < kT ? h : kT) + 2) * p.hw;
  return p;
}

// GEMM rows of a pass's fullest block
int rows_of(int h, int w, int ipb, int tw) { return ipb * (h < kT ? h : kT) * (w < tw ? w : tw); }

int tiles_of(int h, int w) { return ((w + kT - 1) / kT) * ((h + kT - 1) / kT); }

}  // namespace

// Scratch one call needs: sizes[0] bf16 elements (t1 / tw, t2, y), sizes[1]
// f32 elements (the partial sums, the folded vectors, the counters).
extern "C" void hishead_scratch_sizes(int b, int h, int w, int f, long long* sizes) {
  const long long hw = static_cast<long long>(h) * w, f2 = 2LL * f;
  sizes[0] = b * hw * (2 * f2 + f);
  sizes[1] = kFolds * b * (tiles_of(h, w) + 1LL) * 2 * f2 + kFolds * b;
}

// Shared memory of one block of pass `pass` (0 pw1, 1 dw, 2 pw2, 3 towers,
// 4 pred) with ipb images a block, `split` channel slices and tiles of 8 x
// tw, for the level's h, w and f (the chooser's arithmetic, held against
// this).
extern "C" int hishead_smem_bytes(int pass, int ipb, int h, int w, int f, int split, int tw) {
  const int n = pass == kPw2 ? f : 2 * f;
  const Pass p = pass_of(h, w, ipb, pass == kPred ? kPredNC : n / split, tw);
  return smem_of(pass, ipb, p.halo, f, p.slice, rows_of(h, w, ipb, tw) <= kMC ? kMC : 128);
}

// x [B, H, W, f] bf16 NHWC -> out [B, H, W, nc + 5] bf16; the weights in the
// layouts of Args, f a multiple of 32 up to 256, every pointer 16-byte
// aligned.  cfg: (images a block, channel slices, tile width) of pw1, dw,
// pw2, towers and pred (ops/head.pick_fhead_tile; pred's slices are
// ceil(nc / 32) + 1; all but dw take tiles of 8 x 16 and blocks of 128
// rows, on wgmma, with slices of 128 channels).  Returns a
// cudaError_t (0 = all five launched).
extern "C" int hishead_launch(const void* x, const void* pw1, const void* dw, const void* pw2, const void* tow,
                              const void* pcls, const void* pcr, const void* gn, const void* bias, int wb, void* out,
                              void* scratch_bf16, void* scratch_f32, int b, int h, int w, int f, int nc,
                              const int* cfg, void* stream) {
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
  g.batch = b;
  g.h = h;
  g.w = w;
  g.f = f;
  g.f2 = 2 * f;
  g.nc = nc;
  g.wb = wb;
  g.pmax = tiles_of(h, w);
  if (f % kGroups || f > 256 || nc < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(b) * h * w;
  g.t1 = static_cast<uint16_t*>(scratch_bf16);
  g.t2 = g.t1 + rows * g.f2;
  g.y = g.t2 + rows * g.f2;
  g.part = static_cast<float*>(scratch_f32);
  g.fold = g.part + static_cast<int64_t>(kFolds) * b * g.pmax * 2 * g.f2;
  g.count = reinterpret_cast<int*>(g.fold + static_cast<int64_t>(kFolds) * b * 2 * g.f2);

  static int optin = -1;  // every kernel may take all the shared memory a block can opt in to
  if (optin < 0) {
    int dev = 0, bytes_ = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&bytes_, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int ps = 0; ps < kPasses; ++ps)
      for (int slice = 64; slice <= 128; slice += 64)
        for (int mc = 64; mc <= 128; mc += 64)
          if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel_of(ps, slice, mc), cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_);
    if (err != cudaSuccess) return static_cast<int>(err);
    optin = bytes_;
  }
  Pass pass[kPasses];
  int split[kPasses], mc[kPasses];
  for (int ps = 0; ps < kPasses; ++ps) {
    const int ipb = cfg[3 * ps], tw = cfg[3 * ps + 2], n = ps == kPw2 ? f : 2 * f;
    split[ps] = ps == kPred ? (nc + kPredNC - 1) / kPredNC + 1 : cfg[3 * ps + 1];
    const bool wide = ps == kPw1 || ps == kTowers || ps == kPred;  // 8x16 tiles, 128 rows (wgmma)
    if (ipb < 1 || (tw != kT && !(tw == 16 && wide)) || (b + ipb - 1) / ipb > 65535 ||
        (ps != kPred && (split[ps] < 1 || n % split[ps] || (n / split[ps]) % 16)))
      return static_cast<int>(cudaErrorInvalidValue);
    const int r = rows_of(h, w, ipb, tw);
    mc[ps] = r <= kMC ? kMC : 128;
    if (r > (wide ? 128 : kMC) || (r > kMC && ps != kPred && (n / split[ps]) % 128))
      return static_cast<int>(cudaErrorInvalidValue);
    pass[ps] = pass_of(h, w, ipb, ps == kPred ? kPredNC : n / split[ps], tw);
  }
  g.target[kGn1] = pass[kPw1].ntiles * split[kPw1];
  g.target[kGn2] = pass[kDw].ntiles * split[kDw];
  g.target[kGnT] = pass[kTowers].ntiles * split[kTowers];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(g.count, 0, sizeof(int) * kFolds * b, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[2] = {&g, nullptr};
  for (int ps = 0; ps < kPasses; ++ps) {
    const int smem = smem_of(ps, pass[ps].ipb, pass[ps].halo, f, pass[ps].slice, mc[ps]);
    if (smem > optin) return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid(pass[ps].ntiles, (b + pass[ps].ipb - 1) / pass[ps].ipb, split[ps]);
    args[1] = &pass[ps];
    err = cudaLaunchKernel(kernel_of(ps, pass[ps].slice, mc[ps]), grid, dim3(kMmaThreads), args, smem, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
