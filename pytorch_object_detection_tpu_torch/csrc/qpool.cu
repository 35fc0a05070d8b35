// K6: int8 2x2 / stride 2 max pool (VALID), NHWC; and K10: int8 3x3 /
// stride 2 max pool, padding 1, NHWC.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_pool.py:qmaxpool2x2, the
// HisFPN's downsamples and extra-level seeds.  That kernel keeps row bands of
// one image in VMEM and takes bf16 maxes over int8 values; it falls back to
// XLA's reduce_window for odd sizes or C % 128.  Here one thread makes one
// 16-byte word of one output position from four 16-byte loads (per-byte
// signed max, __vmaxs4), for every H, W (odd sizes floor, as VALID does);
// channel counts that are not a multiple of 16 take the one-byte form.
//
// Bound on the card: device memory.  Each input byte is read once and each
// output byte written once (1.25 bytes moved per input byte); there is no
// arithmetic to speak of.  At the pyramid's sizes (<= 4 MB per call at B=8)
// a call is as short as a launch, so launch cost, not bandwidth, dominates.
// So the HisFPN launches it once: its two seeds, seed6 = pool(t5) and
// seed7 = pool(seed6), come from one read of t5 (qpool_seeds: one thread
// makes a 2x2 block of seed6 words from a 4x4 window and, where the block is
// whole, their max, the seed7 word: floor(floor(h / 2) / 2) = floor(h / 4));
// the four level pools run inside K5's producer load (csrc/qhis.cu,
// combine pool_add).
//
// K10 replaces pytorch_object_detection_tpu/ops/pallas_pool.py:qmaxpool3x3s2,
// the pool after the direct 7x7/2 uint8 stem conv (the PODT_STEM_XLA7 path).
// That kernel takes one image's map in VMEM, merges column pairs into the
// lanes and takes bf16 maxes; it falls back to reduce_window for odd sizes,
// and can emit the row-pair lane-merged layout of the TPU's stage-1
// kernels, which the port does not have.  Bound on the card: device memory,
// the map read once and the quarter-size output written once.
//
// A block owns a band of `rows` output rows across a span of `cols` output
// columns, all channels (ops/qpool.pick_pool3_tile picks them: 2 x 64 on the
// 512x512 stem map).  It stages the band's 2 * rows + 1 input rows over
// 2 * cols + 1 columns once in shared memory, every 16-byte word by one
// cp.async with all of a thread's copies in flight together, so each input
// byte leaves device memory once, plus the shared halo row and column of
// 1 / (2 rows) and 1 / (2 cols).  The padding needs no value: a row or
// column outside the map is staged as its clamped neighbour, which lies in
// the same window (every window holds row 2y and column 2x), so the max is
// unchanged.  Then each thread makes one 16-byte output word from the nine
// staged words of its window (per-byte signed max, __vmaxs4); threads of
// odd columns take the three columns of a tap row in a rotated order, so a
// quarter warp's 16-byte reads cover all 32 banks at 64 channels.  Stores
// are 16-byte and coalesced; indices are 32-bit within an image.  Any H and
// W, output (H - 1) / 2 + 1; C % 16 != 0 takes the one-byte form.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int vmax(int a, int b) {
  return static_cast<int>(__vmaxs4(static_cast<unsigned>(a), static_cast<unsigned>(b)));
}

// grid-stride over [B, Ho, Wo, C / 16] 16-byte words
__global__ void __launch_bounds__(kThreads)
    qpool_vec16(const int4* __restrict__ x, int4* __restrict__ out, int h, int w, int c16, int ho, int wo,
                int64_t total) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(i % c16);
    int64_t p = i / c16;
    const int ox = static_cast<int>(p % wo);
    p /= wo;
    const int oy = static_cast<int>(p % ho);
    const int64_t b = p / ho;
    const int4* r0 = x + ((b * h + 2 * oy) * w + 2 * ox) * c16 + c;
    const int4* r1 = r0 + static_cast<int64_t>(w) * c16;
    const int4 a = __ldg(r0), bb = __ldg(r0 + c16), cc = __ldg(r1), d = __ldg(r1 + c16);
    out[i] = make_int4(vmax(vmax(a.x, bb.x), vmax(cc.x, d.x)), vmax(vmax(a.y, bb.y), vmax(cc.y, d.y)),
                       vmax(vmax(a.z, bb.z), vmax(cc.z, d.z)), vmax(vmax(a.w, bb.w), vmax(cc.w, d.w)));
  }
}

// the seeds: grid-stride over [B, ceil(Ho / 2), ceil(Wo / 2), C / 16]
// words, Ho = H / 2 (seed6's size), H7 = Ho / 2 (seed7's): item (b, qy, qx,
// c) writes seed6 at rows 2 qy .. 2 qy + 1, columns 2 qx .. 2 qx + 1 (those
// inside it) and, where all four are, seed7 at (qy, qx).  C % 16 == 0 (t5
// has 2 x K5's half channels, a multiple of 16).
__device__ __forceinline__ int4 max2(const int4& a, const int4& b) {
  return make_int4(vmax(a.x, b.x), vmax(a.y, b.y), vmax(a.z, b.z), vmax(a.w, b.w));
}

__global__ void __launch_bounds__(kThreads)
    qpool_seeds(const int4* __restrict__ x, int4* __restrict__ s6, int4* __restrict__ s7, int h, int w, int cw,
                int ho, int wo, int64_t total) {
  const int qh = (ho + 1) / 2, qw = (wo + 1) / 2, h7 = ho / 2, w7 = wo / 2;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(i % cw);
    int64_t p = i / cw;
    const int qx = static_cast<int>(p % qw);
    p /= qw;
    const int qy = static_cast<int>(p % qh);
    const int64_t b = p / qh;
    int4 m6[2][2];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int oy = 2 * qy + dy, ox = 2 * qx + dx;
        if (oy >= ho || ox >= wo) continue;
        const int4* r0 = x + ((b * h + 2 * oy) * w + 2 * ox) * cw + c;
        const int4* r1 = r0 + static_cast<int64_t>(w) * cw;
        m6[dy][dx] = max2(max2(__ldg(r0), __ldg(r0 + cw)), max2(__ldg(r1), __ldg(r1 + cw)));
        s6[((b * ho + oy) * wo + ox) * cw + c] = m6[dy][dx];
      }
    if (qy < h7 && qx < w7)
      s7[((b * h7 + qy) * w7 + qx) * cw + c] = max2(max2(m6[0][0], m6[0][1]), max2(m6[1][0], m6[1][1]));
  }
}

// the same over single bytes, for C % 16 != 0
__global__ void __launch_bounds__(kThreads)
    qpool_byte(const int8_t* __restrict__ x, int8_t* __restrict__ out, int h, int w, int c, int ho, int wo,
               int64_t total) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int ch = static_cast<int>(i % c);
    int64_t p = i / c;
    const int ox = static_cast<int>(p % wo);
    p /= wo;
    const int oy = static_cast<int>(p % ho);
    const int64_t b = p / ho;
    const int8_t* r0 = x + ((b * h + 2 * oy) * w + 2 * ox) * c + ch;
    const int8_t* r1 = r0 + static_cast<int64_t>(w) * c;
    const int m0 = max(static_cast<int>(r0[0]), static_cast<int>(r0[c]));
    const int m1 = max(static_cast<int>(r1[0]), static_cast<int>(r1[c]));
    out[i] = static_cast<int8_t>(max(m0, m1));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

struct Pool3Args {
  const int4* x;
  int4* out;
  int h, w, c16;   // input rows, columns, 16-byte words a pixel (C / 16)
  int ho, wo;
  int rows, cols;  // output rows and columns a block
};

// K10: grid (spans, bands, B); dynamic smem: the staged input
// [2 * rows + 1][2 * cols + 1][c16] words
__global__ void __launch_bounds__(kThreads) qpool3_band(const Pool3Args g) {
  extern __shared__ __align__(16) int4 st[];
  const int c16 = g.c16;
  const int oy0 = blockIdx.y * g.rows, ox0 = blockIdx.x * g.cols;
  const int nro = min(g.rows, g.ho - oy0), nco = min(g.cols, g.wo - ox0);
  const int nri = 2 * nro + 1, seg = (2 * nco + 1) * c16;  // staged rows, words a staged row
  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - 1;
  const int4* img = g.x + static_cast<size_t>(blockIdx.z) * g.h * g.w * c16;

  // 1. the band's input rows, clamped into the map, into shared memory
  for (int r = 0; r < nri; ++r) {
    const int4* row = img + min(max(iy0 + r, 0), g.h - 1) * g.w * c16;
    for (int j = threadIdx.x; j < seg; j += kThreads) {
      const int col = j / c16;
      cp_async16(st + r * seg + j, row + min(max(ix0 + col, 0), g.w - 1) * c16 + (j - col * c16));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. the 3x3 max of one 16-byte word of one output position
  const int nout = nro * nco * c16;
  int4* out = g.out + static_cast<size_t>(blockIdx.z) * g.ho * g.wo * c16;
  for (int o = threadIdx.x; o < nout; o += kThreads) {
    const int p = o / c16, q = o - p * c16, oyl = p / nco, oxl = p - oyl * nco;
    const int rot = oxl & 1;
    const int4* win = st + (2 * oyl * (2 * nco + 1) + 2 * oxl) * c16 + q;
    int4 m = win[rot * c16];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int dx = k + rot < 3 ? k + rot : k + rot - 3;
        const int4 v = win[dy * seg + dx * c16];
        m = make_int4(vmax(m.x, v.x), vmax(m.y, v.y), vmax(m.z, v.z), vmax(m.w, v.w));
      }
    }
    out[((oy0 + oyl) * g.wo + ox0 + oxl) * c16 + q] = m;
  }
}

int pool3_smem_bytes(int c, int rows, int cols) { return (2 * rows + 1) * (2 * cols + 1) * c; }

// the same over single bytes, for C % 16 != 0
__global__ void __launch_bounds__(kThreads)
    qpool3_byte(const int8_t* __restrict__ x, int8_t* __restrict__ out, int h, int w, int c, int ho, int wo,
                int64_t total) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int ch = static_cast<int>(i % c);
    int64_t p = i / c;
    const int ox = static_cast<int>(p % wo);
    p /= wo;
    const int oy = static_cast<int>(p % ho);
    const int64_t b = p / ho;
    int m = -128;
    for (int iy = max(2 * oy - 1, 0); iy <= min(2 * oy + 1, h - 1); ++iy)
      for (int ix = max(2 * ox - 1, 0); ix <= min(2 * ox + 1, w - 1); ++ix)
        m = max(m, static_cast<int>(x[((b * h + iy) * w + ix) * c + ch]));
    out[i] = static_cast<int8_t>(m);
  }
}

int grid_for(int64_t total) {
  const int64_t want = (total + kThreads - 1) / kThreads;
  return static_cast<int>(want < (1 << 20) ? want : (1 << 20));
}

}  // namespace

// x [B, H, W, C] int8 NHWC contiguous (16-byte aligned when C % 16 == 0);
// out [B, H / 2, W / 2, C].  Returns a cudaError_t (0 = launched).
extern "C" int qpool_launch(const void* x, void* out, int batch, int h, int w, int c, void* stream) {
  const int ho = h / 2, wo = w / 2;
  const bool vec = c % 16 == 0;
  const int64_t total = static_cast<int64_t>(batch) * ho * wo * (vec ? c / 16 : c);
  if (total == 0) return 0;
  const int blocks = grid_for(total);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    qpool_vec16<<<blocks, kThreads, 0, s>>>(static_cast<const int4*>(x), static_cast<int4*>(out), h, w, c / 16,
                                           ho, wo, total);
  } else {
    qpool_byte<<<blocks, kThreads, 0, s>>>(static_cast<const int8_t*>(x), static_cast<int8_t*>(out), h, w, c, ho,
                                          wo, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6, the HisFPN's seeds: x [B, H, W, C] int8 NHWC contiguous, 16-byte
// aligned, C % 16 == 0; s6 [B, H / 2, W / 2, C], s7 [B, H / 2 / 2, W / 2 /
// 2, C], each its own allocation.  Returns a cudaError_t (0 = launched).
extern "C" int qpool_seeds_launch(const void* x, void* s6, void* s7, int batch, int h, int w, int c, void* stream) {
  if (c % 16) return static_cast<int>(cudaErrorInvalidValue);
  const int ho = h / 2, wo = w / 2, cw = c / 16;
  const int64_t total = static_cast<int64_t>(batch) * ((ho + 1) / 2) * ((wo + 1) / 2) * cw;
  if (total == 0 || ho == 0 || wo == 0) return 0;
  qpool_seeds<<<grid_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(s6), static_cast<int4*>(s7), h, w, cw, ho, wo, total);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a K10 block (ops/qpool.pool3_smem_bytes holds the same sum).
extern "C" int qpool3_smem_bytes(int c, int rows, int cols) { return pool3_smem_bytes(c, rows, cols); }

// K10: x [B, H, W, C] int8 NHWC contiguous (16-byte aligned when C % 16 ==
// 0); out [B, (H - 1) / 2 + 1, (W - 1) / 2 + 1, C], 16-byte aligned when C %
// 16 == 0; rows x cols output positions a block (the one-byte form, C % 16
// != 0, ignores them).  Returns a cudaError_t (0 = launched).
extern "C" int qpool3_launch(const void* x, void* out, int batch, int h, int w, int c, int rows, int cols,
                             void* stream) {
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  if (batch == 0 || h == 0 || w == 0 || c == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 16) {
    const int64_t total = static_cast<int64_t>(batch) * ho * wo * c;
    qpool3_byte<<<grid_for(total), kThreads, 0, s>>>(static_cast<const int8_t*>(x), static_cast<int8_t*>(out), h,
                                                    w, c, ho, wo, total);
    return static_cast<int>(cudaGetLastError());
  }
  if (rows < 1 || cols < 1 || batch > 65535 || (ho + rows - 1) / rows > 65535 ||
      static_cast<int64_t>(h) * w * c >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Pool3Args g{static_cast<const int4*>(x), static_cast<int4*>(out), h, w, c / 16, ho, wo, rows, cols};
  const int smem = pool3_smem_bytes(c, rows, cols);
  static int opted = 48 * 1024;  // dynamic shared memory the kernel may take
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(qpool3_band, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const dim3 grid((wo + cols - 1) / cols, (ho + rows - 1) / rows, batch);
  qpool3_band<<<grid, kThreads, smem, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}
