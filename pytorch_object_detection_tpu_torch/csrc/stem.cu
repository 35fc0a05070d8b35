// K17: the bf16 stem tail in one pass: BN + ReLU (bf16), 3x3 / stride 2 max
// pool (padding 1), int8 quantize; NHWC in, NHWC out.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_stem.py:stem_bn_pool_quant
// (backend="pallas_stem_tail").  The stem conv's bf16 output is the largest
// activation of the network ([B, 256, 256, 64] at 512x512); the TPU kernel
// reads it once per image from VMEM in row chunks, with pair-reduce pooling,
// and writes the pooled int8 map once.  Bound on the card: device memory,
// the bf16 map read once and the int8 map written once.
//
// A block owns a band of `rows` pooled rows across a span of `cols` pooled
// columns, all channels (ops/stem.pick_stem_tail_tile picks the band and
// span: 8 x 8 on the 512x512 canvas, five blocks an SM).  It reads the
// band's 2 * rows + 1 input rows (the first one the halo it shares with
// the band above, read again, not kept) over 2 * cols + 1 columns once, in
// 16-byte words with four loads in flight a thread, applies BN + ReLU once
// an element as bf16x2 operations and keeps the result in shared memory;
// zero stands for the padding (every window holds a real value, and y >=
// 0).  One bulk copy a row measured 3x slower: the block then waits for
// its whole band before any BN.  Then each thread takes the 3x3 max of 16
// channels of one pooled position from shared memory (bf16x2 max, exact),
// quantizes them in f32 and writes them as one 16-byte word (8 channels,
// 8 bytes, where C is not a multiple of 16).  Indices are 32-bit within an
// image.
//
// The arithmetic is the JAX kernel's, step by step:
//   y  = max(bf16(bf16(t * mult_b) + shift_b), 0)   each op rounded to bf16
//   p  = max of y over the window, zero padding     (exact: y >= 0 and every
//                                                    window holds a real value)
//   q  = clip(rint(f32(p) * inv_s), -127, 127)      inv_s = 1 / scale in f32
// __hmul2_rn / __hadd2_rn round each bf16 product and sum once, as the f32
// operation rounded to bf16 does: the product of two bf16 values is exact in
// f32, and a sum of two bf16 values that is not exact in f32 has one term
// below half a bf16 step of the other, so both round alike (the same as
// PyTorch's bf16 elementwise ops).  inv_s is the IEEE f32 reciprocal, as
// torch's 1 / scale; the multiply is __fmul_rn, rintf rounds half to even.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;  // 16-byte loads in flight a thread (8 measured slower)

struct Args {
  const uint4* x;
  const uint4* mult;
  const uint4* shift;
  const float* scale;
  int8_t* out;
  int h, w, upp;  // input rows, columns, 16-byte units a pixel (C / 8)
  int ho, wo;
  int rows, cols;  // pooled rows and columns a block
};

__device__ __forceinline__ uint4 bn_relu(uint4 t, uint4 m, uint4 s) {
  __nv_bfloat162 a[4], b[4], c[4];
  memcpy(a, &t, 16);
  memcpy(b, &m, 16);
  memcpy(c, &s, 16);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __hmax2(__hadd2_rn(__hmul2_rn(a[i], b[i]), c[i]), zero);
  memcpy(&t, a, 16);
  return t;
}

__device__ __forceinline__ uint4 max4(uint4 a, uint4 b) {
  __nv_bfloat162 x[4], y[4];
  memcpy(x, &a, 16);
  memcpy(y, &b, 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __hmax2(x[i], y[i]);
  memcpy(&a, x, 16);
  return a;
}

// 8 pooled bf16 values -> 8 int8 in one 64-bit word
__device__ __forceinline__ uint2 quant8(uint4 p, float inv) {
  __nv_bfloat162 v[4];
  memcpy(v, &p, 16);
  int8_t q[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(v[i]);
    q[2 * i] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(f.x, inv)), -127.0f), 127.0f)));
    q[2 * i + 1] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(f.y, inv)), -127.0f), 127.0f)));
  }
  uint2 r;
  memcpy(&r, q, 8);
  return r;
}

// grid (spans, bands, B); dynamic smem: mult and shift (upp units each),
// then y [2 * rows + 1][2 * cols + 1][upp] units.  kCPT channels a pool
// thread: 16 (two units, one 16-byte store) or 8.
template <int kCPT>
__global__ void __launch_bounds__(kThreads) stem_tail_kernel(const Args g) {
  extern __shared__ __align__(16) uint4 sm[];
  constexpr int kU = kCPT / 8;  // units a pool thread
  const int upp = g.upp;
  uint4* ms = sm;
  uint4* ys = sm + 2 * upp;
  const int oy0 = blockIdx.y * g.rows, ox0 = blockIdx.x * g.cols;
  const int nro = min(g.rows, g.ho - oy0), nco = min(g.cols, g.wo - ox0);
  const int nri = 2 * nro + 1, nci = 2 * nco + 1;
  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - 1;
  const uint4* img = g.x + static_cast<size_t>(blockIdx.z) * g.h * g.w * upp;
  for (int i = threadIdx.x; i < 2 * upp; i += kThreads) ms[i] = i < upp ? g.mult[i] : g.shift[i - upp];
  __syncthreads();

  // 1. the band's input rows, BN + ReLU once an element, into shared memory
  const int seg = nci * upp, total = nri * seg;
  for (int base = threadIdx.x; base < total; base += kThreads * kLoads) {
    uint4 v[kLoads];
    int unit[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = base + k * kThreads;
      unit[k] = -1;  // outside the band, or the zero pad
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total) {
        const int r = i / seg, rem = i - r * seg, col = rem / upp, u = rem - col * upp;
        const int iy = iy0 + r, ix = ix0 + col;
        if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w) {
          v[k] = __ldg(img + (iy * g.w + ix) * upp + u);
          unit[k] = u;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = base + k * kThreads;
      if (i < total) ys[i] = unit[k] < 0 ? v[k] : bn_relu(v[k], ms[unit[k]], ms[upp + unit[k]]);
    }
  }
  __syncthreads();

  // 2. the 3x3 max of kCPT channels of one pooled position, quantized
  const float inv = 1.0f / __ldg(g.scale);
  const int gpp = upp / kU;  // pool threads a pooled position
  const int nout = nro * nco * gpp;
  int8_t* out = g.out + static_cast<size_t>(blockIdx.z) * g.ho * g.wo * upp * 8;
  for (int o = threadIdx.x; o < nout; o += kThreads) {
    const int q = o % gpp, p = o / gpp, oxl = p % nco, oyl = p / nco;
    // odd columns read their two units in the other order: the quarter
    // warp's 16-byte reads then cover all 32 banks
    const int first = kU == 2 ? (oxl & 1) : 0;
    uint4 best[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) best[k] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint4* src = ys + ((2 * oyl + dy) * nci + 2 * oxl + dx) * upp + q * kU;
#pragma unroll
        for (int k = 0; k < kU; ++k) {
          const int kk = k ^ first;
          best[kk] = max4(best[kk], src[kk]);
        }
      }
    }
    int8_t* dst = out + ((oy0 + oyl) * g.wo + ox0 + oxl) * upp * 8 + q * kCPT;
    if (kU == 2) {
      const uint2 lo = quant8(best[0], inv), hi = quant8(best[kU - 1], inv);
      *reinterpret_cast<uint4*>(dst) = make_uint4(lo.x, lo.y, hi.x, hi.y);
    } else {
      *reinterpret_cast<uint2*>(dst) = quant8(best[0], inv);
    }
  }
}

int smem_bytes(int c, int rows, int cols) { return (2 + (2 * rows + 1) * (2 * cols + 1)) * (c / 8) * 16; }

template <int kCPT>
int launch(const Args& g, int batch, int smem, cudaStream_t stream) {
  auto fn = stem_tail_kernel<kCPT>;
  static int opted = 48 * 1024;  // dynamic shared memory this kernel may take
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const dim3 grid((g.wo + g.cols - 1) / g.cols, (g.ho + g.rows - 1) / g.rows, batch);
  fn<<<grid, kThreads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of a block (ops/stem.stem_tail_smem_bytes holds the same sum).
extern "C" int stem_tail_smem_bytes(int c, int rows, int cols) { return smem_bytes(c, rows, cols); }

// x [B, H, W, C] bf16 NHWC contiguous, 16-byte aligned; mult, shift bf16
// [C], 16-byte aligned; scale one f32 on the device; out [B, (H - 1) / 2 +
// 1, (W - 1) / 2 + 1, C] int8, 16-byte aligned.  C a multiple of 8; rows x
// cols pooled positions a block.  Returns a cudaError_t (0 = launched).
extern "C" int stem_tail_launch(const void* x, const void* mult, const void* shift, const void* scale, void* out,
                                int batch, int h, int w, int c, int rows, int cols, void* stream) {
  Args g;
  g.x = static_cast<const uint4*>(x);
  g.mult = static_cast<const uint4*>(mult);
  g.shift = static_cast<const uint4*>(shift);
  g.scale = static_cast<const float*>(scale);
  g.out = static_cast<int8_t*>(out);
  g.h = h;
  g.w = w;
  g.upp = c / 8;
  g.ho = (h - 1) / 2 + 1;
  g.wo = (w - 1) / 2 + 1;
  g.rows = rows;
  g.cols = cols;
  if (c % 8 || c < 8 || rows < 1 || cols < 1 || batch > 65535 || (g.ho + rows - 1) / rows > 65535 ||
      static_cast<int64_t>(h) * w * c / 8 >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || h == 0 || w == 0) return 0;
  const int smem = smem_bytes(c, rows, cols);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return c % 16 == 0 ? launch<16>(g, batch, smem, st) : launch<8>(g, batch, smem, st);
}
