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
//            x1q  = clip8(silu(conv1(x) * A1 + B1) * inv_x1)     (1x1, cin -> half)
//            x2q  = clip8(conv2(x) * A2 + B2)                    (1x1, cin -> half)
//            sum[b][c] += x1q  (int32: exact in any order; block sums, then atomics)
//   mid      g    = sigmoid(silu(mean @ se_w1 + se_b1) @ se_w2 + se_b2), f32, per
//                   image in every block's prologue, mean = float(sum) / (H*W) * premul
//            aq   = clip8(relu(dw3x3(x1q) * Adw + Bdw))
//            bq   = clip8(x1q * g)
//            mq   = clip8(relu(conv3x3([aq, bq]) * A3 + B3))      (cin -> half)
//   out      out  = clip8(silu(conv3x3_dil2([mq, x2q]) * A4 + B4) * inv_out)  (cin -> cin)
//
// Convs pad with zeros in the int8 domain, as the reference does.  The
// producer owns 64 positions of one image; each consumer owns an 8 x 8 tile
// of one image and recomputes its halo from device memory: mid reads x1q
// with a 2-row/column halo and builds [aq, bq] with a 1-halo in shared
// memory; out reads [mq, x2q] with the dilation's 2-halo.  Shifts past the
// edge of a tiny level (4x4 and below) read the zero fill.  Convs use the
// __dp4a tile of int8_common.cuh (8 positions x 4 channels per thread,
// weights [out][taps][in] through L1/L2); channel counts must be multiples
// of 16 (half) and 32 (cin).
//
// Bound on the card: int8 multiply-adds (about 951 k per position, 6.4 G
// per 512^2 image, 95 % in conv3 and conv4), run here on the CUDA cores
// with dp4a, not the tensor cores; device memory moves a few bytes per
// multiply-add thousand.  Tensor cores (mma.sync / wgmma) are the next step.
//
// Against the plain version (nn/fpn_int8's per-op oracle): the int8 convs are
// exact and the epilogues use separate __fmul_rn / __fadd_rn under
// -fmad=false, but SiLU and sigmoid use expf and the SE dots sum in another
// order than the plain matmul, so an output can differ by one int8 step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 64;            // producer: positions per block
constexpr int kTR = 8, kTC = 8;    // consumers: output tile

struct Args {
  const int8_t* xa;  // [B, Ha, Wa, cin]
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
  int h, w, cin, half, r, combine;  // combine: 0 none, 1 add, 2 up_add
};

__device__ __forceinline__ float silu(float z) {
  return __fmul_rn(z, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))));
}

__device__ __forceinline__ float sigmoid(float z) { return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))); }

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((d & 0xff) << 24);
}

__device__ __forceinline__ int8_t byte_of(int v, int i) { return static_cast<int8_t>((v >> (8 * i)) & 0xff); }

// clip8(a * ca + b * cb) on four bytes
__device__ __forceinline__ int combine4(int a, int b, float ca, float cb) {
  int8_t q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = clip8(__fadd_rn(__fmul_rn(static_cast<float>(byte_of(a, i)), ca),
                           __fmul_rn(static_cast<float>(byte_of(b, i)), cb)));
  return pack4(q[0], q[1], q[2], q[3]);
}

// grid (ceil(H*W / kTP), B); dynamic smem: x [kTP][cin] int8, then half int32 sums
__global__ void __launch_bounds__(kThreads) his_produce(const Args g) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* xs = smem;
  int* sums = reinterpret_cast<int*>(smem + kTP * g.cin);
  const int b = blockIdx.y, hw = g.h * g.w, p0 = blockIdx.x * kTP;
  const int npos = min(kTP, hw - p0);
  const int tid = threadIdx.x, c16 = g.cin / 16;
  const float ca = g.sc[3], cb = g.sc[4];

  for (int c = tid; c < g.half; c += kThreads) sums[c] = 0;
  for (int i = tid; i < kTP * c16; i += kThreads) {
    const int pos = i / c16, c = (i % c16) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (pos < npos) {
      const int p = p0 + pos;
      const int64_t at = (static_cast<int64_t>(b) * hw + p) * g.cin + c;
      if (g.combine == 0) {
        v = __ldg(reinterpret_cast<const int4*>(g.xa + at));
      } else {
        int64_t at_a = at;
        if (g.combine == 2) {  // the coarser level, 2x nearest upsample
          const int y = p / g.w, x = p % g.w;
          at_a = ((static_cast<int64_t>(b) * (g.h / 2) + y / 2) * (g.w / 2) + x / 2) * g.cin + c;
        }
        const int4 a = __ldg(reinterpret_cast<const int4*>(g.xa + at_a));
        const int4 bb = __ldg(reinterpret_cast<const int4*>(g.xb + at));
        v = make_int4(combine4(a.x, bb.x, ca, cb), combine4(a.y, bb.y, ca, cb), combine4(a.z, bb.z, ca, cb),
                      combine4(a.w, bb.w, ca, cb));
      }
    }
    *reinterpret_cast<int4*>(xs + pos * g.cin + c) = v;
  }
  __syncthreads();

  // conv1 | conv2: outputs [0, half) from w1, [half, 2 half) from w2
  const float inv_x1 = g.sc[0];
  const int groups = 2 * g.half / kQ;
  const int items = (npos + kP - 1) / kP * groups;
  for (int it = tid; it < items; it += kThreads) {
    const int o = (it % groups) * kQ, pg = (it / groups) * kP;
    const bool first = o < g.half;
    const int oc = first ? o : o - g.half;
    const int8_t* act[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) act[p] = xs + min(pg + p, npos - 1) * g.cin;
    int acc[kP][kQ];
    zero(acc);
    dot_tile(acc, act, (first ? g.w1 : g.w2) + static_cast<int64_t>(oc) * g.cin, g.cin, g.cin);
    int part[kQ] = {0, 0, 0, 0};
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (pg + p >= npos) break;
      int8_t q[kQ];
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        if (first) {
          q[k] = clip8(__fmul_rn(silu(epilogue(acc[p][k], g.a1[oc + k], g.b1[oc + k])), inv_x1));
          part[k] += q[k];
        } else {
          q[k] = clip8(epilogue(acc[p][k], g.a2[oc + k], g.b2[oc + k]));
        }
      }
      const int64_t at = (static_cast<int64_t>(b) * hw + p0 + pg + p) * g.half + oc;
      *reinterpret_cast<int*>((first ? g.x1q : g.x2q) + at) = pack4(q[0], q[1], q[2], q[3]);
    }
    if (first)
#pragma unroll
      for (int k = 0; k < kQ; ++k) atomicAdd(&sums[oc + k], part[k]);
  }
  __syncthreads();
  for (int c = tid; c < g.half; c += kThreads)
    if (sums[c] != 0) atomicAdd(&g.se_sum[b * g.half + c], sums[c]);
}

// load rows [y0, y0 + rows) x cols [x0, x0 + cols) of an [H, W, ch] int8 map
// of image b into dst[rows][cols][dst_ch] at channel offset dst_c; zero outside
__device__ __forceinline__ void load_region(int8_t* dst, int dst_ch, int dst_c, const int8_t* src, int ch, int b,
                                            int h, int w, int y0, int x0, int rows, int cols) {
  const int c16 = ch / 16;
  for (int i = threadIdx.x; i < rows * cols * c16; i += kThreads) {
    const int pos = i / c16, c = (i % c16) * 16;
    const int y = y0 + pos / cols, x = x0 + pos % cols;
    int4 v = make_int4(0, 0, 0, 0);
    if (y >= 0 && y < h && x >= 0 && x < w)
      v = __ldg(reinterpret_cast<const int4*>(src + ((static_cast<int64_t>(b) * h + y) * w + x) * ch + c));
    *reinterpret_cast<int4*>(dst + pos * dst_ch + dst_c + c) = v;
  }
}

// grid (ceil(W / kTC), ceil(H / kTR), B); dynamic smem: mean, g [half] f32,
// hid [r] f32, then x1 [(kTR+4)(kTC+4)][half] and cat [(kTR+2)(kTC+2)][cin] int8
__global__ void __launch_bounds__(kThreads) his_mid(const Args g) {
  extern __shared__ __align__(16) int8_t smem[];
  const int half = g.half, cin = g.cin, tid = threadIdx.x;
  float* mean = reinterpret_cast<float*>(smem);
  float* gate = mean + half;
  float* hid = gate + half;
  const int fbytes = ((2 * half + g.r) * 4 + 15) / 16 * 16;
  int8_t* x1 = smem + fbytes;                           // [(kTR+4) * (kTC+4)][half]
  int8_t* cat = x1 + (kTR + 4) * (kTC + 4) * half;      // [(kTR+2) * (kTC+2)][cin]
  const int b = blockIdx.z, r0 = blockIdx.y * kTR, c0 = blockIdx.x * kTC;

  // the SE gate of image b
  const float premul = g.sc[2], hw = static_cast<float>(g.h * g.w);
  for (int c = tid; c < half; c += kThreads)
    mean[c] = __fmul_rn(__fdiv_rn(static_cast<float>(g.se_sum[b * half + c]), hw), premul);
  load_region(x1, half, 0, g.x1q, half, b, g.h, g.w, r0 - 2, c0 - 2, kTR + 4, kTC + 4);
  __syncthreads();
  for (int j = tid; j < g.r; j += kThreads) {
    float s = 0.0f;
    for (int c = 0; c < half; ++c) s = __fadd_rn(s, __fmul_rn(mean[c], g.se_w1[c * g.r + j]));
    hid[j] = silu(__fadd_rn(s, g.se_b1[j]));
  }
  __syncthreads();
  for (int c = tid; c < half; c += kThreads) {
    float s = 0.0f;
    for (int j = 0; j < g.r; ++j) s = __fadd_rn(s, __fmul_rn(hid[j], g.se_w2[j * half + c]));
    gate[c] = sigmoid(__fadd_rn(s, g.se_b2[c]));
  }
  __syncthreads();

  // [aq, bq] on rows [r0-1, r0+kTR+1) x cols [c0-1, c0+kTC+1); 0 outside the map
  constexpr int kCR = kTR + 2, kCC = kTC + 2, kXC = kTC + 4;
  const int groups = half / 4;
  for (int it = tid; it < kCR * kCC * groups; it += kThreads) {
    const int pos = it / groups, c = (it % groups) * 4;
    const int i = pos / kCC, j = pos % kCC;
    const int y = r0 - 1 + i, x = c0 - 1 + j;
    int a_word = 0, b_word = 0;
    if (y >= 0 && y < g.h && x >= 0 && x < g.w) {
      int acc[4] = {0, 0, 0, 0};
      for (int t = 0; t < 9; ++t) {
        const int v = *reinterpret_cast<const int*>(x1 + ((i + t / 3) * kXC + j + t % 3) * half + c);
        const int wv = __ldg(reinterpret_cast<const int*>(g.wdw + t * half + c));
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += byte_of(v, k) * byte_of(wv, k);
      }
      const int center = *reinterpret_cast<const int*>(x1 + ((i + 1) * kXC + j + 1) * half + c);
      int8_t qa[4], qb[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        qa[k] = requant_relu(epilogue(acc[k], g.adw[c + k], g.bdw[c + k]));
        qb[k] = clip8(__fmul_rn(static_cast<float>(byte_of(center, k)), gate[c + k]));
      }
      a_word = pack4(qa[0], qa[1], qa[2], qa[3]);
      b_word = pack4(qb[0], qb[1], qb[2], qb[3]);
    }
    *reinterpret_cast<int*>(cat + pos * cin + c) = a_word;
    *reinterpret_cast<int*>(cat + pos * cin + half + c) = b_word;
  }
  __syncthreads();

  // conv3 3x3 pad 1 over [aq, bq] -> mq on the tile
  const int th = min(kTR, g.h - r0), tw = min(kTC, g.w - c0), npos = th * tw;
  const int ogroups = half / kQ;
  for (int it = tid; it < (npos + kP - 1) / kP * ogroups; it += kThreads) {
    const int o = (it % ogroups) * kQ, pg = (it / ogroups) * kP;
    const int8_t* base[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int pos = min(pg + p, npos - 1);
      base[p] = cat + ((pos / tw) * kCC + pos % tw) * cin;
    }
    int acc[kP][kQ];
    zero(acc);
    for (int t = 0; t < 9; ++t) {
      const int off = ((t / 3) * kCC + t % 3) * cin;
      const int8_t* act[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) act[p] = base[p] + off;
      dot_tile(acc, act, g.w3 + static_cast<int64_t>(o) * 9 * cin + t * cin, 9 * cin, cin);
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int pos = pg + p;
      if (pos >= npos) break;
      const int y = r0 + pos / tw, x = c0 + pos % tw;
      *reinterpret_cast<int*>(g.mq + ((static_cast<int64_t>(b) * g.h + y) * g.w + x) * half + o) =
          pack4(requant_relu(epilogue(acc[p][0], g.a3[o + 0], g.b3[o + 0])),
                requant_relu(epilogue(acc[p][1], g.a3[o + 1], g.b3[o + 1])),
                requant_relu(epilogue(acc[p][2], g.a3[o + 2], g.b3[o + 2])),
                requant_relu(epilogue(acc[p][3], g.a3[o + 3], g.b3[o + 3])));
    }
  }
}

// grid (ceil(W / kTC), ceil(H / kTR), B); dynamic smem: [(kTR+4)(kTC+4)][cin]
// int8 holding [mq, x2q]
__global__ void __launch_bounds__(kThreads) his_out(const Args g) {
  extern __shared__ __align__(16) int8_t smem[];
  const int half = g.half, cin = g.cin, tid = threadIdx.x;
  const int b = blockIdx.z, r0 = blockIdx.y * kTR, c0 = blockIdx.x * kTC;
  constexpr int kRC = kTC + 4;
  load_region(smem, cin, 0, g.mq, half, b, g.h, g.w, r0 - 2, c0 - 2, kTR + 4, kTC + 4);
  load_region(smem, cin, half, g.x2q, half, b, g.h, g.w, r0 - 2, c0 - 2, kTR + 4, kTC + 4);
  __syncthreads();

  const float inv_out = g.sc[1];
  const int th = min(kTR, g.h - r0), tw = min(kTC, g.w - c0), npos = th * tw;
  const int ogroups = cin / kQ;
  for (int it = tid; it < (npos + kP - 1) / kP * ogroups; it += kThreads) {
    const int o = (it % ogroups) * kQ, pg = (it / ogroups) * kP;
    const int8_t* base[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int pos = min(pg + p, npos - 1);
      base[p] = smem + ((pos / tw) * kRC + pos % tw) * cin;
    }
    int acc[kP][kQ];
    zero(acc);
    for (int t = 0; t < 9; ++t) {
      const int off = (2 * (t / 3) * kRC + 2 * (t % 3)) * cin;  // dilation 2
      const int8_t* act[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) act[p] = base[p] + off;
      dot_tile(acc, act, g.w4 + static_cast<int64_t>(o) * 9 * cin + t * cin, 9 * cin, cin);
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int pos = pg + p;
      if (pos >= npos) break;
      const int y = r0 + pos / tw, x = c0 + pos % tw;
      int8_t q[kQ];
#pragma unroll
      for (int k = 0; k < kQ; ++k)
        q[k] = clip8(__fmul_rn(silu(epilogue(acc[p][k], g.a4[o + k], g.b4[o + k])), inv_out));
      *reinterpret_cast<int*>(g.out + ((static_cast<int64_t>(b) * g.h + y) * g.w + x) * cin + o) =
          pack4(q[0], q[1], q[2], q[3]);
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

}  // namespace

// Pointers in the order of Args (see ops/qhis.py); the int8 maps NHWC
// contiguous and 16-byte aligned, weights [out][taps][in]; x1q, x2q, mq
// [B, H, W, half] int8 and se_sum [B, half] int32 are scratch (se_sum is
// zeroed here).  half % 16 == 0, cin == 2 * half.  Runs the three kernels
// on `stream`.  Returns a cudaError_t (0 = launched).
extern "C" int qhis_launch(void* const* ptrs, int batch, int h, int w, int cin, int half, int r, int combine,
                           void* stream) {
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
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.half = half;
  g.r = r;
  g.combine = combine;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(g.se_sum, 0, sizeof(int) * batch * half, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&g};

  const dim3 pgrid((h * w + kTP - 1) / kTP, batch);
  err = launch(reinterpret_cast<const void*>(his_produce), pgrid, kTP * cin + 4 * half, args, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 tgrid((w + kTC - 1) / kTC, (h + kTR - 1) / kTR, batch);
  const size_t fbytes = ((2 * half + r) * 4 + 15) / 16 * 16;
  const size_t mid = fbytes + (kTR + 4) * (kTC + 4) * half + (kTR + 2) * (kTC + 2) * cin;
  err = launch(reinterpret_cast<const void*>(his_mid), tgrid, mid, args, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch(reinterpret_cast<const void*>(his_out), tgrid, (kTR + 4) * (kTC + 4) * cin, args, s);
  return static_cast<int>(err);
}
