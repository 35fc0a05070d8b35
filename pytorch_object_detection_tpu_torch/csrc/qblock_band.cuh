// K13's band body (csrc/qchain.cu, one launch per chain of bottlenecks): one
// thread block computes one (image, band of output rows) of one int8
// bottleneck, the function of kernel C (csrc/qblock.cu, whose header note
// gives the data rule and the bit-exactness argument), on the CUDA cores.
//
// conv1 is recomputed on the band's input rows plus the 3x3 halo ((rows-1)*s
// + 3 input rows) into shared memory, with a zero column on each side and
// zero rows outside the image: conv2 pads in the a1 domain, as the reference
// does.  Then conv2 over the band into shared memory, then conv3 + shortcut
// straight to global memory.  A thread computes 8 positions x 4 output
// channels per step with __dp4a over 16-byte words (int32 accumulation,
// exact), so channel counts must be multiples of 16.  Weights are
// [Cout][taps][Cin] int8 and are read through L1/L2.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;

struct QBlockArgs {
  const int8_t* x;
  const int8_t* w1;
  const int8_t* w2;
  const int8_t* w3;
  const int8_t* wd;  // nullptr: identity shortcut
  const float *a1, *b1, *a2, *b2, *a3, *b3, *ad, *bd;
  int8_t* out;
  int h, w, cin, cw, cout, stride, ho, wo, rows;
};

// one (image `img`, band `band`) of the block; blockDim.x == kThreads;
// smem: dynamic shared memory of smem_bytes(rows, stride, W, Cw) bytes
__device__ __forceinline__ void qblock_band(const QBlockArgs& g, int band, int img, int8_t* smem) {
  const int s = g.stride, W = g.w, H = g.h, cw = g.cw, cin = g.cin;
  const int wp = W + 2;
  const int rows_a1 = (g.rows - 1) * s + 3;
  const int r0 = band * g.rows;  // first output row of the band
  const int in0 = r0 * s - 1;    // input row of a1's first smem row
  const int r_eff = min(g.rows, g.ho - r0);
  const int8_t* x_img = g.x + static_cast<int64_t>(img) * H * W * cin;
  int8_t* a1s = smem;                           // [rows_a1][W + 2][cw]
  int8_t* a2s = smem + rows_a1 * wp * cw;       // [r_eff * wo][cw]
  const int tid = threadIdx.x;

  // conv2's zero padding: a1 columns -1 and W
  const int chunks = cw / 16;
  for (int i = tid; i < rows_a1 * 2 * chunks; i += kThreads) {
    const int c = i % chunks, rc = i / chunks;
    const int col = (rc & 1) ? W + 1 : 0;
    *reinterpret_cast<int4*>(a1s + ((rc >> 1) * wp + col) * cw + c * 16) = make_int4(0, 0, 0, 0);
  }

  // conv1 on rows [in0, in0 + rows_a1), zero outside the image
  {
    const int npos = rows_a1 * W, groups = cw / kQ;
    const int items = (npos + kP - 1) / kP * groups;
    for (int it = tid; it < items; it += kThreads) {
      const int o = (it % groups) * kQ, p0 = (it / groups) * kP;
      const int8_t* act[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = min(p0 + p, npos - 1);
        const int ir = min(max(in0 + pos / W, 0), H - 1);
        act[p] = x_img + (static_cast<int64_t>(ir) * W + pos % W) * cin;
      }
      int acc[kP][kQ];
      zero(acc);
      dot_tile(acc, act, g.w1 + static_cast<int64_t>(o) * cin, cin, cin);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = p0 + p;
        if (pos >= npos) break;
        const int i = pos / W, ir = in0 + i;
        const bool inside = ir >= 0 && ir < H;
        char4 v;
        v.x = inside ? requant_relu(epilogue(acc[p][0], g.a1[o + 0], g.b1[o + 0])) : 0;
        v.y = inside ? requant_relu(epilogue(acc[p][1], g.a1[o + 1], g.b1[o + 1])) : 0;
        v.z = inside ? requant_relu(epilogue(acc[p][2], g.a1[o + 2], g.b1[o + 2])) : 0;
        v.w = inside ? requant_relu(epilogue(acc[p][3], g.a1[o + 3], g.b1[o + 3])) : 0;
        *reinterpret_cast<char4*>(a1s + (i * wp + pos % W + 1) * cw + o) = v;
      }
    }
  }
  __syncthreads();

  // conv2 3x3 / s over the band's output rows
  const int npos = r_eff * g.wo;
  {
    const int groups = cw / kQ;
    const int items = (npos + kP - 1) / kP * groups;
    for (int it = tid; it < items; it += kThreads) {
      const int o = (it % groups) * kQ, p0 = (it / groups) * kP;
      const int8_t* base[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = min(p0 + p, npos - 1);
        base[p] = a1s + ((pos / g.wo) * s * wp + (pos % g.wo) * s) * cw;
      }
      int acc[kP][kQ];
      zero(acc);
      for (int t = 0; t < 9; ++t) {
        const int off = ((t / 3) * wp + t % 3) * cw;
        const int8_t* act[kP];
#pragma unroll
        for (int p = 0; p < kP; ++p) act[p] = base[p] + off;
        dot_tile(acc, act, g.w2 + static_cast<int64_t>(o) * 9 * cw + t * cw, 9 * cw, cw);
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = p0 + p;
        if (pos >= npos) break;
        char4 v;
        v.x = requant_relu(epilogue(acc[p][0], g.a2[o + 0], g.b2[o + 0]));
        v.y = requant_relu(epilogue(acc[p][1], g.a2[o + 1], g.b2[o + 1]));
        v.z = requant_relu(epilogue(acc[p][2], g.a2[o + 2], g.b2[o + 2]));
        v.w = requant_relu(epilogue(acc[p][3], g.a2[o + 3], g.b2[o + 3]));
        *reinterpret_cast<char4*>(a2s + pos * cw + o) = v;
      }
    }
  }
  __syncthreads();

  // conv3 + shortcut -> the block output
  {
    const int groups = g.cout / kQ;
    const int items = (npos + kP - 1) / kP * groups;
    int8_t* out_img = g.out + (static_cast<int64_t>(img) * g.ho + r0) * g.wo * g.cout;
    for (int it = tid; it < items; it += kThreads) {
      const int o = (it % groups) * kQ, p0 = (it / groups) * kP;
      const int8_t* act[kP];
      const int8_t* xin[kP];  // the shortcut's input position (row r*s, column c*s)
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = min(p0 + p, npos - 1);
        act[p] = a2s + pos * cw;
        xin[p] = x_img + (static_cast<int64_t>(r0 + pos / g.wo) * s * W + (pos % g.wo) * s) * cin;
      }
      int acc[kP][kQ];
      zero(acc);
      dot_tile(acc, act, g.w3 + static_cast<int64_t>(o) * cw, cw, cw);
      float y[kP][kQ];
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int q = 0; q < kQ; ++q) y[p][q] = epilogue(acc[p][q], g.a3[o + q], g.b3[o + q]);
      if (g.wd != nullptr) {
        zero(acc);
        dot_tile(acc, xin, g.wd + static_cast<int64_t>(o) * cin, cin, cin);
#pragma unroll
        for (int p = 0; p < kP; ++p)
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            y[p][q] = __fadd_rn(y[p][q], epilogue(acc[p][q], g.ad[o + q], g.bd[o + q]));
      } else {
        const float short_mul = g.ad[0];
#pragma unroll
        for (int p = 0; p < kP; ++p)
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            y[p][q] = __fadd_rn(y[p][q], __fmul_rn(static_cast<float>(xin[p][o + q]), short_mul));
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int pos = p0 + p;
        if (pos >= npos) break;
        char4 v;
        v.x = requant_relu(y[p][0]);
        v.y = requant_relu(y[p][1]);
        v.z = requant_relu(y[p][2]);
        v.w = requant_relu(y[p][3]);
        *reinterpret_cast<char4*>(out_img + static_cast<int64_t>(pos) * g.cout + o) = v;
      }
    }
  }
}

}  // namespace
