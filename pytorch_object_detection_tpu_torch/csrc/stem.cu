// K17: the bf16 stem tail in one pass: BN + ReLU (bf16), 3x3 / stride 2 max
// pool (padding 1), int8 quantize; NHWC in, NHWC out.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_stem.py:stem_bn_pool_quant
// (backend="pallas_stem_tail").  The stem conv's bf16 output is the largest
// activation of the network ([B, 256, 256, 64] at 512x512); the TPU kernel
// reads it once per image from VMEM in row chunks, with pair-reduce pooling,
// and writes the pooled int8 map once.  The same data rule holds here: one
// thread makes 8 channels (one 16-byte word) of one output position from
// its nine window words, so the bf16 map is read about once from device
// memory (the overlapping windows re-read it from L1/L2) and the int8 map
// written once.  Bound on the card: device memory.
//
// The arithmetic is the JAX kernel's, step by step:
//   y  = max(bf16(bf16(t * mult_b) + shift_b), 0)   each op rounded to bf16
//   p  = max of y over the window, zero padding     (exact: y >= 0 and every
//                                                    window holds a real value)
//   q  = clip(rint(f32(p) * inv_s), -127, 127)      inv_s = 1 / scale in f32
// Each bf16 op is computed in f32 and rounded once to bf16 (__float2bfloat16_rn):
// the product of two bf16 values is exact in f32, and a sum of two bf16
// values that is not exact in f32 has one term below half a bf16 step of the
// other, so both round as one bf16 operation would, and as PyTorch's bf16
// elementwise ops do.  The multiply and add are separate __fmul_rn /
// __fadd_rn under -fmad=false; rintf rounds half to even.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bn_relu(__nv_bfloat16 t, __nv_bfloat16 m, __nv_bfloat16 s) {
  const __nv_bfloat16 p = __float2bfloat16_rn(__fmul_rn(__bfloat162float(t), __bfloat162float(m)));
  const __nv_bfloat16 y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(p), __bfloat162float(s)));
  return fmaxf(__bfloat162float(y), 0.0f);
}

// grid-stride over [B, Ho, Wo, C / 8] words of 8 channels
__global__ void __launch_bounds__(kThreads)
    stem_tail_kernel(const uint4* __restrict__ x, const uint4* __restrict__ mult, const uint4* __restrict__ shift,
                     const float* __restrict__ inv_s, uint2* __restrict__ out, int h, int w, int c8, int ho, int wo,
                     int64_t total) {
  const float inv = __ldg(inv_s);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(i % c8);
    int64_t p = i / c8;
    const int ox = static_cast<int>(p % wo);
    p /= wo;
    const int oy = static_cast<int>(p % ho);
    const int64_t b = p / ho;
    __nv_bfloat16 m[8], s[8];
    const uint4 mv = __ldg(mult + c), sv = __ldg(shift + c);
    memcpy(m, &mv, 16);
    memcpy(s, &sv, 16);
    float best[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) best[k] = 0.0f;  // the zero pad
    for (int iy = max(2 * oy - 1, 0); iy <= min(2 * oy + 1, h - 1); ++iy) {
      const uint4* row = x + (b * h + iy) * w * c8 + c;
      for (int ix = max(2 * ox - 1, 0); ix <= min(2 * ox + 1, w - 1); ++ix) {
        const uint4 v = __ldg(row + static_cast<int64_t>(ix) * c8);
        __nv_bfloat16 t[8];
        memcpy(t, &v, 16);
#pragma unroll
        for (int k = 0; k < 8; ++k) best[k] = fmaxf(best[k], bn_relu(t[k], m[k], s[k]));
      }
    }
    int8_t q[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      q[k] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(best[k], inv)), -127.0f), 127.0f)));
    uint2 word;
    memcpy(&word, q, 8);
    out[i] = word;
  }
}

}  // namespace

// x [B, H, W, C] bf16 NHWC contiguous, 16-byte aligned; mult, shift bf16
// [C], 16-byte aligned; inv_s one f32 on the device; out [B, (H - 1) / 2 + 1,
// (W - 1) / 2 + 1, C] int8.  C a multiple of 8.  Returns a cudaError_t
// (0 = launched).
extern "C" int stem_tail_launch(const void* x, const void* mult, const void* shift, const void* inv_s, void* out,
                                int batch, int h, int w, int c, void* stream) {
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const int64_t total = static_cast<int64_t>(batch) * ho * wo * (c / 8);
  if (total == 0) return 0;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  stem_tail_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(mult), static_cast<const uint4*>(shift),
      static_cast<const float*>(inv_s), static_cast<uint2*>(out), h, w, c / 8, ho, wo, total);
  return static_cast<int>(cudaGetLastError());
}
