// K4: int8 GEMM [M, K] x [K, N] with the fused requant epilogue; the 1x1
// convs of the HisFPN laterals (tf1, tf2, tf3) run through it.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_qconv.py:qmatmul (both of
// its pallas_calls: with and without the int8 residual) and :qconv1x1, which
// reshapes NHWC to [B*H*W, C].  The TPU kernel takes a (tile_m x K) strip of
// x and a (K x tile_n) strip of w into VMEM and runs one MXU dot per tile,
// with the epilogue on the accumulator in VMEM, so device memory sees int8
// only.  The same data rule holds here:
//
//   y   = acc * A[n] + B[n]            (acc: exact int32 sum, converted to f32)
//   y  += res[m, n] * res_scale        (residual variant only)
//   y   = max(y, 0)                    (relu flag)
//   out = clip(rint(y), -127, 127)     (round half to even)
//
// A thread block owns a 64 x 64 output tile and walks K in 64-byte steps,
// staging both operands' 64-byte strips in shared memory (rows padded to
// 17 words); each thread keeps 4 x 4 int32 accumulators and adds with
// __dp4a (exact).  K must be a multiple of 16 (16-byte loads); M and N may
// be ragged.  w is [N][K]: each output channel's K-vector contiguous.
//
// Bound on the card: int8 multiply-adds, on the CUDA cores (dp4a) rather
// than the tensor cores; the operands cross device memory about once
// (x once per 64 output channels, w once per 64 rows, both from L2).  An
// mma.sync / wgmma version is the next step.
//
// Bit-exactness with the plain version (torch._int_mm + the same epilogue):
// |acc| reaches 127^2 * 2048 > 2^24 for tf1, so the int32 -> f32
// conversion rounds (__int2float_rn, as the reference's astype does); each
// multiply and add is a separate __fmul_rn / __fadd_rn under -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 64;  // kBK in bytes
constexpr int kWords = kBK / 4, kPitch = kWords + 1;

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* a;
  const float* b;
  const int8_t* res;  // nullptr: no residual
  const float* res_scale;
  int8_t* out;
  int m, n, k, relu;
};

__device__ __forceinline__ void load_strip(int (*dst)[kPitch], const int8_t* src, int rows, int row0, int k,
                                           int k0) {
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;  // 64 rows x 4 words of 16 bytes
  int4 v = make_int4(0, 0, 0, 0);
  if (row0 + r < rows && k0 + q * 16 < k)
    v = __ldg(reinterpret_cast<const int4*>(src + static_cast<int64_t>(row0 + r) * k + k0 + q * 16));
  dst[r][q * 4 + 0] = v.x;
  dst[r][q * 4 + 1] = v.y;
  dst[r][q * 4 + 2] = v.z;
  dst[r][q * 4 + 3] = v.w;
}

// grid (ceil(M / 64), ceil(N / 64)), block kThreads
__global__ void __launch_bounds__(kThreads) qmm_kernel(const Args g) {
  __shared__ int xs[kBM][kPitch];
  __shared__ int ws[kBN][kPitch];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // 4 columns tx*4.., 4 rows ty*4..
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < g.k; k0 += kBK) {
    __syncthreads();
    load_strip(xs, g.x, g.m, m0, g.k, k0);
    load_strip(ws, g.w, g.n, n0, g.k, k0);
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < kWords; ++kw) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = xs[ty * 4 + i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[tx * 4 + j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
  }

  const float rs = g.res != nullptr ? __ldg(g.res_scale) : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.m) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.n) break;
      const int64_t at = static_cast<int64_t>(m) * g.n + n;
      float y = epilogue(acc[i][j], __ldg(g.a + n), __ldg(g.b + n));
      if (g.res != nullptr) y = __fadd_rn(y, __fmul_rn(static_cast<float>(g.res[at]), rs));
      if (g.relu) y = fmaxf(y, 0.0f);
      g.out[at] = clip8(y);
    }
  }
}

}  // namespace

// x [M, K], w [N, K], res [M, N] (or null), out [M, N]: int8, row-major,
// contiguous, 16-byte aligned, K % 16 == 0.  a, b f32 [N]; res_scale one
// f32 on the device (read only with res).  Returns a cudaError_t (0 = launched).
extern "C" int qmm_launch(const void* x, const void* w, const void* a, const void* b, const void* res,
                          const void* res_scale, void* out, int m, int n, int k, int relu, void* stream) {
  Args g;
  g.x = static_cast<const int8_t*>(x);
  g.w = static_cast<const int8_t*>(w);
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.res = static_cast<const int8_t*>(res);
  g.res_scale = static_cast<const float*>(res_scale);
  g.out = static_cast<int8_t*>(out);
  g.m = m;
  g.n = n;
  g.k = k;
  g.relu = relu;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  qmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
