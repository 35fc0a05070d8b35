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
// The GEMM is csrc/qmm_tile.cuh's 128 x BN tile on the int8 tensor cores
// (mma.sync m16n8k32, operands staged by cp.async; shared with the K4'
// epilogue variants of csrc/qmm_variants.cu); this file is its epilogue and
// launch.  ops/qconv.pick_qmm_tile chooses BN and the split of K: where
// M x N gives too few 128 x BN tiles to fill the card (the lateral tf1 at
// B=8: M 2048, N 256, K 2048), blocks take slices of K, write int32
// partial sums to a workspace, and a second kernel adds them and applies
// the epilogue.
//
// Bound on the card: the laterals move a few bytes per multiply-add, so
// device memory and the tensor cores' rate are within a few times of each
// other; the tile reads x once per BN output channels and w once per 128
// rows, from L2.  wgmma with TMA is the next step.
//
// Bit-exactness with the plain version (torch._int_mm + the same epilogue):
// int32 sums are exact in any order; |acc| reaches 127^2 * 2048 > 2^24 for
// tf1, so the int32 -> f32 conversion rounds (__int2float_rn, as the
// reference's astype does); each multiply and add is a separate __fmul_rn /
// __fadd_rn under -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "qmm_tile.cuh"

namespace {

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* a;
  const float* b;
  const int8_t* res;  // nullptr: no residual
  const float* res_scale;
  int8_t* out;
  int* ws;  // split-K partial sums [splits][M][N]
  int m, n, k, relu, steps_per;
};

// outputs (m, n) .. (m, n + cnt - 1)
struct Requant {
  Args g;
  float rs;
  __device__ __forceinline__ void operator()(int m, int n, int cnt, const int (&acc)[16]) const {
    const int64_t at = static_cast<int64_t>(m) * g.n + n;
    int8_t r[16], o[16];
    if (g.res != nullptr) load16(r, g.res + at, cnt);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = min(n + j, g.n - 1);
      float y = epilogue(acc[j], __ldg(g.a + c), __ldg(g.b + c));
      if (g.res != nullptr) y = __fadd_rn(y, __fmul_rn(static_cast<float>(r[j]), rs));
      if (g.relu) y = fmaxf(y, 0.0f);
      o[j] = clip8(y);
    }
    store16(g.out + at, o, cnt);
  }
};

__device__ __forceinline__ Requant requant(const Args& g) {
  return Requant{g, g.res != nullptr ? __ldg(g.res_scale) : 0.0f};
}

// grid (ceil(M / 128), ceil(N / BN), splits), block kMmaThreads, dynamic
// smem QmmShape<BN>::kSmem; block z takes K steps [z * steps_per, ...)
template <int BN, bool SPLIT>
__global__ void __launch_bounds__(kMmaThreads) qmm_kernel(const Args g) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int steps = (g.k + kStepBytes - 1) / kStepBytes;
  const int s0 = blockIdx.z * g.steps_per, s1 = min(steps, s0 + g.steps_per);
  if (SPLIT) {
    qmm_tile<BN>(g.x, g.w, g.m, g.n, g.k, s0, s1, smem, QmmPartial{g.ws, g.m, g.n});
  } else {
    qmm_tile<BN>(g.x, g.w, g.m, g.n, g.k, s0, s1, smem, requant(g));
  }
}

// split-K second pass: one thread per 16 outputs of a row, the splits'
// int32 sums added (exact), then the epilogue
__global__ void qmm_reduce_kernel(const Args g, int splits) {
  const int groups = (g.n + 15) / 16;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(g.m) * groups) return;
  const int m = static_cast<int>(i / groups), n = static_cast<int>(i % groups) * 16, cnt = min(16, g.n - n);
  const int64_t mn = static_cast<int64_t>(g.m) * g.n, at = static_cast<int64_t>(m) * g.n + n;
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  for (int z = 0; z < splits; ++z) {
    const int* p = g.ws + z * mn + at;
    if (cnt == 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int4 v = reinterpret_cast<const int4*>(p)[j];
        acc[4 * j] += v.x;
        acc[4 * j + 1] += v.y;
        acc[4 * j + 2] += v.z;
        acc[4 * j + 3] += v.w;
      }
    } else {
      for (int j = 0; j < cnt; ++j) acc[j] += p[j];
    }
  }
  requant(g)(m, n, cnt, acc);
}

// the kernel's dynamic shared memory above 48 KB, asked for once
template <int BN, bool SPLIT>
int allow_smem() {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      qmm_kernel<BN, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, QmmShape<BN>::kSmem));
  return err;
}

template <int BN>
int launch(const Args& g, int splits, cudaStream_t stream) {
  const dim3 grid((g.m + kQmmBM - 1) / kQmmBM, (g.n + BN - 1) / BN, splits);
  const int smem = QmmShape<BN>::kSmem;
  if (splits == 1) {
    const int err = allow_smem<BN, false>();
    if (err != 0) return err;
    qmm_kernel<BN, false><<<grid, kMmaThreads, smem, stream>>>(g);
    return static_cast<int>(cudaGetLastError());
  }
  const int err = allow_smem<BN, true>();
  if (err != 0) return err;
  qmm_kernel<BN, true><<<grid, kMmaThreads, smem, stream>>>(g);
  const int64_t groups = static_cast<int64_t>(g.m) * ((g.n + 15) / 16);
  qmm_reduce_kernel<<<static_cast<unsigned>((groups + 255) / 256), 256, 0, stream>>>(g, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K], w [N, K], res [M, N] (or null), out [M, N]: int8, row-major,
// contiguous, 16-byte aligned, K % 16 == 0.  a, b f32 [N]; res_scale one
// f32 on the device (read only with res).  bn 128 or 64; splits >= 1 blocks
// along K, each taking steps_per 64-byte steps (the last one the rest); ws
// int32 [splits, M, N] when splits > 1.  Returns a cudaError_t (0 = launched).
extern "C" int qmm_launch(const void* x, const void* w, const void* a, const void* b, const void* res,
                          const void* res_scale, void* out, void* ws, int m, int n, int k, int relu, int bn, int splits,
                          int steps_per, void* stream) {
  Args g;
  g.x = static_cast<const int8_t*>(x);
  g.w = static_cast<const int8_t*>(w);
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.res = static_cast<const int8_t*>(res);
  g.res_scale = static_cast<const float*>(res_scale);
  g.out = static_cast<int8_t*>(out);
  g.ws = static_cast<int*>(ws);
  g.m = m;
  g.n = n;
  g.k = k;
  g.relu = relu;
  g.steps_per = steps_per;
  if ((n + bn - 1) / bn > 65535 || splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128) return launch<128>(g, splits, s);
  if (bn == 64) return launch<64>(g, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
