// K13: a chain of int8 ResNet bottlenecks in one launch.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_qchain.py:qchain, which
// runs a whole backbone segment ([layer1_0 .. layer2_3] -> C3, [layer3_*] ->
// C4, [layer4_*] -> C5) as one pallas_call: per image, each block writes its
// output to VMEM scratch that the next block reads, so HBM sees the segment
// input once and its output once.  plan_chains splits a segment when its
// per-image estimate overflows a VMEM budget; no such budget exists here, so
// every segment runs whole.
//
// On this card one image's activations (4 MB at stage 1, 512x512) do not fit
// in an SM's shared memory, and blocks on different SMs cannot hand each
// other rows without a grid-wide barrier, so the chain is a cooperative
// launch: a grid of exactly the thread blocks that can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs) walks the (image,
// band) work items of each bottleneck in turn with the band body of
// csrc/qblock_band.cuh (one block per image and band of output rows, the
// function of kernel C), then meets at cooperative_groups::this_grid().sync()
// before the next bottleneck.  Intermediate activations go to two ping-pong
// scratch buffers in device memory (the 50 MB L2 holds much of a B=8
// segment's traffic).  Each bottleneck's band height comes from
// ops/qchain.pick_rows; the result does not depend on it, and K13 gives
// kernel C's int8 values bit for bit.
//
// Bound on the card: int8 multiply-adds on the CUDA cores (dp4a).  The TPU's reason for the chain (no HBM round trip between blocks)
// buys little here, where kernel C runs far below the memory bound; what it
// saves is 15 launch gaps per forward, against a grid barrier per block.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qblock_band.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxChain = 16;

struct Chain {
  QBlockArgs blk[kMaxChain];
  int n, batch;
};

// a cooperative grid of co-resident blocks, block kThreads, dynamic smem the
// largest of the chain's bottlenecks' kernel C band sizes.  No minimum of
// blocks per SM: held to 128 registers a thread (two blocks an SM, as kernel
// C) the band body spills 136 bytes a thread and the chain ran slower than
// kernel C's launches at B=64; at its own 188 registers (one block an SM)
// it does not spill (PERF.md section 6)
__global__ void __launch_bounds__(kThreads) qchain_kernel(const Chain c) {
  extern __shared__ __align__(16) int8_t smem[];
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < c.n; ++i) {
    const QBlockArgs& g = c.blk[i];
    const int bands = (g.ho + g.rows - 1) / g.rows;
    for (int item = blockIdx.x; item < bands * c.batch; item += gridDim.x) {
      qblock_band(g, item % bands, item / bands, smem);
      __syncthreads();  // the next item overwrites this one's shared memory
    }
    if (i + 1 < c.n) grid.sync();  // block i's output is block i + 1's input
  }
}

}  // namespace

// n bottlenecks (n <= 16); ptrs [n][14]: x, w1, w2, w3, wd (null: identity),
// a1, b1, a2, b2, a3, b3, ad (identity: short_mul), bd, out; dims [n][7]: h,
// w, cin, cw, cout, stride, rows.  Block i's out is block i + 1's x (the
// caller's scratch).  Layouts as kernel C's (csrc/qblock.cu).  grid_out
// receives the grid size.  Returns a cudaError_t (0 = launched).
extern "C" int qchain_launch(const void* const* ptrs, const int* dims, int n, int batch, int* grid_out,
                             void* stream) {
  if (n < 1 || n > kMaxChain) return static_cast<int>(cudaErrorInvalidValue);
  Chain c;
  c.n = n;
  c.batch = batch;
  size_t smem = 0;
  int items = 0;
  for (int i = 0; i < n; ++i) {
    const void* const* p = ptrs + 14 * i;
    const int* d = dims + 7 * i;
    QBlockArgs& g = c.blk[i];
    g.x = static_cast<const int8_t*>(p[0]);
    g.w1 = static_cast<const int8_t*>(p[1]);
    g.w2 = static_cast<const int8_t*>(p[2]);
    g.w3 = static_cast<const int8_t*>(p[3]);
    g.wd = static_cast<const int8_t*>(p[4]);
    g.a1 = static_cast<const float*>(p[5]);
    g.b1 = static_cast<const float*>(p[6]);
    g.a2 = static_cast<const float*>(p[7]);
    g.b2 = static_cast<const float*>(p[8]);
    g.a3 = static_cast<const float*>(p[9]);
    g.b3 = static_cast<const float*>(p[10]);
    g.ad = static_cast<const float*>(p[11]);
    g.bd = static_cast<const float*>(p[12]);
    g.out = static_cast<int8_t*>(const_cast<void*>(p[13]));
    g.h = d[0];
    g.w = d[1];
    g.cin = d[2];
    g.cw = d[3];
    g.cout = d[4];
    g.stride = d[5];
    g.rows = d[6];
    g.ho = (g.h - 1) / g.stride + 1;
    g.wo = (g.w - 1) / g.stride + 1;
    const size_t need = static_cast<size_t>((g.rows - 1) * g.stride + 3) * (g.w + 2) * g.cw +
                        static_cast<size_t>(g.rows) * g.wo * g.cw;
    smem = need > smem ? need : smem;
    const int it = (g.ho + g.rows - 1) / g.rows * batch;
    items = it > items ? it : items;
  }
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(qchain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qchain_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = per_sm * sms < items ? per_sm * sms : items;
  *grid_out = grid;
  void* args[] = {&c};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(qchain_kernel), dim3(grid), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
