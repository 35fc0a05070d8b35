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
// launch: a persistent grid of the clusters that can be resident at once
// walks each bottleneck's kernel C work items (image, tile of 8 x tw output
// positions, cluster rank) with kernel C's phases (csrc/qblock_tile.cuh:
// conv1, conv2, conv3 on the int8 tensor cores), then meets at
// cooperative_groups::this_grid().sync() before the next bottleneck.  The
// launch has one cluster size S, the largest of its bottlenecks' splits; a
// bottleneck of split s runs S / s tiles at once in each cluster, and the
// part of a cluster left without a tile in the last round still takes the
// phases' two cluster barriers.  Intermediate activations go to two
// ping-pong scratch buffers in device memory (the 50 MB L2 holds much of a
// B=8 segment's traffic).  ops/qchain.pick_chain_tile gives each bottleneck
// kernel C's (tw, split) under the launch's one shared-memory size (its
// largest tile's) and one cluster size; the result does not depend on it,
// and K13 gives kernel C's int8 values bit for bit.
//
// Bound on the card: as kernel C's (int8 multiply-adds on stages 3-4,
// device memory on the stride-1 blocks of stages 1-2).  The TPU's reason for
// the chain (no HBM round trip between blocks) buys little here; what it
// saves is 13 launch gaps per forward, against a grid barrier per block and
// the residency of the segment's largest tile: a segment whose largest tile
// needs more than half an SM's shared memory (C4 from its stride-2 block,
// C5) runs one block an SM where kernel C runs two on its stride-1 blocks.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qblock_tile.cuh"

namespace {

#ifndef QCHAIN_MIN_BLOCKS
#define QCHAIN_MIN_BLOCKS 2
#endif

constexpr int kMaxChain = 8;

// Registers: the phases take kernel C's 128 (two blocks an SM), and kernel C
// leaves none spare.  Inlined into the chain's loops they spill: the
// compiler hoists their loop-invariant values out of the loop and keeps
// them live across it, and arguments read through a runtime index take
// registers of their own.  So each bottleneck's tile runs in a function of
// its own (chain_tile<I>, not inlined: no loop around its body), which reads
// its arguments at fixed offsets of the __constant__ chain, as kernel C
// reads its parameters.  The call still costs the two-block build a few
// hundred bytes of spill a tile function (the build log has the counts);
// the one-block build spills nothing.
struct Chain {
  Args blk[kMaxChain];
  int tiles[kMaxChain];       // kernel C tiles of block i (batch x tiles_y x tiles_x)
  int split_log2[kMaxChain];  // log2 of block i's split
  int step[kMaxChain];        // tiles one round of the grid takes: clusters x cluster / split
  int n, cluster_log2;
};

// written by qchain_launch on the launch's stream just before the launch
__constant__ Chain kChain;

extern __shared__ __align__(128) int8_t chain_smem[];

__device__ __forceinline__ int cluster_rank() { return static_cast<int>(cg::this_cluster().block_rank()); }

// K13's clusters hold cluster / split groups of a tile's split blocks
struct GroupOfCluster {
  static __device__ __forceinline__ int first(const Tile& t) { return cluster_rank() - t.q; }
};

// channel slice q of kernel C tile `tile` of bottleneck I
template <int I>
__device__ __noinline__ void chain_tile(int tile, int q) {
  const Args& g = kChain.blk[I];
  bottleneck_tile<GroupOfCluster>(g, tile_at(g, tile, q, g.split, chain_smem));
}

// bottleneck I's tiles in rounds over the resident clusters: rank r of a
// cluster takes tile base + r / s's channel slice r % s
template <int I>
__device__ __forceinline__ void chain_block() {
  const int sl = kChain.split_log2[I];
  for (int base = (static_cast<int>(blockIdx.x) >> kChain.cluster_log2) << (kChain.cluster_log2 - sl);
       base < kChain.tiles[I]; base += kChain.step[I]) {
    const int rank = cluster_rank(), tile = base + (rank >> sl);
    if (tile < kChain.tiles[I]) {
      chain_tile<I>(tile, rank & ((1 << sl) - 1));
    } else {  // no tile for this group: its share of the phases' cluster barriers
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
  }
}

// bottlenecks I .. n - 1, a grid barrier before each but the first
template <int I>
__device__ __forceinline__ void chain_from() {
  if constexpr (I < kMaxChain) {
    if (I >= kChain.n) return;
    if (I > 0) cg::this_grid().sync();  // block I - 1's output is block I's input
    chain_block<I>();
    chain_from<I + 1>();
  }
}

// a cooperative grid of co-resident clusters of 1 << kChain.cluster_log2
// blocks, block kMmaThreads, dynamic smem the largest of the chain's
// smem_bytes.  Built twice: QCHAIN_MIN_BLOCKS 2 caps the registers for two
// blocks an SM, as kernel C's, for the chains whose tiles leave room for
// two (C3), and the tile functions spill a little at that cap; 1 lets them
// take up to 255 registers without a spill, for the chains whose largest
// tile fills more than half an SM's shared memory anyway (C4, C5)
__global__ void __launch_bounds__(kMmaThreads, QCHAIN_MIN_BLOCKS) qchain_kernel() {
  cg::this_cluster().sync();  // every block of the cluster runs before any writes into its shared memory
  chain_from<0>();
}

}  // namespace

// n bottlenecks (n <= 8); ptrs [n][14]: x, w1, w2, w3, wd (null: identity),
// a1, b1, a2, b2, a3, b3, ad (identity: short_mul), bd, out; dims [n][8]: h,
// w, cin, cw, cout, stride, tw, split.  Block i's out is block i + 1's x
// (the caller's scratch).  Layouts and tiles as kernel C's (csrc/qblock.cu);
// every split divides `cluster` (1, 2, 4 or 8).  grid_out receives the grid
// size.  Returns a cudaError_t (0 = launched).
extern "C" int qchain_launch(const void* const* ptrs, const int* dims, int n, int batch, int cluster, int* grid_out,
                             void* stream) {
  if (n < 1 || n > kMaxChain || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Chain c;
  c.n = n;
  c.cluster_log2 = cluster == 8 ? 3 : cluster == 4 ? 2 : cluster == 2 ? 1 : 0;
  size_t smem = 0;
  int64_t rounds = 0;  // clusters the widest bottleneck could use
  for (int i = 0; i < n; ++i) {
    const void* const* p = ptrs + 14 * i;
    const int* d = dims + 8 * i;
    Args& g = c.blk[i];
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
    if (!set_tiles(g, batch, d[6], d[7]) || cluster % d[7]) return static_cast<int>(cudaErrorInvalidValue);
    c.tiles[i] = batch * g.tiles_x * g.tiles_y;
    c.split_log2[i] = d[7] == 8 ? 3 : d[7] == 4 ? 2 : d[7] == 2 ? 1 : 0;
    const size_t need = smem_bytes(g.stride, d[6], g.cw);
    smem = need > smem ? need : smem;
    const int per = cluster / d[7];
    const int64_t r = (static_cast<int64_t>(c.tiles[i]) + per - 1) / per;
    rounds = r > rounds ? r : rounds;
  }
  static int optin = -1;
  if (optin < 0) {
    const cudaError_t err = opt_in_smem(qchain_kernel, &optin);
    if (err != cudaSuccess) {
      optin = -1;
      return static_cast<int>(err);
    }
  }
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidConfiguration);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  int resident = 0;  // clusters that can be resident at once
  cudaError_t err = cudaOccupancyMaxActiveClusters(&resident, qchain_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int clusters = static_cast<int>(rounds < resident ? rounds : resident);
  for (int i = 0; i < n; ++i) c.step[i] = clusters * (cluster / c.blk[i].split);
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  *grid_out = clusters * cluster;
  // kChain is one per device: a launch on another stream waits for the last
  // one that read it (the copy is staged at once from pageable memory).  A
  // CUDA graph cannot hold that copy, so a capturing stream is refused
  // before the event is touched.
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  if ((err = cudaStreamIsCapturing(cfg.stream, &capture)) != cudaSuccess) return static_cast<int>(err);
  if (capture != cudaStreamCaptureStatusNone) return static_cast<int>(cudaErrorStreamCaptureUnsupported);
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  static cudaEvent_t done[64] = {};
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev] == nullptr && (err = cudaEventCreateWithFlags(&done[dev], cudaEventDisableTiming)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaStreamWaitEvent(cfg.stream, done[dev], 0)) != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyToSymbolAsync(kChain, &c, sizeof(Chain), 0, cudaMemcpyHostToDevice, cfg.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaLaunchKernelEx(&cfg, qchain_kernel)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaEventRecord(done[dev], cfg.stream));
}
