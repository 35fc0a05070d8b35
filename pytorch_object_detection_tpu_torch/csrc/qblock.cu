// Kernel C: one whole int8 ResNet bottleneck per launch, stride 1 or 2, on
// the int8 tensor cores.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_qblock.py:qbottleneck
// (stride-1 blocks) and :qbottleneck_s2 (the three stride-2 blocks).  Those
// keep one image's NHWC map in VMEM and walk row chunks with a static Python
// loop, computing conv1 -> conv2 -> conv3 + shortcut with the a1/a2
// intermediates in VMEM, so HBM sees the block input once and its output
// once.  The same data rule holds here:
//
//   conv1  1x1,            a1 = requant(relu(acc1 * A1 + B1))   (int8, smem)
//   conv2  3x3 pad 1 / s,  a2 = requant(relu(acc2 * A2 + B2))   (int8, smem)
//   conv3  1x1 + shortcut, out = requant(relu((acc3 * A3 + B3) + short))
//   short  = accd * Ad + Bd     (projection: 1x1 conv at stride s), or
//            x * short_mul      (identity; short_mul is one f32 at ad[0])
//
// Design.  A cluster of `split` thread blocks (1, 2, 4 or 8) owns one
// spatial tile of 8 x tw output positions (tw 8 or 16) of one image; block
// rank q of the cluster computes the q-th 1/split of conv1's, conv2's and
// conv3's output channels:
//   1. conv1 on the tile plus its 3x3 halo ((8-1)s+3 x (tw-1)s+3 input
//      positions; zeros outside the image: conv2 pads in the a1 domain, as
//      the reference does) -> its a1 channels in shared memory, then pushed
//      into every peer's a1 (distributed shared memory) and cluster.sync();
//   2. conv2 as an implicit GEMM over the 9 taps, reading the whole a1 in
//      shared memory -> its a2 channels, pushed the same way;
//   3. the projection shortcut (a GEMM over x at the strided positions) and
//      conv3 over the whole a2; the pre-activations go through shared
//      memory, so the identity shortcut's x and the block output move in
//      16-byte words.
// Every GEMM runs csrc/qmma_tile.cuh's MmaTile (mma.sync m16n8k32 s8, ldmatrix
// fragments); x strips and every weight K-slice come through a ring of
// cp.async stages (48 KB, cut into 3 to 8 stages by the phase's step size:
// the small steps of a narrow slice need more in flight to cover L2's
// latency), so each staged weight byte serves the tile's 64 or 128
// positions.  Registers are capped for two blocks per SM.  a1 and a2 rows
// are XOR-swizzled (swz) for ldmatrix.  ops/qblock.pick_tile chooses (tw,
// split): tiles that fill the card, two blocks per SM where they fit,
// clusters on the small maps at small batch.  The phases live in
// csrc/qblock_tile.cuh, which K13 (csrc/qchain.cu) and K11 (csrc/qconv3.cu)
// build on too; this file holds the one-bottleneck launch.
//
// Bound on the card: int8 multiply-adds on stages 3-4 and the stride-2
// blocks (conv2 is 9/17 of a stride-1 block's), device memory on the
// stride-1 blocks of stages 1-2 (large maps, narrow Cw); device memory sees
// the block input about once per cluster block and its output once, the
// weights once per tile from L2.
//
// Bit-exactness with the plain version: int32 sums are exact in any order;
// |acc| reaches 127^2 * 4608 > 2^24, so the int32 -> f32 conversion rounds
// (to nearest, __int2float_rn, as the reference's astype does); every
// epilogue multiply and add is a separate __fmul_rn/__fadd_rn under
// -fmad=false, so no FMA contraction moves a value across a requant
// boundary; rintf rounds half to even.  The projection shortcut adds
// (acc3*A3 + B3) + (accd*Ad + Bd), the XLA oracle's association
// (nn/resnet_int8.py:549-554), not the Pallas kernel's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qblock_tile.cuh"

namespace {

// grid (tiles * split) in clusters of split, block kMmaThreads, dynamic
// smem smem_bytes(stride, tw, cw)
__global__ void __launch_bounds__(kMmaThreads, 2) qblock_kernel(const Args g) {
  extern __shared__ __align__(128) int8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Tile t = tile_at(g, blockIdx.x / g.split, static_cast<int>(cluster.block_rank()), g.split, smem);
  cluster.sync();  // every block of the cluster runs before any writes into its shared memory
  bottleneck_tile<WholeCluster>(g, t);
}

}  // namespace

// x [B, H, W, Cin] int8 NHWC contiguous; out [B, Ho, Wo, Cout] with
// Ho = (H - 1) / stride + 1 (likewise Wo).  w1 [Cw][Cin], w2 [Cw][3][3][Cw],
// w3 [Cout][Cw], wd [Cout][Cin] int8 (wd null: identity, ad -> short_mul);
// epilogue vectors f32.  Channel counts multiples of 16; tiles of 8 x tw
// output positions (tw 8 or 16); split (1, 2, 4 or 8) blocks per tile, a
// cluster, with Cw and Cout multiples of 16 * split.  Returns a cudaError_t
// (0 = launched).
extern "C" int qblock_launch(const void* x, const void* w1, const void* w2, const void* w3, const void* wd,
                             const void* a1, const void* b1, const void* a2, const void* b2, const void* a3,
                             const void* b3, const void* ad, const void* bd, void* out, int batch, int h, int w,
                             int cin, int cw, int cout, int stride, int tw, int split, void* stream) {
  Args g;
  g.x = static_cast<const int8_t*>(x);
  g.w1 = static_cast<const int8_t*>(w1);
  g.w2 = static_cast<const int8_t*>(w2);
  g.w3 = static_cast<const int8_t*>(w3);
  g.wd = static_cast<const int8_t*>(wd);
  g.a1 = static_cast<const float*>(a1);
  g.b1 = static_cast<const float*>(b1);
  g.a2 = static_cast<const float*>(a2);
  g.b2 = static_cast<const float*>(b2);
  g.a3 = static_cast<const float*>(a3);
  g.b3 = static_cast<const float*>(b3);
  g.ad = static_cast<const float*>(ad);
  g.bd = static_cast<const float*>(bd);
  g.out = static_cast<int8_t*>(out);
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cw = cw;
  g.cout = cout;
  g.stride = stride;
  if (!set_tiles(g, batch, tw, split)) return static_cast<int>(cudaErrorInvalidValue);
  static int optin = -1;  // the kernel may take all the shared memory a block can opt in to
  if (optin < 0) {
    const cudaError_t err = opt_in_smem(qblock_kernel, &optin);
    if (err != cudaSuccess) {
      optin = -1;
      return static_cast<int>(err);
    }
  }
  const size_t smem = smem_bytes(stride, tw, cw);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidConfiguration);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * g.tiles_x * g.tiles_y * split));
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, qblock_kernel, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
