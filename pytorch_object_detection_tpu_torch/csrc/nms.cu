// Kernel A: greedy NMS keep mask over score-sorted, class-shifted boxes.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_nms.py:
// pallas_nms_keep_mask (reached through pallas_batched_class_nms), which
// builds the K x K IoU matrix of one image in VMEM and iterates the
// fixpoint `keep = valid & !(keep @ (iou > t))` as MXU matvecs.
//
// Hopper has no use for the matvec form.  Two kernels instead:
//   1. nms_mask_kernel fills a [B, K, ceil(K/64)] uint64 bitmask, bit j of
//      row i set when i < j and IoU(i, j) > t.  One 64-thread block per
//      64 x 64 tile of one image; the 64 column boxes sit in shared memory.
//      Tiles below the diagonal (word w of rows 64t..64t+63, w < t) hold
//      only zeros and are never read by the scan, so they are not written.
//   2. nms_scan_kernel runs one warp per image over 64-row tiles in score
//      order.  Before the loop it turns `valid` into one ballot word per
//      tile, in shared memory beside the "removed" words.  For tile t each
//      lane holds two rows' diagonal words (word t of rows 64t+l and
//      64t+32+l, loaded while tile t-1 resolved); the tile's greedy order
//      resolves in registers: row i is kept when it is valid and bit i of
//      the tile's removed word is clear, and a kept row ORs its diagonal
//      word (shuffled from its lane) into that word.  Then the kept rows'
//      later words (t+1 ...) are ORed into the removed set, the lanes
//      spread over (kept row, word) pairs with loads independent of each
//      other.
// The greedy scan and the fixpoint have the same unique solution, because
// keep[j] depends only on rows i < j.  Invalid boxes are never kept, so they
// never suppress.
//
// Bound on the card: the scan is a chain per image (latency, not bytes or
// FLOPs): ceil(K/64) tiles, each one resolve of 64 register steps and a
// round of independent loads a lane per 8 (kept row, word) pairs; no
// device load of `valid` or of a kept row's words sits between two rows of
// a tile.  The mask is B*K*K/2 IoUs, a few MFLOP.  The design keeps the IoU matrix out
// of device memory (K^2/8 bytes of mask instead of 4*K^2 of floats) and
// needs no host round trip, where the plain fixpoint syncs once per
// iteration.
//
// Exactness: the IoU arithmetic is ops/boxes.pairwise_iou's, operation for
// operation: inter / (union > 0 ? union : 1) with union = (area_i + area_j)
// - inter and unclamped areas, strict `>`.  This file is compiled with
// -fmad=false, so no multiply-add contracts into an FMA and exact-threshold
// cases round as the plain version's separate operations do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kOrLoads = 8;  // loads in flight a lane while the kept rows' later words are ORed in

struct Box {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ p) {
  return Box{p[0], p[1], p[2], p[3]};
}

__device__ __forceinline__ float iou(const Box& a, const Box& b) {
  const float lt_x = fmaxf(a.x1, b.x1);
  const float lt_y = fmaxf(a.y1, b.y1);
  const float rb_x = fminf(a.x2, b.x2);
  const float rb_y = fminf(a.y2, b.y2);
  const float w = fmaxf(rb_x - lt_x, 0.0f);
  const float h = fmaxf(rb_y - lt_y, 0.0f);
  const float inter = w * h;
  const float area_a = (a.x2 - a.x1) * (a.y2 - a.y1);
  const float area_b = (b.x2 - b.x1) * (b.y2 - b.y1);
  const float uni = area_a + area_b - inter;
  return inter / (uni > 0.0f ? uni : 1.0f);
}

// grid (words, words, B), block kTile threads: thread t owns row
// blockIdx.y * 64 + t and writes its 64-bit word for column tile blockIdx.x.
__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ boxes, unsigned long long* __restrict__ mask,
                int k, int words, float thr) {
  const int b = blockIdx.z;
  const int row_tile = blockIdx.y;
  const int col_tile = blockIdx.x;
  const int i = row_tile * kTile + threadIdx.x;
  unsigned long long* out = mask + ((int64_t)b * k + i) * words + col_tile;
  if (col_tile < row_tile) return;  // block-uniform: all zeros, never read by the scan
  const float* bb = boxes + (int64_t)b * k * 4;
  __shared__ Box cols[kTile];
  const int c = col_tile * kTile + threadIdx.x;
  if (c < k) cols[threadIdx.x] = load_box(bb + (int64_t)c * 4);
  __syncthreads();
  if (i >= k) return;
  const Box bi = load_box(bb + (int64_t)i * 4);
  const int n_cols = min(kTile, k - col_tile * kTile);
  unsigned long long bits = 0ull;
  for (int j = 0; j < n_cols; ++j) {
    if (i < col_tile * kTile + j && iou(bi, cols[j]) > thr) bits |= 1ull << j;
  }
  *out = bits;
}

// grid (B), block 32 threads (one warp); dynamic shared memory: removed
// [words], the valid words [words] (u64), the tile's kept rows [64] (u8)
__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int k, int words) {
  extern __shared__ unsigned long long sm[];
  unsigned long long* removed = sm;
  unsigned long long* vword = sm + words;
  uint8_t* kept_rows = reinterpret_cast<uint8_t*>(sm + 2 * words);
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* mb = mask + (int64_t)b * k * words;
  const uint8_t* vb = valid + (int64_t)b * k;
  uint8_t* kb = keep + (int64_t)b * k;
  // valid, once: bit i of word t is row 64t + i
  for (int t = 0; t < words; ++t) {
    const int i = kTile * t + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, i < k && vb[i] != 0);
    const unsigned hi = __ballot_sync(0xffffffffu, i + 32 < k && vb[i + 32] != 0);
    if (lane == 0) vword[t] = lo | (static_cast<unsigned long long>(hi) << 32);
  }
  for (int w = lane; w < words; w += 32) removed[w] = 0ull;
  __syncwarp();
  // word t of rows 64t + lane and 64t + 32 + lane: the tile's diagonal words
  const auto diag = [&](int t, unsigned long long& d0, unsigned long long& d1) {
    const int i = kTile * t + lane;
    d0 = i < k ? mb[(int64_t)i * words + t] : 0ull;
    d1 = i + 32 < k ? mb[(int64_t)(i + 32) * words + t] : 0ull;
  };
  unsigned long long d0, d1;
  diag(0, d0, d1);
  for (int t = 0; t < words; ++t) {
    unsigned long long n0 = 0ull, n1 = 0ull;
    if (t + 1 < words) diag(t + 1, n0, n1);  // the next tile's, in flight while this one resolves
    const unsigned long long v = vword[t];
    unsigned long long rem = removed[t], kept = 0ull;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {  // warp-uniform: every lane resolves the same tile
      const unsigned long long di = __shfl_sync(0xffffffffu, i < 32 ? d0 : d1, i & 31);
      if ((((v & ~rem) >> i) & 1ull) != 0ull) {
        rem |= di;  // row i has bits only for columns > i of this tile
        kept |= 1ull << i;
      }
    }
    const int i = kTile * t + lane;
    if (i < k) kb[i] = static_cast<uint8_t>((kept >> lane) & 1ull);
    if (i + 32 < k) kb[i + 32] = static_cast<uint8_t>((kept >> (lane + 32)) & 1ull);
    const int nw = words - t - 1;
    if (nw > 0 && kept != 0ull) {
      if ((kept >> lane) & 1ull) kept_rows[__popcll(kept & ((1ull << lane) - 1ull))] = lane;
      if ((kept >> (lane + 32)) & 1ull) kept_rows[__popcll(kept & ((1ull << (lane + 32)) - 1ull))] = lane + 32;
      __syncwarp();
      const int pairs = __popcll(kept) * nw;
      for (int base = 0; base < pairs; base += 32 * kOrLoads) {
        unsigned long long got[kOrLoads];
#pragma unroll
        for (int u = 0; u < kOrLoads; ++u) {
          const int p = base + 32 * u + lane, j = p / nw;
          got[u] = p < pairs ? mb[(int64_t)(kTile * t + kept_rows[j]) * words + t + 1 + (p - j * nw)] : 0ull;
        }
#pragma unroll
        for (int u = 0; u < kOrLoads; ++u) {
          const int p = base + 32 * u + lane;
          if (got[u] != 0ull) atomicOr(&removed[t + 1 + p % nw], got[u]);
        }
      }
      __syncwarp();
    }
    d0 = n0;
    d1 = n1;
  }
}

}  // namespace

// boxes f32 [B, K, 4] contiguous; valid u8 [B, K]; mask u64 [B, K, words]
// scratch; keep u8 [B, K] out.  Launches both kernels on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int nms_keep_mask(const void* boxes, const void* valid, void* mask, void* keep,
                             int batch, int k, float thr, void* stream) {
  const int words = (k + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(words, words, batch);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(static_cast<const float*>(boxes),
                                         static_cast<unsigned long long*>(mask), k, words, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * words * sizeof(unsigned long long) + kTile;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<batch, 32, smem, s>>>(
      static_cast<const unsigned long long*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, words);
  return static_cast<int>(cudaGetLastError());
}
