// K4's int8 GEMM tile [M, K] x [N, K]^T on the int8 tensor cores, shared by
// K4 (csrc/qconv.cu) and the K4' epilogue variants (csrc/qmm_variants.cu).
//
// A thread block of 8 warps owns a 128 x BN output tile (BN 128 or 64) and
// walks its K steps [step0, step1) (64 bytes each) through a ring of
// kQmmStages cp.async stages: csrc/qmma_tile.cuh's MmaTile, warps 2 x 4
// (64 x 32 each) for BN 128, 4 x 2 (32 x 32) for BN 64.  K must be a
// multiple of 16 (16-byte copies; a chunk past K is staged as zeros); M and
// N may be ragged.  w is [N][K]: each output channel's K-vector contiguous.
// The sums go through shared memory (the drained ring), so that the
// epilogue reads and writes device memory in whole rows: a functor
// ``epi(m, n, cnt, acc)`` gets the exact int32 sums of outputs (m, n) ..
// (m, n + cnt - 1) of the block's K steps, n a multiple of 16 and cnt <= 16.
// K4 splits K across blocks (blockIdx.z) where M x N leaves too few tiles to
// fill the card, and then adds the int32 partial sums in a second pass
// (csrc/qconv.cu), exact in any order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "qmma_tile.cuh"

namespace {

constexpr int kQmmBM = 128, kQmmStages = 4;

template <int BN>
struct QmmShape {
  using Tile = MmaTile<kQmmBM, BN, BN == 128 ? 2 : 4>;
  static constexpr int kSlot = (kQmmBM + BN) * kStepBytes;  // one stage: the A and B strips
  // the int32 sums' rows, padded by 8 words: the 8-byte fragment stores of a
  // half-warp (4 rows) hit 32 distinct banks
  static constexpr int kPitch = BN + 8;
  static constexpr int kRing = kQmmStages * kSlot, kSums = kQmmBM * kPitch * 4;
  static constexpr int kSmem = kRing > kSums ? kRing : kSums;  // dynamic shared memory of a block
};

// the tile of block (blockIdx.x, blockIdx.y) over K steps [step0, step1);
// smem: QmmShape<BN>::kSmem bytes, 128-byte aligned
template <int BN, class Epi>
__device__ __forceinline__ void qmm_tile(const int8_t* x, const int8_t* w, int m, int n, int k, int step0, int step1,
                                         uint8_t* smem, const Epi& epi) {
  using S = QmmShape<BN>;
  using T = typename S::Tile;
  const int m0 = blockIdx.x * kQmmBM, n0 = blockIdx.y * BN;
  const uint32_t base = smem_u32(smem);
  const int8_t* xr = x + static_cast<int64_t>(m0) * k;
  const int8_t* wr = w + static_cast<int64_t>(n0) * k;
  T t;
  t.zero();
  auto issue = [&](int s, int slot) {
    const int kb = (step0 + s) * kStepBytes;
    const uint32_t a = base + slot * S::kSlot, b = a + kQmmBM * kStepBytes;
    auto kc = [&](int c) { return kb + 16 * c < k; };
    stage_rows<kQmmBM>(a, [&](int r) { return xr + static_cast<int64_t>(r) * k + kb; },
                       [&](int r) { return m0 + r < m; }, kc, x);
    stage_rows<BN>(b, [&](int r) { return wr + static_cast<int64_t>(r) * k + kb; },
                   [&](int r) { return n0 + r < n; }, kc, w);
  };
  auto compute = [&](int, int slot) {
    const uint32_t a = base + slot * S::kSlot, b = a + kQmmBM * kStepBytes;
    t.step([&](int r, int c) { return a + swz64(r, c); }, [&](int r, int c) { return b + swz64(r, c); }, m - m0);
  };
  pipeline<kQmmStages>(step1 - step0, issue, compute);

  // the sums into shared memory (the ring is drained), then 16 outputs of a
  // row per thread and step
  int* sums = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<int2*>(sums + sum_at(T::row(mt, 2 * hf), T::col(nt, 0), S::kPitch)) =
            make_int2(t.acc[mt][nt][2 * hf], t.acc[mt][nt][2 * hf + 1]);
  __syncthreads();
  constexpr int kGroups = BN / 16;
  for (int gi = threadIdx.x; gi < kQmmBM * kGroups; gi += kMmaThreads) {
    const int r = gi / kGroups, c = (gi % kGroups) * 16;
    const int cnt = min(16, n - n0 - c);
    if (m0 + r >= m || cnt <= 0) continue;
    int acc[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int4 v = *reinterpret_cast<const int4*>(sums + sum_at(r, c + 4 * j, S::kPitch));
      acc[4 * j] = v.x;
      acc[4 * j + 1] = v.y;
      acc[4 * j + 2] = v.z;
      acc[4 * j + 3] = v.w;
    }
    epi(m0 + r, n0 + c, cnt, acc);
  }
}

// 16 int8 values at p (cnt of them): one 16-byte access where whole and aligned
__device__ __forceinline__ void store16(int8_t* p, const int8_t (&v)[16], int cnt) {
  if (cnt == 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<int4*>(p) = pack16(v);
  } else {
    for (int j = 0; j < cnt; ++j) p[j] = v[j];
  }
}

__device__ __forceinline__ void load16(int8_t (&v)[16], const int8_t* p, int cnt) {
  if (cnt == 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    unpack16(v, *reinterpret_cast<const int4*>(p));
  } else {
    for (int j = 0; j < 16; ++j) v[j] = j < cnt ? p[j] : 0;
  }
}

// split-K: block z's partial sums to ws[z][M][N]
struct QmmPartial {
  int* ws;
  int m, n;
  __device__ __forceinline__ void operator()(int r, int c, int cnt, const int (&acc)[16]) const {
    int* p = ws + (static_cast<int64_t>(blockIdx.z) * m + r) * n + c;
    if (cnt == 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        reinterpret_cast<int4*>(p)[j] = make_int4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    } else {
      for (int j = 0; j < cnt; ++j) p[j] = acc[j];
    }
  }
};

}  // namespace
