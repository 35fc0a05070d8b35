// The int8 tensor-core tile shared by K4 (csrc/qmm_tile.cuh, csrc/qconv.cu,
// csrc/qmm_variants.cu), kernel C, K13 and K11 (csrc/qblock_tile.cuh, under
// csrc/qblock.cu, csrc/qchain.cu and csrc/qconv3.cu), K7/K9 (csrc/qhead.cu),
// K5 (csrc/qhis.cu), K1 (csrc/qstem.cu) and K12 (csrc/qmnblock.cu), and in
// bf16 by K15's 64-row blocks (csrc/head.cu); K16 (csrc/fused.cu) and K15's
// wgmma kernels take its cp.async helpers and sum_at().
//
// A thread block of 8 warps computes an MC x NC block of exact int32 sums
// C[m, n] = sum_k A[m, k] * B[n, k], both operands K-contiguous int8 (NHWC
// activations [M, K], the port's [N, K] weights), so neither is transposed.
// The warps form WARPS_M x (8 / WARPS_M); each owns a (MC / WARPS_M) x
// (NC / WARPS_N) part and runs mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
// on it, its fragments loaded from shared memory by ldmatrix (.x4: one m16
// A fragment of 32 bytes, or two n8 B fragments).  No .satfinite: |acc|
// stays at or below 127^2 * 4608 < 2^31 on every shape the port runs, so
// the int32 sums are exact in any order.  MmaTile<..., float> runs the same
// tile on bf16 operands, mma.sync m16n8k16 with f32 sums: an m16 x k16 bf16
// fragment covers the bytes of an m16 x k32 int8 one, so the staging and
// the ldmatrix addressing are the same.
//
// K is walked in steps of 64 bytes (two mma k32 slices, or two k16 in
// bf16).  Operands that come from device memory are staged by cp.async.cg
// 16-byte copies into a ring of stages (pipeline() below): while the tensor
// cores work on one step, the next steps' copies are in flight.  Staged
// rows are 64 bytes with their four 16-byte chunks XOR-swizzled (swz64), so
// the eight rows of an ldmatrix matrix hit 32 distinct banks (a dense
// 64-byte pitch gives a 4-way conflict).  Operands that live in shared
// memory already (kernel C's a1 and a2, K11's input halo) use swz() on
// their own row length.  step() issues each mma right after the ldmatrix
// it needs (asm volatile keeps that order); step_mt(), which K12 and K15
// use, loads every fragment of the step first, so the loads' latency
// overlaps, and takes the A address by m16 tile, so a caller can keep its
// lane's rows in registers.
//
// The accumulator fragment's layout gives the epilogue its (m, n): lane l
// holds rows l/4 and l/4 + 8, columns 2*(l%4) + {0, 1} of each m16n8 tile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaThreads = 256;  // 8 warps
constexpr int kStepBytes = 64;    // K bytes per pipeline step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, zeros where !valid (src is
// then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same fragments as bf16: an m16 x k16 A fragment and an n8 x k16 B
// fragment cover the bytes of an m16 x k32 / n8 x k32 int8 one, in the same
// registers, so ldmatrix loads both alike; f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the tile's mma by its sums' type: int8 operands for int sums, bf16 for f32
__device__ __forceinline__ void mma_op(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  mma_s8(d, a, b0, b1);
}
__device__ __forceinline__ void mma_op(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  mma_bf16(d, a, b0, b1);
}

// byte offset of 16-byte chunk c of row r in a staged strip of 64-byte rows:
// rows 2j and 2j+1 share a chunk permutation, so rows r..r+7 of one chunk
// column land on 8 distinct 4-bank groups
__device__ __forceinline__ int swz64(int r, int c) { return r * kStepBytes + ((c ^ ((r >> 1) & 3)) << 4); }

// byte offset of 16-byte chunk c of row r in rows of cpr chunks (cpr * 16
// bytes): 4-chunk rows as swz64, whole groups of 8 chunks XOR'd with r % 8,
// anything else in place (a chunk at or past cpr reads the next row: the
// callers pair it with zero weights)
__device__ __forceinline__ int swz(int r, int c, int cpr) {
  int x = 0;
  if (cpr == 4) {
    x = (r >> 1) & 3;
  } else if ((c | 7) < cpr) {
    x = r & 7;
  }
  return ((r * cpr) << 4) + ((c ^ x) << 4);
}

// Runs `steps` K steps through a ring of STAGES slots: issue(step, slot)
// stages a step's operands with cp_async16 (no commit), compute(step, slot)
// consumes them once they have landed.  Ends with the ring drained and the
// block synchronised, so the next pipeline may reuse every slot.
template <int STAGES, class Issue, class Compute>
__device__ __forceinline__ void pipeline(int steps, const Issue& issue, const Compute& compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s, s);
    cp_async_commit();
  }
  int slot = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // step s has landed (this thread's copies) ...
    __syncthreads();              // ... every thread's; slot (s - 1) % STAGES is free
    const int nx = s + STAGES - 1;
    if (nx < steps) issue(nx, nx % STAGES);
    cp_async_commit();
    compute(s, slot);
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// An MC x NC block of sums over 8 warps (WARPS_M x 8 / WARPS_M): int32 of
// int8 operands (Acc = int), or f32 of bf16 operands (Acc = float: a 64-byte
// step is then 32 bf16 of K, two k16 slices).
template <int MC_, int NC_, int WARPS_M_, class Acc = int>
struct MmaTile {
  static constexpr int MC = MC_, NC = NC_, WARPS_M = WARPS_M_, WARPS_N = 8 / WARPS_M_;
  static constexpr int WM = MC / WARPS_M, WN = NC / WARPS_N;  // one warp's part
  static constexpr int MT = WM / 16, NT = WN / 8;             // its m16 and n8 tiles
  static_assert(WARPS_M * WARPS_N == 8 && MT * 16 == WM && NT * 8 == WN && NT % 2 == 0, "whole fragments");

  Acc acc[MT][NT][4];

  static __device__ __forceinline__ int lane() { return threadIdx.x & 31; }
  static __device__ __forceinline__ int wm() { return (threadIdx.x >> 5) / WARPS_N; }
  static __device__ __forceinline__ int wn() { return (threadIdx.x >> 5) % WARPS_N; }
  // tile row / column of acc[mt][nt][i]
  static __device__ __forceinline__ int row(int mt, int i) {
    return wm() * WM + mt * 16 + (lane() >> 2) + (i >= 2 ? 8 : 0);
  }
  static __device__ __forceinline__ int col(int nt, int i) { return wn() * WN + nt * 8 + 2 * (lane() & 3) + (i & 1); }
  // first tile row of the warp's m16 tile mt (warp-uniform)
  static __device__ __forceinline__ int mt_row0(int mt) { return wm() * WM + mt * 16; }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = Acc(0);
  }

  // acc += A[rows, step] x B[cols, step]^T over one 64-byte step.
  // a_addr(r, c): shared address of 16-byte chunk c (0..3) of the step's A
  // row r; b_addr(n, c) the same for B.  m16 tiles at or past `live_rows`
  // are skipped (their sums are not used).
  template <class AAddr, class BAddr>
  __device__ __forceinline__ void step(const AAddr& a_addr, const BAddr& b_addr, int live_rows) {
    const int l = lane();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // two k32 slices: chunks 2kk, 2kk + 1
      uint32_t bf[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldsm_x4(bf[np], b_addr(wn() * WN + np * 16 + (l & 7) + ((l >> 4) << 3), 2 * kk + ((l >> 3) & 1)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt_row0(mt) >= live_rows) continue;
        uint32_t af[4];
        ldsm_x4(af, a_addr(mt_row0(mt) + (l & 15), 2 * kk + (l >> 4)));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma_op(acc[mt][2 * np], af, bf[np][0], bf[np][1]);
          mma_op(acc[mt][2 * np + 1], af, bf[np][2], bf[np][3]);
        }
      }
    }
  }

  // step() with every fragment of the step loaded before its first mma (the
  // loads' latency overlaps), and a_addr(mt, c): the address of chunk c of
  // this lane's A row of m16 tile mt (row mt_row0(mt) + lane % 16), so a
  // caller can keep the lane's rows in registers across the steps.
  template <class AAddr, class BAddr>
  __device__ __forceinline__ void step_mt(const AAddr& a_addr, const BAddr& b_addr, int live_rows) {
    const int l = lane();
    uint32_t bf[2][NT / 2][4], af[2][MT][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // two k32 (int8) or k16 (bf16) slices: chunks 2kk, 2kk + 1
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldsm_x4(bf[kk][np], b_addr(wn() * WN + np * 16 + (l & 7) + ((l >> 4) << 3), 2 * kk + ((l >> 3) & 1)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (mt_row0(mt) < live_rows) ldsm_x4(af[kk][mt], a_addr(mt, 2 * kk + (l >> 4)));
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt_row0(mt) >= live_rows) continue;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma_op(acc[mt][2 * np], af[kk][mt], bf[kk][np][0], bf[kk][np][1]);
          mma_op(acc[mt][2 * np + 1], af[kk][mt], bf[kk][np][2], bf[kk][np][3]);
        }
      }
  }
};

// Stages rows [0, ROWS) of one 64-byte step into a swz64 strip at `strip`:
// thread t copies chunk t % 4 of rows t / 4 + 64 j.  src(r) is row r's
// first byte of the step (not formed where !ok(r)); chunk c is read where
// ok(r) and kc(c) (the chunk lies inside K), zeros elsewhere; `safe` is any
// device address, passed where nothing is read.
template <int ROWS, class Src, class Ok, class KOk>
__device__ __forceinline__ void stage_rows(uint32_t strip, const Src& src, const Ok& ok, const KOk& kc,
                                           const void* safe) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < (ROWS + 63) / 64; ++j) {
    const int r = (threadIdx.x >> 2) + 64 * j;
    if (ROWS % 64 == 0 || r < ROWS) {
      const bool v = ok(r) && kc(c);
      cp_async16(strip + swz64(r, c), v ? static_cast<const void*>(src(r) + 16 * c) : safe, v);
    }
  }
}

// Rows of int32 or f32 sums staged for an epilogue that reads 16 columns of
// a row per thread: element (r, c) of rows of `pitch` words (a multiple of 8
// plus 8: the 8-byte fragment stores of a half-warp's 4 rows hit distinct
// banks).  16-byte chunk c / 4 is XOR'd with (c / 32) % 4, so the 8 threads
// of a quarter-warp, reading chunk j of 8 consecutive 16-column groups, hit
// 8 distinct bank groups.
__device__ __forceinline__ int sum_at(int r, int c, int pitch) {
  return r * pitch + ((((c >> 2) ^ (c >> 5)) & 3) | ((c >> 2) & ~3)) * 4 + (c & 3);
}

// 16 int8 values as one 16-byte word, and back (register moves, no local memory)
__device__ __forceinline__ int4 pack16(const int8_t (&v)[16]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(static_cast<uint8_t>(v[4 * i])) |
           static_cast<uint32_t>(static_cast<uint8_t>(v[4 * i + 1])) << 8 |
           static_cast<uint32_t>(static_cast<uint8_t>(v[4 * i + 2])) << 16 |
           static_cast<uint32_t>(static_cast<uint8_t>(v[4 * i + 3])) << 24;
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]), static_cast<int>(w[3]));
}

__device__ __forceinline__ void unpack16(int8_t (&v)[16], const int4& q) {
  const uint32_t w[4] = {static_cast<uint32_t>(q.x), static_cast<uint32_t>(q.y), static_cast<uint32_t>(q.z),
                         static_cast<uint32_t>(q.w)};
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xff);
}

}  // namespace
