// The bf16 tensor-core GEMM tile of K16's unaligned path (csrc/fused.cu:
// operands whose K or pointers do not allow 16-byte copies).
//
// A thread block of 8 warps owns a BM x BN tile of C = A[M, K] x B[N, K]^T
// (B is K-contiguous per output column: the port's OIHW weight as it is).
// K is walked in steps of 32; each step's A and B strips are staged in
// shared memory, double-buffered: the next step's strips are fetched from
// device memory into registers while the tensor cores work on this step's.
// Each warp runs mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate) over
// its (BM / WARPS_M) x (BN / WARPS_N) part.  Rows of the staged strips are
// padded to 40 bf16 (80 bytes), so the fragment loads of a warp hit 32
// distinct banks.
//
// A and B come through loader functors: ``uint4 operator()(int row, int k)``
// returns the 8 bf16 at tile row ``row`` and absolute depth k..k+7, zeros
// outside the matrix.
//
// bf16 values move as raw 16-bit words (uint16_t); bf2f widens exactly and
// f2bf rounds to nearest even, as the reference's astype(bfloat16) does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 32;        // depth per step: two m16n8k16
constexpr int kPitch = kBK + 8;

__device__ __forceinline__ float bf2f(uint16_t h) { return __uint_as_float(static_cast<uint32_t>(h) << 16); }

__device__ __forceinline__ uint16_t f2bf(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = static_cast<uint32_t>(f2bf(f[2 * i])) | (static_cast<uint32_t>(f2bf(f[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 bf16 at p[0..8): one 16-byte load where ``vec`` (p 16-byte aligned),
// else word by word; elements at or past ``valid`` read as 0
__device__ __forceinline__ uint4 load8(const uint16_t* __restrict__ p, int valid, bool vec) {
  if (valid >= 8 && vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < valid) w[j / 2] |= static_cast<uint32_t>(__ldg(p + j)) << (16 * (j % 2));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A row-major [rows, K] matrix (leading dimension ld) as a GEMM operand:
// tile row r is matrix row row0 + r, valid below ``rows``
struct PlainOperand {
  const uint16_t* p;
  int64_t row0;
  int rows, k, ld;
  bool vec;  // ld and p allow 16-byte loads
  __device__ __forceinline__ uint4 operator()(int r, int kk) const {
    if (r >= rows || kk >= k) return zero4();
    return load8(p + (row0 + r) * ld + kk, k - kk, vec);
  }
};

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps");
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;  // one warp's part
  static constexpr int MT = WTM / 16, NT = WTN / 8;             // its m16 and n8 fragments
  static_assert(MT * 16 == WTM && NT * 8 == WTN, "warp tile of whole fragments");
  static constexpr int A_PER = (BM * kBK / 8 + kThreads - 1) / kThreads;  // 16-byte chunks a thread stages
  static constexpr int B_PER = (BN * kBK / 8 + kThreads - 1) / kThreads;

  struct Smem {
    uint16_t a[2][BM][kPitch];
    uint16_t b[2][BN][kPitch];
  };
  using Acc = float[MT][NT][4];

  // warp coordinates and a lane's place in the m16n8 fragments
  static __device__ __forceinline__ int wm() { return (threadIdx.x / 32) / WARPS_N; }
  static __device__ __forceinline__ int wn() { return (threadIdx.x / 32) % WARPS_N; }
  static __device__ __forceinline__ int lane_g() { return (threadIdx.x % 32) >> 2; }
  static __device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }
  // tile row / column of acc[mt][nt][i]
  static __device__ __forceinline__ int row(int mt, int i) { return wm() * WTM + mt * 16 + lane_g() + (i >= 2 ? 8 : 0); }
  static __device__ __forceinline__ int col(int nt, int i) { return wn() * WTN + nt * 8 + 2 * lane_t() + (i & 1); }

  template <class LoadA, class LoadB>
  static __device__ __forceinline__ void fetch(uint4 (&ra)[A_PER], uint4 (&rb)[B_PER], const LoadA& la,
                                               const LoadB& lb, int k0) {
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int c = threadIdx.x + j * kThreads;
      ra[j] = c < BM * 4 ? la(c / 4, k0 + (c % 4) * 8) : zero4();
    }
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int c = threadIdx.x + j * kThreads;
      rb[j] = c < BN * 4 ? lb(c / 4, k0 + (c % 4) * 8) : zero4();
    }
  }

  static __device__ __forceinline__ void stage(Smem& sm, int s, const uint4 (&ra)[A_PER], const uint4 (&rb)[B_PER]) {
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < BM * 4) *reinterpret_cast<uint4*>(&sm.a[s][c / 4][(c % 4) * 8]) = ra[j];
    }
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < BN * 4) *reinterpret_cast<uint4*>(&sm.b[s][c / 4][(c % 4) * 8]) = rb[j];
    }
  }

  // acc = A[tile rows, 0:k] x B[tile cols, 0:k]^T
  template <class LoadA, class LoadB>
  static __device__ __forceinline__ void mainloop(Acc& acc, Smem& sm, const LoadA& la, const LoadB& lb, int k) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    const int g = lane_g(), t = lane_t(), rw = wm() * WTM, cw = wn() * WTN;
    const int steps = (k + kBK - 1) / kBK;
    uint4 ra[A_PER], rb[B_PER];
    fetch(ra, rb, la, lb, 0);
    stage(sm, 0, ra, rb);
    __syncthreads();
    for (int step = 0; step < steps; ++step) {
      const int s = step & 1;
      if (step + 1 < steps) fetch(ra, rb, la, lb, (step + 1) * kBK);  // in flight during the products
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = rw + mt * 16 + g;
          af[mt][0] = *reinterpret_cast<const uint32_t*>(&sm.a[s][r][kk + 2 * t]);
          af[mt][1] = *reinterpret_cast<const uint32_t*>(&sm.a[s][r + 8][kk + 2 * t]);
          af[mt][2] = *reinterpret_cast<const uint32_t*>(&sm.a[s][r][kk + 2 * t + 8]);
          af[mt][3] = *reinterpret_cast<const uint32_t*>(&sm.a[s][r + 8][kk + 2 * t + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = cw + nt * 8 + g;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sm.b[s][n][kk + 2 * t]);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&sm.b[s][n][kk + 2 * t + 8]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma16816(acc[mt][nt], af[mt], b0, b1);
        }
      }
      if (step + 1 < steps) stage(sm, s ^ 1, ra, rb);
      __syncthreads();  // stage s^1 written; stage s free for the next fetch
    }
  }
};

// out[row * ld + col], out[row * ld + col + 1] as bf16: one 32-bit store
// where both are in range and the pair is 4-byte aligned
__device__ __forceinline__ void store_pair(uint16_t* out, int64_t at, float v0, float v1, bool both, bool aligned) {
  if (both && aligned) {
    *reinterpret_cast<uint32_t*>(out + at) = static_cast<uint32_t>(f2bf(v0)) | (static_cast<uint32_t>(f2bf(v1)) << 16);
  } else {
    out[at] = f2bf(v0);
    if (both) out[at + 1] = f2bf(v1);
  }
}

}  // namespace
