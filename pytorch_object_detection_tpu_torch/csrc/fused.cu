// K16: out = act((x @ w^T) * scale + shift (+ residual)), bf16 in and out, the
// product accumulated in f32 on the tensor cores and the epilogue in f32
// registers before the single bf16 store.  The fused ResNet-50's conv1 and
// conv3 (nn/fused_resnet.resnet50_fused_forward) run through it: a 1x1
// stride-1 conv over an NHWC map is this GEMM with M = B*H*W, and conv3
// takes the block's shortcut as the residual and the ReLU.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_fused.py:matmul_bn_act
// (both of its pallas_calls, with and without the residual) and
// :conv1x1_bn_act.  The TPU kernel keeps a (block_m x K) strip of x and a
// (K x block_n) strip of w in VMEM and runs one MXU dot, so the frozen BN,
// the residual add and the ReLU cost no extra pass over device memory.
// The same rule holds here; the TPU tiling rules (block_m dividing M, K and
// N multiples of 128) do not: M, N and K may be anything (a K that is not a
// multiple of 8, or an operand that is not 16-byte aligned, takes the
// word-by-word loads).
//
// Layouts: x [M, K], w [N, K] (the port's OIHW 1x1 weight: each output
// channel's K-vector contiguous, the .col B operand of mma.sync as it is),
// residual and out [M, N], all bf16 row-major; scale, shift f32 [N].
//
// Design: 128 x 128 output tiles, or 128 x 64 where N <= 64 or where 128 x
// 128 tiles do not fill the card (ops/fused.pick_k16_tile).  K is walked in
// stages of 64 bf16: x and w rows come through a ring of 3 cp.async.cg
// stages into 128-byte rows with the 128-byte swizzle that wgmma reads, and
// each warpgroup (rows 64 g .. 64 g + 63) runs
// wgmma.mma_async.m64nBNk16.f32.bf16.bf16 on shared-memory descriptors, 4
// per stage, waiting for them before the stage's slot is refilled.  The f32
// sums go through shared memory (the drained ring), so the epilogue reads
// scale, shift and the residual and writes the output as 16-byte words:
// each thread takes one 16-column group of 4 (or 8) rows and loads all its
// residual words before it uses any.  A K that is not a multiple of 8, or x
// or w not 16-byte aligned, takes the word-by-word tile of csrc/bf16_mma.cuh
// (mma.sync from registers, two slots of padded rows) instead.
//
// Bound on the card: at 512x512 the 32 GEMMs of a B=8 forward move 1.82 GB
// and do 73.6 G multiply-adds, about 80 per byte, under the card's ~295
// bf16 operations per byte: device memory bounds them, the layer-1 GEMMs
// (K = 64, one stage) most; their stores are a third of their bytes.  Not
// done here: TMA and a producer warp, wgmma overlapped with the next copies.
//
// Numerics: each epilogue multiply and add is a separate f32 operation
// (-fmad=false), in the reference's order; the product's sum runs in
// another order than the plain version's f32 matmul, so an output may
// differ from it by one bf16 rounding step.
#include "bf16_mma.cuh"
#include "qmma_tile.cuh"

namespace {

struct Args {
  const uint16_t* x;
  const uint16_t* w;
  const float* scale;
  const float* shift;
  const uint16_t* res;  // nullptr: no residual
  uint16_t* out;
  int m, n, k, act;
  bool vec;      // x and w take 16-byte copies (K % 8 == 0, both 16-byte aligned)
  bool vec_epi;  // scale, shift, residual and out take 16-byte words (N % 8 == 0, all aligned)
};

constexpr int kRingStages = 3;  // stages of 64 bf16 of K (one 128-byte swizzled row each)

template <int BN>
struct RingShape {
  static constexpr int kStageA = 128 * 128, kStage = (128 + BN) * 128;  // bytes: the x rows, then the w rows
  static constexpr int kPitch = BN + 8;                                // f32 words of a staged row of sums
  static constexpr int kRing = kRingStages * kStage, kSums = 128 * kPitch * 4;
  // ops/fused.k16_smem_bytes: the ring (reused for the sums), 1024 bytes for aligning it
  static constexpr int kSmem = (kRing > kSums ? kRing : kSums) + 1024;
};

// a wgmma shared-memory descriptor of a K-major operand in 128-byte swizzled
// rows (8-row atoms of 1024 bytes, 1024-byte aligned) starting at addr
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b) { wgmma_n128(d, a, b); }
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b) { wgmma_n64(d, a, b); }

// byte offset of 16-byte chunk c of row r in 128-byte rows, 128-byte swizzle
__device__ __forceinline__ int swz128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// 16 outputs (m, n) .. (m, n + cnt - 1) from their f32 sums, element by
// element (a ragged N edge, or operands the 16-byte path does not take)
__device__ __forceinline__ void epilogue_scalar(const Args& g, int64_t m, int n, int cnt, const float (&acc)[16]) {
  const int64_t at = m * g.n + n;
  for (int j = 0; j < cnt; ++j) {
    float y = __fadd_rn(__fmul_rn(acc[j], __ldg(g.scale + n + j)), __ldg(g.shift + n + j));
    if (g.res != nullptr) y = __fadd_rn(y, bf2f(g.res[at + j]));
    g.out[at + j] = f2bf(g.act ? fmaxf(y, 0.0f) : y);
  }
}

// the 128 x BN tile of block (blockIdx.x, blockIdx.y): cp.async ring,
// wgmma from shared memory (warpgroup g: rows 64 g .. 64 g + 63); dynamic
// smem RingShape<BN>::kSmem bytes
template <int BN>
__global__ void __launch_bounds__(kMmaThreads, 2) matmul_bn_act_ring(const Args g) {
  using S = RingShape<BN>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * 128;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, wg = tid >> 7;
  const uint16_t* xr = g.x + m0 * g.k;
  const uint16_t* wr = g.w + static_cast<int64_t>(n0) * g.k;
  const int steps = (g.k + 63) / 64;
  auto issue = [&](int s, int slot) {
    const uint32_t a = base + slot * S::kStage, b = a + S::kStageA;
    const int c = tid & 7, kc = s * 64 + 8 * c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (tid >> 3) + 32 * j;
      const bool v = m0 + r < g.m && kc < g.k;
      cp_async16(a + swz128(r, c), v ? static_cast<const void*>(xr + static_cast<int64_t>(r) * g.k + kc) : g.x, v);
    }
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int r = (tid >> 3) + 32 * j;
      const bool v = n0 + r < g.n && kc < g.k;
      cp_async16(b + swz128(r, c), v ? static_cast<const void*>(wr + static_cast<int64_t>(r) * g.k + kc) : g.w, v);
    }
  };
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) {
    if (s < steps) issue(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRingStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the copies, seen by wgmma
    __syncthreads();
    const int nx = s + kRingStages - 1;
    if (nx < steps) issue(nx, nx % kRingStages);
    cp_async_commit();
    const uint32_t a = base + (s % kRingStages) * S::kStage;
    const uint64_t da = sw128_desc(a + wg * 64 * 128), db = sw128_desc(a + S::kStageA);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma(d, da + 2 * kk, db + 2 * kk);  // 16 bf16 = 32 bytes further along K
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // the slot is free for the next copies
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
  cp_async_wait<0>();
  __syncthreads();

  // the f32 sums into the drained ring, then 16 outputs of a row per thread
  float* sums = reinterpret_cast<float*>(smem);
  {
    const int l = tid & 31, row = wg * 64 + ((tid >> 5) & 3) * 16 + (l >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(sums + sum_at(row + 8 * hf, 8 * j + 2 * (l & 3), S::kPitch)) =
            make_float2(d[4 * j + 2 * hf], d[4 * j + 2 * hf + 1]);
  }
  __syncthreads();
  // each thread: one 16-column group c (the same in every pass, as
  // kMmaThreads is a multiple of BN / 16) of rows r0 + kRowsPer * i; the
  // residual words of all its rows are loaded before any is used
  constexpr int kGroups = BN / 16, kRowsPer = kMmaThreads / kGroups, kIters = 128 / kRowsPer;
  const int c = (threadIdx.x % kGroups) * 16, r0 = threadIdx.x / kGroups, n = n0 + c;
  const int cnt = min(16, g.n - n);
  if (cnt <= 0) return;
  const bool vec = cnt == 16 && g.vec_epi;
  uint4 rw[kIters][2];
  if (vec && g.res != nullptr) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int64_t m = m0 + r0 + kRowsPer * i;
      if (m < g.m) {
        rw[i][0] = __ldg(reinterpret_cast<const uint4*>(g.res + m * g.n + n));
        rw[i][1] = __ldg(reinterpret_cast<const uint4*>(g.res + m * g.n + n) + 1);
      }
    }
  }
  float sc[16], sh[16];
  if (vec) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(g.scale + n) + j);
      const float4 b = __ldg(reinterpret_cast<const float4*>(g.shift + n) + j);
      sc[4 * j] = a.x, sc[4 * j + 1] = a.y, sc[4 * j + 2] = a.z, sc[4 * j + 3] = a.w;
      sh[4 * j] = b.x, sh[4 * j + 1] = b.y, sh[4 * j + 2] = b.z, sh[4 * j + 3] = b.w;
    }
  }
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int r = r0 + kRowsPer * i;
    const int64_t m = m0 + r;
    if (m >= g.m) break;
    float acc[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(sums + sum_at(r, c + 4 * j, S::kPitch));
      acc[4 * j] = v.x, acc[4 * j + 1] = v.y, acc[4 * j + 2] = v.z, acc[4 * j + 3] = v.w;
    }
    if (!vec) {
      epilogue_scalar(g, m, n, cnt, acc);
      continue;
    }
    float res[16];
    if (g.res != nullptr) {
      float lo[8], hi[8];
      unpack8(rw[i][0], lo);
      unpack8(rw[i][1], hi);
#pragma unroll
      for (int j = 0; j < 8; ++j) res[j] = lo[j], res[8 + j] = hi[j];
    }
    float lo[8], hi[8];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = __fadd_rn(__fmul_rn(acc[j], sc[j]), sh[j]);
      if (g.res != nullptr) v = __fadd_rn(v, res[j]);
      v = g.act ? fmaxf(v, 0.0f) : v;
      (j < 8 ? lo[j] : hi[j - 8]) = v;
    }
    uint4* out = reinterpret_cast<uint4*>(g.out + m * g.n + n);
    out[0] = pack8(lo);
    out[1] = pack8(hi);
  }
}

// the word-by-word tile (csrc/bf16_mma.cuh): any K, any alignment
template <class T>
__global__ void __launch_bounds__(kThreads) matmul_bn_act_kernel(const Args g) {
  __shared__ __align__(16) typename T::Smem sm;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int rows = g.m - m0 < T::BM ? static_cast<int>(g.m - m0) : T::BM;
  const PlainOperand la{g.x, m0, rows, g.k, g.k, g.vec};
  const PlainOperand lb{g.w, n0, min(T::BN, g.n - n0), g.k, g.k, g.vec};
  typename T::Acc acc;
  T::mainloop(acc, sm, la, lb, g.k);

  const bool aligned = (g.n % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + T::row(mt, 2 * h);
      if (m >= g.m) continue;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int n = n0 + T::col(nt, 0);
        if (n >= g.n) continue;
        const bool both = n + 1 < g.n;
        const int64_t at = m * g.n + n;
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j == 1 && !both) {
            y[1] = 0.0f;
            continue;
          }
          float v = __fadd_rn(__fmul_rn(acc[mt][nt][2 * h + j], __ldg(g.scale + n + j)), __ldg(g.shift + n + j));
          if (g.res != nullptr) v = __fadd_rn(v, bf2f(g.res[at + j]));
          y[j] = g.act ? fmaxf(v, 0.0f) : v;
        }
        store_pair(g.out, at, y[0], y[1], both, aligned);
      }
    }
}

using Wide = Tile<128, 128, 2, 4>;
using Narrow = Tile<128, 64, 4, 2>;

template <int BN>
cudaError_t launch_ring(const Args& g, cudaStream_t s) {
  using S = RingShape<BN>;
  static bool attr = false;  // the ring takes more than the default 48 KB of shared memory
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(matmul_bn_act_ring<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const dim3 grid((g.m + 127) / 128, (g.n + BN - 1) / BN);
  matmul_bn_act_ring<BN><<<grid, kMmaThreads, S::kSmem, s>>>(g);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one block of the ring kernel with 128 x bn tiles.
extern "C" int matmul_bn_act_smem(int bn) {
  return bn == 128 ? RingShape<128>::kSmem : RingShape<64>::kSmem;
}

// Returns a cudaError_t (0 = launched).  res may be null; bn (128 or 64,
// ops/fused.pick_k16_tile) is the tile's width.
extern "C" int matmul_bn_act_launch(const void* x, const void* w, const void* scale, const void* shift,
                                    const void* res, void* out, int m, int n, int k, int act, int bn, void* stream) {
  Args g;
  g.x = static_cast<const uint16_t*>(x);
  g.w = static_cast<const uint16_t*>(w);
  g.scale = static_cast<const float*>(scale);
  g.shift = static_cast<const float*>(shift);
  g.res = static_cast<const uint16_t*>(res);
  g.out = static_cast<uint16_t*>(out);
  g.m = m;
  g.n = n;
  g.k = k;
  g.act = act;
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  g.vec = k % 8 == 0 && a16(x) && a16(w);
  g.vec_epi = n % 8 == 0 && a16(scale) && a16(shift) && a16(out) && (res == nullptr || a16(res));
  if (bn != 128 && bn != 64) return static_cast<int>(cudaErrorInvalidValue);
  if ((n + bn - 1) / bn > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.vec) return static_cast<int>(bn == 128 ? launch_ring<128>(g, s) : launch_ring<64>(g, s));
  if (bn == 64) {
    const dim3 grid((m + Narrow::BM - 1) / Narrow::BM, (n + Narrow::BN - 1) / Narrow::BN);
    matmul_bn_act_kernel<Narrow><<<grid, kThreads, 0, s>>>(g);
  } else {
    const dim3 grid((m + Wide::BM - 1) / Wide::BM, (n + Wide::BN - 1) / Wide::BN);
    matmul_bn_act_kernel<Wide><<<grid, kThreads, 0, s>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}
