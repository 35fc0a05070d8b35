// Kernel C's int8 conv tile, shared by kernel C (csrc/qblock.cu: one
// bottleneck a launch), K13 (csrc/qchain.cu: a chain of bottlenecks in one
// cooperative launch) and K11 (csrc/qconv3.cu: the stride-1 3x3 conv, conv2's
// implicit GEMM on an input halo staged from device memory).
//
// A tile is 8 x tw output positions (tw 8 or 16) of one image; its `s`
// blocks (a thread block cluster in kernel C and K13, plain channel slices
// in K11) each compute 1/s of every conv's output channels.  The phases:
//   conv1  1x1 on the tile and its 3x3 halo -> a1 (int8, swz rows, shared)
//   conv2  3x3 / stride, the implicit GEMM over the 9 taps on a1 -> a2
//   conv3  the shortcut and 1x1 on a2 -> the block output (16-byte words)
// each followed, in kernel C and K13, by push_slice: the block's channels
// into every peer's copy, then the cluster barrier.  csrc/qblock.cu's note
// gives the data rule, the ring and the bit-exactness argument.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "qmma_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kTH = 8;                  // output rows of a tile
constexpr int kRingBytes = 48 * 1024;   // the cp.async ring, cut into as many stages as a phase's step fits

// stages of the ring for steps of `rows` staged 64-byte rows (at most 8)
__host__ __device__ constexpr int ring_stages(int rows) {
  return kRingBytes / (rows * kStepBytes) < 8 ? kRingBytes / (rows * kStepBytes) : 8;
}

struct Args {
  const int8_t* x;
  const int8_t* w1;
  const int8_t* w2;
  const int8_t* w3;
  const int8_t* wd;  // nullptr: identity shortcut
  const float *a1, *b1, *a2, *b2, *a3, *b3, *ad, *bd;
  int8_t* out;
  int h, w, cin, cw, cout, stride, ho, wo;
  int tw_log2, split, tiles_x, tiles_y;
};

// one cluster block's tile
struct Tile {
  int img, oy0, ox0;  // image, first output row and column
  int iy0, ix0;       // input row and column of a1's (0, 0)
  int hw, mh;         // a1 columns, a1 positions
  int tw, p;          // output columns, positions
  int q, s;           // rank in the cluster, cluster size
  int cpr;            // 16-byte chunks of an a1 / a2 row (cw / 16)
  int8_t* a1;         // [mh][cw], swz rows
  int8_t* a2;         // [p][cw], swz rows
  uint32_t ring;      // kRingBytes (shared address)
  int8_t* ring_ptr;   // the same, generic
  const int8_t* x_img;
};

// tile `tile` of the launch's tile grid (image-major) for block q of s;
// shared memory: a1, a2, then the ring
__device__ __forceinline__ Tile tile_at(const Args& g, int tile, int q, int s, int8_t* smem) {
  Tile t;
  t.s = s;
  t.q = q;
  const int per_img = g.tiles_x * g.tiles_y;
  t.img = tile / per_img;
  const int rem = tile - t.img * per_img;
  t.tw = 1 << g.tw_log2;
  t.p = kTH * t.tw;
  t.oy0 = (rem / g.tiles_x) * kTH;
  t.ox0 = (rem % g.tiles_x) * t.tw;
  t.iy0 = t.oy0 * g.stride - 1;
  t.ix0 = t.ox0 * g.stride - 1;
  t.hw = (t.tw - 1) * g.stride + 3;
  t.mh = ((kTH - 1) * g.stride + 3) * t.hw;
  t.cpr = g.cw / 16;
  t.a1 = smem;
  t.a2 = smem + t.mh * g.cw;
  t.ring_ptr = t.a2 + t.p * g.cw;
  t.ring = smem_u32(t.ring_ptr);
  t.x_img = g.x + static_cast<int64_t>(t.img) * g.h * g.w * g.cin;
  return t;
}

// The cluster ranks of a tile's s blocks start at Group::first(t): kernel
// C's cluster is one tile's group (WholeCluster); K13's clusters hold
// several groups of a narrower split.
struct WholeCluster {
  static __device__ __forceinline__ int first(const Tile&) { return 0; }
};

// this block's slice [q * n, (q + 1) * n) of the rows [0, rows) of `buf`
// (swz rows of cpr chunks) into every other block of its group, then the
// cluster barrier
template <class Group>
__device__ __forceinline__ void push_slice(const Tile& t, int8_t* buf, int rows, int n) {
  cg::cluster_group cluster = cg::this_cluster();
  if (t.s > 1) {
    __syncthreads();
    const int nch = n / 16, c0 = t.q * nch, rank0 = Group::first(t);
    for (int i = threadIdx.x; i < rows * nch; i += kMmaThreads) {
      const int r = i / nch, off = swz(r, c0 + i % nch, t.cpr);
      const int4 v = *reinterpret_cast<const int4*>(buf + off);
      for (int j = 1; j < t.s; ++j) {
        int8_t* peer = cluster.map_shared_rank(buf, rank0 + (t.q + j) % t.s);
        *reinterpret_cast<int4*>(peer + off) = v;
      }
    }
  }
  cluster.sync();
}

// Each phase below runs one cp.async pipeline per chunk of its output
// channels (and, for conv1, of its halo rows); the chunk's epilogue follows
// the pipeline.

// conv1 over the halo: this block's cw / s channels of a1, pushed to the group
template <class T, class Group>
__device__ __forceinline__ void conv1(const Args& g, const Tile& t) {
  const int c1 = g.cw / t.s, nb = t.q * c1;
  const int steps = (g.cin + kStepBytes - 1) / kStepBytes;
  constexpr int JA = T::MC / 64;
  constexpr int kSlot = (T::MC + T::NC) * kStepBytes;
  for (int m0 = 0; m0 < t.mh; m0 += T::MC) {
    // this thread's staged A rows: halo positions m0 + tid / 4 + 64 j
    const int8_t* arow[JA];
    bool aok[JA];
#pragma unroll
    for (int j = 0; j < JA; ++j) {
      const int pos = m0 + (threadIdx.x >> 2) + 64 * j;
      const int iy = t.iy0 + pos / t.hw, ix = t.ix0 + pos % t.hw;
      aok[j] = pos < t.mh && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      arow[j] = t.x_img + (static_cast<int64_t>(iy) * g.w + ix) * g.cin;
    }
    for (int n0 = 0; n0 < c1; n0 += T::NC) {
      T mm;
      mm.zero();
      const int8_t* brow = g.w1 + static_cast<int64_t>(nb + n0 + (threadIdx.x >> 2)) * g.cin;
      auto issue = [&](int s, int slot) {
        const int kb = s * kStepBytes;
        const uint32_t sa = t.ring + slot * kSlot, sb = sa + T::MC * kStepBytes;
        auto kc = [&](int c) { return kb + 16 * c < g.cin; };
        stage_rows<T::MC>(sa, [&](int r) { return arow[r >> 6] + kb; }, [&](int r) { return aok[r >> 6]; }, kc, g.x);
        stage_rows<T::NC>(sb, [&](int r) { return brow + static_cast<int64_t>(r & ~63) * g.cin + kb; },
                          [&](int r) { return n0 + r < c1; }, kc, g.w1);
      };
      auto compute = [&](int, int slot) {
        const uint32_t sa = t.ring + slot * kSlot, sb = sa + T::MC * kStepBytes;
        mm.step([&](int r, int c) { return sa + swz64(r, c); }, [&](int r, int c) { return sb + swz64(r, c); },
                t.mh - m0);
      };
      pipeline<ring_stages(T::MC + T::NC)>(steps, issue, compute);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int pos = m0 + T::row(mt, 2 * hf);
          if (pos >= t.mh) continue;
          const int iy = t.iy0 + pos / t.hw, ix = t.ix0 + pos % t.hw;
          const bool inside = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt) {
            const int n = n0 + T::col(nt, 0);
            if (n >= c1) continue;
            const int ch = nb + n;
            char2 v = make_char2(0, 0);
            if (inside) {
              v.x = requant_relu(epilogue(mm.acc[mt][nt][2 * hf], __ldg(g.a1 + ch), __ldg(g.b1 + ch)));
              v.y = requant_relu(epilogue(mm.acc[mt][nt][2 * hf + 1], __ldg(g.a1 + ch + 1), __ldg(g.b1 + ch + 1)));
            }
            *reinterpret_cast<char2*>(t.a1 + swz(pos, ch >> 4, t.cpr) + (ch & 15)) = v;
          }
        }
    }
  }
  push_slice<Group>(t, t.a1, t.mh, c1);
}

// conv2's implicit GEMM over the 9 taps on the whole a1 (g.cw channels,
// weights [n][3][3][g.cw] at g.w2): this block's n / s output channels in
// chunks of T::NC; epi(mm, n0, c, nb) takes each chunk's sums (n0 its first
// channel of the block's c = n / s, nb the block's first channel) once the
// ring is drained
template <class T, class Epi>
__device__ __forceinline__ void conv3x3_gemm(const Args& g, const Tile& t, int n, const Epi& epi) {
  const int c2 = n / t.s, nb = t.q * c2;
  const int per_tap = (g.cw + kStepBytes - 1) / kStepBytes, steps = 9 * per_tap;
  const int s = g.stride, twm = t.tw - 1;
  constexpr int kSlot = T::NC * kStepBytes;
  for (int n0 = 0; n0 < c2; n0 += T::NC) {
    T mm;
    mm.zero();
    const int8_t* brow = g.w2 + static_cast<int64_t>(nb + n0 + (threadIdx.x >> 2)) * 9 * g.cw;
    auto issue = [&](int st, int slot) {
      const int tap = st / per_tap, c0 = (st - tap * per_tap) * kStepBytes;
      stage_rows<T::NC>(t.ring + slot * kSlot,
                        [&](int r) { return brow + static_cast<int64_t>(r & ~63) * 9 * g.cw + tap * g.cw + c0; },
                        [&](int r) { return n0 + r < c2; }, [&](int c) { return c0 + 16 * c < g.cw; }, g.w2);
    };
    auto compute = [&](int st, int slot) {
      const int tap = st / per_tap, k16 = (st - tap * per_tap) * (kStepBytes / 16);
      const int toff = (tap / 3) * t.hw + tap % 3;
      const uint32_t a1 = smem_u32(t.a1), sb = t.ring + slot * kSlot;
      mm.step(
          [&](int r, int c) {
            const int pos = ((r >> g.tw_log2) * s) * t.hw + (r & twm) * s + toff;
            return a1 + swz(pos, k16 + c, t.cpr);
          },
          [&](int r, int c) { return sb + swz64(r, c); }, t.p);
    };
    pipeline<ring_stages(T::NC)>(steps, issue, compute);
    epi(mm, n0, c2, nb);
  }
}

// conv2: this block's cw / s channels of a2, pushed to the group
template <class T, class Group>
__device__ __forceinline__ void conv2(const Args& g, const Tile& t) {
  conv3x3_gemm<T>(g, t, g.cw, [&](const T& mm, int n0, int c2, int nb) {
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = T::row(mt, 2 * hf);
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int n = n0 + T::col(nt, 0);
          if (n >= c2) continue;
          const int ch = nb + n;
          char2 v;
          v.x = requant_relu(epilogue(mm.acc[mt][nt][2 * hf], __ldg(g.a2 + ch), __ldg(g.b2 + ch)));
          v.y = requant_relu(epilogue(mm.acc[mt][nt][2 * hf + 1], __ldg(g.a2 + ch + 1), __ldg(g.b2 + ch + 1)));
          *reinterpret_cast<char2*>(t.a2 + swz(r, ch >> 4, t.cpr) + (ch & 15)) = v;
        }
      }
  });
  push_slice<Group>(t, t.a2, t.p, g.cw / t.s);
}

// the shortcut and conv3 on the whole a2: this block's cout / s channels of
// the block output
template <class T>
__device__ __forceinline__ void conv3(const Args& g, const Tile& t) {
  const int c3 = g.cout / t.s, nb = t.q * c3;
  const int s = g.stride, twm = t.tw - 1;
  constexpr int JA = T::MC / 64;
  // this thread's staged shortcut rows: output positions tid / 4 + 64 j
  const int8_t* arow[JA];
  bool aok[JA];
#pragma unroll
  for (int j = 0; j < JA; ++j) {
    const int r = (threadIdx.x >> 2) + 64 * j;
    const int oy = t.oy0 + (r >> g.tw_log2), ox = t.ox0 + (r & twm);
    aok[j] = oy < g.ho && ox < g.wo;
    arow[j] = t.x_img + (static_cast<int64_t>(oy * s) * g.w + ox * s) * g.cin;
  }
  for (int n0 = 0; n0 < c3; n0 += T::NC) {
    T mm;
    float y[T::MT][T::NT][4];  // the projection shortcut, accd * Ad + Bd
    if (g.wd != nullptr) {
      mm.zero();
      const int8_t* brow = g.wd + static_cast<int64_t>(nb + n0 + (threadIdx.x >> 2)) * g.cin;
      constexpr int kSlot = (T::MC + T::NC) * kStepBytes;
      auto issue = [&](int st, int slot) {
        const int kb = st * kStepBytes;
        const uint32_t sa = t.ring + slot * kSlot, sb = sa + T::MC * kStepBytes;
        auto kc = [&](int c) { return kb + 16 * c < g.cin; };
        stage_rows<T::MC>(sa, [&](int r) { return arow[r >> 6] + kb; }, [&](int r) { return aok[r >> 6]; }, kc, g.x);
        stage_rows<T::NC>(sb, [&](int r) { return brow + static_cast<int64_t>(r & ~63) * g.cin + kb; },
                          [&](int r) { return n0 + r < c3; }, kc, g.wd);
      };
      auto compute = [&](int, int slot) {
        const uint32_t sa = t.ring + slot * kSlot, sb = sa + T::MC * kStepBytes;
        mm.step([&](int r, int c) { return sa + swz64(r, c); }, [&](int r, int c) { return sb + swz64(r, c); },
                T::MC);
      };
      pipeline<ring_stages(T::MC + T::NC)>((g.cin + kStepBytes - 1) / kStepBytes, issue, compute);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ch = nb + min(n0 + T::col(nt, i), c3 - 1);
            y[mt][nt][i] = epilogue(mm.acc[mt][nt][i], __ldg(g.ad + ch), __ldg(g.bd + ch));
          }
    }
    mm.zero();
    const int8_t* brow = g.w3 + static_cast<int64_t>(nb + n0 + (threadIdx.x >> 2)) * g.cw;
    constexpr int kSlot = T::NC * kStepBytes;
    auto issue = [&](int st, int slot) {
      const int kb = st * kStepBytes;
      stage_rows<T::NC>(t.ring + slot * kSlot, [&](int r) { return brow + static_cast<int64_t>(r & ~63) * g.cw + kb; },
                        [&](int r) { return n0 + r < c3; }, [&](int c) { return kb + 16 * c < g.cw; }, g.w3);
    };
    auto compute = [&](int st, int slot) {
      const uint32_t a2 = smem_u32(t.a2), sb = t.ring + slot * kSlot;
      const int k16 = st * (kStepBytes / 16);
      mm.step([&](int r, int c) { return a2 + swz(r, k16 + c, t.cpr); }, [&](int r, int c) { return sb + swz64(r, c); },
              t.p);
    };
    pipeline<ring_stages(T::NC)>((g.cw + kStepBytes - 1) / kStepBytes, issue, compute);
    // (acc3 * A3 + B3) [+ the projection] as f32 into the drained ring (sum_at
    // rows) ...
    constexpr int kPitch = T::NC + 8;
    float* pre = reinterpret_cast<float*>(t.ring_ptr);
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int r = T::row(mt, 2 * hf), n = T::col(nt, 0), ch = nb + min(n0 + n, c3 - 2);
          float v0 = epilogue(mm.acc[mt][nt][2 * hf], __ldg(g.a3 + ch), __ldg(g.b3 + ch));
          float v1 = epilogue(mm.acc[mt][nt][2 * hf + 1], __ldg(g.a3 + ch + 1), __ldg(g.b3 + ch + 1));
          if (g.wd != nullptr) {
            v0 = __fadd_rn(v0, y[mt][nt][2 * hf]);
            v1 = __fadd_rn(v1, y[mt][nt][2 * hf + 1]);
          }
          *reinterpret_cast<float2*>(pre + sum_at(r, n, kPitch)) = make_float2(v0, v1);
        }
    __syncthreads();
    // ... then 16 channels of one position per thread: the identity
    // shortcut read and the block output written 16 bytes at a time
    const float short_mul = g.wd == nullptr ? __ldg(g.ad) : 0.0f;
    constexpr int kGroups = T::NC / 16;
    for (int gi = threadIdx.x; gi < T::MC * kGroups; gi += kMmaThreads) {
      const int r = gi / kGroups, n = (gi % kGroups) * 16;
      const int oy = t.oy0 + (r >> g.tw_log2), ox = t.ox0 + (r & twm);
      if (oy >= g.ho || ox >= g.wo || n0 + n >= c3) continue;
      const int ch = nb + n0 + n;
      float v[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 f = *reinterpret_cast<const float4*>(pre + sum_at(r, n + 4 * j, kPitch));
        v[4 * j] = f.x;
        v[4 * j + 1] = f.y;
        v[4 * j + 2] = f.z;
        v[4 * j + 3] = f.w;
      }
      int8_t xv[16], o[16];
      if (g.wd == nullptr) {  // identity: stride 1, cin == cout
        unpack16(xv, *reinterpret_cast<const int4*>(t.x_img + (static_cast<int64_t>(oy) * g.w + ox) * g.cin + ch));
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = __fadd_rn(v[j], __fmul_rn(static_cast<float>(xv[j]), short_mul));
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) o[j] = requant_relu(v[j]);
      *reinterpret_cast<int4*>(g.out + ((static_cast<int64_t>(t.img) * g.ho + oy) * g.wo + ox) * g.cout + ch) =
          pack16(o);
    }
    __syncthreads();  // the ring is free for the next chunk's copies
  }
}

using T128x128 = MmaTile<128, 128, 2>;
using T128x64 = MmaTile<128, 64, 4>;
using T64x128 = MmaTile<64, 128, 2>;
using T64x64 = MmaTile<64, 64, 2>;

// the whole bottleneck on one tile: the three phases, each on the widest
// MmaTile its channel slice fills; every block of the group already running
template <class Group>
__device__ __forceinline__ void bottleneck_tile(const Args& g, const Tile& t) {
  const int c1 = g.cw / t.s, c3 = g.cout / t.s;
  if (c1 % 128 == 0) {
    conv1<T128x128, Group>(g, t);
  } else {
    conv1<T128x64, Group>(g, t);
  }
  if (t.p == 128) {
    if (c1 % 128 == 0) {
      conv2<T128x128, Group>(g, t);
    } else {
      conv2<T128x64, Group>(g, t);
    }
    conv3<T128x64>(g, t);
  } else {
    if (c1 % 128 == 0) {
      conv2<T64x128, Group>(g, t);
    } else {
      conv2<T64x64, Group>(g, t);
    }
    if (c3 % 128 == 0) {
      conv3<T64x128>(g, t);
    } else {
      conv3<T64x64>(g, t);
    }
  }
}

// dynamic shared memory of one kernel C or K13 block (ops/qblock.smem_bytes):
// a1 (the halo), a2, the ring
size_t smem_bytes(int stride, int tw, int cw) {
  const size_t hw = static_cast<size_t>(tw - 1) * stride + 3, mh = static_cast<size_t>((kTH - 1) * stride + 3) * hw;
  return mh * cw + static_cast<size_t>(kTH) * tw * cw + kRingBytes;
}

// fills the tile fields of g for tiles of 8 x tw output positions, split
// blocks each; false where kernel C does not take them
bool set_tiles(Args& g, int batch, int tw, int split) {
  g.ho = (g.h - 1) / g.stride + 1;
  g.wo = (g.w - 1) / g.stride + 1;
  g.tw_log2 = tw == 16 ? 4 : 3;
  g.split = split;
  g.tiles_x = (g.wo + tw - 1) / tw;
  g.tiles_y = (g.ho + kTH - 1) / kTH;
  return (tw == 8 || tw == 16) && (split == 1 || split == 2 || split == 4 || split == 8) &&
         g.cw % (16 * split) == 0 && g.cout % (16 * split) == 0 && g.cin % 16 == 0 &&
         static_cast<int64_t>(batch) * g.tiles_x * g.tiles_y * split <= 0x7fffffff;
}

// the largest dynamic shared memory a block of `kernel` may take, set as its
// limit; once per process
template <class K>
cudaError_t opt_in_smem(K kernel, int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  return err;
}

}  // namespace
