// Kernel B: GroupNorm + activation (relu, silu or none) over NCHW tensors.
//
// Replaces pytorch_object_detection_tpu/ops/pallas_gn.py:groupnorm_act,
// which keeps one image's NHWC map in VMEM, reduces per-channel sums and
// squares, folds them into groups with 0/1 membership matmuls (Mosaic
// cannot reshape the lane dimension) and writes the activated result.
//
// In NCHW the channels of a group are one contiguous slab of cg * H * W
// elements, so no membership matrix is needed.  Bound on the card:
// device-memory bytes, the map read once and written once (about 8 f32
// operations an element, far below the card's rate).  The design:
//
// * One read from device memory.  The resident path stages a slab in
//   shared memory by one bulk copy (cp.async.bulk on an mbarrier: the copy
//   engine moves it, no thread issues a load a word), sums it there, then
//   normalizes from shared memory and writes 16-byte words.  A slab larger than a block
//   holds is split across a thread block cluster of `split` blocks (2, 4 or
//   8): each rank stages its part and the partial sums meet through
//   distributed shared memory.  Above what a cluster of 8 holds (about 1.7
//   MB of bf16) the streaming path reads the slab twice from device memory,
//   in 16-byte words, with the same split.
// * Small slabs (the 8x8 and 4x4 levels): a team of one or a few warps a
//   slab, `per_block` slabs a block, so that the card fills at B=8.
// * The statistics do not depend on the tiling.  A slab is cut into chunks
//   of 256 16-byte units (4 KB) counted from the 16-byte boundary at or
//   below its first element; one warp sums a chunk in a fixed order (lane l
//   takes units l, l + 32, ..., each unit's elements in order, then the
//   warp's xor butterfly), and the chunks' sums are folded in chunk order.
//   Every split, team and path gives the same bits, and so does every run.
// * scale and bias are read in their own dtype (f32 or bf16, exact in f32),
//   so the pipeline's bf16 model needs no cast kernel a call.
//
// Numerics follow flax nn.GroupNorm: f32 statistics, biased variance
// E[x^2] - mean^2 clamped at 0, rsqrt(var + eps); y = x * mul + add with
// mul = rsqrt * scale[c], add = bias[c] - mean * mul (a multiply and an
// add, each rounded, as the plain version: an element equal to the mean
// then gives bias exactly, however large mul); silu as y * sigmoid(y) = y / (1 + exp(-y)) with the card's
// fast exp2 and reciprocal (__expf, __fdividef: a few ulps, where the exact
// expf and division would make the 64x64 levels' silu bound by the
// instructions, not by the bytes).  The output has
// the input's dtype (round to nearest even for bf16).  The f32 steps are
// written as __fadd_rn / __fmul_rn / __fmaf_rn, so no path's code contracts
// them differently from another's.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunkUnits = 256;              // 16-byte units a chunk
constexpr int kLaneUnits = kChunkUnits / 32;  // units a lane sums in a chunk
constexpr int kMaxThreads = 256;
// loads a thread has in flight before it uses them: 4 from device memory
// (streaming), 1 from shared memory (resident: fewer registers, more blocks)
template <bool kResident>
struct Batch {
  static constexpr int kN = kResident ? 1 : 4;
};

struct Args {
  const void* x;
  const void* scale;
  const void* bias;
  void* y;
  int nslabs;   // batch * groups
  int groups;
  int cg;       // channels a group
  int hw;
  int n;        // elements a slab, cg * hw
  float eps;
  int act;      // 0 none, 1 relu, 2 silu
  int param_f32;  // scale and bias: 1 f32, 0 bf16
  int split;      // blocks a cluster: ranks of one slab
  int per_block;  // slabs a block (split 1)
  int cpr;        // chunks a rank holds
};

template <typename T>
struct Unit {
  static constexpr int kN = 16 / sizeof(T);  // elements a 16-byte unit
};

__device__ __forceinline__ void unpack(const uint4& v, float* f, float*) {
  memcpy(f, &v, 16);
}
__device__ __forceinline__ void unpack(const uint4& v, float* f, __nv_bfloat16*) {
  __nv_bfloat162 h[4];
  memcpy(h, &v, 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float param(const void* p, int i, int f32) {
  return f32 ? static_cast<const float*>(p)[i] : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one slab's geometry: unit 0 starts at the 16-byte boundary at or below
// its first element (x is 16-byte aligned, so that is (s * n) % kN
// elements before it)
template <typename T>
struct Slab {
  const T* xb;  // unit 0 of x
  T* yb;        // unit 0 of y (the same offsets: y is 16-byte aligned too)
  int off;      // elements of unit 0 before the slab
  int nu;       // units
  int nc;       // chunks
  __device__ Slab(const Args& g, int s) {
    constexpr int kN = Unit<T>::kN;
    const int64_t first = static_cast<int64_t>(s) * g.n;
    off = static_cast<int>(first % kN);
    xb = static_cast<const T*>(g.x) + (first - off);
    yb = static_cast<T*>(g.y) + (first - off);
    nu = (off + g.n + kN - 1) / kN;
    nc = (nu + kChunkUnits - 1) / kChunkUnits;
  }
  // elements [lo, hi) of unit u lie in the slab
  __device__ __forceinline__ void range(int u, int n, int& lo, int& hi) const {
    constexpr int kN = Unit<T>::kN;
    const int i0 = u * kN - off;
    lo = i0 < 0 ? -i0 : 0;
    hi = n - i0 < kN ? n - i0 : kN;
  }
};

// unit u of the slab: from shared memory (the staged copy, unit u at
// staged[u - u0]) or from device memory (a partial unit element by element,
// so nothing outside the slab is read); elements outside [lo, hi) are junk
template <typename T, bool kResident>
__device__ __forceinline__ uint4 load_unit(const Slab<T>& sl, const uint4* staged, int u0, int u, int lo, int hi) {
  constexpr int kN = Unit<T>::kN;
  if (kResident) return staged[u - u0];
  if (lo == 0 && hi == kN) return __ldg(reinterpret_cast<const uint4*>(sl.xb) + u);
  T t[kN];
#pragma unroll
  for (int e = 0; e < kN; ++e) t[e] = e >= lo && e < hi ? sl.xb[u * kN + e] : sl.xb[u * kN + lo];
  uint4 v;
  memcpy(&v, t, 16);
  return v;
}

// (sum, sum of squares) of chunk k, the same in every lane: lane l sums
// units k * 256 + l + 32 j in order of j, each unit's elements in order,
// then the xor butterfly (each step adds the same two values in every lane);
// kBatch units' loads are in flight before their sums
template <typename T, bool kResident>
__device__ float2 chunk_stats(const Slab<T>& sl, const uint4* staged, int u0, int k, int n, int lane) {
  constexpr int kN = Unit<T>::kN;
  constexpr int kBatch = Batch<kResident>::kN;
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int h = 0; h < kLaneUnits; h += kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = k * kChunkUnits + (h + j) * 32 + lane;
      if (u < sl.nu) {
        int lo, hi;
        sl.range(u, n, lo, hi);
        v[j] = load_unit<T, kResident>(sl, staged, u0, u, lo, hi);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = k * kChunkUnits + (h + j) * 32 + lane;
      if (u < sl.nu) {
        int lo, hi;
        sl.range(u, n, lo, hi);
        float f[kN];
        unpack(v[j], f, static_cast<T*>(nullptr));
        if (lo == 0 && hi == kN) {
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            s = __fadd_rn(s, f[e]);
            ss = __fmaf_rn(f[e], f[e], ss);
          }
        } else {
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            if (e >= lo && e < hi) {
              s = __fadd_rn(s, f[e]);
              ss = __fmaf_rn(f[e], f[e], ss);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  }
  return make_float2(s, ss);
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) return fmaxf(y, 0.0f);
  if (act == 2) return __fdividef(y, 1.0f + __expf(-y));  // 0 where exp(-y) overflows: silu's limit
  return y;
}

// normalize unit u (elements [lo, hi)) with the slab's (mul, add) pairs and write it
template <typename T>
__device__ __forceinline__ void normalize_unit(const Slab<T>& sl, const float2* muladd, uint4 v, int u, int lo,
                                               int hi, int hw, int act) {
  constexpr int kN = Unit<T>::kN;
  float f[kN];
  unpack(v, f, static_cast<T*>(nullptr));
  const int i = u * kN - sl.off + lo;
  int ci = i / hw, r = i - ci * hw;
  float2 m = muladd[ci];
  T out[kN];
  if (lo == 0 && hi == kN && r + kN <= hw) {  // a whole unit of one channel
#pragma unroll
    for (int e = 0; e < kN; ++e) from_f32(activate(__fadd_rn(__fmul_rn(f[e], m.x), m.y), act), out + e);
    uint4 w;
    memcpy(&w, out, 16);
    reinterpret_cast<uint4*>(sl.yb)[u] = w;
    return;
  }
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    if (e < lo || e >= hi) continue;
    from_f32(activate(__fadd_rn(__fmul_rn(f[e], m.x), m.y), act), out + e);
    if (++r == hw && e + 1 < hi) {
      r = 0;
      m = muladd[++ci];
    }
  }
  if (lo == 0 && hi == kN) {
    uint4 w;
    memcpy(&w, out, 16);
    reinterpret_cast<uint4*>(sl.yb)[u] = w;
  } else {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      if (e >= lo && e < hi) sl.yb[u * kN + e] = out[e];
    }
  }
}

// a team's shared memory, 16-byte aligned for the next team's staged units:
// [cpr * 256 units staged (resident)] [cpr float2 partials] [float2 mean,
// rsqrt] [the staging's mbarrier] [cg float2 mul, add]
__host__ __device__ __forceinline__ int team_smem_bytes(bool resident, int cpr, int cg) {
  return ((resident ? cpr * kChunkUnits * 16 : 0) + cpr * 8 + 8 + 8 + cg * 8 + 15) / 16 * 16;
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid (ceil(nslabs / per_block) * split), blocks of per_block teams of
// blockDim.x / per_block threads, one slab a team, clusters of split
template <typename T, bool kResident>
__global__ void __launch_bounds__(kMaxThreads) gn_act_kernel(const Args g) {
  constexpr int kN = Unit<T>::kN;
  constexpr int kBatch = Batch<kResident>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = blockDim.x / g.per_block;
  const int j = threadIdx.x / team, tt = threadIdx.x % team;
  const int lane = tt % 32, warp = tt / 32, warps = team / 32;
  const int rank = g.split > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int s = (blockIdx.x / g.split) * g.per_block + j;
  const bool live = s < g.nslabs;

  unsigned char* mine = smem + j * team_smem_bytes(kResident, g.cpr, g.cg);
  uint4* staged = reinterpret_cast<uint4*>(mine);
  float2* parts = reinterpret_cast<float2*>(mine + (kResident ? g.cpr * kChunkUnits * 16 : 0));
  float2* stats = parts + g.cpr;
  uint64_t* bar = reinterpret_cast<uint64_t*>(stats + 1);
  float2* muladd = reinterpret_cast<float2*>(bar + 1);

  const Slab<T> sl(g, live ? s : 0);
  const int k0 = rank * g.cpr;
  const int k1 = min(sl.nc, k0 + g.cpr);
  const int u0 = k0 * kChunkUnits;
  const int u1 = min(sl.nu, k1 * kChunkUnits);

  // 1. stage the rank's units (resident): its whole units in one bulk copy
  // (the copy engine, completing on the team's mbarrier), the slab's
  // partial first and last units element by element
  if (kResident) {
    if (tt == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (live) {
      const int f0 = max(u0, sl.off ? 1 : 0), f1 = max(f0, min(u1, (sl.off + g.n) / kN));
      if (tt == 0) {
        const uint32_t bytes = static_cast<uint32_t>(f1 - f0) * 16;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
                     : "memory");
        if (bytes)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                  smem_addr(staged + (f0 - u0))),
              "l"(reinterpret_cast<const uint4*>(sl.xb) + f0), "r"(bytes), "r"(smem_addr(bar))
              : "memory");
      }
      // the partial units: at most the slab's first (u0 < f0) and its last (f1 < u1)
      const int u = tt == 0 && u0 < f0 ? u0 : tt == team - 1 && f1 < u1 ? f1 : -1;
      if (u >= 0) {
        int lo, hi;
        sl.range(u, g.n, lo, hi);
        T* dst = reinterpret_cast<T*>(staged + (u - u0));
        for (int e = lo; e < hi; ++e) dst[e] = sl.xb[u * kN + e];  // shared memory: any index
      }
      while (!mbar_try_wait(bar, 0)) {
      }
    }
    __syncthreads();
  }

  // 2. the rank's chunks' sums, one warp a chunk
  if (live) {
    for (int k = k0 + warp; k < k1; k += warps) {
      const float2 p = chunk_stats<T, kResident>(sl, staged, u0, k, g.n, lane);
      if (lane == 0) parts[k - k0] = p;
    }
  }
  if (g.split > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  // 3. every rank folds all chunks in chunk order: the team's first warp
  // gathers 32 chunks' sums at a time (from the cluster's blocks), and
  // every lane adds them in order
  if (live && warp == 0) {
    float sum = 0.0f, sq = 0.0f;
    for (int kb = 0; kb < sl.nc; kb += 32) {
      const int k = kb + lane;
      float2 p = make_float2(0.0f, 0.0f);
      if (k < sl.nc) {
        const float2* src = parts;
        if (g.split > 1) src = cg::this_cluster().map_shared_rank(parts, k / g.cpr);
        p = src[k % g.cpr];
      }
      const int m = min(32, sl.nc - kb);
      for (int i = 0; i < m; ++i) {
        sum = __fadd_rn(sum, __shfl_sync(0xffffffffu, p.x, i));
        sq = __fadd_rn(sq, __shfl_sync(0xffffffffu, p.y, i));
      }
    }
    if (lane == 0) {
      const float inv_n = 1.0f / static_cast<float>(g.n);
      const float mean = __fmul_rn(sum, inv_n);
      const float var = fmaxf(__fsub_rn(__fmul_rn(sq, inv_n), __fmul_rn(mean, mean)), 0.0f);
      *stats = make_float2(mean, rsqrtf(__fadd_rn(var, g.eps)));
    }
  }
  if (g.split > 1) cluster_arrive();  // this block's remote reads are done
  __syncthreads();
  if (live) {
    const float2 st = *stats;
    const int c0 = (s % g.groups) * g.cg;
    for (int ci = tt; ci < g.cg; ci += team) {
      const float mul = __fmul_rn(st.y, param(g.scale, c0 + ci, g.param_f32));
      muladd[ci] = make_float2(mul, __fsub_rn(param(g.bias, c0 + ci, g.param_f32), __fmul_rn(st.x, mul)));
    }
  }
  __syncthreads();

  // 4. normalize the rank's units and write them
  if (live) {
    for (int ub = u0 + tt; ub < u1; ub += team * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int u = ub + q * team;
        if (u < u1) {
          int lo, hi;
          sl.range(u, g.n, lo, hi);
          v[q] = load_unit<T, kResident>(sl, staged, u0, u, lo, hi);
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int u = ub + q * team;
        if (u < u1) {
          int lo, hi;
          sl.range(u, g.n, lo, hi);
          normalize_unit(sl, muladd, v[q], u, lo, hi, g.hw, g.act);
        }
      }
    }
  }
  if (g.split > 1) cluster_wait();  // no block leaves while another reads its partials
}

template <typename T, bool kResident>
int launch(const Args& g, int warps, cudaStream_t stream) {
  const int threads = g.per_block * warps * 32;
  const int smem = g.per_block * team_smem_bytes(kResident, g.cpr, g.cg);
  auto fn = gn_act_kernel<T, kResident>;
  static int opted = 48 * 1024;  // dynamic shared memory this kernel may take
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((g.nslabs + g.per_block - 1) / g.per_block) * g.split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fn, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of a block (ops/gn.gn_smem_bytes holds the same sum).
extern "C" int gn_smem_bytes(int resident, int cpr, int cg, int per_block) {
  return per_block * team_smem_bytes(resident != 0, cpr, cg);
}

// One call's shape and tile, as ops/gn.py caches it per call shape.
struct GnCall {
  int x_f32;      // x, y: 1 float32, 0 bfloat16
  int param_f32;  // scale, bias: 1 float32, 0 bfloat16
  int batch, channels, hw, groups;
  int act;       // 0 none, 1 relu, 2 silu
  int resident;  // 1 staged in shared memory, 0 streaming
  int split;     // blocks a cluster (1, 2, 4 or 8)
  int per_block;  // slabs a block (split 1)
  int warps;      // warps a slab (per_block * warps at most 8)
  int cpr;        // chunks of 256 16-byte units a rank (cpr * split covers a slab)
  float eps;
};

// x, y [B, C, H*W] contiguous, 16-byte aligned; scale, bias [C]; the tile
// from ops/gn.pick_gn_tile.  Returns a cudaError_t (0 = launched).
extern "C" int gn_act_launch(const void* x, const void* scale, const void* bias, void* y, const GnCall* c,
                             void* stream) {
  if ((c->split != 1 && c->split != 2 && c->split != 4 && c->split != 8) || c->per_block < 1 || c->warps < 1 ||
      c->per_block * c->warps * 32 > kMaxThreads || (c->split > 1 && c->per_block != 1) || c->cpr < 1 ||
      c->groups < 1 || c->channels % c->groups)
    return static_cast<int>(cudaErrorInvalidValue);
  Args g;
  g.x = x;
  g.scale = scale;
  g.bias = bias;
  g.y = y;
  g.nslabs = c->batch * c->groups;
  g.groups = c->groups;
  g.cg = c->channels / c->groups;
  g.hw = c->hw;
  g.n = g.cg * c->hw;
  g.eps = c->eps;
  g.act = c->act;
  g.param_f32 = c->param_f32;
  g.split = c->split;
  g.per_block = c->per_block;
  g.cpr = c->cpr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c->x_f32) return c->resident ? launch<float, true>(g, c->warps, st) : launch<float, false>(g, c->warps, st);
  return c->resident ? launch<__nv_bfloat16, true>(g, c->warps, st) : launch<__nv_bfloat16, false>(g, c->warps, st);
}
