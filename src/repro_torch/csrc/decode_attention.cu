// Decode attention for Hopper (sm_90a), written by hand: flash-decoding in
// one launch, the splits merged through distributed shared memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel).  See
// repro_torch/kernels/decode_attention.py for the contract, the bound on
// the H100 and the split rule; in short:
//
//   * grid (n_split, Hkv * G / GB, B), 4 warps a block.  A block serves
//     GB = heads_per_block(G) of the G query heads of one KV head (G 8 and
//     16 in blocks of 4, G 10 in blocks of 5), so a lane's accumulator
//     stays small; the blocks of one KV head read the same rows, the
//     second time from L2.  The n_split blocks of one (batch row, KV head,
//     head block) form a thread block cluster (up to 16, the non-portable
//     size); block `split` reads cache slots [split * chunk,
//     (split + 1) * chunk) of its row;
//   * the cache goes through shared memory in tiles of NS rows, a ring of
//     three by cp.async (16-byte copies, zeros past the valid slots), two
//     tiles ahead of the warps.  A tile row of Dh elements is read by L
//     lanes (16 at bf16 Dh 128, 32 at Dh 256; 20 of 32 at Dh 160), so a
//     warp takes 32 / L rows at once and U = 4 such steps a tile;
//   * q, pre-scaled by scale * log2(e), sits in shared memory; each lane
//     group keeps an fp32 online softmax (m, l, acc) per head in base 2,
//     rescaled once per U rows; masked slots weigh exactly 0;
//   * the lane groups of a warp merge by shuffles, the warps in shared
//     memory (the accumulators take the ring's place); then cluster.sync(),
//     and block `split` merges the n_split blocks' (m, l, acc) for its own
//     1/n_split of the GB * Dh outputs, reading the other blocks' shared
//     memory with all reads of a loop in flight at once, and writes
//     acc / max(l, 1e-30) in the output dtype.  A second cluster.sync()
//     keeps every block's shared memory alive until all have read it;
//   * slot j of row b is valid when j < lengths[b] and, with a window,
//     j >= lengths[b] - window: exactly the TPU kernel's mask, on slot
//     indices.  lengths is read on the device.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing.  The entry returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it is not built for.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int STAGES = 3;  // cache tiles in the shared-memory ring
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SPLIT = 16;  // the largest (non-portable) cluster
constexpr float NEG_INF = -1e30f;

struct CacheStrides {
  int64_t b, s, h;
};

// the smallest power of two >= chunks, at most 32
__host__ __device__ constexpr int lanes_per_row(int chunks) {
  return chunks > 16 ? 32 : chunks > 8 ? 16 : chunks > 4 ? 8 : 4;
}

// How a warp covers cache rows of D elements of T.
template <typename T, int D>
struct Rows {
  static constexpr int VEC = 16 / sizeof(T);  // elements in a 16-byte load
  static constexpr int NC = D / VEC;          // 16-byte chunks in a row
  static constexpr int L = lanes_per_row(NC);
  static constexpr int NV = (NC + L - 1) / L;  // loads a lane makes a row
  static constexpr int R = 32 / L;             // rows a warp reads at once
  static constexpr int E = NV * VEC;           // elements a lane holds
  static constexpr int U = 4;                    // rows a group takes a tile
  static constexpr int NS = WARPS * R * U;       // rows of a tile
};

// Query heads a block serves for a group of G heads: up to 5, so that the
// accumulator a lane holds stays small and more blocks fill the card; the
// G / heads_per_block blocks of a KV head read the same cache rows (the
// second read comes from L2).
__host__ __device__ constexpr int heads_per_block(int G) {
  return G <= 4 ? G : G % 5 == 0 ? 5 : 4;
}

// Dynamic shared memory: the ring of STAGES (K, V) tiles, which the warps'
// accumulators (WARPS x G x D floats) reuse once the cache is read; then q
// (G x D), the warps' m and l, the block's m and l, the blocks' m and l,
// the merge weights.
template <typename T, int D, int G>
__host__ __device__ constexpr size_t ring_bytes() {
  using P = Rows<T, D>;
  constexpr size_t ring = size_t(STAGES) * 2 * P::NS * D * sizeof(T);
  constexpr size_t accs = size_t(WARPS) * G * D * sizeof(float);
  return ring > accs ? ring : accs;
}

template <typename T, int D, int G>
__host__ __device__ constexpr size_t smem_bytes() {
  return ring_bytes<T, D, G>() +
         sizeof(float) * (size_t(G) * D + 2 * WARPS * G + 2 * G +
                          3 * MAX_SPLIT * G);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // 16 bytes, or zeros when !valid (src-size 0: nothing is read)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const float*) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = f[i];
}

__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// G: the query heads of this block, of the `group` heads of its KV head.
template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const int* __restrict__ lengths,
                  T* __restrict__ o, int group, int S, int chunk, int64_t sqb,
                  int64_t sqh, CacheStrides sk, CacheStrides sv, int64_t sob,
                  int64_t soh, int window, float scale_log2) {
  using P = Rows<T, D>;
  constexpr int VEC = P::VEC, NC = P::NC, L = P::L, NV = P::NV, R = P::R,
                E = P::E, U = P::U;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw;               // STAGES x (K tile, V tile)
  float* wacc = reinterpret_cast<float*>(smem_raw);  // after the loop:
                                          // WARPS x G x D; [0] = the block's
  float* qs = reinterpret_cast<float*>(smem_raw + ring_bytes<T, D, G>());
  float* wm = qs + G * D;                 // WARPS x G
  float* wl = wm + WARPS * G;             // WARPS x G
  float* bm = wl + WARPS * G;             // G: the block's m
  float* bl = bm + G;                     // G: the block's l
  float* rm = bl + G;                     // MAX_SPLIT x G: the blocks' m
  float* rl = rm + MAX_SPLIT * G;         // MAX_SPLIT x G: the blocks' l
  float* wgt = rl + MAX_SPLIT * G;        // MAX_SPLIT x G merge weights

  cg::cluster_group cluster = cg::this_cluster();
  const int split = cluster.block_rank();
  const int n_split = cluster.num_blocks();
  const int parts = group / G;
  const int hk = blockIdx.y / parts;
  const int h0 = hk * group + (blockIdx.y % parts) * G;  // first query head
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane / L;  // the row this lane group reads
  const int li = lane % L;

  const int len = lengths[b];
  int lo = split * chunk;
  const int hi = min(min(lo + chunk, len), S);
  if (window > 0) lo = max(lo, len - window);

  // Tiles of NS cache rows go through a ring of STAGES in shared memory by
  // cp.async, STAGES - 1 tiles ahead of the warps.
  const T* kb = kc + b * sk.b + hk * sk.h;
  const T* vb = vc + b * sv.b + hk * sv.h;
  constexpr int NS = P::NS;
  constexpr int TILE = NS * D;  // elements of a K (or V) tile
  const int n_tiles = hi > lo ? (hi - lo + NS - 1) / NS : 0;
  T* tiles = reinterpret_cast<T*>(ring);
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      T* kt = tiles + (t % STAGES) * 2 * TILE;
      for (int i = tid; i < NS * NC; i += THREADS) {
        const int row = i / NC, ch = i % NC;
        const int pos = lo + t * NS + row;
        const bool in = pos < hi;
        const int64_t at = int64_t(in ? pos : lo);
        cp_async16(kt + row * D + ch * VEC, kb + at * sk.s + ch * VEC, in);
        cp_async16(kt + TILE + row * D + ch * VEC, vb + at * sv.s + ch * VEC,
                   in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  // q, while the first tiles are in flight
  for (int i = tid; i < G * D; i += THREADS)
    qs[i] = to_float(q[b * sqb + (int64_t)(h0 + i / D) * sqh + i % D]) *
            scale_log2;

  float acc[G][E], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // tile t is in; tile t - 1's slot is free
    load_tile(t + STAGES - 1);
    const T* kt = tiles + (t % STAGES) * 2 * TILE;
    const T* vt = kt + TILE;
    bool ok[U];
    int row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      row[u] = (u * WARPS + warp) * R + grp;
      ok[u] = lo + t * NS + row[u] < hi;
    }
    // scores of every head for the U rows, then one rescale per head
    float pr[U][G];
    {
      float kf[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const int ch = c * L + li;
          const uint4 raw =
              ch < NC ? *reinterpret_cast<const uint4*>(kt + row[u] * D +
                                                        ch * VEC)
                      : make_uint4(0, 0, 0, 0);
          unpack(raw, &kf[u][c * VEC], kb);
        }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float qv[E];
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const int ch = c * L + li;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            qv[c * VEC + e] = ch < NC ? qs[g * D + ch * VEC + e] : 0.f;
        }
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qv[e], kf[u][e], dot);
#pragma unroll
          for (int off = L / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          pr[u][g] = dot;
          if (ok[u]) mx = fmaxf(mx, dot);
        }
        const float corr = exp2f(m[g] - mx);
        m[g] = mx;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          pr[u][g] = ok[u] ? exp2f(pr[u][g] - mx) : 0.f;
          sum += pr[u][g];
        }
        l[g] = l[g] * corr + sum;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int ch = c * L + li;
        const uint4 raw =
            ch < NC ? *reinterpret_cast<const uint4*>(vt + row[u] * D +
                                                      ch * VEC)
                    : make_uint4(0, 0, 0, 0);
        unpack(raw, &vf[c * VEC], vb);
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pr[u][g], vf[e], acc[g][e]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is free: the accumulators take its place

  // Merge the lane groups of each warp (they read different rows).  A
  // state that saw no slot (m = -1e30, l = 0, acc = 0) weighs 0 next to
  // one that did, and stays 0 when none did.
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float ca = exp2f(m[g] - mx), cb = exp2f(mo - mx);
      l[g] = l[g] * ca + lo_ * cb;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * ca +
                    __shfl_xor_sync(0xffffffffu, acc[g][e], off) * cb;
      m[g] = mx;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (li == 0) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int ch = c * L + li;
        if (ch < NC) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            wacc[(warp * G + g) * D + ch * VEC + e] = acc[g][c * VEC + e];
        }
      }
    }
  }
  __syncthreads();

  // Merge the warps: the block's state in bm, bl and wacc[0].
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float M = wm[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) M = fmaxf(M, wm[w * G + g]);
    float A = 0.f, Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(wm[w * G + g] - M);
      A += wacc[w * G * D + i] * f;
      Lsum += wl[w * G + g] * f;
    }
    wacc[i] = A;
    if (i % D == 0) {
      bm[g] = M;
      bl[g] = Lsum;
    }
  }
  cluster.sync();  // every block's state is written

  // Merge the blocks of the cluster.  Every remote read of a loop is
  // started before any is used: distributed shared memory costs a round
  // trip between SMs, and n_split of them in a row would cost more than
  // the cache.
  if (tid < n_split * G) {
    const int r = tid / G, g = tid % G;
    rm[tid] = cluster.map_shared_rank(bm, r)[g];
    rl[tid] = cluster.map_shared_rank(bl, r)[g];
  }
  __syncthreads();
  if (tid < G) {
    const int g = tid;
    float M = NEG_INF;
    for (int r = 0; r < n_split; ++r) M = fmaxf(M, rm[r * G + g]);
    float Lsum = 0.f;
    for (int r = 0; r < n_split; ++r) {
      const float f = exp2f(rm[r * G + g] - M);
      wgt[r * G + g] = f;
      Lsum += rl[r * G + g] * f;
    }
    const float inv = 1.f / fmaxf(Lsum, 1e-30f);
    for (int r = 0; r < n_split; ++r) wgt[r * G + g] *= inv;
  }
  __syncthreads();
  // this block's share of the G * D outputs
  const int per = (G * D + n_split - 1) / n_split;
  const int end = min(G * D, (split + 1) * per);
  for (int i = split * per + tid; i < end; i += THREADS) {
    const int g = i / D;
    float part[MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      part[r] = r < n_split ? cluster.map_shared_rank(wacc, r)[i] : 0.f;
    float A = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < n_split) A = fmaf(wgt[r * G + g], part[r], A);
    o[b * sob + (int64_t)(h0 + g) * soh + i % D] = from_float<T>(A);
  }
  cluster.sync();  // no block leaves while another reads its memory
}

// The launch's shape, strides and scalars, built once per shape by the
// wrapper (kernels/decode_attention.py, _Params) so that a call passes
// seven arguments through ctypes instead of twenty-six.
struct Params {
  int64_t dtype, B, Hkv, G, S, D, n_split, chunk;
  int64_t sqb, sqh, skb, sks, skh, svb, svs, svh, sob, soh;
  int64_t window;
  double scale;
};

// The calling thread's current context (the whole card's, or a
// partition's green context), through the driver entry point, so that
// nothing links libcuda; null if there is none.
CUcontext current_context() {
  using GetCurrent = CUresult (*)(CUcontext*);
  static GetCurrent fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuCtxGetCurrent", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuCtxGetCurrent", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? (GetCurrent)p : nullptr;
  }();
  CUcontext c = nullptr;
  if (fn) fn(&c);
  return c;
}

// One instantiation of the kernel: its attributes, launch and cluster
// occupancy.
template <typename T, int D, int G>
struct Decode {
  static constexpr size_t smem = smem_bytes<T, D, G>();

  // The shared-memory opt-in and the non-portable cluster size are
  // attributes of the kernel in one context: a partition (a green context)
  // is another context on the same card.  They are set once per context.
  static cudaError_t prepare() {
    constexpr int MAX_CONTEXTS = 64;
    static CUcontext ready[MAX_CONTEXTS];
    static int n_ready = 0;
    const CUcontext ctx = current_context();
    for (int i = 0; i < n_ready; ++i)
      if (ctx && ready[i] == ctx) return cudaSuccess;
    auto kernel = decode_kernel<T, D, G>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && ctx && n_ready < MAX_CONTEXTS)
      ready[n_ready++] = ctx;
    return err;
  }

  static cudaLaunchConfig_t config(const Params& p, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.n_split, p.Hkv * (p.G / G), p.B);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.n_split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }

  static cudaError_t launch(const void* q, const void* kc, const void* vc,
                            const int* lengths, void* o, const Params& p,
                            cudaStream_t stream) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(p, stream, attr);
    err = cudaLaunchKernelEx(
        &cfg, decode_kernel<T, D, G>, static_cast<const T*>(q),
        static_cast<const T*>(kc), static_cast<const T*>(vc), lengths,
        static_cast<T*>(o), int(p.G), int(p.S), int(p.chunk), p.sqb, p.sqh,
        CacheStrides{p.skb, p.sks, p.skh}, CacheStrides{p.svb, p.svs, p.svh},
        p.sob, p.soh, int(p.window), float(p.scale * 1.4426950408889634));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }

  // Clusters of p.n_split blocks that the current context's SMs hold at
  // once (0: such a cluster cannot launch there).
  static cudaError_t max_clusters(const Params& p, int* n) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(p, nullptr, attr);
    return cudaOccupancyMaxActiveClusters(n, decode_kernel<T, D, G>, &cfg);
  }
};

// Calls f(Decode<T, D, heads_per_block(G)>{}) for the instantiation of
// p's dtype, head dim and group; cudaErrorInvalidValue if there is none.
template <typename T, int D, typename F>
cudaError_t visit_d(const Params& p, F&& f) {
#define REPRO_DECODE_CASE(GG) \
  case GG:                     \
    return f(Decode<T, D, heads_per_block(GG)>{});
  // the groups each head dim is built for: kernels/decode_attention.GROUPS
  if constexpr (D == 64 || D == 128) {
    switch (p.G) {
      REPRO_DECODE_CASE(1)
      REPRO_DECODE_CASE(2)
      REPRO_DECODE_CASE(4)
      REPRO_DECODE_CASE(8)
      REPRO_DECODE_CASE(16)
      default:
        return cudaErrorInvalidValue;
    }
  } else if constexpr (D == 160) {
    switch (p.G) {
      REPRO_DECODE_CASE(4)
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    switch (p.G) {
      REPRO_DECODE_CASE(10)
      default:
        return cudaErrorInvalidValue;
    }
  }
#undef REPRO_DECODE_CASE
}

template <typename F>
cudaError_t visit(const Params& p, F&& f) {
#define REPRO_DECODE_D(T, DD) \
  if (p.D == DD) return visit_d<T, DD>(p, f);
  if (p.dtype == 0) {
    REPRO_DECODE_D(float, 64)
    REPRO_DECODE_D(float, 128)
    REPRO_DECODE_D(float, 160)
    REPRO_DECODE_D(float, 256)
  } else if (p.dtype == 1) {
    REPRO_DECODE_D(__nv_bfloat16, 64)
    REPRO_DECODE_D(__nv_bfloat16, 128)
    REPRO_DECODE_D(__nv_bfloat16, 160)
    REPRO_DECODE_D(__nv_bfloat16, 256)
  }
#undef REPRO_DECODE_D
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// params: a Params.  dtype 0 = float32, 1 = bfloat16.  q (B, H, D) with
// strides (sqb, sqh); caches (B, S, Hkv, D) with strides (b, s, h),
// 16-byte aligned rows; o (B, H, D) with strides (sob, soh); lengths (B,)
// int32.  1 <= n_split <= 16 blocks a (row, KV head) of `chunk` slots
// each.  window <= 0 means no window.
int decode_attention_launch(const void* q, const void* kc, const void* vc,
                            const void* lengths, void* o, const void* params,
                            void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  if (p.n_split < 1 || p.n_split > MAX_SPLIT) return cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return visit(p, [&](auto k) {
    return decltype(k)::launch(q, kc, vc, len, o, p, st);
  });
}

// *n = clusters of params' n_split blocks (of its dtype, head dim and
// group) that the current context's SMs hold at once.
int decode_attention_max_clusters(const void* params, int* n) {
  const Params& p = *static_cast<const Params*>(params);
  *n = 0;
  if (p.n_split < 1 || p.n_split > MAX_SPLIT) return cudaErrorInvalidValue;
  return visit(p, [&](auto k) { return decltype(k)::max_clusters(p, n); });
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
