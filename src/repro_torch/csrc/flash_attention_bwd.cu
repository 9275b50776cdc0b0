// Backward of prefill attention for Hopper (sm_90a), written by hand.
//
// The Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel) has no backward pass: the JAX package
// trains through its jnp attention and XLA's autodiff.  This file is the
// backward of the port's forward kernel (csrc/flash_attention.cu), which it
// leaves untouched: it takes q, k, v and the incoming gradient dO, and
// recomputes what it needs.  See repro_torch/kernels/flash_attention.py for
// the contract and what bounds it on the H100: operations (the least work
// is 10 Dh a live query-key pair; this design does 18 Dh, S and dP twice
// in the first pass and once in the second), so the bf16 kernels are built
// on the tensor cores.
//
// bf16 (training): wgmma, TMA and mbarriers, as the forward, and two
// kernels launched in order on the caller's stream by one entry.  Every
// tile is 64 queries or 64 keys (wgmma's M); Q, K, V and dO are read as
// they lie through 4-d (Dh, S, H, B) tensor maps, stored as 64-column
// blocks with the 128-byte swizzle, Dh 80 and 160 padded to 128 and 192 by
// TMA's zero fill (the forward's note has the details).  A tile of Q, K, V
// or dO serves as a K-major operand (S = Q K^T, dP = dO V^T, contracted
// over Dh) and as an MN-major one through the descriptor's transpose bit
// (dQ += dS K, dK += dS^T Q, dV += P^T dO, contracted over keys or
// queries): the same bytes in shared memory, two descriptors.
//   1. flash_bwd_rows_bf16, one block per (head, batch row, query tile),
//      the tiles with the most live keys first: one producer warpgroup
//      (one thread issues TMA: Q and dO once, then K / V tiles through a
//      two-stage ring) and one consumer warpgroup that sweeps the live key
//      tiles twice.  Sweep 1: S and dP by wgmma (both operands in shared
//      memory, one commit group), then per row, online in fp32 registers
//      on the accumulator layout, the max, l = sum exp(S - max) and u =
//      sum exp(S - max) dP, rescaled as the max grows; lse = max + log l
//      and D = u / l (rowsum(P dP), which equals rowsum(dO O); it is not
//      taken from O because the forward's O is rounded to bf16, and in a
//      row whose gradient cancels, dS = P (dP - D) ~ 0, that rounding
//      reaches dQ at several percent of the row).  lse (base 2) and D go
//      to fp32 scratch for the second kernel.  Sweep 2: S and dP again, P
//      = exp(S - lse) and dS = P (dP - D) in fp32, dS rounded to bf16 in
//      registers (the accumulator's layout is wgmma's register-A layout)
//      and dQ += dS K with K as the MN-major B operand.  dQ is scaled by
//      1/sqrt(Dh) once, at the store.  Fusing the log-sum-exp pass into the
//      dQ pass loads Q and dO once and saves a launch; the forward stays
//      as it is (it writes no lse).
//   2. flash_bwd_kv_bf16, one block per (query head, batch row, key tile),
//      the first key tiles (which the most queries see) first: K and V
//      loaded once, Q and dO tiles of the live queries through a two-stage
//      TMA ring, and two consumer warpgroups on the same 64 keys,
//      so that the 64 x Dh fp32 accumulators of dK and of dV each have a
//      warpgroup of their own: at Dh 256 one is 128 registers a thread,
//      and both in one warpgroup would not fit.  Warpgroup 0 computes S^T
//      = K Q^T, P^T = exp(S^T - lse) (lse of each column's query), writes
//      P^T in fp32 to shared memory and owns dV += P^T dO (P^T rounded to
//      bf16 as the register A operand).  Warpgroup 1 computes dP^T = V
//      dO^T, reads P^T, forms dS^T = P^T (dP^T - D) and owns dK += dS^T Q.
//      Two named barriers hand P^T over (full: written; empty: read), so
//      one 16 KB buffer serves.  There is no producer warp: one thread of
//      warpgroup 1 issues the loads, tile t + 2 once both warpgroups are
//      done with tile t.  So the block has 8 warps, two on each quarter
//      of the SM's register file, and a thread may hold 255 registers: a
//      consumer at Dh 256 needs about 200.  (With a ninth warp, or a
//      producer warpgroup and setmaxnreg, ptxas compiled it to 168, and it
//      spilled and serialized its wgmma.)  Shared memory at Dh 256: K and
//      V 64 KB, the ring 128 KB, P^T 16 KB: 209 KB of 227.
//      Where a KV head serves a group of query heads, each block writes
//      its head's share as an fp32 partial and flash_bwd_group_sum adds
//      the group's partials up in a fixed order: no atomics, two calls give
//      bitwise-equal gradients, and a group's heads run in parallel
//      (recurrentgemma-2b's 10 query heads share one KV head: a block per
//      KV head would leave 64 blocks for 132 SMs).
//   Masks are the forward's (causal, window, the ragged S): tiles that the
//   mask hides from a whole tile are never loaded, and only a tile that
//   crosses the diagonal, the window edge or S computes the mask.  Rows
//   past S are zeros from TMA and never stored.
//
// fp32 (the card-vs-CPU parity path): the CUDA-core kernels of the first
// version, held to the fp64 plain version at 1e-4 / 1e-5, which TF32 would
// not meet.  flash_bwd_stats (lse and D per query tile), flash_bwd_dkdv
// (per query head and key tile; partials summed by flash_bwd_group_sum
// where grouped) and flash_bwd_dq (per query tile).  Tiles of T queries
// and T keys, T = 64 up to Dh 128 and 32 above, in fp32 in shared memory
// (rows padded to Dh + 4 and T + 1 floats so that the threads that read
// along a column hit distinct banks); 256 threads as a 16 x 16 grid:
// thread (ty, tx) owns the score entries (ty + 16 i, tx + 16 j) and the
// accumulator entries (row ty + 16 i, column tx + 16 c).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing (the caller passes the fp32 lse, D and partials
// scratch).  The entry returns cudaGetLastError(), or cudaErrorInvalidValue
// for a dtype, head dim, alignment or tensor map it does not take.

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta, *part;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, H, Hkv, S, causal, window;
  float scale;
};

// dk[b, hk] = the sum of the group's fp32 partials part[b, hk * group + g]
// over g = 0 .. group - 1 in order (part: (B, H, S, D) contiguous)
template <typename E>
__global__ void flash_bwd_group_sum(const float* __restrict__ part,
                                    E* __restrict__ out, int group, int Hkv,
                                    int S, int D, Strides so, int64_t n) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int d = int(i % D);
    const int s = int(i / D % S);
    const int hk = int(i / (int64_t(D) * S) % Hkv);
    const int b = int(i / (int64_t(D) * S * Hkv));
    const float* src =
        part + ((int64_t(b) * Hkv * group + int64_t(hk) * group) * S + s) *
                   D + d;
    float sum = 0.f;
    for (int g = 0; g < group; ++g) sum += src[int64_t(g) * S * D];
    store(out + b * so.b + hk * so.h + s * so.s + d, sum);
  }
}

template <typename E>
cudaError_t group_sums(const Args& a, const float* pk, const float* pv,
                       int D, cudaStream_t st) {
  const int64_t n = int64_t(a.B) * a.Hkv * a.S * D;
  const int blocks =
      int((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  const int group = a.H / a.Hkv;
  flash_bwd_group_sum<E><<<blocks, 256, 0, st>>>(
      pk, static_cast<E*>(a.dk), group, a.Hkv, a.S, D, a.sdk, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_group_sum<E><<<blocks, 256, 0, st>>>(
      pv, static_cast<E*>(a.dv), group, a.Hkv, a.S, D, a.sdv, n);
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  // above 48 KB of dynamic shared memory a launch is refused unless the
  // kernel opts in
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

// ------------------------------------------------------------------ fp32 --

constexpr int THREADS = 256;

// One tile geometry per head dim.
template <int D>
struct Geo {
  static constexpr int T = D <= 128 ? 64 : 32;  // queries and keys a tile
  static constexpr int R = T / 16;  // score rows (and columns) a thread
  static constexpr int C = D / 16;  // accumulator columns a thread
  static constexpr int DP = D + 4;  // a (T, D) tile's padded row, floats
  static constexpr int TP = T + 1;  // a (T, T) tile's padded row, floats
  static constexpr int TILE = T * DP;
};

__device__ __forceinline__ bool visible(int qi, int kj, int S, int causal,
                                        int window) {
  return qi < S && kj < S && (!causal || kj <= qi) &&
         (window <= 0 || kj > qi - window);
}

// reductions over the 16 threads of a row (tx = lane % 16)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// rows row0 .. row0 + T - 1 of one (batch, head) slice into a padded
// tile; rows past S are zeros.  16-byte loads, all of a thread's issued
// before the first is stored, so a tile costs one round trip to memory (the
// wrapper checks the 16-byte alignment of bases and row strides).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride_s, int row0,
                                          int S) {
  using G = Geo<D>;
  constexpr int PER_ROW = D / 4;     // loads a row
  constexpr int N = G::T * PER_ROW;  // loads a tile
  constexpr int ITERS = (N + THREADS - 1) / THREADS;
  float4 buf[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * 4;
    buf[it] = i < N && row0 + r < S
                  ? *reinterpret_cast<const float4*>(src + (row0 + r) *
                                                               stride_s + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (i < N) {
      const int r = i / PER_ROW, c = (i - r * PER_ROW) * 4;
      *reinterpret_cast<float4*>(dst + r * G::DP + c) = buf[it];
    }
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two padded tiles,
// read 16 bytes at a time (rows padded by 4 floats: the 8 threads of a
// 16-byte load phase hit distinct banks)
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         float (&acc)[Geo<D>::R][Geo<D>::R]) {
  using G = Geo<D>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < G::R; ++i)
#pragma unroll
    for (int j = 0; j < G::R; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[G::R], b[G::R];
#pragma unroll
    for (int i = 0; i < G::R; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * G::DP + d);
#pragma unroll
    for (int j = 0; j < G::R; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * G::DP + d);
#pragma unroll
    for (int i = 0; i < G::R; ++i)
#pragma unroll
      for (int j = 0; j < G::R; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// the key range [begin, end) that a query tile q0 .. q0 + T - 1 can see,
// begin aligned down to a tile
template <int T>
__device__ __forceinline__ void key_range(int q0, int S, int causal,
                                          int window, int* begin, int* end) {
  const int q_last = min(q0 + T, S) - 1;
  *begin = window > 0 ? max(0, q0 - window + 1) / T * T : 0;
  *end = causal ? q_last + 1 : S;
}

// 1: lse and D, online over the live key tiles, per row: the max m, l =
// sum exp(S - m) and u = sum exp(S - m) dP, both rescaled as m grows; then
// lse = m + log l and D = u / l
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_stats(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout, float* __restrict__ lse,
                    float* __restrict__ delta, int group, int H, int S,
                    Strides sq, Strides sk, Strides sv, Strides sdo,
                    int causal, int window, float scale) {
  using G = Geo<D>;
  constexpr int T = G::T, R = G::R;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + G::TILE;
  float* Ks = dOs + G::TILE;
  float* Vs = Ks + G::TILE;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T;  // the longest first
  const float* kb = k + b * sk.b + (h / group) * sk.h;
  const float* vb = v + b * sv.b + (h / group) * sv.h;

  load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile<D>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  float m[R], l[R], u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    u[i] = 0.f;
  }
  int k_begin, k_end;
  key_range<T>(q0, S, causal, window, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += T) {
    __syncthreads();  // the previous key tile's readers are done
    load_tile<D>(Ks, kb, sk.s, k0, S);
    load_tile<D>(Vs, vb, sv.s, k0, S);
    __syncthreads();
    float s[R][R], dp[R][R];
    dot_tile<D>(Qs, Ks, s);
    dot_tile<D>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[R];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ok[j] = visible(qi, k0 + tx + 16 * j, S, causal, window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        dsum = fmaf(p, dp[i][j], dsum);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      u[i] = u[i] * corr + row_sum(dsum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (tx == 0 && qi < S) {
      const int64_t row = (int64_t(b) * H + h) * S + qi;
      lse[row] = m[i] + logf(l[i]);
      delta[row] = u[i] / l[i];
    }
  }
}

// 2: one block per (query head, batch row, key tile): that head's share of
// dK and dV of the tile's keys, written to head h of dk / dv: the
// gradients themselves where the group is 1, else the partials that
// flash_bwd_group_sum adds up over the group.
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int group, int H, int S,
                   Strides sq, Strides sk, Strides sv, Strides sdo,
                   Strides sdk, Strides sdv, int causal, int window,
                   float scale) {
  using G = Geo<D>;
  constexpr int T = G::T, R = G::R, C = G::C, DP = G::DP, TP = G::TP;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + G::TILE;
  float* Qs = Vs + G::TILE;
  float* dOs = Qs + G::TILE;
  float* Ps = dOs + G::TILE;  // T x TP
  float* dSs = Ps + T * TP;   // T x TP
  float* Ls = dSs + T * TP;   // T
  float* Ds = Ls + T;         // T
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * T;
  const int hk = h / group;

  load_tile<D>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, S);
  load_tile<D>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, S);
  float acc_k[R][C], acc_v[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // the queries that see a key of this tile: causal ones from k0 on, and
  // with a window those before k_last + window
  const int k_last = min(k0 + T, S) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* db = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + (int64_t(b) * H + h) * S;
  const float* del_b = delta + (int64_t(b) * H + h) * S;
  for (int q0 = q_begin; q0 < q_end; q0 += T) {
    __syncthreads();  // the previous query tile's readers are done
    load_tile<D>(Qs, qb, sq.s, q0, S);
    load_tile<D>(dOs, db, sdo.s, q0, S);
    for (int r = threadIdx.x; r < T; r += THREADS) {
      const int qi = q0 + r;
      Ls[r] = qi < S ? lse_b[qi] : 0.f;
      Ds[r] = qi < S ? del_b[qi] : 0.f;
    }
    __syncthreads();
    float s[R][R], dp[R][R];
    dot_tile<D>(Qs, Ks, s);
    dot_tile<D>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, S, causal, window)
                            ? expf(s[i][j] * scale - Ls[r])
                            : 0.f;
        Ps[r * TP + c] = p;
        dSs[r * TP + c] = p * (dp[i][j] - Ds[r]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < T; ++r) {
      float pk[R], sk_[R], o_[C], q_[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pk[i] = Ps[r * TP + ty + 16 * i];
        sk_[i] = dSs[r * TP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        o_[c] = dOs[r * DP + tx + 16 * c];
        q_[c] = Qs[r * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc_v[i][c] = fmaf(pk[i], o_[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(sk_[i], q_[c], acc_k[i][c]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj < S) {
      float* dkr = dk + b * sdk.b + h * sdk.h + kj * sdk.s;
      float* dvr = dv + b * sdv.b + h * sdv.h + kj * sdv.s;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dkr[tx + 16 * c] = acc_k[i][c];
        dvr[tx + 16 * c] = acc_v[i][c];
      }
    }
  }
}

// 3: dQ += dS K over the live key tiles of one (head, batch row, query
// tile)
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int group, int H, int S, Strides sq, Strides sk, Strides sv,
                 Strides sdo, Strides sdq, int causal, int window,
                 float scale) {
  using G = Geo<D>;
  constexpr int T = G::T, R = G::R, C = G::C, DP = G::DP, TP = G::TP;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + G::TILE;
  float* Ks = dOs + G::TILE;
  float* Vs = Ks + G::TILE;
  float* dSs = Vs + G::TILE;  // T x TP
  float* Ls = dSs + T * TP;   // T
  float* Ds = Ls + T;         // T
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T;  // the longest first
  const int hk = h / group;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile<D>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  for (int r = threadIdx.x; r < T; r += THREADS) {
    const int qi = q0 + r;
    const int64_t row = (int64_t(b) * H + h) * S + qi;
    Ls[r] = qi < S ? lse[row] : 0.f;
    Ds[r] = qi < S ? delta[row] : 0.f;
  }
  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  int k_begin, k_end;
  key_range<T>(q0, S, causal, window, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += T) {
    __syncthreads();  // the previous key tile's readers are done
    load_tile<D>(Ks, kb, sk.s, k0, S);
    load_tile<D>(Vs, vb, sv.s, k0, S);
    __syncthreads();
    float s[R][R], dp[R][R];
    dot_tile<D>(Qs, Ks, s);
    dot_tile<D>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        dSs[r * TP + c] =
            visible(q0 + r, k0 + c, S, causal, window)
                ? expf(s[i][j] * scale - Ls[r]) * (dp[i][j] - Ds[r]) * scale
                : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < T; ++kk) {
      float ds[R], k_[C];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dSs[(ty + 16 * i) * TP + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) k_[c] = Ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(ds[i], k_[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < S) {
      float* dqr = dq + b * sdq.b + h * sdq.h + qi * sdq.s;
#pragma unroll
      for (int c = 0; c < C; ++c) dqr[tx + 16 * c] = acc[i][c];
    }
  }
}

template <int D>
cudaError_t launch_fp32(const Args& a, cudaStream_t st) {
  using G = Geo<D>;
  constexpr size_t tile = sizeof(float) * G::TILE;
  constexpr size_t scores = sizeof(float) * G::T * G::TP;
  constexpr size_t rows = sizeof(float) * 2 * G::T;
  constexpr size_t smem_stats = 4 * tile;
  constexpr size_t smem_dkdv = 4 * tile + 2 * scores + rows;
  constexpr size_t smem_dq = 4 * tile + scores + rows;
  const int group = a.H / a.Hkv;
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_stats<D>, smem_stats)) != cudaSuccess ||
      (err = allow_smem(flash_bwd_dkdv<D>, smem_dkdv)) != cudaSuccess ||
      (err = allow_smem(flash_bwd_dq<D>, smem_dq)) != cudaSuccess)
    return err;
  if (group > 1 && a.part == nullptr) return cudaErrorInvalidValue;
  // (head, batch row, tile): the tile index varies slowest, so the blocks
  // of the tiles with the most work start first
  const dim3 grid(a.H, a.B, (a.S + G::T - 1) / G::T);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  flash_bwd_stats<D><<<grid, THREADS, smem_stats, st>>>(
      q, k, v, dout, a.lse, a.delta, group, a.H, a.S, a.sq, a.sk, a.sv,
      a.sdo, a.causal, a.window, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (group == 1) {
    flash_bwd_dkdv<D><<<grid, THREADS, smem_dkdv, st>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), group, a.H, a.S, a.sq, a.sk, a.sv, a.sdo,
        a.sdk, a.sdv, a.causal, a.window, a.scale);
  } else {
    // fp32 partials (B, H, S, D) per query head, then their sum per group
    const int64_t n_part = int64_t(a.B) * a.H * a.S * D;
    const Strides sp{int64_t(a.H) * a.S * D, int64_t(a.S) * D, D};
    flash_bwd_dkdv<D><<<grid, THREADS, smem_dkdv, st>>>(
        q, k, v, dout, a.lse, a.delta, a.part, a.part + n_part, group, a.H,
        a.S, a.sq, a.sk, a.sv, a.sdo, sp, sp, a.causal, a.window, a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = group_sums<float>(a, a.part, a.part + n_part, D, st)) !=
        cudaSuccess)
      return err;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq<D><<<grid, THREADS, smem_dq, st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), group, a.H,
      a.S, a.sq, a.sk, a.sv, a.sdo, a.sdq, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16 --

constexpr int BT = 64;  // queries or keys a tile: wgmma's M

template <int D>
struct TileB {
  static constexpr int DP = (D + 63) / 64 * 64;  // padded to swizzle atoms
  static constexpr int CB = DP / 64;             // 64-column blocks
  static constexpr int STAGES = 2;
  static constexpr uint32_t TILE_BYTES = BT * DP * 2;  // a 64-row tile
  // + 1024: the dynamic segment is aligned up to the swizzle atom
  // rows: Q and dO, and the ring's K / V stages
  static constexpr size_t SMEM_ROWS =
      2 * TILE_BYTES + STAGES * 2 * TILE_BYTES + 1024;
  // kv: K and V, the ring's Q / dO stages, and P^T in fp32
  static constexpr size_t SMEM_KV =
      2 * TILE_BYTES + STAGES * 2 * TILE_BYTES + BT * BT * 4 + 1024;
};

__device__ __forceinline__ bool sees(int q, int key, int S, int causal,
                                     int window) {
  return key < S && (!causal || key <= q) &&
         (window <= 0 || key > q - window);
}

// Whether the query tile q0 .. q0 + 63 against the key tile k0 .. k0 + 63
// crosses S, the diagonal or the window edge (else no pair is masked).
__device__ __forceinline__ bool crosses(int q0, int k0, int S, int causal,
                                        int window) {
  return k0 + BT > S || (causal && k0 + BT - 1 > q0) ||
         (window > 0 && k0 <= q0 + BT - 1 - window);
}

// named barriers between the two consumer warpgroups of flash_bwd_kv_bf16
// (barrier 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// a 64 x 64 accumulator (this thread's 32 entries) as wgmma's register A
// operand, rounded to bf16: k-step kk takes columns 16 kk .. 16 kk + 15
__device__ __forceinline__ void to_a(const float (&x)[BT / 2],
                                     uint32_t (&pa)[BT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    pa[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    pa[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    pa[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    pa[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// x (64 x 64) = A B^T over the D columns of two 64-row tiles in shared
// memory, both K-major: D / 16 k-steps of 32 bytes inside a 64-column
// block, the next block a whole block further on
template <int D>
__device__ __forceinline__ void product_ss(float (&x)[BT / 2], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * BT * 128 + (kk & 3) * 32;
    Wgmma<BT>::ss(x, sw128_desc(a + off, 16, 1024),
                  sw128_desc(b + off, 16, 1024), kk > 0);
  }
}

// acc (64 x DP) += A B with A (64 x 64) in registers and B a 64-row tile
// in shared memory read MN-major: k-step kk is rows 16 kk .. 16 kk + 15,
// two 8-row atoms (2048 bytes) down each column block
template <int DP>
__device__ __forceinline__ void product_rs(float (&acc)[DP / 2],
                                           const uint32_t (&pa)[BT / 16][4],
                                           uint32_t b) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    Wgmma<DP>::rs(acc, pa[kk], sw128_desc(b + kk * 2048, BT * 128, 1024));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows ra and ra + 8 of a 64 x DP accumulator, times `mul`, to row-major
// storage (the D real columns; rows at or past S are not stored)
template <int D, int DP, typename O>
__device__ __forceinline__ void store_acc(const float (&acc)[DP / 2],
                                          O* base, int64_t stride_row,
                                          int ra, int S, float mul) {
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (8 * j < D) {  // D is a multiple of 8: the padding is never stored
      const int col = 8 * j + cq;
      if (ra < S)
        store2(base + ra * stride_row + col, acc[4 * j] * mul,
               acc[4 * j + 1] * mul);
      if (ra + 8 < S)
        store2(base + (ra + 8) * stride_row + col, acc[4 * j + 2] * mul,
               acc[4 * j + 3] * mul);
    }
  }
}

// rows r0 .. r0 + 63 of head h, batch row b of two tensors (CB 64-column
// blocks each) into two consecutive 64-row tiles at dst, on one barrier
template <int CB>
__device__ __forceinline__ void load_pair(uint32_t dst, const CUtensorMap* a,
                                          const CUtensorMap* b_map,
                                          uint64_t* bar, int r0, int h,
                                          int b) {
  constexpr uint32_t TILE = BT * CB * 128;
  mbar_expect_tx(bar, 2 * TILE);
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    tma_load(dst + c * BT * 128, a, bar, c * 64, r0, h, b);
    tma_load(dst + TILE + c * BT * 128, b_map, bar, c * 64, r0, h, b);
  }
}

// 1: lse and D in a first sweep over the live key tiles, dQ in a second
template <int D>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_rows_bf16(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        float* __restrict__ lse2, float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, Strides sdq,
                        int group, int H, int S, int causal, int window,
                        float scale, float scale_log2) {
  using C = TileB<D>;
  constexpr int DP = C::DP, CB = C::CB, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_in, bar_full[ST], bar_free[ST];
  // Q, dO, then stage s: K at s_ring + 2 s TILE_BYTES, V after it
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_do = s_q + C::TILE_BYTES;
  const uint32_t s_ring = s_do + C::TILE_BYTES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BT;  // the longest first
  const int hk = h / group;
  const int q_last = min(q0 + BT, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BT * BT : 0;
  const int k_end = causal ? q_last + 1 : S;
  const int n = (k_end - k_begin + BT - 1) / BT;  // live key tiles

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&bar_in, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_free[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer warpgroup: one thread starts every TMA load: Q and dO,
    // then the live K / V tiles twice, one sweep after the other ----
    if (tid == 128) {
      load_pair<CB>(s_q, &tq, &tdo, &bar_in, q0, h, b);
      for (int t = 0; t < 2 * n; ++t) {
        const int s = t % ST;
        mbar_wait(&bar_free[s], ((t / ST) & 1) ^ 1);  // round 0 passes
        load_pair<CB>(s_ring + s * 2 * C::TILE_BYTES, &tk, &tv,
                      &bar_full[s], k_begin + (t < n ? t : t - n) * BT, hk,
                      b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: query rows qa and qb = qa + 8 of this thread,
  // columns 8 j + cq + {0, 1} of each score tile ----
  const int lane = tid & 31, warp = tid >> 5;
  const int qa = q0 + warp * 16 + (lane >> 2), qb = qa + 8;
  const int cq = 2 * (lane & 3);
  // sweep 1: the running max and this lane's share of l and u (the quad
  // adds its four up at the end); sweep 2: lse (base 2) and D
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f, u_a = 0.f,
        u_b = 0.f;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  mbar_wait(&bar_in, 0);

  for (int t = 0; t < 2 * n; ++t) {
    const int s = t % ST;
    const bool first = t < n;
    const int k0 = k_begin + (first ? t : t - n) * BT;
    const uint32_t st_k = s_ring + s * 2 * C::TILE_BYTES;
    const uint32_t st_v = st_k + C::TILE_BYTES;
    // S = Q K^T and dP = dO V^T in one commit group
    float sc[BT / 2], dp[BT / 2];
    mbar_wait(&bar_full[s], (t / ST) & 1);
    wgmma_fence();
    product_ss<D>(sc, s_q, st_k);
    product_ss<D>(dp, s_do, st_v);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    if (first) mbar_arrive(&bar_free[s]);  // sweep 1 is done with K and V

    // logits in base 2; masked ones -inf
    const bool edge = crosses(q0, k0, S, causal, window);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa = sc[4 * j + e] * scale_log2;
        float xb = sc[4 * j + 2 + e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + cq + e;
          if (!sees(qa, key, S, causal, window)) xa = -INFINITY;
          if (!sees(qb, key, S, causal, window)) xb = -INFINITY;
        }
        sc[4 * j + e] = xa;
        sc[4 * j + 2 + e] = xb;
      }
    }

    if (first) {
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx_a = fmaxf(mx_a, sc[4 * j + e]);
          mx_b = fmaxf(mx_b, sc[4 * j + 2 + e]);
        }
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      // m starts at -1e30 (finite), so a fully masked row gives p = 0
      const float corr_a = exp2f(m_a - mx_a), corr_b = exp2f(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      float sa = 0.f, sb = 0.f, da = 0.f, db = 0.f;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pa_ = exp2f(sc[4 * j + e] - mx_a);
          const float pb_ = exp2f(sc[4 * j + 2 + e] - mx_b);
          sa += pa_;
          sb += pb_;
          da = fmaf(pa_, dp[4 * j + e], da);
          db = fmaf(pb_, dp[4 * j + 2 + e], db);
        }
      }
      l_a = l_a * corr_a + sa;
      l_b = l_b * corr_b + sb;
      u_a = u_a * corr_a + da;
      u_b = u_b * corr_b + db;
      if (t == n - 1) {
#pragma unroll
        for (int w = 1; w < 4; w <<= 1) {
          l_a += __shfl_xor_sync(0xffffffffu, l_a, w);
          l_b += __shfl_xor_sync(0xffffffffu, l_b, w);
          u_a += __shfl_xor_sync(0xffffffffu, u_a, w);
          u_b += __shfl_xor_sync(0xffffffffu, u_b, w);
        }
        l_a = fmaxf(l_a, 1e-30f);
        l_b = fmaxf(l_b, 1e-30f);
        m_a += log2f(l_a);  // from here on: lse in base 2
        m_b += log2f(l_b);
        u_a /= l_a;  // from here on: D
        u_b /= l_b;
        if ((lane & 3) == 0) {
          const int64_t row = (int64_t(b) * H + h) * S;
          if (qa < S) {
            lse2[row + qa] = m_a;
            delta[row + qa] = u_a;
          }
          if (qb < S) {
            lse2[row + qb] = m_b;
            delta[row + qb] = u_b;
          }
        }
      }
      continue;
    }

    // sweep 2: dS = P (dP - D), P = exp2(x - lse), rounded to bf16 as the
    // A operand of dQ += dS K
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - m_a) * (dp[4 * j + e] - u_a);
        sc[4 * j + 2 + e] =
            exp2f(sc[4 * j + 2 + e] - m_b) * (dp[4 * j + 2 + e] - u_b);
      }
    }
    uint32_t pa[BT / 16][4];
    to_a(sc, pa);
    product_rs<DP>(acc, pa, st_k);
    mbar_arrive(&bar_free[s]);
  }

  store_acc<D, DP>(acc, dq + b * sdq.b + h * sdq.h, sdq.s, qa, S, scale);
}

// 2: dK and dV of one key tile from one query head; O: bf16 (the
// gradients, group 1) or float (a query head's partial)
template <int D, typename O>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_kv_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta, O* __restrict__ dk,
                      O* __restrict__ dv, Strides sdk, Strides sdv,
                      int group, int H, int S, int causal, int window,
                      float scale, float scale_log2) {
  using C = TileB<D>;
  constexpr int DP = C::DP, CB = C::CB, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_full[ST], bar_free[ST];
  // K, V, then stage s: Q at s_ring + 2 s TILE_BYTES, dO after it; then
  // P^T, fp32, entry i of consumer thread t at [i * 128 + t]
  const uint32_t s_k = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_v = s_k + C::TILE_BYTES;
  const uint32_t s_ring = s_v + C::TILE_BYTES;
  float* p_t = reinterpret_cast<float*>(
      smem_raw + (s_ring + ST * 2 * C::TILE_BYTES - smem_u32(smem_raw)));

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BT;
  const int hk = h / group;
  // the queries that see a key of this tile: causal ones from k0 on, and
  // with a window those before k_last + window
  const int k_last = min(k0 + BT, S) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;
  const int n = (q_end - q_begin + BT - 1) / BT;  // live query tiles

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int me = tid & 127;
  if (tid == 0) {
    mbar_init(&bar_kv, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_free[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The first thread of warpgroup 1 issues every load (no producer warp:
  // see the note at the top): K and V, the first ST query tiles, then tile
  // t + ST once every consumer is done with tile t.
  if (wg == 1 && me == 0) {
    load_pair<CB>(s_k, &tk, &tv, &bar_kv, k0, hk, b);
    for (int t = 0; t < ST && t < n; ++t)
      load_pair<CB>(s_ring + t * 2 * C::TILE_BYTES, &tq, &tdo, &bar_full[t],
                    q_begin + t * BT, h, b);
  }

  // ---- consumer warpgroup wg: 0 owns dV, 1 owns dK; key rows ka and ka +
  // 8 of this thread, query columns 8 j + cq + {0, 1} of each tile ----
  const int lane = tid & 31;
  const int ka = k0 + (me >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  // per query: lse (base 2) for warpgroup 0, D for warpgroup 1
  const float* per_q = (wg == 0 ? lse2 : delta) + (int64_t(b) * H + h) * S;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  mbar_wait(&bar_kv, 0);

  for (int t = 0; t < n; ++t) {
    const int s = t % ST;
    const int q0 = q_begin + t * BT;
    const uint32_t st_q = s_ring + s * 2 * C::TILE_BYTES;
    const uint32_t st_do = st_q + C::TILE_BYTES;
    float r[BT / 8][2];  // this thread's columns' lse or D
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = q0 + 8 * j + cq + e;
        r[j][e] = col < S ? per_q[col] : 0.f;
      }
    // warpgroup 0: S^T = K Q^T; 1: dP^T = V dO^T
    float x[BT / 2];
    mbar_wait(&bar_full[s], (t / ST) & 1);
    wgmma_fence();
    product_ss<D>(x, wg == 0 ? s_k : s_v, wg == 0 ? st_q : st_do);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);

    if (wg == 0) {
      // P^T = exp2(S^T scale log2(e) - lse); masked pairs 0
      const bool edge = crosses(q0, k0, S, causal, window);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = q0 + 8 * j + cq + e;
          float pa_ = exp2f(x[4 * j + e] * scale_log2 - r[j][e]);
          float pb_ = exp2f(x[4 * j + 2 + e] * scale_log2 - r[j][e]);
          if (edge) {
            if (!sees(col, ka, S, causal, window)) pa_ = 0.f;
            if (!sees(col, ka + 8, S, causal, window)) pb_ = 0.f;
          }
          x[4 * j + e] = pa_;
          x[4 * j + 2 + e] = pb_;
        }
      }
      if (t > 0) bar_sync(2);  // warpgroup 1 has read the last P^T
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) p_t[i * 128 + me] = x[i];
      bar_arrive(1);  // P^T written
    } else {
      // dS^T = P^T (dP^T - D)
      bar_sync(1);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ia = 4 * j + e, ib = 4 * j + 2 + e;
          x[ia] = p_t[ia * 128 + me] * (x[ia] - r[j][e]);
          x[ib] = p_t[ib * 128 + me] * (x[ib] - r[j][e]);
        }
      }
      if (t + 1 < n) bar_arrive(2);  // P^T read
    }
    // warpgroup 0: dV += P^T dO; 1: dK += dS^T Q
    uint32_t pa[BT / 16][4];
    to_a(x, pa);
    product_rs<DP>(acc, pa, wg == 0 ? st_do : st_q);
    mbar_arrive(&bar_free[s]);
    if (wg == 1 && me == 0 && t + ST < n) {
      // once every consumer is done with tile t, its stage takes t + ST
      mbar_wait(&bar_free[s], (t / ST) & 1);
      load_pair<CB>(st_q, &tq, &tdo, &bar_full[s], q0 + ST * BT, h, b);
    }
  }

  if (wg == 0)
    store_acc<D, DP>(acc, dv + b * sdv.b + h * sdv.h, sdv.s, ka, S, 1.f);
  else
    store_acc<D, DP>(acc, dk + b * sdk.b + h * sdk.h, sdk.s, ka, S, scale);
}

template <int D>
cudaError_t launch_bf16(const Args& a, cudaStream_t st) {
  using C = TileB<D>;
  using bf16 = __nv_bfloat16;
  if (!tma_ok(a.q, a.sq) || !tma_ok(a.k, a.sk) || !tma_ok(a.v, a.sv) ||
      !tma_ok(a.dout, a.sdo))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, a.q, D, a.S, a.H, a.B, a.sq, BT) ||
      !make_map(&tk, a.k, D, a.S, a.Hkv, a.B, a.sk, BT) ||
      !make_map(&tv, a.v, D, a.S, a.Hkv, a.B, a.sv, BT) ||
      !make_map(&tdo, a.dout, D, a.S, a.H, a.B, a.sdo, BT))
    return cudaErrorInvalidValue;
  const int group = a.H / a.Hkv;
  if (group > 1 && a.part == nullptr) return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_rows_bf16<D>, C::SMEM_ROWS)) !=
          cudaSuccess ||
      (err = allow_smem(flash_bwd_kv_bf16<D, bf16>, C::SMEM_KV)) !=
          cudaSuccess ||
      (err = allow_smem(flash_bwd_kv_bf16<D, float>, C::SMEM_KV)) !=
          cudaSuccess)
    return err;
  const float scale_log2 = a.scale * 1.4426950408889634f;
  // (head, batch row, tile): the tile index varies slowest, so the blocks
  // of the tiles with the most work start first
  const dim3 grid(a.H, a.B, (a.S + BT - 1) / BT);
  flash_bwd_rows_bf16<D><<<grid, 256, C::SMEM_ROWS, st>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dq), a.sdq,
      group, a.H, a.S, a.causal, a.window, a.scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (group == 1) {
    flash_bwd_kv_bf16<D, bf16><<<grid, 256, C::SMEM_KV, st>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.sdk, a.sdv, group, a.H, a.S, a.causal,
        a.window, a.scale, scale_log2);
    return cudaGetLastError();
  }
  // fp32 partials (B, H, S, D) per query head, then their sum per group
  const int64_t n_part = int64_t(a.B) * a.H * a.S * D;
  const Strides sp{int64_t(a.H) * a.S * D, int64_t(a.S) * D, D};
  flash_bwd_kv_bf16<D, float><<<grid, 256, C::SMEM_KV, st>>>(
      tq, tk, tv, tdo, a.lse, a.delta, a.part, a.part + n_part, sp, sp,
      group, a.H, a.S, a.causal, a.window, a.scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return group_sums<bf16>(a, a.part, a.part + n_part, D, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 21 int64 in elements, the
// (batch, head, seq) strides of q, k, v, dout, dq, dk, dv in that order;
// window <= 0 means no window.  lse and delta: (B, H, S) fp32 scratch;
// part: 2 (B, H, S, D) fp32 scratch where H > Hkv, else may be null.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, void* dq, void* dk, void* dv,
                               float* lse, float* delta, float* part,
                               int dtype, int B,
                               int H, int Hkv, int S, int D,
                               const int64_t* strides, int causal,
                               int window, float scale, void* stream) {
  Args a{q, k, v, dout, dq, dk, dv, lse, delta, part};
  Strides* st[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  if (Hkv <= 0 || H % Hkv || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD_CASE(DD) \
  if (D == DD)                   \
    return dtype == 0 ? launch_fp32<DD>(a, s) : launch_bf16<DD>(a, s);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  REPRO_FLASH_BWD_CASE(64)
  REPRO_FLASH_BWD_CASE(80)
  REPRO_FLASH_BWD_CASE(128)
  REPRO_FLASH_BWD_CASE(160)
  REPRO_FLASH_BWD_CASE(256)
#undef REPRO_FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
