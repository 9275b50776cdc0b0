// Backward of prefill attention for Hopper (sm_90a), written by hand.
//
// The Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel) has no backward pass: the JAX package
// trains through its jnp attention and XLA's autodiff.  This file is the
// backward of the port's forward kernel (csrc/flash_attention.cu), which it
// leaves untouched: it takes q, k, v and the incoming gradient dO, and
// recomputes what it needs.  See repro_torch/kernels/flash_attention.py for
// the contract and what bounds it on the H100.
//
// Three kernels, launched in order on the caller's stream by one entry:
//   1. flash_bwd_stats, one block per (head, batch row, query tile): the
//      log-sum-exp of each query row's scaled, masked logits and D =
//      rowsum(P * dP) with P = exp(S - lse) and dP = dO V^T, in one online
//      sweep over the live key tiles (a running max, and the sums of
//      exp(S - max) and of exp(S - max) dP rescaled as it grows), in fp32.
//      D equals rowsum(dO * O); it is summed from P and dP because the
//      forward's O is rounded to bf16, and in a row whose
//      gradient cancels (attention on nearly one key: dS = P (dP - D) is
//      then nearly 0) that rounding would reach dQ at several percent of
//      the row.
//   2. flash_bwd_dkdv, one block per (query head, batch row, key tile): it
//      loops over the query tiles that see a key of its tile, recomputes P
//      and dS = P (dP - D) / sqrt(Dh), and accumulates that head's dV +=
//      P^T dO and dK += dS^T Q in registers.  Where a KV head serves a
//      group of query heads, each block writes its head's share as an fp32
//      partial and flash_bwd_group_sum adds the group's partials up in a
//      fixed order: no atomics, deterministic, and a group's heads run in
//      parallel (recurrentgemma-2b's 10 query heads share one KV head, so
//      a block per KV head would leave the first key tile, which every
//      later query sees, with ten heads of work).
//   3. flash_bwd_dq, one block per (head, batch row, query tile): dQ += dS K
//      over the live key tiles.
//   Each grid runs the tiles with the most live pairs first.
//
// All on the CUDA cores, fp32 in shared memory and registers whatever the
// input type (bf16 or fp32), outputs rounded once to the input type.  Tiles
// of T queries and T keys, T = 64 up to Dh 128 and 32 above (four fp32
// tiles of 32 x 260 are 133 KB of shared memory at Dh 256); 256 threads as
// a 16 x 16 grid: thread (ty, tx) owns the score entries (ty + 16 i,
// tx + 16 j) and the accumulator entries (row ty + 16 i, column tx + 16 c).
// Shared-memory rows are padded to Dh + 4 and T + 1 floats so that the
// threads that read along a column hit distinct banks (the products of two
// (T, Dh) tiles read 16 bytes at a time).  The
// masks are those of the forward (causal, window, the ragged last tile;
// masked logits give P = 0); key or query tiles that the mask hides from a
// whole tile are never visited.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing (the caller passes the fp32 lse, D and partials
// scratch).  The
// entry returns cudaGetLastError(), or cudaErrorInvalidValue for a dtype or
// head dim it is not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;

struct Strides {
  int64_t b, h, s;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// 16 bytes of E as floats
__device__ __forceinline__ void unpack(uint4 u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float* out, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// rows row0 .. row0 + T - 1 of one (batch, head) slice into a padded fp32
// tile; rows past S are zeros.  16-byte loads, all of a thread's issued
// before the first is stored, so a tile costs one round trip to memory (the
// wrapper checks the 16-byte alignment of bases and row strides).
template <int D, typename E>
__device__ __forceinline__ void load_tile(float* dst, const E* src,
                                          int64_t stride_s, int row0,
                                          int S) {
  using G = Geo<D>;
  constexpr int V = 16 / sizeof(E);     // elements a load
  constexpr int PER_ROW = D / V;        // loads a row
  constexpr int N = G::T * PER_ROW;     // loads a tile
  constexpr int ITERS = (N + THREADS - 1) / THREADS;
  uint4 buf[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * V;
    buf[it] = i < N && row0 + r < S
                  ? *reinterpret_cast<const uint4*>(src + (row0 + r) *
                                                              stride_s + c)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (i < N) {
      const int r = i / PER_ROW, c = (i - r * PER_ROW) * V;
      float f[V];
      unpack(buf[it], f, E());
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(dst + r * G::DP + c + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
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

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta, *part;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, H, Hkv, S, causal, window;
  float scale;
};

// ---------------------------------------------------- 1: lse and D ----

template <int D, typename E>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_stats(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const E* __restrict__ dout,
                    float* __restrict__ lse, float* __restrict__ delta,
                    int group, int H, int S, Strides sq, Strides sk,
                    Strides sv, Strides sdo, int causal, int window,
                    float scale) {
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
  const E* kb = k + b * sk.b + (h / group) * sk.h;
  const E* vb = v + b * sv.b + (h / group) * sv.h;

  load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile<D>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  // online over the live key tiles, per row: the max m, l = sum exp(S -
  // m) and u = sum exp(S - m) dP, both rescaled as m grows; then lse = m +
  // log l and D = u / l
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

// ------------------------------------------------------- 2: dK, dV ----

// One block per (query head, batch row, key tile): that head's share of dK
// and dV of the tile's keys, written to head h of dk / dv: the gradients
// themselves where the group is 1, else fp32 partials, one per query head,
// that flash_bwd_group_sum adds up over the group.
template <int D, typename E, typename O>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv(const E* __restrict__ q, const E* __restrict__ k,
                   const E* __restrict__ v, const E* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, O* __restrict__ dk,
                   O* __restrict__ dv, int group, int H, int S,
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
  const E* qb = q + b * sq.b + h * sq.h;
  const E* db = dout + b * sdo.b + h * sdo.h;
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
      O* dkr = dk + b * sdk.b + h * sdk.h + kj * sdk.s;
      O* dvr = dv + b * sdv.b + h * sdv.h + kj * sdv.s;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        store(dkr + tx + 16 * c, acc_k[i][c]);
        store(dvr + tx + 16 * c, acc_v[i][c]);
      }
    }
  }
}

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

// ------------------------------------------------------------ 3: dQ ----

template <int D, typename E>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const E* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, E* __restrict__ dq,
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
  const E* kb = k + b * sk.b + hk * sk.h;
  const E* vb = v + b * sv.b + hk * sv.h;

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
      E* dqr = dq + b * sdq.b + h * sdq.h + qi * sdq.s;
#pragma unroll
      for (int c = 0; c < C; ++c) store(dqr + tx + 16 * c, acc[i][c]);
    }
  }
}

// ---------------------------------------------------------- launch ----

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  // above 48 KB of dynamic shared memory a launch is refused unless the
  // kernel opts in
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int D, typename E>
cudaError_t launch(const Args& a, cudaStream_t st) {
  using G = Geo<D>;
  constexpr size_t tile = sizeof(float) * G::TILE;
  constexpr size_t scores = sizeof(float) * G::T * G::TP;
  constexpr size_t rows = sizeof(float) * 2 * G::T;
  constexpr size_t smem_stats = 4 * tile;
  constexpr size_t smem_dkdv = 4 * tile + 2 * scores + rows;
  constexpr size_t smem_dq = 4 * tile + scores + rows;
  const int group = a.H / a.Hkv;
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_stats<D, E>, smem_stats)) != cudaSuccess ||
      (err = allow_smem(flash_bwd_dkdv<D, E, E>, smem_dkdv)) !=
          cudaSuccess ||
      (err = allow_smem(flash_bwd_dkdv<D, E, float>, smem_dkdv)) !=
          cudaSuccess ||
      (err = allow_smem(flash_bwd_dq<D, E>, smem_dq)) != cudaSuccess)
    return err;
  if (group > 1 && a.part == nullptr) return cudaErrorInvalidValue;
  // (head, batch row, tile): the tile index varies slowest, so the blocks
  // of the tiles with the most work start first
  const dim3 grid(a.H, a.B, (a.S + G::T - 1) / G::T);
  const E* q = static_cast<const E*>(a.q);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);
  const E* dout = static_cast<const E*>(a.dout);
  flash_bwd_stats<D, E><<<grid, THREADS, smem_stats, st>>>(
      q, k, v, dout, a.lse, a.delta, group, a.H, a.S, a.sq, a.sk, a.sv,
      a.sdo, a.causal, a.window, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (group == 1) {
    flash_bwd_dkdv<D, E, E><<<grid, THREADS, smem_dkdv, st>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<E*>(a.dk),
        static_cast<E*>(a.dv), group, a.H, a.S, a.sq, a.sk, a.sv, a.sdo,
        a.sdk, a.sdv, a.causal, a.window, a.scale);
  } else {
    // fp32 partials (B, H, S, D) per query head, then their sum per group
    const int64_t n_part = int64_t(a.B) * a.H * a.S * D;
    const Strides sp{int64_t(a.H) * a.S * D, int64_t(a.S) * D, D};
    float* pk = a.part;
    float* pv = a.part + n_part;
    flash_bwd_dkdv<D, E, float><<<grid, THREADS, smem_dkdv, st>>>(
        q, k, v, dout, a.lse, a.delta, pk, pv, group, a.H, a.S, a.sq, a.sk,
        a.sv, a.sdo, sp, sp, a.causal, a.window, a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int64_t n = int64_t(a.B) * a.Hkv * a.S * D;
    const int blocks = int((n + 255) / 256 < 132 * 16 ? (n + 255) / 256
                                                        : 132 * 16);
    flash_bwd_group_sum<E><<<blocks, 256, 0, st>>>(
        pk, static_cast<E*>(a.dk), group, a.Hkv, a.S, D, a.sdk, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    flash_bwd_group_sum<E><<<blocks, 256, 0, st>>>(
        pv, static_cast<E*>(a.dv), group, a.Hkv, a.S, D, a.sdv, n);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq<D, E><<<grid, THREADS, smem_dq, st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<E*>(a.dq), group, a.H,
      a.S, a.sq, a.sk, a.sv, a.sdo, a.sdq, a.causal, a.window, a.scale);
  return cudaGetLastError();
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
#define REPRO_FLASH_BWD_CASE(DD)                                 \
  if (D == DD)                                                   \
    return dtype == 0 ? launch<DD, float>(a, s)                  \
                      : launch<DD, __nv_bfloat16>(a, s);
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
