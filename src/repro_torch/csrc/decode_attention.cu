// Decode attention for Hopper (sm_90a), written by hand: flash-decoding.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel).  See
// repro_torch/kernels/decode_attention.py for the contract, the bound on
// the H100 and the design; in short:
//
//   * decode_partial: grid (n_split, Hkv, B), 4 warps.  A block reads cache
//     slots [split * chunk, (split + 1) * chunk) of one (batch row, KV head)
//     once, for all G query heads of that KV head.  Each warp takes every
//     4th group of U = 4 slots; a lane holds D / 32 elements of each row,
//     the dot products are reduced with warp shuffles, and each warp keeps
//     an fp32 online softmax (m, l, acc) per head.  The warps' states are
//     merged in shared memory and written as the split's partial;
//   * decode_combine: grid (Hkv, B), merges the splits' partials and writes
//     acc / max(l, 1e-30) in the output dtype;
//   * slot j of row b is valid when j < lengths[b] and, with a window,
//     j >= lengths[b] - window: exactly the TPU kernel's mask, on slot
//     indices.  lengths is read on the device.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing (the partials come from the caller).  The entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int U = 4;  // slots in flight per warp
constexpr float NEG_INF = -1e30f;

struct CacheStrides {
  int64_t b, s, h;
};

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

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
    decode_partial(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ lengths,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int Hkv, int S, int chunk,
                   int n_split, int64_t sqb, int64_t sqh, CacheStrides sk,
                   CacheStrides sv, int window, float scale) {
  constexpr int E = D / 32;  // elements of a row per lane
  __shared__ float sm[WARPS][G];
  __shared__ float sl[WARPS][G];
  __shared__ float sacc[WARPS][G][D];

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int len = lengths[b];
  int lo = split * chunk;
  const int hi = min(min(lo + chunk, len), S);
  if (window > 0) lo = max(lo, len - window);

  float qr[G][E], acc[G][E], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = q + b * sqb + (int64_t)(hk * G + g) * sqh + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[g][e] = to_float(qp[e]);
      acc[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  const T* kb = kc + b * sk.b + hk * sk.h + lane * E;
  const T* vb = vc + b * sv.b + hk * sv.h + lane * E;
  for (int base = lo + warp * U; base < hi; base += WARPS * U) {
    float kr[U][E], vr[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + u;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[u][e] = pos < hi ? to_float(kb[pos * sk.s + e]) : 0.f;
        vr[u][e] = pos < hi ? to_float(vb[pos * sv.s + e]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u >= hi) break;  // uniform across the warp
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qr[g][e], kr[u][e], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= scale;
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * corr + p * vr[u][e];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm[warp][g] = m[g];
      sl[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sacc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();

  // A warp that saw no slot has m = -1e30, l = 0, acc = 0: its weight
  // exp(m - M) is 0 next to any warp that did, and its l and acc are 0
  // when none did.
  const int64_t row = ((int64_t)(b * Hkv + hk) * n_split + split) * G;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = sm[0][g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) M = fmaxf(M, sm[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm[w][g] - M);
      L += sl[w][g] * f;
      A += sacc[w][g][d] * f;
    }
    part_acc[(row + g) * D + d] = A;
    if (d == 0) {
      part_m[row + g] = M;
      part_l[row + g] = L;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_combine(const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, T* __restrict__ o,
                   int Hkv, int G, int D, int n_split, int64_t sob,
                   int64_t soh) {
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t first = (int64_t)(b * Hkv + hk) * n_split * G;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
    for (int sp = 0; sp < n_split; ++sp)
      M = fmaxf(M, part_m[first + (int64_t)sp * G + g]);
    float L = 0.f, A = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const int64_t r = first + (int64_t)sp * G + g;
      const float f = expf(part_m[r] - M);
      L += part_l[r] * f;
      A += part_acc[r * D + d] * f;
    }
    o[b * sob + (int64_t)(hk * G + g) * soh + d] =
        from_float<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* lengths, void* o, float* part_m, float* part_l,
                   float* part_acc, int B, int Hkv, int S, int n_split,
                   int chunk, int64_t sqb, int64_t sqh, CacheStrides sk,
                   CacheStrides sv, int64_t sob, int64_t soh, int window,
                   float scale, cudaStream_t stream) {
  decode_partial<T, D, G><<<dim3(n_split, Hkv, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, part_m, part_l, part_acc, Hkv, S,
      chunk, n_split, sqb, sqh, sk, sv, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<dim3(Hkv, B), THREADS, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), Hkv, G, D, n_split, sob,
      soh);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(int G, const void* q, const void* kc, const void* vc,
                     const int* lengths, void* o, float* part_m,
                     float* part_l, float* part_acc, int B, int Hkv, int S,
                     int n_split, int chunk, int64_t sqb, int64_t sqh,
                     CacheStrides sk, CacheStrides sv, int64_t sob,
                     int64_t soh, int window, float scale,
                     cudaStream_t stream) {
#define REPRO_DECODE_CASE(GG)                                                \
  case GG:                                                                   \
    return launch<T, D, GG>(q, kc, vc, lengths, o, part_m, part_l, part_acc, \
                            B, Hkv, S, n_split, chunk, sqb, sqh, sk, sv, sob, \
                            soh, window, scale, stream);
  switch (G) {
    REPRO_DECODE_CASE(1)
    REPRO_DECODE_CASE(2)
    REPRO_DECODE_CASE(4)
    REPRO_DECODE_CASE(8)
    REPRO_DECODE_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q (B, H, D) with strides (sqb, sqh);
// caches (B, S, Hkv, D) with strides (b, s, h); o (B, H, D) with strides
// (sob, soh); lengths (B,) int32.  part_m / part_l hold B*Hkv*n_split*G
// floats and part_acc that times D.  window <= 0 means no window.
int decode_attention_launch(const void* q, const void* kc, const void* vc,
                            const void* lengths, void* o, void* part_m,
                            void* part_l, void* part_acc, int dtype, int B,
                            int Hkv, int G, int S, int D, int n_split,
                            int chunk, int64_t sqb, int64_t sqh, int64_t skb,
                            int64_t sks, int64_t skh, int64_t svb,
                            int64_t svs, int64_t svh, int64_t sob,
                            int64_t soh, int window, float scale,
                            void* stream) {
  const CacheStrides sk{skb, sks, skh}, sv{svb, svs, svh};
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_d<float, 64>(G, q, kc, vc, len, o, pm, pl, pa, B, Hkv, S,
                               n_split, chunk, sqb, sqh, sk, sv, sob, soh,
                               window, scale, st);
  if (dtype == 0 && D == 128)
    return launch_d<float, 128>(G, q, kc, vc, len, o, pm, pl, pa, B, Hkv, S,
                                n_split, chunk, sqb, sqh, sk, sv, sob, soh,
                                window, scale, st);
  if (dtype == 1 && D == 64)
    return launch_d<__nv_bfloat16, 64>(G, q, kc, vc, len, o, pm, pl, pa, B,
                                       Hkv, S, n_split, chunk, sqb, sqh, sk,
                                       sv, sob, soh, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch_d<__nv_bfloat16, 128>(G, q, kc, vc, len, o, pm, pl, pa, B,
                                        Hkv, S, n_split, chunk, sqb, sqh, sk,
                                        sv, sob, soh, window, scale, st);
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
