// Prefill attention for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel).  See
// repro_torch/kernels/flash_attention.py for the contract, the bound on the
// H100 and the design; in short:
//
//   * grid (ceil(S / BQ), H, B); 128 threads; one block owns BQ = 64 queries
//     of one (batch, head) and loops over K/V tiles of BK = 64 keys staged in
//     shared memory (the TPU's sequential kv grid axis);
//   * thread (ty, tx) owns query rows ty*4 .. ty*4+3 and key columns
//     tx + 8*j of each score tile, and the output columns tx + 8*c; the
//     8 threads of a row group reduce the row max and sum by warp shuffles;
//   * the running max m, denominator l and accumulator acc are fp32
//     registers; masked logits are -1e30 and the denominator is floored at
//     1e-30, as on the TPU;
//   * K/V tiles that the causal mask or the window hide from every query of
//     the block are never loaded; keys and queries past S (the ragged last
//     tile) are masked here, so any S works;
//   * q/k/v/o are addressed through (batch, head, seq) strides; the head
//     dim must be contiguous.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing.  The entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

struct Strides {
  int64_t b, h, s;
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

template <int D>
constexpr size_t smem_bytes() {
  // Q and K rows padded to D + 1 floats and P rows to BK + 1 floats, so
  // that the threads of a warp hit distinct banks.
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int group, int S,
                 Strides sq, Strides sk, Strides sv, Strides so, int causal,
                 int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int CPT = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;           // BQ x DP
  float* Ks = Qs + BQ * DP;   // BK x DP
  float* Vs = Ks + BK * DP;   // BK x D
  float* Ps = Vs + BK * D;    // BQ x BKP

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    Qs[r * DP + d] = qi < S ? to_float(qb[qi * sq.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // Key range any query of this block can see; whole tiles outside it are
  // skipped (the TPU kernel's `live` test).
  const int q_last = min(q0 + BQ, S) - 1;
  int k_begin = 0;
  int k_end = S;
  if (causal) k_end = min(S, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int ki = k0 + r;
      const bool in = ki < S;
      Ks[r * DP + d] = in ? to_float(kb[ki * sk.s + d]) : 0.f;
      Vs[r * D + d] = in ? to_float(vb[ki * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tx + 8 * j;
        const bool ok = kj < S && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) Ps[(ty * 4 + i) * BKP + tx + 8 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * BKP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[kk * D + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        ob[qi * so.s + tx + 8 * c] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int S, Strides sq, Strides sk,
                   Strides sv, Strides so, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // Above 48 KB of dynamic shared memory the launch is refused unless the
  // kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / Hkv, S, sq, sk, sv,
      so, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements, (batch, head,
// seq) order; window <= 0 means no window.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int Hkv, int S,
                           int D, int64_t sqb, int64_t sqh, int64_t sqs,
                           int64_t skb, int64_t skh, int64_t sks, int64_t svb,
                           int64_t svh, int64_t svs, int64_t sob, int64_t soh,
                           int64_t sos, int causal, int window, float scale,
                           void* stream) {
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs},
      so{sob, soh, sos};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, H, Hkv, S, sq, sk, sv, so, causal,
                             window, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, H, Hkv, S, sq, sk, sv, so,
                              causal, window, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, Hkv, S, sq, sk, sv, so,
                                     causal, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, Hkv, S, sq, sk, sv,
                                      so, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
