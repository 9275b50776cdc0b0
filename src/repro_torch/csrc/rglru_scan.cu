// RG-LRU linear scan for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan / _rglru_kernel).  See repro_torch/kernels/rglru_scan.py for
// the contract, the bound on the H100 and the design; in short:
//
//   * grid (ceil(W / 64), B), 64 threads; thread w of row b walks
//     t = 0 .. S-1 computing h = a_t * h + b_t in an fp32 register, from
//     h0 (or zero), and writes every h_t and the last h;
//   * neighbouring threads take neighbouring lanes w, so each warp's loads
//     and stores are coalesced; a and b are addressed through (batch, seq)
//     strides with unit stride on W, the outputs are contiguous fp32;
//   * the steps depend on each other through h only: each thread loads
//     U = 16 steps of a and b before it runs them, so that many loads are
//     in flight while the chain of FMAs waits on none of them.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing.  The entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 16;  // steps whose loads are issued together

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const float* __restrict__ h0, float* __restrict__ hseq,
                 float* __restrict__ hlast, int S, int W, int64_t sab,
                 int64_t sas, int64_t sbb, int64_t sbs) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int row = blockIdx.y;
  if (w >= W) return;
  const T* ap = a + row * sab + w;
  const T* bp = b + row * sbb + w;
  float* hp = hseq + (int64_t)row * S * W + w;
  float h = h0 != nullptr ? h0[(int64_t)row * W + w] : 0.f;
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = to_float(ap[(t + u) * sas]);
      bv[u] = to_float(bp[(t + u) * sbs]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = fmaf(av[u], h, bv[u]);
      hp[(int64_t)(t + u) * W] = h;
    }
  }
  for (; t < S; ++t) {
    h = fmaf(to_float(ap[t * sas]), h, to_float(bp[t * sbs]));
    hp[(int64_t)t * W] = h;
  }
  hlast[(int64_t)row * W + w] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0,
                   float* hseq, float* hlast, int B, int S, int W,
                   int64_t sab, int64_t sas, int64_t sbb, int64_t sbs,
                   cudaStream_t stream) {
  dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, hseq, hlast, S,
      W, sab, sas, sbb, sbs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of a and b): 0 = float32, 1 = bfloat16.  a, b (B, S, W) with
// strides (b, s) in elements and unit stride on W; h0 (B, W) or null,
// hseq (B, S, W) and hlast (B, W) contiguous fp32.
int rglru_scan_launch(const void* a, const void* b, const void* h0,
                      void* hseq, void* hlast, int dtype, int B, int S, int W,
                      int64_t sab, int64_t sas, int64_t sbb, int64_t sbs,
                      void* stream) {
  const float* h0f = static_cast<const float*>(h0);
  float* hs = static_cast<float*>(hseq);
  float* hl = static_cast<float*>(hlast);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, h0f, hs, hl, B, S, W, sab, sas, sbb, sbs, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0f, hs, hl, B, S, W, sab, sas, sbb,
                                 sbs, st);
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
