// Mamba-2 SSD scan for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan / _ssd_kernel).  See repro_torch/kernels/ssd_scan.py for the
// contract, the bound on the H100 and the design; in short:
//
//   * grid (H, B); 256 threads as a 16 x 16 grid (ty, tx).  One block owns
//     one (batch row, head) and loops over chunks of L = 64 positions: the
//     loop replaces the TPU's sequential chunk axis;
//   * the (N, P) fp32 state lives in shared memory from h0 (or zero) to
//     the end of the sequence, where it is written out as h_final;
//   * per chunk, in order: B, C and x * dt are staged in shared memory
//     (fp32) and one warp takes the inclusive cumulative sum of dt * a and
//     the weights exp(cum_last - cum_j); the gram C B^T is masked BEFORE
//     the exponential (the upper triangle's exponents are positive and
//     would overflow) into M = exp(cum_i - cum_j) C_i . B_j for j <= i;
//     y_i = sum_j M_ij (x dt)_j + exp(cum_i) C_i^T h; then
//     h = exp(cum_last) h + sum_j exp(cum_last - cum_j) B_j (x dt)_j^T;
//   * positions at or past S read as dt = 0 and zero x, B, C: they leave
//     the state unchanged and write no y, so any S works;
//   * x is addressed through (batch, seq, head) strides and B, C through
//     (batch, seq) strides (the model hands slices of one projection);
//     dt (B, S, H), a (H,), h0 and both outputs are contiguous fp32.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing.  The entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 64;         // positions per chunk
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int N, int P>
constexpr size_t smem_bytes() {
  // B and C rows padded to N + 1 floats and M rows to L + 1, so that the
  // threads of a warp hit distinct banks.
  return sizeof(float) * (2 * size_t(L) * (N + 1) + size_t(L) * P +
                          size_t(N) * P + size_t(L) * (L + 1) + 2 * L);
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ hout, int S, int H,
               int64_t sxb, int64_t sxs, int64_t sxh, int64_t sbb,
               int64_t sbs, int64_t scb, int64_t scs) {
  static_assert(N % 16 == 0 && P % 16 == 0, "N and P: multiples of 16");
  constexpr int NP = N + 1;
  constexpr int LP = L + 1;
  constexpr int RN = N / 16;  // state rows per thread
  constexpr int CP = P / 16;  // columns of y and of the state per thread
  extern __shared__ float smem[];
  float* Bs = smem;          // L x NP
  float* Cs = Bs + L * NP;   // L x NP
  float* Xs = Cs + L * NP;   // L x P, x * dt
  float* Hs = Xs + L * P;    // N x P, the state
  float* Ms = Hs + N * P;    // L x LP, decay-masked gram
  float* cum = Ms + L * LP;  // L, inclusive cumsum of dt * a
  float* wj = cum + L;       // L, exp(cum_last - cum_j)

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float ah = a[h];

  const T* xb = x + b * sxb + h * sxh;
  const float* dtb = dt + (int64_t)b * S * H + h;
  const T* bb = bm + b * sbb;
  const T* cb = cm + b * scb;
  float* yb = y + (int64_t)b * S * H * P + (int64_t)h * P;
  const int64_t hoff = ((int64_t)b * H + h) * N * P;

  for (int i = tid; i < N * P; i += THREADS)
    Hs[i] = h0 != nullptr ? h0[hoff + i] : 0.f;

  for (int t0 = 0; t0 < S; t0 += L) {
    __syncthreads();  // the previous chunk's readers (and Hs's init) done

    if (tid < 32) {
      // lane holds positions tid and tid + 32 of the chunk
      const int ta = t0 + tid, tb = t0 + tid + 32;
      float v0 = ta < S ? dtb[(int64_t)ta * H] * ah : 0.f;
      float v1 = tb < S ? dtb[(int64_t)tb * H] * ah : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (tid >= off) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float tot = __shfl_sync(0xffffffffu, v1, 31);
      cum[tid] = v0;
      cum[tid + 32] = v1;
      wj[tid] = expf(tot - v0);
      wj[tid + 32] = expf(tot - v1);
    }
    for (int i = tid; i < L * N; i += THREADS) {
      const int r = i / N, n = i % N;
      const int t = t0 + r;
      const bool in = t < S;
      Bs[r * NP + n] = in ? to_float(bb[t * sbs + n]) : 0.f;
      Cs[r * NP + n] = in ? to_float(cb[t * scs + n]) : 0.f;
    }
    for (int i = tid; i < L * P; i += THREADS) {
      const int r = i / P, p = i % P;
      const int t = t0 + r;
      Xs[r * P + p] =
          t < S ? to_float(xb[t * sxs + p]) * dtb[(int64_t)t * H] : 0.f;
    }
    __syncthreads();

    // M[i][j], rows i = ty*4 + r, columns j = tx + 16*c
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty * 4 + r) * NP + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * NP + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          const float e = j <= i ? cum[i] - cum[j] : NEG_INF;
          Ms[i * LP + j] = expf(e) * acc[r][c];
        }
      }
    }
    __syncthreads();

    // y, rows i = ty*4 + r, columns p = tx + 16*c
    {
      float acc[4][CP], sacc[4][CP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[r][c] = sacc[r][c] = 0.f;
      const int jend = ty * 4 + 4;  // M is zero right of the diagonal
      for (int j = 0; j < jend; ++j) {
        float mv[4], xv[CP];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = Ms[(ty * 4 + r) * LP + j];
#pragma unroll
        for (int c = 0; c < CP; ++c) xv[c] = Xs[j * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[r][c] = fmaf(mv[r], xv[c], acc[r][c]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[CP];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty * 4 + r) * NP + n];
#pragma unroll
        for (int c = 0; c < CP; ++c) hv[c] = Hs[n * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c)
            sacc[r][c] = fmaf(cv[r], hv[c], sacc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        const int t = t0 + i;
        if (t < S) {
          const float e = expf(cum[i]);
#pragma unroll
          for (int c = 0; c < CP; ++c)
            yb[(int64_t)t * H * P + tx + 16 * c] = acc[r][c] + e * sacc[r][c];
        }
      }
    }
    __syncthreads();  // every reader of the old state is done

    // state, rows n = ty*RN + r, columns p = tx + 16*c
    {
      const float decay = expf(cum[L - 1]);
      float acc[RN][CP];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c)
          acc[r][c] = decay * Hs[(ty * RN + r) * P + tx + 16 * c];
#pragma unroll 2
      for (int j = 0; j < L; ++j) {
        const float w = wj[j];
        float bv[RN], xv[CP];
#pragma unroll
        for (int r = 0; r < RN; ++r) bv[r] = Bs[j * NP + ty * RN + r] * w;
#pragma unroll
        for (int c = 0; c < CP; ++c) xv[c] = Xs[j * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[r][c] = fmaf(bv[r], xv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c)
          Hs[(ty * RN + r) * P + tx + 16 * c] = acc[r][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += THREADS) hout[hoff + i] = Hs[i];
}

template <typename T, int N, int P>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* bm, const void* cm, const float* h0, float* y,
                   float* hout, int B, int S, int H, int64_t sxb, int64_t sxs,
                   int64_t sxh, int64_t sbb, int64_t sbs, int64_t scb,
                   int64_t scs, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N, P>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  ssd_kernel<T, N, P><<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), h0, y, hout, S, H, sxb, sxs, sxh, sbb, sbs,
      scb, scs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of x, B and C): 0 = float32, 1 = bfloat16.  x (B, S, H, P) with
// strides (sxb, sxs, sxh); B and C (B, S, N) with strides (b, s); dt
// (B, S, H), a (H,), h0 (B, H, N, P) or null, y (B, S, H, P) and hout
// (B, H, N, P) contiguous fp32.  Strides in elements.
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* bm, const void* cm, const void* h0, void* y,
                    void* hout, int dtype, int B, int S, int H, int P, int N,
                    int64_t sxb, int64_t sxs, int64_t sxh, int64_t sbb,
                    int64_t sbs, int64_t scb, int64_t scs, void* stream) {
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(hout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 128 && P == 64 && dtype == 0)
    return launch<float, 128, 64>(x, dtf, af, bm, cm, h0f, yf, hf, B, S, H,
                                  sxb, sxs, sxh, sbb, sbs, scb, scs, st);
  if (N == 128 && P == 64 && dtype == 1)
    return launch<__nv_bfloat16, 128, 64>(x, dtf, af, bm, cm, h0f, yf, hf, B,
                                          S, H, sxb, sxs, sxh, sbb, sbs, scb,
                                          scs, st);
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
