// Mamba-2 SSD scan for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan / _ssd_kernel).  See repro_torch/kernels/ssd_scan.py for the
// contract, the bound on the H100 and the design.  Two kernels, chosen by
// the dtype of x, B and C:
//
// ssd_bf16_kernel (bf16 x / B / C, the serving path): tensor cores.
//   * grid (H * P / 32, B), 128 threads (4 warps).  One block owns one
//     (batch row, head, 32 of the P columns) and loops over chunks of
//     L = 64 positions: column p of y and of the state reads only column p
//     of x, so the two column blocks of a head are independent and each
//     recomputes the chunk's gram;
//   * every product of a chunk is mma.sync.m16n8k16 (bf16 in, fp32
//     accumulate) with its operands read by ldmatrix from swizzled shared
//     memory.  In each product one operand is exactly bf16 (C, B or x as
//     the model hands them); the fp32 factors fold into the other operand
//     u, which is split into hi = bf16(u) and lo = bf16(u - hi) and
//     multiplied twice, hi.v + lo.v (about 2^-17 relative per element):
//       G  = C B^T                       (64 x 128)(128 x 64), one pass
//       M' = [j <= i] exp(cum_i - cum_j) G_ij dt_j, the exponent masked
//            BEFORE exp (the upper triangle's exponents are positive);
//       y  = M' x + diag(exp cum) C H     (M' and H split)
//       H <- exp(cum_L) H + (B o w dt)^T x, w_j = exp(cum_L - cum_j)
//                                         (the scaled B^T split);
//   * warp w owns rows 16w .. 16w + 15 of the chunk: its gram tiles right
//     of the diagonal are never computed, and the gram's accumulator
//     layout is mma's A-operand layout, so M' goes to M' x in registers.
//     G and C H share one pass over C (one ldmatrix of C for both), and
//     C H, scaled by exp(cum_i), is the accumulator M' x adds into;
//   * the fp32 state H (128 x 32 per block) lives in accumulator
//     registers from h0 to h_final (warp w: rows 32w .. 32w + 31) and is
//     never rounded; each chunk writes its hi / lo bf16 copy to shared
//     memory for the next chunk's C H;
//   * B, C and x are staged as bf16 by cp.async (16-byte copies, zero fill
//     past S).  B and x are double-buffered: the next chunk's are requested
//     after the chunk's first block barrier and land during its products.
//     C is read only by the first pass, so the next chunk's C is requested
//     after the second barrier (from the L2: all the heads of a row read
//     it) and lands during M' x and the state update.  dt's cumulative
//     sums are double-buffered too, so a chunk has two barriers.  Shared
//     memory is 75,264 bytes and ptxas keeps to 168 registers, so three
//     blocks share an SM and the 384 blocks of the serving shape run as
//     one wave on 132 SMs (on a partition of fewer SMs, several waves:
//     no block waits on another, so only the time changes);
//   * positions at or past S read as dt = 0 and zero x, B, C: they leave
//     the state unchanged and write no y, so any S works.
//
// ssd_kernel (fp32 inputs, the parity path): CUDA cores, unchanged.
//   * grid (H, B); 256 threads as a 16 x 16 grid (ty, tx).  One block owns
//     one (batch row, head) and loops over chunks of L = 64 positions;
//   * the (N, P) fp32 state lives in shared memory from h0 (or zero) to
//     the end of the sequence, where it is written out as h_final;
//   * per chunk, in order: B, C and x * dt are staged in shared memory
//     (fp32) and one warp takes the inclusive cumulative sum of dt * a and
//     the weights exp(cum_last - cum_j); the gram C B^T is masked BEFORE
//     the exponential into M = exp(cum_i - cum_j) C_i . B_j for j <= i;
//     y_i = sum_j M_ij (x dt)_j + exp(cum_i) C_i^T h; then
//     h = exp(cum_last) h + sum_j exp(cum_last - cum_j) B_j (x dt)_j^T.
//
// Both address x through (batch, seq, head) strides and B, C through
// (batch, seq) strides (the model hands slices of one projection); dt
// (B, S, H), a (H,), h0 and both outputs are contiguous fp32.  The bf16
// kernel copies 16 bytes at a time where the pointers and strides allow
// it and element by element otherwise.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing.  The entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int L = 64;         // positions per chunk
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------------ fp32 --

__device__ __forceinline__ float to_float(float x) { return x; }

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

template <int N, int P>
cudaError_t launch_fp32(const float* x, const float* dt, const float* a,
                        const float* bm, const float* cm, const float* h0,
                        float* y, float* hout, int B, int S, int H,
                        int64_t sxb, int64_t sxs, int64_t sxh, int64_t sbb,
                        int64_t sbs, int64_t scb, int64_t scs,
                        cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N, P>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<float, N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  ssd_kernel<float, N, P><<<dim3(H, B), THREADS, smem, stream>>>(
      x, dt, a, bm, cm, h0, y, hout, S, H, sxb, sxs, sxh, sbb, sbs, scb, scs);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16 --

namespace tc {  // the tensor-core kernel

constexpr int N = 128;         // state size
constexpr int P = 64;          // head dim
constexpr int PB = 32;         // columns of P per block
constexpr int THREADS = 128;   // 4 warps
constexpr int ROW_BC = 2 * N;  // bytes of a staged B or C row
constexpr int ROW_X = 2 * PB;  // bytes of a staged x or state row
constexpr int SZ_BC = L * ROW_BC;
constexpr int SZ_X = L * ROW_X;
constexpr int OFF_C = 0;
constexpr int OFF_B = OFF_C + SZ_BC;  // two buffers
constexpr int OFF_X = OFF_B + 2 * SZ_BC;  // two buffers
constexpr int OFF_HHI = OFF_X + 2 * SZ_X;
constexpr int OFF_HLO = OFF_HHI + N * ROW_X;
constexpr int OFF_CUM = OFF_HLO + N * ROW_X;  // two copies of each
constexpr int OFF_DT = OFF_CUM + 2 * 4 * L;
constexpr int OFF_S = OFF_DT + 2 * 4 * L;
constexpr int SMEM = OFF_S + 2 * 4 * L;  // 75,264 bytes

__global__ void __launch_bounds__(THREADS, 3)
    ssd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ a,
                    const __nv_bfloat16* __restrict__ bm,
                    const __nv_bfloat16* __restrict__ cm,
                    const float* __restrict__ h0, float* __restrict__ y,
                    float* __restrict__ hout, int S, int H, int64_t sxb,
                    int64_t sxs, int64_t sxh, int64_t sbb, int64_t sbs,
                    int64_t scb, int64_t scs, bool vec) {
  extern __shared__ __align__(128) uint8_t sm[];
  uint8_t* Cs = sm + OFF_C;
  uint8_t* Hhi = sm + OFF_HHI;
  uint8_t* Hlo = sm + OFF_HLO;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row, column pair
  const int h = blockIdx.x / (P / PB);
  const int p0 = (blockIdx.x % (P / PB)) * PB;
  const int b = blockIdx.y;
  const float ah = a[h];

  const __nv_bfloat16* xb = x + b * sxb + h * sxh + p0;
  const float* dtb = dt + (int64_t)b * S * H + h;
  const __nv_bfloat16* bb = bm + b * sbb;
  const __nv_bfloat16* cb = cm + b * scb;
  float* yb = y + (int64_t)b * S * H * P + (int64_t)h * P + p0;
  const int64_t hoff = ((int64_t)b * H + h) * N * P + p0;

  // the state: rows 32 warp + 16 mt + g (+ 8), columns 8 nt + 2 q (+ 1)
  float hacc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 32 * warp + 16 * mt + g + 8 * half;
        float2 v = make_float2(0.f, 0.f);
        if (h0 != nullptr)
          v = *reinterpret_cast<const float2*>(h0 + hoff + (int64_t)n * P +
                                               8 * nt + 2 * q);
        hacc[mt][nt][2 * half] = v.x;
        hacc[mt][nt][2 * half + 1] = v.y;
      }

  const int nchunks = (S + L - 1) / L;
  stage<16>(Cs, cb, scs, 0, S, vec);
  stage<16>(sm + OFF_B, bb, sbs, 0, S, vec);
  stage<4>(sm + OFF_X, xb, sxs, 0, S, vec);
  cp_commit();
  float d0 = 0.f, d1 = 0.f;  // warp 0: dt at positions lane, lane + 32
  if (warp == 0) {
    d0 = lane < S ? dtb[(int64_t)lane * H] : 0.f;
    d1 = lane + 32 < S ? dtb[(int64_t)(lane + 32) * H] : 0.f;
  }
  write_state(hacc, Hhi, Hlo, warp, g, q);

  for (int k = 0; k < nchunks; ++k) {
    const int t0 = k * L;
    const int cur = k & 1, nxt = cur ^ 1;
    const uint8_t* Bs = sm + OFF_B + cur * SZ_BC;
    const uint8_t* Xs = sm + OFF_X + cur * SZ_X;
    float* cum = reinterpret_cast<float*>(sm + OFF_CUM) + cur * L;
    float* dts = reinterpret_cast<float*>(sm + OFF_DT) + cur * L;
    float* sj = reinterpret_cast<float*>(sm + OFF_S) + cur * L;
    if (warp == 0) {  // cumsum of dt a; chunk k - 1 read the other copy
      float v0 = d0 * ah, v1 = d1 * ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (lane >= off) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float tot = __shfl_sync(0xffffffffu, v1, 31);
      cum[lane] = v0;
      cum[lane + 32] = v1;
      dts[lane] = d0;
      dts[lane + 32] = d1;
      sj[lane] = expf(tot - v0) * d0;
      sj[lane + 32] = expf(tot - v1) * d1;
      const int tn = t0 + L + lane;  // the next chunk's dt, read ahead
      d0 = tn < S ? dtb[(int64_t)tn * H] : 0.f;
      d1 = tn + 32 < S ? dtb[(int64_t)(tn + 32) * H] : 0.f;
    }
    cp_wait_all();  // this chunk's B, C and x have landed
    __syncthreads();
    if (k + 1 < nchunks) {  // into the buffers chunk k - 1 read
      stage<16>(sm + OFF_B + nxt * SZ_BC, bb, sbs, t0 + L, S, vec);
      stage<4>(sm + OFF_X + nxt * SZ_X, xb, sxs, t0 + L, S, vec);
    }
    cp_commit();

    // one pass over C: G = C B^T for rows 16 warp .. + 15 (column tiles
    // 0 .. 2 warp + 1, the rest is right of the diagonal), and C H for the
    // same rows from the state's hi / lo copy
    const int i0 = 16 * warp;
    float gacc[8][4], yacc[4][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[t][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(Cs + swz_bc(i0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                          2 * ks + (lane >> 4)),
              af);
#pragma unroll
      for (int tp = 0; tp < 4; ++tp) {
        if (tp <= warp) {
          uint32_t bf[4];
          ldsm_x4(Bs + swz_bc(16 * tp + (lane & 7) + (lane >> 4) * 8,
                              2 * ks + ((lane >> 3) & 1)),
                  bf);
          mma(gacc[2 * tp], af, bf[0], bf[1]);
          mma(gacc[2 * tp + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int off = swz_x(16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8,
                              2 * np + (lane >> 4));
        uint32_t bh[4], bl[4];
        ldsm_x4_t(Hhi + off, bh);
        ldsm_x4_t(Hlo + off, bl);
        mma(yacc[2 * np], af, bh[0], bh[1]);
        mma(yacc[2 * np], af, bl[0], bl[1]);
        mma(yacc[2 * np + 1], af, bh[2], bh[3]);
        mma(yacc[2 * np + 1], af, bl[2], bl[3]);
      }
    }
    __syncthreads();  // every warp is done with C and the state's copy
    if (k + 1 < nchunks) stage<16>(Cs, cb, scs, t0 + L, S, vec);
    cp_commit();

    // y = exp(cum_i) C H + M' x, with M' = [j <= i] exp(cum_i - cum_j) G
    // dt_j as hi / lo A fragments: the tile of columns 16 kk .. + 15 is
    // accumulator tiles 2 kk, 2 kk + 1
    const int ia = i0 + g, ib = ia + 8;
    const float cum_a = cum[ia], cum_b = cum[ib];
    const float ea = expf(cum_a), eb = expf(cum_b);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      yacc[nt][0] *= ea;
      yacc[nt][1] *= ea;
      yacc[nt][2] *= eb;
      yacc[nt][3] *= eb;
    }
    uint32_t mhi[4][4], mlo[4][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t <= 2 * warp + 1) {
        const int j = 8 * t + 2 * q;
        const float c0 = cum[j], c1 = cum[j + 1];
        const float e0 = dts[j], e1 = dts[j + 1];
        const float m0 =
            expf(j <= ia ? cum_a - c0 : NEG_INF) * (gacc[t][0] * e0);
        const float m1 =
            expf(j + 1 <= ia ? cum_a - c1 : NEG_INF) * (gacc[t][1] * e1);
        const float m2 =
            expf(j <= ib ? cum_b - c0 : NEG_INF) * (gacc[t][2] * e0);
        const float m3 =
            expf(j + 1 <= ib ? cum_b - c1 : NEG_INF) * (gacc[t][3] * e1);
        const int r = (t & 1) * 2;
        split(m0, m1, mhi[t >> 1][r], mlo[t >> 1][r]);
        split(m2, m3, mhi[t >> 1][r + 1], mlo[t >> 1][r + 1]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk <= warp) {  // the column tiles left of the diagonal
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t xf[4];
          ldsm_x4_t(Xs + swz_x(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                               2 * np + (lane >> 4)),
                    xf);
          mma(yacc[2 * np], mhi[kk], xf[0], xf[1]);
          mma(yacc[2 * np], mlo[kk], xf[0], xf[1]);
          mma(yacc[2 * np + 1], mhi[kk], xf[2], xf[3]);
          mma(yacc[2 * np + 1], mlo[kk], xf[2], xf[3]);
        }
      }
    }
    const int ta = t0 + ia, tb = t0 + ib;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int p = 8 * nt + 2 * q;
      if (ta < S)
        *reinterpret_cast<float2*>(yb + (int64_t)ta * H * P + p) =
            make_float2(yacc[nt][0], yacc[nt][1]);
      if (tb < S)
        *reinterpret_cast<float2*>(yb + (int64_t)tb * H * P + p) =
            make_float2(yacc[nt][2], yacc[nt][3]);
    }

    // H <- exp(tot) H + (B o s)^T x, s_j = exp(tot - cum_j) dt_j, with the
    // scaled B^T split into hi / lo
    const float decay = expf(cum[L - 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[mt][nt][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t xf[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_t(Xs + swz_x(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                             2 * np + (lane >> 4)),
                  xf[np]);
      const int j = 16 * kk + 2 * q;
      const float s0 = sj[j], s1 = sj[j + 1], s8 = sj[j + 8],
                  s9 = sj[j + 9];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t ra[4];  // (B^T) rows n, columns j, from B stored (j, n)
        ldsm_x4_t(Bs + swz_bc(16 * kk + (lane & 7) + (lane >> 4) * 8,
                              (32 * warp + 16 * mt) / 8 + ((lane >> 3) & 1)),
                  ra);
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ra[r]));
          const bool hi_k = r >= 2;  // columns j + 8, j + 9
          split(v.x * (hi_k ? s8 : s0), v.y * (hi_k ? s9 : s1), ahi[r],
                alo[r]);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma(hacc[mt][2 * np], ahi, xf[np][0], xf[np][1]);
          mma(hacc[mt][2 * np], alo, xf[np][0], xf[np][1]);
          mma(hacc[mt][2 * np + 1], ahi, xf[np][2], xf[np][3]);
          mma(hacc[mt][2 * np + 1], alo, xf[np][2], xf[np][3]);
        }
      }
    }
    // the new state's copy: every reader of the old one passed the
    // barrier above, and the next reader comes after the next chunk's
    write_state(hacc, Hhi, Hlo, warp, g, q);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 32 * warp + 16 * mt + g + 8 * half;
        *reinterpret_cast<float2*>(hout + hoff + (int64_t)n * P + 8 * nt +
                                   2 * q) =
            make_float2(hacc[mt][nt][2 * half], hacc[mt][nt][2 * half + 1]);
      }
}

cudaError_t launch_bf16(const __nv_bfloat16* x, const float* dt,
                        const float* a, const __nv_bfloat16* bm,
                        const __nv_bfloat16* cm, const float* h0, float* y,
                        float* hout, int B, int S, int H, int64_t sxb,
                        int64_t sxs, int64_t sxh, int64_t sbb, int64_t sbs,
                        int64_t scb, int64_t scs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bf16_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // 16-byte copies need 16-byte aligned rows: base pointers and every
  // stride a multiple of 8 elements (the column block starts at 32)
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(bm) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(cm) % 16 == 0) &&
                   ((sxb | sxs | sxh | sbb | sbs | scb | scs) % 8 == 0);
  ssd_bf16_kernel<<<dim3(H * (P / PB), B), THREADS, SMEM, stream>>>(
      x, dt, a, bm, cm, h0, y, hout, S, H, sxb, sxs, sxh, sbb, sbs, scb, scs,
      vec);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype (of x, B and C): 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores).  x (B, S, H, P) with strides (sxb, sxs, sxh); B and C (B, S, N)
// with strides (b, s); dt (B, S, H), a (H,), h0 (B, H, N, P) or null, y
// (B, S, H, P) and hout (B, H, N, P) contiguous fp32.  Strides in elements.
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
    return launch_fp32<128, 64>(
        static_cast<const float*>(x), dtf, af, static_cast<const float*>(bm),
        static_cast<const float*>(cm), h0f, yf, hf, B, S, H, sxb, sxs, sxh,
        sbb, sbs, scb, scs, st);
  if (N == tc::N && P == tc::P && dtype == 1)
    return tc::launch_bf16(static_cast<const __nv_bfloat16*>(x), dtf, af,
                           static_cast<const __nv_bfloat16*>(bm),
                           static_cast<const __nv_bfloat16*>(cm), h0f, yf, hf,
                           B, S, H, sxb, sxs, sxh, sbb, sbs, scb, scs, st);
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
