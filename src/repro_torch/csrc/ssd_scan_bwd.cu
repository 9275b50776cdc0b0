// Mamba-2 SSD scan backward for Hopper (sm_90a), written by hand.
//
// The gradient of the SSD scan (csrc/ssd_scan.cu), which replaces the
// Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan /
// _ssd_kernel).  The TPU kernel has no gradient: the JAX package trains
// through autodiff of its jnp ssd_chunked (src/repro/models/ssm.py).  See
// repro_torch/kernels/ssd_scan.py (ssd_scan_bwd_chunks) for the equations
// and for the bound.  Two routes, chosen by the dtype of x, B and C, each
// a kernel and then a kernel that sums its partials in a fixed order (no
// float atomics, so two calls give bitwise-equal gradients):
//
// ssd_bwd_bf16_kernel (bf16 x / B / C, the training path): tensor cores.
//   * grid (H * P / 32, B), 128 threads (4 warps).  One block owns one
//     (batch row, head, 32 of the P columns), as the forward's does: column
//     p of dx, dh0 and the carry reads only column p of x, dy, h0 and
//     dh_final, and every other gradient is a sum over p, so each block
//     writes its share of ddt, da, dB and dC and ssd_bwd_bf16_sum adds the
//     shares of the column blocks and heads;
//   * every product is mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with
//     operands read by ldmatrix from swizzled shared memory, with the
//     forward's precision scheme: the exact operand stays bf16 (x, B or C as
//     the model hands them) and an fp32 one is split into hi = bf16(u) and
//     lo = bf16(u - hi), the fp32 factors (decay mask, dt, w, exp cum)
//     folded into it: two passes, hi v + lo v; three where both operands
//     are fp32 (M^T dy, H dy^T: hi hi + hi lo + lo hi);
//   * sweep 1, forward over the chunks of L = 64: the state in accumulator
//     registers from h0, as the forward kernel's update; each chunk's start
//     state goes to a scratch, 8 float4 a thread a chunk, read back by the
//     same thread (16 KB a chunk a block, 101 MB at mamba2's training
//     shape, written once and read once);
//   * sweep 2, backward over the chunks with the fp32 carry dH' in
//     accumulator registers (and its hi / lo copy in shared memory), in
//     three phases split by block barriers, each with its own warp layout:
//       (i) rows i (warp w: 16w .. + 15): G = C B^T, dM = dy x^T dt_j,
//           M, dG = dM o dec, E = dM o M in registers; dG's hi / lo tiles on
//           or below the diagonal to shared memory; E's row and column sums;
//       (j) rows j: G^T = B C^T again into M^T as A fragments, du = M^T dy
//           + diag(w) B dH', dx = dt du, x . du and the t2 term;
//       (n) rows n (32w .. + 31) of the transposes: Z = H dy^T from the
//           scratch, dC^T = Z o exp(cum) + B^T dG^T and dB^T = dH' x^T o
//           (w dt) + C^T dG written as this block's partials (H P / 32, B,
//           S, N), the t1 and <dH', H> terms, then the carry
//           dH <- exp(tot) dH' + C^T (exp(cum) o dy);
//     then warp 0 sums dcum, scans it into ds and writes ddt's share;
//   * shared memory 75,536 bytes and at most 168 registers, so three
//     blocks share an SM and the 384 blocks of the training shape run as
//     one wave on 132 SMs (on a partition of fewer SMs, several waves: no
//     block waits on another);
//   * positions at or past S read as dt = 0 and zero x, B, C, dy, and none
//     of their gradients is written.
//
// ssd_bwd_kernel (fp32 x / B / C, the parity path): CUDA cores, unchanged.
//   grid (H, B), 256 threads as a 16 x 16 grid (ty, tx).  One block owns one
//   (batch row, head), every product in fp32 on the CUDA cores:
//   * sweep 1, forward over the chunks of L = 64 positions: the fp32 state
//     from h0 (or zero), each chunk's start state written to a scratch
//     (B, H, chunks, N, P) before the update
//     H <- exp(cum_L) H + sum_j exp(cum_L - cum_j) B_j (dt x)_j^T;
//   * sweep 2, backward over the chunks, with the fp32 carry dH (the
//     gradient of the chunk's end state, from dh_final or zero) in shared
//     memory, per chunk:
//       (b) the masked gram M = [i >= j] exp(cum_i - cum_j) C B^T (the
//           exponent masked BEFORE exp), dM = [i >= j] dy u^T, and from
//           them dG = dM o exp(cum_i - cum_j) and E = dM o M; <dH, H>;
//       (c) du = M^T dy + diag(w) B dH (w_j = exp(cum_L - cum_j)), written
//           as dx = dt du, and per position x . du and the two state terms
//           of dcum (C H and B dH, reduced over P by shuffles);
//       (d) dcum (row sums of E less its column sums, the state terms, and
//           <dH, H'> at the last position), its reverse cumulative sum ds
//           by one warp, ddt = a ds + x . du, and da += dt . ds;
//       (e) this head's dC = dG B + diag(exp cum) dy H^T and
//           dB = dG^T C + diag(w) u dH^T, written as fp32 partials
//           (H, B, S, N);
//       (f) dH <- exp(cum_L) dH + C^T diag(exp cum) dy, in place;
//     after chunk 0 the carry is dh0.  Positions at or past S read as
//     dt = 0 and zero x, B, C, dy, and none of their gradients is written.
//     Shared memory: B and C rows padded to N + 1 floats, u, dy, H and dH
//     rows to P + 1, the three L x L tiles to L + 1, so that the threads of
//     a warp hit distinct banks: 217,920 bytes, one block an SM;
//   ssd_bwd_sum: dB and dC summed over the heads' partials and da over the
//   batch rows' partials.
//
// x is addressed through (batch, seq, head) strides and B, C through
// (batch, seq) strides (the model hands slices of one projection); dt
// (B, S, H), a (H,), h0, dy, dh_final and every output are contiguous fp32.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing (the scratch is the caller's).  The entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int L = 64;         // positions per chunk
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }

// offsets (in floats) of the shared-memory arrays
template <int N, int P>
struct Layout {
  static constexpr int NP = N + 1;  // B, C rows
  static constexpr int PP = P + 1;  // u, dy, H, dH rows
  static constexpr int LP = L + 1;  // M, dG, E rows
  static constexpr int B = 0;
  static constexpr int C = B + L * NP;
  static constexpr int U = C + L * NP;    // dt x
  static constexpr int DY = U + L * PP;
  static constexpr int H = DY + L * PP;   // the chunk's start state
  static constexpr int DH = H + N * PP;   // the carry
  static constexpr int M = DH + N * PP;
  static constexpr int DG = M + L * LP;
  static constexpr int E = DG + L * LP;
  static constexpr int VEC = E + L * LP;  // 8 vectors of L (below)
  static constexpr int RED = VEC + 8 * L;  // a partial per warp
  static constexpr int TOTAL = RED + THREADS / 32;
};

// Warp 0: dt * a's inclusive cumulative sum over the chunk at t0 (lane
// holds positions lane and lane + 32), exp(cum), exp(cum_L - cum) and dt.
__device__ __forceinline__ void chunk_scan(const float* dtb, int H, int t0,
                                           int S, float ah, float* cum,
                                           float* w, float* es, float* dtv,
                                           int lane) {
  const int ta = t0 + lane, tb = t0 + lane + 32;
  const float d0 = ta < S ? dtb[(int64_t)ta * H] : 0.f;
  const float d1 = tb < S ? dtb[(int64_t)tb * H] : 0.f;
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
  es[lane] = expf(v0);
  es[lane + 32] = expf(v1);
  w[lane] = expf(tot - v0);
  w[lane + 32] = expf(tot - v1);
  dtv[lane] = d0;
  dtv[lane + 32] = d1;
}

// sum over the 16 lanes that share ty (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sum32(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const T* __restrict__ bm,
                   const T* __restrict__ cm, const float* __restrict__ h0,
                   const float* __restrict__ dy,
                   const float* __restrict__ dhf, float* __restrict__ dx,
                   float* __restrict__ ddt, float* __restrict__ dh0,
                   float* __restrict__ states, float* __restrict__ dbp,
                   float* __restrict__ dcp, float* __restrict__ dap, int S,
                   int H, int64_t sxb, int64_t sxs, int64_t sxh, int64_t sbb,
                   int64_t sbs, int64_t scb, int64_t scs) {
  static_assert(N % 16 == 0 && P % 16 == 0, "N and P: multiples of 16");
  using Lay = Layout<N, P>;
  constexpr int NP = Lay::NP, PP = Lay::PP, LP = Lay::LP;
  constexpr int RN = N / 16;  // state rows per thread
  constexpr int CP = P / 16;  // columns of P per thread
  constexpr int CN = N / 16;  // columns of N per thread
  extern __shared__ float smem[];
  float* Bs = smem + Lay::B;
  float* Cs = smem + Lay::C;
  float* Us = smem + Lay::U;
  float* DYs = smem + Lay::DY;
  float* Hs = smem + Lay::H;
  float* dHs = smem + Lay::DH;
  float* Ms = smem + Lay::M;
  float* DGs = smem + Lay::DG;
  float* Es = smem + Lay::E;
  float* cum = smem + Lay::VEC;
  float* wv = cum + L;    // exp(cum_L - cum_j)
  float* es = wv + L;     // exp(cum_i)
  float* dtv = es + L;    // dt
  float* t1 = dtv + L;    // exp(cum_i) dy_i . (C H)_i
  float* t2 = t1 + L;     // w_j u_j . (B dH)_j
  float* xdu = t2 + L;    // x_j . du_j
  float* dcum = xdu + L;
  float* red = smem + Lay::RED;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int Bsz = gridDim.y;
  const float ah = a[h];
  const int nc = (S + L - 1) / L;

  const T* xb = x + b * sxb + h * sxh;
  const float* dtb = dt + (int64_t)b * S * H + h;
  const T* bb = bm + b * sbb;
  const T* cb = cm + b * scb;
  const int64_t bh = (int64_t)b * H + h;
  const int64_t hoff = bh * N * P;
  float* st = states + bh * nc * N * P;

  // ---- sweep 1: the chunk-start states, forward from h0 ----
  for (int i = tid; i < N * P; i += THREADS)
    Hs[(i / P) * PP + i % P] = h0 != nullptr ? h0[hoff + i] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the previous update (and the init) done
    for (int i = tid; i < N * P; i += THREADS)
      st[(int64_t)c * N * P + i] = Hs[(i / P) * PP + i % P];
    if (warp == 0) chunk_scan(dtb, H, t0, S, ah, cum, wv, es, dtv, lane);
    for (int i = tid; i < L * N; i += THREADS) {
      const int r = i / N, n = i % N;
      const int t = t0 + r;
      Bs[r * NP + n] = t < S ? to_float(bb[t * sbs + n]) : 0.f;
    }
    for (int i = tid; i < L * P; i += THREADS) {
      const int r = i / P, p = i % P;
      const int t = t0 + r;
      Us[r * PP + p] =
          t < S ? to_float(xb[t * sxs + p]) * dtb[(int64_t)t * H] : 0.f;
    }
    __syncthreads();
    const float decay = expf(cum[L - 1]);
    float acc[RN][CP];
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int q = 0; q < CP; ++q)
        acc[r][q] = decay * Hs[(ty * RN + r) * PP + tx + 16 * q];
    for (int j = 0; j < L; ++j) {
      const float wj = wv[j];
      float bv[RN], uv[CP];
#pragma unroll
      for (int r = 0; r < RN; ++r) bv[r] = Bs[j * NP + ty * RN + r] * wj;
#pragma unroll
      for (int q = 0; q < CP; ++q) uv[q] = Us[j * PP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[r][q] = fmaf(bv[r], uv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int q = 0; q < CP; ++q)
        Hs[(ty * RN + r) * PP + tx + 16 * q] = acc[r][q];
  }

  // ---- sweep 2: backward over the chunks ----
  for (int i = tid; i < N * P; i += THREADS)
    dHs[(i / P) * PP + i % P] = dhf != nullptr ? dhf[hoff + i] : 0.f;
  float da_acc = 0.f;  // warp 0's share of da, summed in chunk order
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L;
    __syncthreads();  // every reader of the previous chunk's arrays done
    if (warp == 0) chunk_scan(dtb, H, t0, S, ah, cum, wv, es, dtv, lane);
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
      const bool in = t < S;
      Us[r * PP + p] =
          in ? to_float(xb[t * sxs + p]) * dtb[(int64_t)t * H] : 0.f;
      DYs[r * PP + p] =
          in && dy != nullptr ? dy[(((int64_t)b * S + t) * H + h) * P + p]
                              : 0.f;
    }
    for (int i = tid; i < N * P; i += THREADS)
      Hs[(i / P) * PP + i % P] = st[(int64_t)c * N * P + i];
    __syncthreads();
    const float tot = cum[L - 1];

    // (b) M, dG, E (rows i = 4 ty + r, columns j = tx + 16 q) and <dH, H>
    {
      float g[4][4], dm[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) g[r][q] = dm[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty * 4 + r) * NP + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = Bs[(tx + 16 * q) * NP + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) g[r][q] = fmaf(cv[r], bv[q], g[r][q]);
      }
      for (int p = 0; p < P; ++p) {
        float yv[4], uv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) yv[r] = DYs[(ty * 4 + r) * PP + p];
#pragma unroll
        for (int q = 0; q < 4; ++q) uv[q] = Us[(tx + 16 * q) * PP + p];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) dm[r][q] = fmaf(yv[r], uv[q], dm[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = tx + 16 * q;
          const bool live = j <= i;
          const float dec = expf(live ? cum[i] - cum[j] : NEG_INF);
          const float m = dec * g[r][q];
          const float d = live ? dm[r][q] : 0.f;
          Ms[i * LP + j] = m;
          DGs[i * LP + j] = d * dec;
          Es[i * LP + j] = d * m;
        }
      }
      float hd = 0.f;
      for (int i = tid; i < N * P; i += THREADS) {
        const int k = (i / P) * PP + i % P;
        hd = fmaf(dHs[k], Hs[k], hd);
      }
      hd = sum32(hd);
      if (lane == 0) red[warp] = hd;
    }
    __syncthreads();

    // (c) du, dx and the per-position terms (rows j = 4 ty + r, columns
    // p = tx + 16 q)
    {
      float md[4][CP], bd[4][CP], ch[4][CP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) md[r][q] = bd[r][q] = ch[r][q] = 0.f;
      // M_ij is zero for i < j: rows of this thread start at 4 ty
      for (int i = ty * 4; i < L; ++i) {
        float mv[4], yv[CP];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = Ms[i * LP + ty * 4 + r];
#pragma unroll
        for (int q = 0; q < CP; ++q) yv[q] = DYs[i * PP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < CP; ++q) md[r][q] = fmaf(mv[r], yv[q], md[r][q]);
      }
      for (int n = 0; n < N; ++n) {
        float bv[4], cv[4], dv[CP], hv[CP];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          bv[r] = Bs[(ty * 4 + r) * NP + n];
          cv[r] = Cs[(ty * 4 + r) * NP + n];
        }
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          dv[q] = dHs[n * PP + tx + 16 * q];
          hv[q] = Hs[n * PP + tx + 16 * q];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < CP; ++q) {
            bd[r][q] = fmaf(bv[r], dv[q], bd[r][q]);
            ch[r][q] = fmaf(cv[r], hv[q], ch[r][q]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ty * 4 + r;
        const int t = t0 + j;
        const float wj = wv[j], dtj = dtv[j], esj = es[j];
        float xd = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const int p = tx + 16 * q;
          const float du = fmaf(wj, bd[r][q], md[r][q]);
          s1 = fmaf(esj * DYs[j * PP + p], ch[r][q], s1);
          s2 = fmaf(wj * bd[r][q], Us[j * PP + p], s2);
          if (t < S) {
            xd = fmaf(to_float(xb[t * sxs + p]), du, xd);
            dx[(((int64_t)b * S + t) * H + h) * P + p] = dtj * du;
          }
        }
        xd = sum16(xd);
        s1 = sum16(s1);
        s2 = sum16(s2);
        if (tx == 0) {
          xdu[j] = xd;
          t1[j] = s1;
          t2[j] = s2;
        }
      }
    }
    __syncthreads();

    // (d) dcum, ds, ddt and da
    if (tid < L) {
      const int i = tid;
      float rs = 0.f, cs = 0.f;
      for (int j = 0; j < L; ++j) {
        rs += Es[i * LP + j];
        cs += Es[j * LP + i];
      }
      float v = rs - cs + t1[i] - t2[i];
      if (i == L - 1) {
        float hd = 0.f, s2 = 0.f;
        for (int k = 0; k < THREADS / 32; ++k) hd += red[k];
        for (int k = 0; k < L; ++k) s2 += t2[k];
        v += expf(tot) * hd + s2;
      }
      dcum[i] = v;
    }
    __syncthreads();
    if (warp == 0) {
      // ds_k = sum_{i >= k} dcum_i: an inclusive scan of the reversed chunk
      float r0 = dcum[L - 1 - lane], r1 = dcum[31 - lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, r0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, r1, off);
        if (lane >= off) {
          r0 += u0;
          r1 += u1;
        }
      }
      r1 += __shfl_sync(0xffffffffu, r0, 31);
      float dav = 0.f;
      const int ks[2] = {L - 1 - lane, 31 - lane};
      const float dss[2] = {r0, r1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = ks[e];
        const int t = t0 + k;
        if (t < S)
          ddt[((int64_t)b * S + t) * H + h] = fmaf(ah, dss[e], xdu[k]);
        dav = fmaf(dtv[k], dss[e], dav);
      }
      da_acc += sum32(dav);
    }

    // (e) this head's dC and dB (rows 4 ty + r, columns n = tx + 16 q)
    {
      float acc[4][CN];
      // dC_i = sum_j dG_ij B_j + exp(cum_i) sum_p dy_ip H_p
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < CN; ++q) acc[r][q] = 0.f;
      for (int j = 0; j < ty * 4 + 4; ++j) {  // dG_ij is zero for j > i
        float gv[4], bv[CN];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = DGs[(ty * 4 + r) * LP + j];
#pragma unroll
        for (int q = 0; q < CN; ++q) bv[q] = Bs[j * NP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < CN; ++q) acc[r][q] = fmaf(gv[r], bv[q], acc[r][q]);
      }
      for (int p = 0; p < P; ++p) {
        float yv[4], hv[CN];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          yv[r] = DYs[(ty * 4 + r) * PP + p] * es[ty * 4 + r];
#pragma unroll
        for (int q = 0; q < CN; ++q) hv[q] = Hs[(tx + 16 * q) * PP + p];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < CN; ++q) acc[r][q] = fmaf(yv[r], hv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + ty * 4 + r;
        if (t < S) {
          float* out = dcp + (((int64_t)h * Bsz + b) * S + t) * N;
#pragma unroll
          for (int q = 0; q < CN; ++q) out[tx + 16 * q] = acc[r][q];
        }
      }
      // dB_j = sum_i dG_ij C_i + exp(cum_L - cum_j) sum_p u_jp dH_p
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < CN; ++q) acc[r][q] = 0.f;
      for (int i = ty * 4; i < L; ++i) {  // dG_ij is zero for i < j
        float gv[4], cv[CN];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = DGs[i * LP + ty * 4 + r];
#pragma unroll
        for (int q = 0; q < CN; ++q) cv[q] = Cs[i * NP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < CN; ++q) acc[r][q] = fmaf(gv[r], cv[q], acc[r][q]);
      }
      for (int p = 0; p < P; ++p) {
        float uv[4], dv[CN];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          uv[r] = Us[(ty * 4 + r) * PP + p] * wv[ty * 4 + r];
#pragma unroll
        for (int q = 0; q < CN; ++q) dv[q] = dHs[(tx + 16 * q) * PP + p];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < CN; ++q) acc[r][q] = fmaf(uv[r], dv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + ty * 4 + r;
        if (t < S) {
          float* out = dbp + (((int64_t)h * Bsz + b) * S + t) * N;
#pragma unroll
          for (int q = 0; q < CN; ++q) out[tx + 16 * q] = acc[r][q];
        }
      }
    }
    __syncthreads();  // every reader of the carry done

    // (f) the carry to the previous chunk (rows n = ty RN + r, columns
    // p = tx + 16 q), in place: each thread reads only what it writes
    {
      const float decay = expf(tot);
      float acc[RN][CP];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q)
          acc[r][q] = decay * dHs[(ty * RN + r) * PP + tx + 16 * q];
      for (int i = 0; i < L; ++i) {
        const float ei = es[i];
        float cv[RN], yv[CP];
#pragma unroll
        for (int r = 0; r < RN; ++r) cv[r] = Cs[i * NP + ty * RN + r] * ei;
#pragma unroll
        for (int q = 0; q < CP; ++q) yv[q] = DYs[i * PP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int q = 0; q < CP; ++q) acc[r][q] = fmaf(cv[r], yv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q)
          dHs[(ty * RN + r) * PP + tx + 16 * q] = acc[r][q];
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += THREADS)
    dh0[hoff + i] = dHs[(i / P) * PP + i % P];
  if (tid == 0) dap[bh] = da_acc;
}

// dB and dC over the heads' partials (H, B*S*N), da over the batch rows'
// (B, H); one thread an output element, the heads summed in order.
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_sum(const float* __restrict__ dbp, const float* __restrict__ dcp,
                const float* __restrict__ dap, float* __restrict__ db,
                float* __restrict__ dc, float* __restrict__ da, int Bsz,
                int H, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx < total) {
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += dbp[h * total + idx];
      sc += dcp[h * total + idx];
    }
    db[idx] = sb;
    dc[idx] = sc;
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < H; h += THREADS) {
      float s = 0.f;
      for (int b = 0; b < Bsz; ++b) s += dap[(int64_t)b * H + h];
      da[h] = s;
    }
}

template <typename T, int N, int P>
cudaError_t launch(const T* x, const float* dt, const float* a, const T* bm,
                   const T* cm, const float* h0, const float* dy,
                   const float* dhf, float* dx, float* ddt, float* da,
                   float* db, float* dc, float* dh0, float* states,
                   float* dbp, float* dcp, float* dap, int B, int S, int H,
                   int64_t sxb, int64_t sxs, int64_t sxh, int64_t sbb,
                   int64_t sbs, int64_t scb, int64_t scs,
                   cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * Layout<N, P>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T, N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<T, N, P><<<dim3(H, B), THREADS, smem, stream>>>(
      x, dt, a, bm, cm, h0, dy, dhf, dx, ddt, dh0, states, dbp, dcp, dap, S,
      H, sxb, sxs, sxh, sbb, sbs, scb, scs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)B * S * N;
  ssd_bwd_sum<<<unsigned((total + THREADS - 1) / THREADS), THREADS, 0,
                stream>>>(dbp, dcp, dap, db, dc, da, B, H, total);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16 --

namespace tc {  // the tensor-core kernel (bf16 x / B / C)

constexpr int N = 128;          // state size
constexpr int P = 64;           // head dim
constexpr int PB = 32;          // columns of P per block
constexpr int COLS = P / PB;    // column blocks of a head
constexpr int THREADS = 128;    // 4 warps
constexpr int SZ_BC = L * 256;  // a staged B or C chunk (bf16)
constexpr int SZ_X = L * 64;    // a staged x, dy hi or dy lo chunk
constexpr int SZ_ST = N * 64;   // the carry's hi or lo copy
constexpr int SZ_TRI = 10 * 512;  // dG's 16 x 16 tiles on or below the diagonal
constexpr int OFF_C = 0;
constexpr int OFF_B = OFF_C + SZ_BC;
constexpr int OFF_X = OFF_B + SZ_BC;
constexpr int OFF_YHI = OFF_X + SZ_X;
constexpr int OFF_YLO = OFF_YHI + SZ_X;
constexpr int OFF_DHHI = OFF_YLO + SZ_X;
constexpr int OFF_DHLO = OFF_DHHI + SZ_ST;
constexpr int OFF_GHI = OFF_DHLO + SZ_ST;
constexpr int OFF_GLO = OFF_GHI + SZ_TRI;
constexpr int OFF_VEC = OFF_GLO + SZ_TRI;  // cum, dt, exp(cum), w: L each
// per position: row sums of E, the 4 warps' column sums of E and shares of
// t1, t2, x . du; then the 4 warps' shares of <dH', H>
constexpr int RED_FLOATS = L + 4 * L + 4 * L + L + L + 4;
constexpr int OFF_RED = OFF_VEC + 4 * 4 * L;
constexpr int SMEM = OFF_RED + 4 * RED_FLOATS;  // 75,536 bytes

// Byte offset of the 16 x 16 tile (it, jt), jt <= it, of dG's hi or lo copy
// (row-major 32-byte rows), and of the 16-byte half h of its row r, swizzled
// so that the eight rows an ldmatrix reads hit eight distinct bank groups.
__device__ __forceinline__ int tri(int it, int jt) {
  return (it * (it + 1) / 2 + jt) * 512;
}
__device__ __forceinline__ int tri_row(int r, int h) {
  return r * 32 + (((h ^ (r >> 2)) & 1) << 4);
}

// The fp32 (N, P) state at src + off, columns [p0, p0 + 32) already in off,
// into accumulator layout (warp w: rows 32w + 16mt + g and + 8, columns
// 8nt + 2q and + 1); zero for a null src.
__device__ __forceinline__ void load_state(float (&acc)[2][4][4],
                                           const float* src, int64_t off,
                                           int warp, int g, int q) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 32 * warp + 16 * mt + g + 8 * (e >> 1);
        const int p = 8 * nt + 2 * q + (e & 1);
        acc[mt][nt][e] = src != nullptr ? src[off + (int64_t)n * P + p] : 0.f;
      }
}

// A fragment (rows 16, k 16) of a 16-row slice of a state held in
// accumulator layout, k over its columns [16 ks, 16 ks + 16), as hi / lo.
__device__ __forceinline__ void state_frag(const float (&s)[4][4], int ks,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(s[2 * ks][0], s[2 * ks][1], hi[0], lo[0]);
  split(s[2 * ks][2], s[2 * ks][3], hi[1], lo[1]);
  split(s[2 * ks + 1][0], s[2 * ks + 1][1], hi[2], lo[2]);
  split(s[2 * ks + 1][2], s[2 * ks + 1][3], hi[3], lo[3]);
}

// A 16-row slice of (N, L) accumulators (rows n = 32w + 16mt + g and + 8,
// columns t = 8 ti + 2q and + 1 of the chunk at t0) into an (S, N) fp32
// partial at out; positions at or past S are dropped.
__device__ __forceinline__ void store_nt(const float (&acc)[8][4], float* out,
                                         int t0, int S, int n, int q) {
#pragma unroll
  for (int ti = 0; ti < 8; ++ti)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + 8 * ti + 2 * q + (e & 1);
      if (t < S) out[(int64_t)t * N + n + 8 * (e >> 1)] = acc[ti][e];
    }
}

__global__ void __launch_bounds__(THREADS, 3)
    ssd_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const __nv_bfloat16* __restrict__ bm,
                        const __nv_bfloat16* __restrict__ cm,
                        const float* __restrict__ h0,
                        const float* __restrict__ dy,
                        const float* __restrict__ dhf, float* __restrict__ dx,
                        float* __restrict__ dh0, float4* __restrict__ states,
                        float* __restrict__ dbp, float* __restrict__ dcp,
                        float* __restrict__ ddtp, float* __restrict__ dap,
                        int S, int H, int64_t sxb, int64_t sxs, int64_t sxh,
                        int64_t sbb, int64_t sbs, int64_t scb, int64_t scs,
                        bool vec, bool vec_dy) {
  extern __shared__ __align__(128) uint8_t sm[];
  const uint8_t* Cs = sm + OFF_C;
  const uint8_t* Bs = sm + OFF_B;
  const uint8_t* Xs = sm + OFF_X;
  uint8_t* Yhi = sm + OFF_YHI;
  uint8_t* Ylo = sm + OFF_YLO;
  uint8_t* DHhi = sm + OFF_DHHI;
  uint8_t* DHlo = sm + OFF_DHLO;
  uint8_t* Ghi = sm + OFF_GHI;
  uint8_t* Glo = sm + OFF_GLO;
  float* vecs = reinterpret_cast<float*>(sm + OFF_VEC);
  float* rowE = reinterpret_cast<float*>(sm + OFF_RED);
  float* colE = rowE + L;    // [warp][L]
  float* t1p = colE + 4 * L;  // [warp][L]
  float* t2v = t1p + 4 * L;
  float* xdu = t2v + L;
  float* hdv = xdu + L;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row, column pair
  const int h = blockIdx.x / COLS, pb = blockIdx.x % COLS, p0 = pb * PB;
  const int b = blockIdx.y, Bsz = gridDim.y;
  const int hp = h * COLS + pb;
  const float ah = a[h];
  const int nc = (S + L - 1) / L;

  const __nv_bfloat16* xb = x + b * sxb + h * sxh + p0;
  const float* dtb = dt + (int64_t)b * S * H + h;
  const __nv_bfloat16* bb = bm + b * sbb;
  const __nv_bfloat16* cb = cm + b * scb;
  const int64_t hoff = ((int64_t)b * H + h) * N * P + p0;  // h0, dh
  const int64_t rowp = (int64_t)H * P;                     // dy, dx rows
  const int64_t yoff = (int64_t)b * S * rowp + (int64_t)h * P + p0;
  // this block's chunk-start states: 8 float4 a thread a chunk, the
  // thread's own accumulators (written and read by the same thread)
  float4* st = states + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) *
                            nc * 8 * THREADS;
  float* dcb = dcp + ((int64_t)hp * Bsz + b) * S * N;
  float* dbb = dbp + ((int64_t)hp * Bsz + b) * S * N;

  // ---- sweep 1: the chunk-start states, forward from h0 ----
  // B and x double-buffered (the second buffers lie where sweep 2 keeps C
  // and dy hi), cum and s = exp(tot - cum) dt double-buffered
  float hacc[2][4][4];
  load_state(hacc, h0, hoff, warp, g, q);
  {
    const int offB[2] = {OFF_B, OFF_C}, offX[2] = {OFF_X, OFF_YHI};
    stage<16>(sm + offB[0], bb, sbs, 0, S, vec);
    stage<4>(sm + offX[0], xb, sxs, 0, S, vec);
    cp_commit();
    float d0 = 0.f, d1 = 0.f;  // warp 0: dt at positions lane, lane + 32
    if (warp == 0) {
      d0 = lane < S ? dtb[(int64_t)lane * H] : 0.f;
      d1 = lane + 32 < S ? dtb[(int64_t)(lane + 32) * H] : 0.f;
    }
    for (int k = 0; k < nc; ++k) {
      const int t0 = k * L, cur = k & 1;
      const uint8_t* B1 = sm + offB[cur];
      const uint8_t* X1 = sm + offX[cur];
      float* cum = vecs + cur * 2 * L;
      float* sj = cum + L;
      if (warp == 0) {  // chunk k - 1 read the other copy
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
        sj[lane] = expf(tot - v0) * d0;
        sj[lane + 32] = expf(tot - v1) * d1;
        const int tn = t0 + L + lane;  // the next chunk's dt, read ahead
        d0 = tn < S ? dtb[(int64_t)tn * H] : 0.f;
        d1 = tn + 32 < S ? dtb[(int64_t)(tn + 32) * H] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        st[((int64_t)k * 8 + e) * THREADS + tid] =
            make_float4(hacc[e >> 2][e & 3][0], hacc[e >> 2][e & 3][1],
                        hacc[e >> 2][e & 3][2], hacc[e >> 2][e & 3][3]);
      cp_wait_all();  // this chunk's B and x have landed
      __syncthreads();
      if (k + 1 < nc) {  // into the buffers chunk k - 1 read
        stage<16>(sm + offB[cur ^ 1], bb, sbs, t0 + L, S, vec);
        stage<4>(sm + offX[cur ^ 1], xb, sxs, t0 + L, S, vec);
      }
      cp_commit();
      // H <- exp(tot) H + (B o s)^T x, the scaled B^T split into hi / lo
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
          ldsm_x4_t(X1 + swz_x(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                               2 * np + (lane >> 4)),
                    xf[np]);
        const int j = 16 * kk + 2 * q;
        const float s0 = sj[j], s1 = sj[j + 1], s8 = sj[j + 8],
                    s9 = sj[j + 9];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t ra[4];  // (B^T) rows n, columns j, from B stored (j, n)
          ldsm_x4_t(B1 + swz_bc(16 * kk + (lane & 7) + (lane >> 4) * 8,
                                (32 * warp + 16 * mt) / 8 + ((lane >> 3) & 1)),
                    ra);
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 v = unpack(ra[r]);
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
    }
  }
  __syncthreads();  // sweep 1's last readers of its buffers are done

  // ---- sweep 2: backward over the chunks, the carry dH' in hacc ----
  load_state(hacc, dhf, hoff, warp, g, q);
  write_state(hacc, DHhi, DHlo, warp, g, q);
  float* cum = vecs;
  float* dtv = vecs + L;
  float* es = vecs + 2 * L;
  float* wv = vecs + 3 * L;
  float da_acc = 0.f;  // warp 0's share of da, summed in chunk order
  for (int k = nc - 1; k >= 0; --k) {
    const int t0 = k * L;
    // every reader of the previous chunk's staging is past its last barrier
    if (warp == 0) chunk_scan(dtb, H, t0, S, ah, cum, wv, es, dtv, lane);
    stage<16>(sm + OFF_C, cb, scs, t0, S, vec);
    stage<16>(sm + OFF_B, bb, sbs, t0, S, vec);
    stage<4>(sm + OFF_X, xb, sxs, t0, S, vec);
    cp_commit();
    prefetch_l2(reinterpret_cast<const uint8_t*>(st + (int64_t)k * 8 *
                                                          THREADS) +
                128 * tid);
    // dy (fp32) as hi / lo bf16, 64-byte rows of 32 columns
    for (int i = tid; i < L * PB / 4; i += THREADS) {
      const int r = i >> 3, f = i & 7;  // row, 4 columns
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (dy != nullptr && t0 + r < S) {
        const float* src = dy + yoff + (int64_t)(t0 + r) * rowp + 4 * f;
        v = vec_dy ? *reinterpret_cast<const float4*>(src)
                   : make_float4(src[0], src[1], src[2], src[3]);
      }
      uint32_t h01, l01, h23, l23;
      split(v.x, v.y, h01, l01);
      split(v.z, v.w, h23, l23);
      const int off = swz_x(r, f >> 1) + (f & 1) * 8;
      *reinterpret_cast<uint2*>(Yhi + off) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(Ylo + off) = make_uint2(l01, l23);
    }
    cp_wait_all();
    __syncthreads();

    // (i) rows i = 16 warp + 0..15: G = C B^T and dM = dy x^T (columns j
    // <= i), then M = dec o G, dM scaled by dt_j and masked, dG = dM o dec
    // and E = dM o M (dec_ij = exp(cum_i - cum_j), the exponent masked
    // BEFORE exp); dG's hi / lo tiles to shared memory, E's row sums and
    // this warp's column sums
    {
      const int i0 = 16 * warp;
      float gacc[8][4], dacc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[t][e] = dacc[t][e] = 0.f;
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
      }
#pragma unroll
      for (int ks = 0; ks < PB / 16; ++ks) {
        uint32_t ahi[4], alo[4];
        const int off = swz_x(i0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              2 * ks + (lane >> 4));
        ldsm_x4(Yhi + off, ahi);
        ldsm_x4(Ylo + off, alo);
#pragma unroll
        for (int tp = 0; tp < 4; ++tp) {
          if (tp <= warp) {
            uint32_t bf[4];  // x^T: k = p, n = j, from x stored (j, p)
            ldsm_x4(Xs + swz_x(16 * tp + (lane & 7) + (lane >> 4) * 8,
                               2 * ks + ((lane >> 3) & 1)),
                    bf);
            mma(dacc[2 * tp], ahi, bf[0], bf[1]);
            mma(dacc[2 * tp], alo, bf[0], bf[1]);
            mma(dacc[2 * tp + 1], ahi, bf[2], bf[3]);
            mma(dacc[2 * tp + 1], alo, bf[2], bf[3]);
          }
        }
      }
      const int ia = i0 + g, ib = ia + 8;
      const float cum_a = cum[ia], cum_b = cum[ib];
      float rsa = 0.f, rsb = 0.f;  // row sums of E
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float cs0 = 0.f, cs1 = 0.f;  // column sums of E over rows ia, ib
        if (t <= 2 * warp + 1) {
          const int j = 8 * t + 2 * q;
          const float cj[2] = {cum[j], cum[j + 1]};
          const float dj[2] = {dtv[j], dtv[j + 1]};
          float dg[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const bool live = j + (e & 1) <= i;
            const float dec =
                expf(live ? (e < 2 ? cum_a : cum_b) - cj[e & 1] : NEG_INF);
            const float dm = live ? dacc[t][e] * dj[e & 1] : 0.f;
            const float ee = dm * (dec * gacc[t][e]);
            dg[e] = dm * dec;
            if (e < 2)
              rsa += ee;
            else
              rsb += ee;
            if (e & 1)
              cs1 += ee;
            else
              cs0 += ee;
          }
          const int c = (t & 1) * 8 + 2 * q;  // column in the 16 x 16 tile
          const int base = tri(warp, t >> 1) + 2 * (c & 7);
          uint32_t hi, lo;
          split(dg[0], dg[1], hi, lo);
          *reinterpret_cast<uint32_t*>(Ghi + base + tri_row(g, c >> 3)) = hi;
          *reinterpret_cast<uint32_t*>(Glo + base + tri_row(g, c >> 3)) = lo;
          split(dg[2], dg[3], hi, lo);
          *reinterpret_cast<uint32_t*>(Ghi + base + tri_row(g + 8, c >> 3)) =
              hi;
          *reinterpret_cast<uint32_t*>(Glo + base + tri_row(g + 8, c >> 3)) =
              lo;
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {  // over g
          cs0 += __shfl_xor_sync(0xffffffffu, cs0, off);
          cs1 += __shfl_xor_sync(0xffffffffu, cs1, off);
        }
        if (g == 0) {
          colE[warp * L + 8 * t + 2 * q] = cs0;
          colE[warp * L + 8 * t + 2 * q + 1] = cs1;
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // over q
        rsa += __shfl_xor_sync(0xffffffffu, rsa, off);
        rsb += __shfl_xor_sync(0xffffffffu, rsb, off);
      }
      if (q == 0) {
        rowE[ia] = rsa;
        rowE[ib] = rsb;
      }
    }
    __syncthreads();

    // (j) rows j = 16 warp + 0..15: G^T = B C^T (columns i >= j) into
    // M^T = dec^T o G^T as hi / lo A fragments, and B dH' in the same pass
    // over B; du = M^T dy + diag(w) B dH', written as dx = dt du; this
    // block's shares of x . du and t2 = w dt x . (B dH')
    {
      const int j0 = 16 * warp;
      float gt[8][4], bd[4][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) gt[t][e] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) bd[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t af[4];
        ldsm_x4(Bs + swz_bc(j0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            2 * ks + (lane >> 4)),
                af);
#pragma unroll
        for (int tp = 0; tp < 4; ++tp) {
          if (tp >= warp) {
            uint32_t bf[4];
            ldsm_x4(Cs + swz_bc(16 * tp + (lane & 7) + (lane >> 4) * 8,
                                2 * ks + ((lane >> 3) & 1)),
                    bf);
            mma(gt[2 * tp], af, bf[0], bf[1]);
            mma(gt[2 * tp + 1], af, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int off = swz_x(16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8,
                                2 * np + (lane >> 4));
          uint32_t bh[4], bl[4];
          ldsm_x4_t(DHhi + off, bh);
          ldsm_x4_t(DHlo + off, bl);
          mma(bd[2 * np], af, bh[0], bh[1]);
          mma(bd[2 * np], af, bl[0], bl[1]);
          mma(bd[2 * np + 1], af, bh[2], bh[3]);
          mma(bd[2 * np + 1], af, bl[2], bl[3]);
        }
      }
      const int ja = j0 + g, jb = ja + 8;
      const float cja = cum[ja], cjb = cum[jb];
      uint32_t mhi[4][4], mlo[4][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (t >= 2 * warp) {
          const int i = 8 * t + 2 * q;
          const float c0 = cum[i], c1 = cum[i + 1];
          const float m0 = expf(i >= ja ? c0 - cja : NEG_INF) * gt[t][0];
          const float m1 = expf(i + 1 >= ja ? c1 - cja : NEG_INF) * gt[t][1];
          const float m2 = expf(i >= jb ? c0 - cjb : NEG_INF) * gt[t][2];
          const float m3 = expf(i + 1 >= jb ? c1 - cjb : NEG_INF) * gt[t][3];
          const int r = (t & 1) * 2;
          split(m0, m1, mhi[t >> 1][r], mlo[t >> 1][r]);
          split(m2, m3, mhi[t >> 1][r + 1], mlo[t >> 1][r + 1]);
        }
      }
      float du[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) du[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= warp) {  // the row tiles i >= j
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int off =
                swz_x(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                      2 * np + (lane >> 4));
            uint32_t yh[4], yl[4];  // dy: k = i, n = p
            ldsm_x4_t(Yhi + off, yh);
            ldsm_x4_t(Ylo + off, yl);
            mma(du[2 * np], mhi[kk], yh[0], yh[1]);
            mma(du[2 * np], mhi[kk], yl[0], yl[1]);
            mma(du[2 * np], mlo[kk], yh[0], yh[1]);
            mma(du[2 * np + 1], mhi[kk], yh[2], yh[3]);
            mma(du[2 * np + 1], mhi[kk], yl[2], yl[3]);
            mma(du[2 * np + 1], mlo[kk], yh[2], yh[3]);
          }
        }
      }
      const float wa = wv[ja], wb = wv[jb], dta = dtv[ja], dtb2 = dtv[jb];
      float xa = 0.f, xb2 = 0.f, sa = 0.f, sb = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = 8 * nt + 2 * q;
        const float2 va = unpack(
            *reinterpret_cast<const uint32_t*>(Xs + swz_x(ja, nt) + 4 * q));
        const float2 vb = unpack(
            *reinterpret_cast<const uint32_t*>(Xs + swz_x(jb, nt) + 4 * q));
        const float u0 = fmaf(wa, bd[nt][0], du[nt][0]);
        const float u1 = fmaf(wa, bd[nt][1], du[nt][1]);
        const float u2 = fmaf(wb, bd[nt][2], du[nt][2]);
        const float u3 = fmaf(wb, bd[nt][3], du[nt][3]);
        xa += va.x * u0 + va.y * u1;
        xb2 += vb.x * u2 + vb.y * u3;
        sa += va.x * bd[nt][0] + va.y * bd[nt][1];
        sb += vb.x * bd[nt][2] + vb.y * bd[nt][3];
        if (t0 + ja < S)
          *reinterpret_cast<float2*>(dx + yoff + (int64_t)(t0 + ja) * rowp +
                                     p) = make_float2(dta * u0, dta * u1);
        if (t0 + jb < S)
          *reinterpret_cast<float2*>(dx + yoff + (int64_t)(t0 + jb) * rowp +
                                     p) = make_float2(dtb2 * u2, dtb2 * u3);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // over q
        xa += __shfl_xor_sync(0xffffffffu, xa, off);
        xb2 += __shfl_xor_sync(0xffffffffu, xb2, off);
        sa += __shfl_xor_sync(0xffffffffu, sa, off);
        sb += __shfl_xor_sync(0xffffffffu, sb, off);
      }
      if (q == 0) {
        xdu[ja] = xa;
        xdu[jb] = xb2;
        t2v[ja] = wa * dta * sa;
        t2v[jb] = wb * dtb2 * sb;
      }
    }
    __syncthreads();  // every reader of the carry's copy is done

    // (n) rows n = 32 warp + 16 mt + 0..15 of the (N, L) transposes: with
    // Z = H dy^T (H the chunk's start state, from this thread's scratch),
    // dC^T = Z o exp(cum_i) + B^T dG^T and dB^T = (dH' x^T) o (w dt)_j +
    // C^T dG, written as this block's partials; t1 = exp(cum_i) sum_n
    // C_in Z_ni and <dH', H> shares; then the carry
    // dH <- exp(tot) dH' + C^T (exp(cum) o dy)
    {
      float hd = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int nrow = 32 * warp + 16 * mt + g;
        const int nb = (32 * warp + 16 * mt) / 8;  // its 16-byte piece of B, C
        float hs[4][4];
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const float4 v = st[((int64_t)k * 8 + mt * 4 + e4) * THREADS + tid];
          hs[e4][0] = v.x;
          hs[e4][1] = v.y;
          hs[e4][2] = v.z;
          hs[e4][3] = v.w;
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) hd = fmaf(hacc[mt][nt][e], hs[nt][e], hd);
        float acc[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < PB / 16; ++ks) {
          uint32_t ahi[4], alo[4];
          state_frag(hs, ks, ahi, alo);
#pragma unroll
          for (int tp = 0; tp < 4; ++tp) {
            const int off = swz_x(16 * tp + (lane & 7) + (lane >> 4) * 8,
                                  2 * ks + ((lane >> 3) & 1));
            uint32_t yh[4], yl[4];  // dy^T: k = p, n = i
            ldsm_x4(Yhi + off, yh);
            ldsm_x4(Ylo + off, yl);
            mma(acc[2 * tp], ahi, yh[0], yh[1]);
            mma(acc[2 * tp], ahi, yl[0], yl[1]);
            mma(acc[2 * tp], alo, yh[0], yh[1]);
            mma(acc[2 * tp + 1], ahi, yh[2], yh[3]);
            mma(acc[2 * tp + 1], ahi, yl[2], yl[3]);
            mma(acc[2 * tp + 1], alo, yh[2], yh[3]);
          }
        }
        // t1's shares: C^T read at the accumulators' positions, summed over
        // this warp's rows n (both slices, in order) into t1p
        float t1c[8][2];
#pragma unroll
        for (int t = 0; t < 8; ++t) t1c[t][0] = t1c[t][1] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t ra[4];
          ldsm_x4_t(Cs + swz_bc(16 * kk + (lane & 7) + (lane >> 4) * 8,
                                nb + ((lane >> 3) & 1)),
                    ra);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 c = unpack(ra[r]);
            const int t = 2 * kk + (r >> 1), e = (r & 1) * 2;
            t1c[t][0] = fmaf(c.x, acc[t][e], t1c[t][0]);
            t1c[t][1] = fmaf(c.y, acc[t][e + 1], t1c[t][1]);
          }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {  // over g
            t1c[t][0] += __shfl_xor_sync(0xffffffffu, t1c[t][0], off);
            t1c[t][1] += __shfl_xor_sync(0xffffffffu, t1c[t][1], off);
          }
          if (g == 0) {
            float* out = t1p + warp * L + 8 * t + 2 * q;
            out[0] = mt ? out[0] + t1c[t][0] : t1c[t][0];
            out[1] = mt ? out[1] + t1c[t][1] : t1c[t][1];
          }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int i = 8 * t + 2 * q;
          const float e0 = es[i], e1 = es[i + 1];
          acc[t][0] *= e0;
          acc[t][1] *= e1;
          acc[t][2] *= e0;
          acc[t][3] *= e1;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // k = j
          uint32_t ra[4];  // B^T rows n, from B stored (j, n)
          ldsm_x4_t(Bs + swz_bc(16 * kk + (lane & 7) + (lane >> 4) * 8,
                                nb + ((lane >> 3) & 1)),
                    ra);
#pragma unroll
          for (int it = 0; it < 4; ++it) {
            if (it >= kk) {  // dG^T: k = j, n = i, from dG stored (i, j)
              const int off =
                  tri(it, kk) + tri_row((lane & 7) + (lane >> 4) * 8,
                                        (lane >> 3) & 1);
              uint32_t gh[4], gl[4];
              ldsm_x4(Ghi + off, gh);
              ldsm_x4(Glo + off, gl);
              mma(acc[2 * it], ra, gh[0], gh[1]);
              mma(acc[2 * it], ra, gl[0], gl[1]);
              mma(acc[2 * it + 1], ra, gh[2], gh[3]);
              mma(acc[2 * it + 1], ra, gl[2], gl[3]);
            }
          }
        }
        store_nt(acc, dcb, t0, S, nrow, q);

        // dB^T: dH' x^T first, scaled by w dt per column j, then C^T dG
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < PB / 16; ++ks) {
          uint32_t ahi[4], alo[4];
          state_frag(hacc[mt], ks, ahi, alo);
#pragma unroll
          for (int tp = 0; tp < 4; ++tp) {
            uint32_t xf[4];  // x^T: k = p, n = j
            ldsm_x4(Xs + swz_x(16 * tp + (lane & 7) + (lane >> 4) * 8,
                               2 * ks + ((lane >> 3) & 1)),
                    xf);
            mma(acc[2 * tp], ahi, xf[0], xf[1]);
            mma(acc[2 * tp], alo, xf[0], xf[1]);
            mma(acc[2 * tp + 1], ahi, xf[2], xf[3]);
            mma(acc[2 * tp + 1], alo, xf[2], xf[3]);
          }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = 8 * t + 2 * q;
          const float s0 = wv[j] * dtv[j], s1 = wv[j + 1] * dtv[j + 1];
          acc[t][0] *= s0;
          acc[t][1] *= s1;
          acc[t][2] *= s0;
          acc[t][3] *= s1;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // k = i
          uint32_t ra[4];  // C^T rows n
          ldsm_x4_t(Cs + swz_bc(16 * kk + (lane & 7) + (lane >> 4) * 8,
                                nb + ((lane >> 3) & 1)),
                    ra);
#pragma unroll
          for (int jt = 0; jt < 4; ++jt) {
            if (jt <= kk) {  // dG: k = i, n = j, from dG stored (i, j)
              const int off =
                  tri(kk, jt) + tri_row((lane & 7) + ((lane >> 3) & 1) * 8,
                                        lane >> 4);
              uint32_t gh[4], gl[4];
              ldsm_x4_t(Ghi + off, gh);
              ldsm_x4_t(Glo + off, gl);
              mma(acc[2 * jt], ra, gh[0], gh[1]);
              mma(acc[2 * jt], ra, gl[0], gl[1]);
              mma(acc[2 * jt + 1], ra, gh[2], gh[3]);
              mma(acc[2 * jt + 1], ra, gl[2], gl[3]);
            }
          }
        }
        store_nt(acc, dbb, t0, S, nrow, q);
      }
      // this warp's share of <dH', H> (over its rows n)
      hd = sum32(hd);
      if (lane == 0) hdv[warp] = hd;
      // the carry to the previous chunk
      const float decay = expf(cum[L - 1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[mt][nt][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t yh[2][4], yl[2][4];  // dy: k = i, n = p
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int off = swz_x(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                2 * np + (lane >> 4));
          ldsm_x4_t(Yhi + off, yh[np]);
          ldsm_x4_t(Ylo + off, yl[np]);
        }
        const int i = 16 * kk + 2 * q;
        const float e0 = es[i], e1 = es[i + 1], e8 = es[i + 8],
                    e9 = es[i + 9];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t ra[4];  // C^T rows n, columns i
          ldsm_x4_t(Cs + swz_bc(16 * kk + (lane & 7) + (lane >> 4) * 8,
                                (32 * warp + 16 * mt) / 8 + ((lane >> 3) & 1)),
                    ra);
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 v = unpack(ra[r]);
            const bool hi_k = r >= 2;  // columns i + 8, i + 9
            split(v.x * (hi_k ? e8 : e0), v.y * (hi_k ? e9 : e1), ahi[r],
                  alo[r]);
          }
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma(hacc[mt][2 * np], ahi, yh[np][0], yh[np][1]);
            mma(hacc[mt][2 * np], ahi, yl[np][0], yl[np][1]);
            mma(hacc[mt][2 * np], alo, yh[np][0], yh[np][1]);
            mma(hacc[mt][2 * np + 1], ahi, yh[np][2], yh[np][3]);
            mma(hacc[mt][2 * np + 1], ahi, yl[np][2], yl[np][3]);
            mma(hacc[mt][2 * np + 1], alo, yh[np][2], yh[np][3]);
          }
        }
      }
      // every reader of the old copy passed the barrier above
      write_state(hacc, DHhi, DHlo, warp, g, q);
    }
    __syncthreads();

    // dcum (this block's share: linear in the columns of P), its reverse
    // cumulative sum ds, ddt's share a ds + x . du, and da's
    if (warp == 0) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = lane + 32 * e;
        v[e] = rowE[i] - (colE[i] + colE[L + i] + colE[2 * L + i] +
                          colE[3 * L + i]) +
               es[i] * (t1p[i] + t1p[L + i] + t1p[2 * L + i] +
                        t1p[3 * L + i]) -
               t2v[i];
      }
      if (lane == 31) {  // position L - 1
        float s2 = 0.f;
        for (int j = 0; j < L; ++j) s2 += t2v[j];
        v[1] += expf(cum[L - 1]) * (hdv[0] + hdv[1] + hdv[2] + hdv[3]) + s2;
      }
      __syncwarp();
      rowE[lane] = v[0];  // dcum, in place of the row sums
      rowE[lane + 32] = v[1];
      __syncwarp();
      // ds_k = sum_{i >= k} dcum_i: an inclusive scan of the reversed chunk
      float r0 = rowE[L - 1 - lane], r1 = rowE[31 - lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, r0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, r1, off);
        if (lane >= off) {
          r0 += u0;
          r1 += u1;
        }
      }
      r1 += __shfl_sync(0xffffffffu, r0, 31);
      float dav = 0.f;
      const int kq[2] = {L - 1 - lane, 31 - lane};
      const float dss[2] = {r0, r1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = kq[e];
        const int t = t0 + kp;
        if (t < S)
          ddtp[(((int64_t)pb * Bsz + b) * S + t) * H + h] =
              fmaf(ah, dss[e], xdu[kp]);
        dav = fmaf(dtv[kp], dss[e], dav);
      }
      da_acc += sum32(dav);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 32 * warp + 16 * mt + g + 8 * (e >> 1);
        const int p = 8 * nt + 2 * q + (e & 1);
        dh0[hoff + (int64_t)n * P + p] = hacc[mt][nt][e];
      }
  if (tid == 0) dap[((int64_t)pb * Bsz + b) * H + h] = da_acc;
}

// dB and dC over the (head, column block) partials (parts, B*S*N), ddt over
// the column blocks' (COLS, B*S*H), da over the (column block, batch row)
// ones (COLS*B, H); one thread an output element, summed in order.
__global__ void __launch_bounds__(256)
    ssd_bwd_bf16_sum(const float* __restrict__ dbp,
                     const float* __restrict__ dcp,
                     const float* __restrict__ ddtp,
                     const float* __restrict__ dap, float* __restrict__ db,
                     float* __restrict__ dc, float* __restrict__ ddt,
                     float* __restrict__ da, int parts, int rows, int H,
                     int64_t total, int64_t total_dt) {
  const int64_t idx = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (idx < total) {
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < parts; ++r) {
      sb += dbp[r * total + idx];
      sc += dcp[r * total + idx];
    }
    db[idx] = sb;
    dc[idx] = sc;
  }
  if (idx < total_dt) {
    float s = 0.f;
    for (int c = 0; c < COLS; ++c) s += ddtp[c * total_dt + idx];
    ddt[idx] = s;
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < H; h += 256) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += dap[(int64_t)r * H + h];
      da[h] = s;
    }
}

cudaError_t launch_bf16(const __nv_bfloat16* x, const float* dt,
                        const float* a, const __nv_bfloat16* bm,
                        const __nv_bfloat16* cm, const float* h0,
                        const float* dy, const float* dhf, float* dx,
                        float* ddt, float* da, float* db, float* dc,
                        float* dh0, float* states, float* dbp, float* dcp,
                        float* dap, int B, int S, int H, int64_t sxb,
                        int64_t sxs, int64_t sxh, int64_t sbb, int64_t sbs,
                        int64_t scb, int64_t scs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_bf16_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // 16-byte copies need 16-byte aligned rows: base pointers and every
  // stride a multiple of 8 elements (the column block starts at 32)
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(bm) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(cm) % 16 == 0) &&
                   ((sxb | sxs | sxh | sbb | sbs | scb | scs) % 8 == 0);
  const bool vec_dy = reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  // the da partials (COLS * B * H) first in dap, then ddt's (COLS, B*S*H)
  float* ddtp = dap + COLS * B * H;
  ssd_bwd_bf16_kernel<<<dim3(H * COLS, B), THREADS, SMEM, stream>>>(
      x, dt, a, bm, cm, h0, dy, dhf, dx, dh0,
      reinterpret_cast<float4*>(states), dbp, dcp, ddtp, dap, S, H, sxb, sxs,
      sxh, sbb, sbs, scb, scs, vec, vec_dy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)B * S * N, total_dt = (int64_t)B * S * H;
  const int64_t n = total > total_dt ? total : total_dt;
  ssd_bwd_bf16_sum<<<unsigned((n + 255) / 256), 256, 0, stream>>>(
      dbp, dcp, ddtp, dap, db, dc, ddt, da, H * COLS, COLS * B, H, total,
      total_dt);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype (of x, B and C): 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores).  x (B, S, H, P) with strides (sxb, sxs, sxh); B and C (B, S, N)
// with strides (b, s); dt (B, S, H), a (H,), h0 (B, H, N, P) or null, dy
// (B, S, H, P) or null, dh_final (B, H, N, P) or null; outputs dx (B, S, H,
// P), ddt (B, S, H), da (H,), dB, dC (B, S, N), dh0 (B, H, N, P); scratch:
// states (B, H, chunks, N, P entries), dB and dC partials (K, B, S, N)
// each, and dap: float32 K = H, da partials (B, H); bfloat16 K = H P / 32,
// da partials (P / 32, B, H) then ddt partials (P / 32, B, S, H).  All fp32
// and contiguous but x, B and C.  Strides in elements.
int ssd_scan_bwd_launch(const void* x, const void* dt, const void* a,
                        const void* bm, const void* cm, const void* h0,
                        const void* dy, const void* dhf, void* dx, void* ddt,
                        void* da, void* db, void* dc, void* dh0, void* states,
                        void* dbp, void* dcp, void* dap, int dtype, int B,
                        int S, int H, int P, int N, int64_t sxb, int64_t sxs,
                        int64_t sxh, int64_t sbb, int64_t sbs, int64_t scb,
                        int64_t scs, void* stream) {
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  const float* dyf = static_cast<const float*>(dy);
  const float* dhff = static_cast<const float*>(dhf);
  float* out[10] = {static_cast<float*>(dx),     static_cast<float*>(ddt),
                    static_cast<float*>(da),     static_cast<float*>(db),
                    static_cast<float*>(dc),     static_cast<float*>(dh0),
                    static_cast<float*>(states), static_cast<float*>(dbp),
                    static_cast<float*>(dcp),    static_cast<float*>(dap)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N != 128 || P != 64) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, 128, 64>(
        static_cast<const float*>(x), dtf, af, static_cast<const float*>(bm),
        static_cast<const float*>(cm), h0f, dyf, dhff, out[0], out[1], out[2],
        out[3], out[4], out[5], out[6], out[7], out[8], out[9], B, S, H, sxb,
        sxs, sxh, sbb, sbs, scb, scs, st);
  if (dtype == 1)
    return tc::launch_bf16(
        static_cast<const __nv_bfloat16*>(x), dtf, af,
        static_cast<const __nv_bfloat16*>(bm),
        static_cast<const __nv_bfloat16*>(cm), h0f, dyf, dhff, out[0], out[1],
        out[2], out[3], out[4], out[5], out[6], out[7], out[8], out[9], B, S,
        H, sxb, sxs, sxh, sbb, sbs, scb, scs, st);
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
