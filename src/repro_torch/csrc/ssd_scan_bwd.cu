// Mamba-2 SSD scan backward for Hopper (sm_90a), written by hand.
//
// The gradient of the SSD scan (csrc/ssd_scan.cu), which replaces the
// Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan /
// _ssd_kernel).  The TPU kernel has no gradient: the JAX package trains
// through autodiff of its jnp ssd_chunked (src/repro/models/ssm.py).  See
// repro_torch/kernels/ssd_scan.py (ssd_scan_bwd_chunks) for the equations,
// which this kernel computes in the same order, and for the bound.
//
// Two kernels, launched one after the other by ssd_scan_bwd_launch:
//
// ssd_bwd_kernel: grid (H, B), 256 threads as a 16 x 16 grid (ty, tx).  One
//   block owns one (batch row, head), every product in fp32 on the CUDA
//   cores for both input dtypes (bf16 x / B / C are widened as they are
//   staged in shared memory):
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
// ssd_bwd_sum: dB and dC summed over the heads' partials and da over the
//   batch rows' partials, in a fixed order: no atomics, so two calls give
//   bitwise-equal gradients.
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

namespace {

constexpr int L = 64;         // positions per chunk
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

}  // namespace

extern "C" {

// dtype (of x, B and C): 0 = float32, 1 = bfloat16.  x (B, S, H, P) with
// strides (sxb, sxs, sxh); B and C (B, S, N) with strides (b, s); dt
// (B, S, H), a (H,), h0 (B, H, N, P) or null, dy (B, S, H, P) or null,
// dh_final (B, H, N, P) or null; outputs dx (B, S, H, P), ddt (B, S, H),
// da (H,), dB, dC (B, S, N), dh0 (B, H, N, P); scratch: states (B, H,
// chunks, N, P), dB and dC partials (H, B, S, N), da partials (B, H).  All
// fp32 and contiguous but x, B and C.  Strides in elements.
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
    return launch<__nv_bfloat16, 128, 64>(
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
