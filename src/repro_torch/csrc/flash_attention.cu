// Prefill attention for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel).  See
// repro_torch/kernels/flash_attention.py for the contract and the bound on
// the H100.  Two kernels, chosen by dtype:
//
// bf16 (the serving path): tensor cores, TMA and mbarriers.
//   * grid (H, B, query tiles), the query tiles launched longest-first (the
//     last causal tile, which sees the most keys, gets the first blocks).
//     One block owns BQ = 64 * NWG queries of one (batch, head): NWG
//     consumer warpgroups of 64 rows each (wgmma's M), and one producer
//     warpgroup.  NWG = 2 (BQ 128) at Dh 64 / 128 / 160, with setmaxnreg
//     moving registers from the producer (40) to the consumers (232); at
//     Dh 256 NWG = 1 (BQ 64), so that the 64 x 256 fp32 accumulator (128
//     registers a thread) fits beside the score tile without spilling.
//   * One thread of the producer warpgroup loads Q once and K / V tiles
//     of BK keys (128 at Dh 64, else 64: at Dh 128 a 128-key score tile
//     spilled, and the 64-key tile ran 5% faster on the card; Dh 80 has
//     Dh 128's padded accumulator, so its tile too) by TMA into
//     a two-stage ring in shared memory;
//     each stage has a full barrier for K, one for V and an empty barrier
//     that the consumers arrive on when both products are done.  The
//     tensor maps are 4-d, (Dh, S, H, B) over the caller's strides, so the
//     model's (B, S, H, Dh) storage is read as it lies; built on the host
//     per call and passed as __grid_constant__ parameters.  Tiles are
//     stored as 64-column blocks with the 128-byte swizzle that the wgmma
//     descriptors name.  TMA fills rows past S with zeros.
//   * Dh 160 does not split into 64-element swizzle atoms: the tile is
//     padded to 192 columns and TMA's out-of-bounds fill writes zeros
//     there.  Q K^T runs its 10 k-steps over the 160 real columns only;
//     P V runs at N = 192 and the 32 extra output columns are not stored.
//   * Dh 80 (hubert-xlarge) the same way: the tile is padded to 128
//     columns (two atoms, the second 16 real columns and 48 of zeros),
//     Q K^T runs 5 k-steps over the 80 real columns, P V runs at N = 128
//     and the 48 extra output columns are not stored.  So Dh 80 reuses Dh
//     128's descriptors, wgmma shapes and register budget as they are.  A
//     32-byte swizzle at 80 columns would move no padding through shared
//     memory, but needs other descriptors and an N = 80 product from an
//     MN-major V that no other head dim exercises; the padding costs
//     shared memory and tensor-core work in P V (128 / 80 of it), not
//     bytes from device memory (TMA's fill reads nothing).
//   * S = Q K^T by wgmma with both operands in shared memory (K-major, as K
//     lies).  The online softmax runs in fp32 registers on the
//     accumulator layout (a row's columns on the 4 lanes of a quad: two
//     shuffles for the row max; the row sum is kept per lane and reduced
//     once at the end), in base 2 with scale * log2(e) folded in.  P is
//     rounded to bf16 in registers and fed to wgmma as the register A
//     operand of O += P V; V is the shared-memory B operand, MN-major
//     through the descriptor's transpose bit.
//   * Masks: key tiles that the causal mask or the window hide from every
//     query of the block are never loaded.  Only a tile that crosses the
//     diagonal, the window edge or S computes the mask (masked logits
//     -inf, which is -1e30 of the TPU kernel for every row that has a
//     valid key, as every causal or windowed row does); interior tiles
//     skip the index arithmetic.
//   * Epilogue: O / max(l, 1e-30) in bf16, stored from registers through
//     the output strides.
//
// fp32 (the card-vs-CPU parity path): the CUDA-core kernel of the first
// port, with Dh 160 and Dh 80 added.  TF32 tensor cores would not meet the
// fp32 tolerance (1e-4 / 1e-5) of the JAX package's tests; the serve runs
// bf16.
//   * grid (ceil(S / BQ), H, B); 128 threads; K/V tiles of 64 keys staged in
//     shared memory; thread (ty, tx) owns R query rows and key columns
//     tx + 8 j; R = 4 (BQ 64) up to Dh 128, R = 2 (BQ 32) at Dh 160 / 256.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing.  The entry returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape, alignment or tensor map it refuses.

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------------ fp32 --

constexpr int BK32 = 64;
constexpr int THREADS32 = 128;

// query rows per thread, and the block's query tile BQ = 16 * R
template <int D>
__host__ __device__ constexpr int rows_per_thread() {
  return D <= 128 ? 4 : 2;
}

template <int D>
constexpr size_t smem_bytes_fp32() {
  // Q and K rows padded to D + 1 floats and P rows to BK + 1 floats, so
  // that the threads of a warp hit distinct banks.
  constexpr size_t BQ = 16 * rows_per_thread<D>();
  return sizeof(float) * (BQ * (D + 1) + size_t(BK32) * (D + 1) +
                          size_t(BK32) * D + BQ * (BK32 + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS32)
    flash_fp32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int group,
               int S, Strides sq, Strides sk, Strides sv, Strides so,
               int causal, int window, float scale) {
  constexpr int BK = BK32;
  constexpr int THREADS = THREADS32;
  constexpr int R = rows_per_thread<D>();
  constexpr int BQ = 16 * R;
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

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    Qs[r * DP + d] = qi < S ? qb[qi * sq.s + d] : 0.f;
  }

  float m[R], l[R], acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
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
      Ks[r * DP + d] = in ? kb[ki * sk.s + d] : 0.f;
      Vs[r * D + d] = in ? vb[ki * sv.s + d] : 0.f;
    }
    __syncthreads();
    float s[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], kv[8];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = Qs[(ty * R + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty * R + i;
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
      for (int j = 0; j < 8; ++j) Ps[(ty * R + i) * BKP + tx + 8 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[R], vv[CPT];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = Ps[(ty * R + i) * BKP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[kk * D + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    if (qi < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        ob[qi * so.s + tx + 8 * c] = acc[i][c] / denom;
    }
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Hkv, int S, Strides sq, Strides sk,
                        Strides sv, Strides so, int causal, int window,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_fp32<D>();
  // Above 48 KB of dynamic shared memory the launch is refused unless the
  // kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  constexpr int BQ = 16 * rows_per_thread<D>();
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fp32<D><<<grid, THREADS32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H / Hkv, S, sq,
      sk, sv, so, causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16 --

// One tile geometry per head dim.
template <int D>
struct Tile {
  static constexpr int DP = (D + 63) / 64 * 64;  // padded to swizzle atoms
  static constexpr int CB = DP / 64;             // 64-column blocks
  static constexpr int NWG = D <= 160 ? 2 : 1;   // consumer warpgroups
  static constexpr int BQ = 64 * NWG;
  static constexpr int BK = DP < 128 ? 128 : 64;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = NWG * 128 + 128;  // + a producer warpgroup
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;
  // + 1024: the dynamic segment is aligned up to the swizzle atom
  static constexpr size_t SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
    flash_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, Strides so, int group, int S,
               int causal, int window, float scale_log2) {
  using C = Tile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, DP = C::DP, CB = C::CB;
  constexpr int ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_k[ST], bar_v[ST], bar_free[ST];

  // Q: CB blocks of BQ x 64; each K / V stage: CB blocks of BK x 64
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk0 = sq + C::Q_BYTES;
  const uint32_t sv0 = sk0 + ST * C::KV_BYTES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest first
  const int hk = h / group;

  // Key tiles some query of the block can see (the TPU kernel's `live`).
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_free[s], C::NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == C::NWG) {
    // ---- producer warpgroup: one thread starts every TMA load; the
    // warpgroup gives its registers to the consumers ----
    if constexpr (C::NWG == 2) setmaxnreg_dec<40>();
    if (tid == C::NWG * 128) {
      mbar_expect_tx(&bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < CB; ++c)
        tma_load(sq + c * BQ * 128, &tq, &bar_q, c * 64, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        const uint32_t round = t / ST;
        mbar_wait(&bar_free[s], (round & 1) ^ 1);  // round 0 passes
        const int k0 = k_begin + t * BK;
        mbar_expect_tx(&bar_k[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          tma_load(sk0 + s * C::KV_BYTES + c * BK * 128, &tk, &bar_k[s],
                   c * 64, k0, hk, b);
        mbar_expect_tx(&bar_v[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          tma_load(sv0 + s * C::KV_BYTES + c * BK * 128, &tv, &bar_v[s],
                   c * 64, k0, hk, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63 ----
  if constexpr (C::NWG == 2) setmaxnreg_inc<232>();
  const int lane = tid & 31;
  const int warp = (tid & 127) >> 5;
  const int row_lo = q0 + wg * 64;           // first row of the warpgroup
  const int qa = row_lo + warp * 16 + (lane >> 2);  // this thread's rows
  const int qb = qa + 8;
  const int cq = 2 * (lane & 3);  // first of this thread's column pairs

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  const uint32_t q_wg = sq + wg * 64 * 128;
  mbar_wait(&bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % ST;
    const uint32_t parity = (t / ST) & 1;
    const int k0 = k_begin + t * BK;
    const uint32_t k_st = sk0 + s * C::KV_BYTES;
    const uint32_t v_st = sv0 + s * C::KV_BYTES;

    // S = Q K^T: D / 16 k-steps; a k-step is 32 bytes inside a 64-column
    // block, and the next block starts a whole block further on.
    float sc[BK / 2];
    mbar_wait(&bar_k[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      const uint32_t blk = kk >> 2;
      Wgmma<BK>::ss(sc, sw128_desc(q_wg + blk * BQ * 128 + off, 16, 1024),
                    sw128_desc(k_st + blk * BK * 128 + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Mask only where the tile crosses S, the diagonal or the window edge
    // for some row of this warpgroup.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > row_lo) ||
                      (window > 0 && k0 <= row_lo + 63 - window);
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa = sc[4 * j + e] * scale_log2;
        float xb = sc[4 * j + 2 + e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + cq + e;
          const bool in = key < S;
          if (!(in && (!causal || key <= qa) &&
                (window <= 0 || key > qa - window)))
            xa = -INFINITY;
          if (!(in && (!causal || key <= qb) &&
                (window <= 0 || key > qb - window)))
            xb = -INFINITY;
        }
        sc[4 * j + e] = xa;
        sc[4 * j + 2 + e] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    // m starts at -1e30 (finite), so a fully masked row gives p = 0
    const float corr_a = exp2f(m_a - mx_a);
    const float corr_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - mx_a);
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mx_b);
        sum_a += sc[4 * j + e];
        sum_b += sc[4 * j + 2 + e];
      }
    }
    l_a = l_a * corr_a + sum_a;  // this lane's share; the quad sums at the end
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= corr_a;
      acc[4 * j + 1] *= corr_a;
      acc[4 * j + 2] *= corr_b;
      acc[4 * j + 3] *= corr_b;
    }
    // The score accumulator's layout is wgmma's register-A layout: k-step
    // kk takes score columns 16 kk .. 16 kk + 15.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V: k-step kk is keys 16 kk .. 16 kk + 15, i.e. two 8-row atoms
    // (2048 bytes) down each column block; N runs over the DP / 64 column
    // blocks, BK * 128 bytes apart.
    mbar_wait(&bar_v[s], parity);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<DP>::rs(acc, pa[kk],
                    sw128_desc(v_st + kk * 2048, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&bar_free[s]);
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + cq;
    if (8 * j < D) {  // D is a multiple of 8: the padding is never stored
      if (qa < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + qa * so.s + col) =
            __floats2bfloat162_rn(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
      if (qb < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + qb * so.s + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv_b,
                                  acc[4 * j + 3] * inv_b);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Hkv, int S, Strides sq, Strides sk,
                        Strides sv, Strides so, int causal, int window,
                        float scale, cudaStream_t stream) {
  using C = Tile<D>;
  if (!tma_ok(q, sq) || !tma_ok(k, sk) || !tma_ok(v, sv) ||
      (reinterpret_cast<uintptr_t>(o) & 3) || (so.s | so.h | so.b) & 1)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, S, H, B, sq, C::BQ) ||
      !make_map(&tk, k, D, S, Hkv, B, sk, C::BK) ||
      !make_map(&tv, v, D, S, Hkv, B, sv, C::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(C::SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (S + C::BQ - 1) / C::BQ);
  flash_bf16<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), so, H / Hkv, S, causal,
      window, scale * 1.4426950408889634f);
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
#define REPRO_FLASH_CASE(DD)                                                 \
  if (D == DD)                                                               \
    return dtype == 0                                                        \
               ? launch_fp32<DD>(q, k, v, o, B, H, Hkv, S, sq, sk, sv, so,   \
                                 causal, window, scale, st)                  \
               : launch_bf16<DD>(q, k, v, o, B, H, Hkv, S, sq, sk, sv, so,   \
                                 causal, window, scale, st);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  REPRO_FLASH_CASE(64)
  REPRO_FLASH_CASE(80)
  REPRO_FLASH_CASE(128)
  REPRO_FLASH_CASE(160)
  REPRO_FLASH_CASE(256)
#undef REPRO_FLASH_CASE
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
