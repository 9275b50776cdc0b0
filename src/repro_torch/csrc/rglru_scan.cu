// RG-LRU linear scan for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan / _rglru_kernel).  See repro_torch/kernels/rglru_scan.py for
// the contract, the bound on the H100 and the design; in short, a
// chunk-parallel scan in one pass with a decoupled look-back:
//
//   * S is cut into chunks of T = 32 steps.  A block of 128 threads owns
//     one (batch row, chunk, tile of 256 lanes), each thread 2
//     neighbouring lanes (one 8-byte load of fp32, 4 of bf16), so a warp's
//     loads and stores are coalesced.  A chunk acts on the state as
//     h -> A h + E (A the product of its a_t, E its last state from zero);
//   * a block takes its work item from an atomic counter, chunk-major, so
//     every item of chunk c - 1 went to a block that is already running
//     before any item of chunk c is handed out: a block waits only on
//     blocks that are resident or done, and the look-back cannot deadlock
//     whatever order the hardware starts blocks in;
//   * the block loads its chunk's a and b into registers (all 64 loads a
//     thread issues are in flight at once), publishes (A, E) with status
//     AGGREGATE, then looks back: one warp reads the status of the 32
//     chunks before it at once, finds the nearest one with status
//     INCLUSIVE (its state at the chunk's end; chunk -1 is h0) with every
//     chunk between it and this one at least AGGREGATE, and moves 32
//     chunks back when there is none; the block folds that state and the
//     aggregates between into its carry, publishes its own end state
//     (INCLUSIVE), re-runs its steps from the carry in registers and
//     writes every h_t; the last chunk writes h_last;
//   * publishing: the values are stored, each thread fences, the block
//     syncs, then one thread stores the status with an atomic; reading: one
//     warp polls the status with volatile loads, fences, the block syncs,
//     then the values are read through the L2 (ld.global.cg).  A poll that
//     spins 2^22 times traps rather than hang the card;
//   * a and b are read once and h written once, so the pass moves the
//     function's own bytes; the scratch holds 3 floats a lane a chunk
//     (A, E, the end state) and one status a (row, chunk, tile), zeroed by
//     cudaMemsetAsync before the launch;
//   * a and b are addressed through (batch, seq) strides with unit stride
//     on W, the outputs are contiguous fp32.  Where W, the pointers or the
//     strides do not allow 2-lane loads, each thread takes one lane.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing (the caller passes the scratch).  The entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int T = 32;  // steps per chunk, held in registers
constexpr long long SPIN_LIMIT = 1ll << 22;

enum : int { EMPTY = 0, AGGREGATE = 1, INCLUSIVE = 2 };

// V neighbouring lanes at p, read-only, as fp32
template <typename E_, int V>
__device__ __forceinline__ void load(const E_* p, float (&v)[V]) {
  if constexpr (std::is_same<E_, float>::value && V == 2) {
    asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v[0]), "=f"(v[1])
                 : "l"(p));
  } else if constexpr (std::is_same<E_, float>::value) {
    asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v[0]) : "l"(p));
  } else if constexpr (V == 2) {
    uint32_t u;
    asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(u) : "l"(p));
    v[0] = __uint_as_float(u << 16);
    v[1] = __uint_as_float(u & 0xffff0000u);
  } else {
    unsigned short u;
    asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(u) : "l"(p));
    v[0] = __uint_as_float(uint32_t(u) << 16);
  }
}

// V lanes of the scratch another block published, through the L2
template <int V>
__device__ __forceinline__ void load_published(const float* p,
                                               float (&v)[V]) {
  if constexpr (V == 2)
    asm volatile("ld.global.cg.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v[0]), "=f"(v[1])
                 : "l"(p));
  else
    asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(v[0]) : "l"(p));
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

__device__ __forceinline__ int load_status(const int* p) {
  int v;
  asm volatile("ld.volatile.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

template <typename E_, int V>
__global__ void __launch_bounds__(THREADS)
    rglru_lookback_kernel(const E_* __restrict__ a, const E_* __restrict__ b,
                          const float* __restrict__ h0,
                          float* __restrict__ hseq, float* __restrict__ hlast,
                          int* status, int* counter, float* agg_a,
                          float* agg_e, float* incl, int B, int S, int W,
                          int nc, int tiles, int64_t sab, int64_t sas,
                          int64_t sbb, int64_t sbs) {
  __shared__ int s_item, s_from;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_item = atomicAdd(counter, 1);
  __syncthreads();
  const int item = s_item;  // chunk-major: (chunk, row, tile)
  const int c = item / (B * tiles);
  const int row = (item / tiles) % B, tile = item % tiles;
  const int w = (tile * THREADS + tid) * V;
  const bool active = w < W;
  const int64_t t0 = (int64_t)c * T;
  const int steps = min(T, S - (int)t0);

  // the chunk's steps (identity steps past S), then its aggregate
  float av[T][V], bv[T][V];
#pragma unroll
  for (int u = 0; u < T; ++u) {
    if (active && u < steps) {
      load<E_, V>(a + row * sab + (t0 + u) * sas + w, av[u]);
      load<E_, V>(b + row * sbb + (t0 + u) * sbs + w, bv[u]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) av[u][v] = 1.f, bv[u][v] = 0.f;
    }
  }
  float A[V], E[V], carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) A[v] = 1.f, E[v] = 0.f, carry[v] = 0.f;
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      A[v] *= av[u][v];
      E[v] = fmaf(av[u][v], E[v], bv[u][v]);
    }

  const int64_t lanes = (int64_t)row * nc * W + w;      // + chunk * W
  int* st = status + (int64_t)row * nc * tiles + tile;  // + chunk * tiles
  if (active && h0 != nullptr)
    load<float, V>(h0 + (int64_t)row * W + w, carry);
  if (c > 0) {
    if (active) {
      store<V>(agg_a + lanes + (int64_t)c * W, A);
      store<V>(agg_e + lanes + (int64_t)c * W, E);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(st + (int64_t)c * tiles, AGGREGATE);
    if (warp == 0) {
      // lane k reads chunk hi - k; chunks before 0 count as INCLUSIVE (h0)
      int hi = c - 1, from = -2;
      long long spins = 0;
      while (from == -2) {
        const int p = hi - lane;
        const int s =
            p >= 0 ? load_status(st + (int64_t)p * tiles) : INCLUSIVE;
        const unsigned inc = __ballot_sync(0xffffffffu, s == INCLUSIVE);
        const unsigned empty = __ballot_sync(0xffffffffu, s == EMPTY);
        if (inc) {
          const int k = __ffs(inc) - 1;  // the nearest
          if (!(empty & ((1u << k) - 1u))) from = hi - k;
        } else if (!empty) {
          hi -= 32;
        }
        if (from == -2 && ++spins > SPIN_LIMIT) __trap();
      }
      __threadfence();
      if (lane == 0) s_from = from;
    }
    __syncthreads();
    const int from = s_from;
    if (active) {
      if (from >= 0)
        load_published<V>(incl + lanes + (int64_t)from * W, carry);
      for (int p = from + 1; p < c; ++p) {
        float pa[V], pe[V];
        load_published<V>(agg_a + lanes + (int64_t)p * W, pa);
        load_published<V>(agg_e + lanes + (int64_t)p * W, pe);
#pragma unroll
        for (int v = 0; v < V; ++v) carry[v] = fmaf(pa[v], carry[v], pe[v]);
      }
    }
  }
  if (c < nc - 1) {  // the state at the chunk's end, for the chunks after
    if (active) {
      float end[V];
#pragma unroll
      for (int v = 0; v < V; ++v) end[v] = fmaf(A[v], carry[v], E[v]);
      store<V>(incl + lanes + (int64_t)c * W, end);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(st + (int64_t)c * tiles, INCLUSIVE);
  }
  if (!active) return;
  float* hp = hseq + ((int64_t)row * S + t0) * W + w;
#pragma unroll
  for (int u = 0; u < T; ++u) {
    if (u < steps) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        carry[v] = fmaf(av[u][v], carry[v], bv[u][v]);
      store<V>(hp + (int64_t)u * W, carry);
    }
  }
  if (c == nc - 1) store<V>(hlast + (int64_t)row * W + w, carry);
}

template <typename E_, int V>
cudaError_t launch(const void* a, const void* b, const float* h0,
                   float* hseq, float* hlast, int* status, float* fscratch,
                   int B, int S, int W, int64_t sab, int64_t sas,
                   int64_t sbb, int64_t sbs, cudaStream_t stream) {
  const int tiles = (W + THREADS * V - 1) / (THREADS * V);
  const int nc = (S + T - 1) / T;
  const size_t items = (size_t)B * nc * tiles;
  cudaError_t err =
      cudaMemsetAsync(status, 0, sizeof(int) * (items + 1), stream);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)B * nc * W;
  rglru_lookback_kernel<E_, V><<<items, THREADS, 0, stream>>>(
      static_cast<const E_*>(a), static_cast<const E_*>(b), h0, hseq, hlast,
      status, status + items, fscratch, fscratch + n, fscratch + 2 * n, B, S,
      W, nc, tiles, sab, sas, sbb, sbs);
  return cudaGetLastError();
}

template <typename E_>
cudaError_t launch_any(const void* a, const void* b, const float* h0,
                       float* hseq, float* hlast, int* status,
                       float* fscratch, int B, int S, int W, int64_t sab,
                       int64_t sas, int64_t sbb, int64_t sbs,
                       cudaStream_t stream) {
  const uintptr_t align = 2 * sizeof(E_);
  const bool pair = W % 2 == 0 && (sab | sas | sbb | sbs) % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(a) % align == 0 &&
                    reinterpret_cast<uintptr_t>(b) % align == 0 &&
                    reinterpret_cast<uintptr_t>(h0) % 8 == 0;
  if (pair)
    return launch<E_, 2>(a, b, h0, hseq, hlast, status, fscratch, B, S, W,
                         sab, sas, sbb, sbs, stream);
  return launch<E_, 1>(a, b, h0, hseq, hlast, status, fscratch, B, S, W, sab,
                       sas, sbb, sbs, stream);
}

}  // namespace

extern "C" {

// dtype (of a and b): 0 = float32, 1 = bfloat16.  a, b (B, S, W) with
// strides (b, s) in elements and unit stride on W; h0 (B, W) or null,
// hseq (B, S, W) and hlast (B, W) contiguous fp32.  Scratch: status, int32,
// B * ceil(S / 32) * ceil(W / 128) + 1 entries; fscratch, fp32,
// 3 * B * ceil(S / 32) * W.
int rglru_scan_launch(const void* a, const void* b, const void* h0,
                      void* hseq, void* hlast, void* status, void* fscratch,
                      int dtype, int B, int S, int W, int64_t sab,
                      int64_t sas, int64_t sbb, int64_t sbs, void* stream) {
  const float* h0f = static_cast<const float*>(h0);
  float* hs = static_cast<float*>(hseq);
  float* hl = static_cast<float*>(hlast);
  int* stat = static_cast<int*>(status);
  float* fs = static_cast<float*>(fscratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_any<float>(a, b, h0f, hs, hl, stat, fs, B, S, W, sab, sas,
                             sbb, sbs, st);
  if (dtype == 1)
    return launch_any<__nv_bfloat16>(a, b, h0f, hs, hl, stat, fs, B, S, W,
                                     sab, sas, sbb, sbs, st);
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
