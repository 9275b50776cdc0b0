// RG-LRU linear scan for Hopper (sm_90a), written by hand, and its
// backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan / _rglru_kernel).  See repro_torch/kernels/rglru_scan.py for
// the contract, the bound on the H100 and the design; in short, a
// chunk-parallel scan in one pass with a decoupled look-back, walked
// forward for the scan and backward for its gradient (the template
// parameter REV of one kernel):
//
//   * S is cut into chunks of T = 32 steps.  A block of 128 threads owns
//     one (batch row, chunk, tile of 128 V lanes), each thread V
//     neighbouring lanes (the forward takes V = 2 where it can: one 8-byte
//     load of fp32, 4 of bf16; the backward V = 1), so a warp's loads and
//     stores are coalesced.  A chunk acts on the carried state as
//     x -> A x + E (A the product of its coefficients, E its last state
//     from zero);
//   * a block takes its work item from an atomic counter, chunk-major in
//     the walk's order (from the first chunk forward, from the last
//     backward), so every item before it in the walk went to a block that
//     is already running before its own is handed out: a block waits only
//     on blocks that are resident or done, and the look-back cannot
//     deadlock whatever order the hardware starts blocks in;
//   * the block loads its chunk's coefficients into registers (all loads a
//     thread issues are in flight at once), publishes (A, E) with status
//     AGGREGATE, then looks back: one warp reads the status of the 32
//     positions of the walk before it at once, finds the nearest one with
//     status INCLUSIVE (its state at the chunk's end; position -1 is the
//     initial state) with every one between it and this one at least
//     AGGREGATE, and moves 32 back when there is none; the block folds
//     that state and the aggregates between into its carry, publishes its
//     own end state (INCLUSIVE) and re-runs its steps from the carry in
//     registers;
//   * forward: h_t = a_t h_{t-1} + b_t from h0 (or zero); every h_t is
//     written, and the last chunk writes h_last;
//   * backward: with g and g_last the gradients of h_seq and h_last, the
//     total gradient G_t of h_t runs the same recurrence from the end,
//     G_t = g_t + a_{t+1} G_{t+1}, read straight from the caller's tensors:
//     a_{t+1} (0 at t = S - 1) and g_t (g_last added at t = S - 1), no
//     flipped, shifted or concatenated copies.  The re-run writes db_t =
//     G_t and da_t = G_t h_{t-1} (h_{-1} = h0 or 0, the forward's h_seq
//     read once), and the block of chunk 0 dh0 = a_0 G_0;
//   * publishing: the values are stored, each thread fences, the block
//     syncs, then one thread stores the status with an atomic; reading: one
//     warp polls the status with volatile loads, fences, the block syncs,
//     then the values are read through the L2 (ld.global.cg).  A poll that
//     spins 2^22 times traps rather than hang the card;
//   * every input is read once and every output written once, so each
//     pass moves its function's own bytes; the scratch holds 3 floats a
//     lane a chunk (A, E, the end state) and one status a (row, chunk,
//     tile), zeroed by cudaMemsetAsync before the launch;
//   * a and b are addressed through (batch, seq) strides with unit stride
//     on W, everything else is contiguous fp32.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing (the caller passes the scratch).  Each entry returns
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

// The pointers of one launch.  Forward: a, b (E_) with strides (sab, sas),
// (sbb, sbs); h0 or null, the initial state; out0 = h_seq, out1 = h_last.
// Backward: a (E_) with strides (sab, sas); g = the gradient of h_seq,
// g_last that of h_last, hseq = the forward's h_seq, h0 or null (all
// fp32, contiguous); out0 = da, out1 = db, dh0.  Scratch: a status a (position in the walk,
// row, tile) and the counter; A, E and the inclusive state a lane a
// position in the walk.
template <typename E_>
struct Args {
  const E_* a;
  const E_* b;
  const float* g;
  const float* g_last;
  const float* hseq;
  const float* h0;
  float* out0;
  float* out1;
  float* dh0;
  int* status;
  int* counter;
  float* agg_a;
  float* agg_e;
  float* incl;
  int B, S, W, nc, tiles;
  int64_t sab, sas, sbb, sbs;
};

// One (row, chunk, tile) of the recurrence x_t = A_t x_{t-1} + E_t walked
// in direction REV: forward (REV false) the scan h_t = a_t h_{t-1} + b_t
// from h0; backward (REV true) its gradient, G_t = g_t + a_{t+1} G_{t+1}
// from the last step (a_S taken as 0, g_last added at t = S - 1), then
// db_t = G_t, da_t = G_t h_{t-1} (h_{-1} = h0 or 0) and dh0 = a_0 G_0.  The
// atomic counter hands out work in the walk's order, chunk-major, so the
// look-back's wait is safe in both directions.
template <typename E_, int V, bool REV>
__global__ void __launch_bounds__(THREADS)
    rglru_lookback_kernel(const Args<E_> p) {
  __shared__ int s_item, s_from;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = p.B, S = p.S, W = p.W, nc = p.nc, tiles = p.tiles;
  if (tid == 0) s_item = atomicAdd(p.counter, 1);
  __syncthreads();
  const int item = s_item;  // chunk-major: (position in the walk, row, tile)
  const int k = item / (B * tiles);
  const int c = REV ? nc - 1 - k : k;  // the chunk
  const int row = (item / tiles) % B, tile = item % tiles;
  const int w = (tile * THREADS + tid) * V;
  const bool active = w < W;
  const int64_t t0 = (int64_t)c * T;
  const int steps = min(T, S - (int)t0);

  // the chunk's coefficients (identity steps past S), then its aggregate
  // over the steps in the walk's order; backward, h_{t-1} too, its loads in
  // flight with the others'
  float av[T][V], bv[T][V];
  float hv[REV ? T : 1][V];
  if constexpr (REV) {
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const int64_t t = t0 + u;
      if (active && u < steps && t > 0) {
        load<float, V>(p.hseq + ((int64_t)row * S + t - 1) * W + w, hv[u]);
      } else if (active && u < steps && p.h0 != nullptr) {
        load<float, V>(p.h0 + (int64_t)row * W + w, hv[u]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) hv[u][v] = 0.f;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int64_t t = t0 + u;
    if (active && u < steps) {
      if constexpr (REV) {
        load<float, V>(p.g + ((int64_t)row * S + t) * W + w, bv[u]);
        if (t == S - 1) {
          float gl[V];
          load<float, V>(p.g_last + (int64_t)row * W + w, gl);
#pragma unroll
          for (int v = 0; v < V; ++v) bv[u][v] += gl[v];
          for (int v = 0; v < V; ++v) av[u][v] = 0.f;
        } else {
          load<E_, V>(p.a + row * p.sab + (t + 1) * p.sas + w, av[u]);
        }
      } else {
        load<E_, V>(p.a + row * p.sab + t * p.sas + w, av[u]);
        load<E_, V>(p.b + row * p.sbb + t * p.sbs + w, bv[u]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) av[u][v] = 1.f, bv[u][v] = 0.f;
    }
  }
  float A[V], E[V], carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) A[v] = 1.f, E[v] = 0.f, carry[v] = 0.f;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int u = REV ? T - 1 - i : i;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      A[v] *= av[u][v];
      E[v] = fmaf(av[u][v], E[v], bv[u][v]);
    }
  }

  const int64_t lanes = (int64_t)row * nc * W + w;      // + k * W
  int* st = p.status + (int64_t)row * nc * tiles + tile;  // + k * tiles
  // the forward walks from h0 (or zero), the backward from zero
  if (!REV && active && p.h0 != nullptr)
    load<float, V>(p.h0 + (int64_t)row * W + w, carry);
  if (k > 0) {
    if (active) {
      store<V>(p.agg_a + lanes + (int64_t)k * W, A);
      store<V>(p.agg_e + lanes + (int64_t)k * W, E);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(st + (int64_t)k * tiles, AGGREGATE);
    if (warp == 0) {
      // lane i reads position hi - i; positions before 0 count as
      // INCLUSIVE (the initial state)
      int hi = k - 1, from = -2;
      long long spins = 0;
      while (from == -2) {
        const int pos = hi - lane;
        const int s =
            pos >= 0 ? load_status(st + (int64_t)pos * tiles) : INCLUSIVE;
        const unsigned inc = __ballot_sync(0xffffffffu, s == INCLUSIVE);
        const unsigned empty = __ballot_sync(0xffffffffu, s == EMPTY);
        if (inc) {
          const int i = __ffs(inc) - 1;  // the nearest
          if (!(empty & ((1u << i) - 1u))) from = hi - i;
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
        load_published<V>(p.incl + lanes + (int64_t)from * W, carry);
      for (int pos = from + 1; pos < k; ++pos) {
        float pa[V], pe[V];
        load_published<V>(p.agg_a + lanes + (int64_t)pos * W, pa);
        load_published<V>(p.agg_e + lanes + (int64_t)pos * W, pe);
#pragma unroll
        for (int v = 0; v < V; ++v) carry[v] = fmaf(pa[v], carry[v], pe[v]);
      }
    }
  }
  if (k < nc - 1) {  // the state at the chunk's end, for the chunks after
    if (active) {
      float end[V];
#pragma unroll
      for (int v = 0; v < V; ++v) end[v] = fmaf(A[v], carry[v], E[v]);
      store<V>(p.incl + lanes + (int64_t)k * W, end);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(st + (int64_t)k * tiles, INCLUSIVE);
  }
  if (!active) return;
  if constexpr (REV) {
    float* dap = p.out0 + ((int64_t)row * S + t0) * W + w;
    float* dbp = p.out1 + ((int64_t)row * S + t0) * W + w;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int u = T - 1 - i;
      if (u < steps) {
        float da[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          carry[v] = fmaf(av[u][v], carry[v], bv[u][v]);
          da[v] = carry[v] * hv[u][v];
        }
        store<V>(dbp + (int64_t)u * W, carry);
        store<V>(dap + (int64_t)u * W, da);
      }
    }
    if (c == 0 && p.dh0 != nullptr) {  // carry is G_0
      float a0[V];
      load<E_, V>(p.a + row * p.sab + w, a0);
#pragma unroll
      for (int v = 0; v < V; ++v) a0[v] *= carry[v];
      store<V>(p.dh0 + (int64_t)row * W + w, a0);
    }
  } else {
    float* hp = p.out0 + ((int64_t)row * S + t0) * W + w;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (u < steps) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          carry[v] = fmaf(av[u][v], carry[v], bv[u][v]);
        store<V>(hp + (int64_t)u * W, carry);
      }
    }
    if (c == nc - 1) store<V>(p.out1 + (int64_t)row * W + w, carry);
  }
}

// Zero the statuses and the counter, then launch: one block a (row,
// chunk, tile of THREADS * V lanes).
template <typename E_, int V, bool REV>
cudaError_t launch(Args<E_> p, float* fscratch, cudaStream_t stream) {
  p.tiles = (p.W + THREADS * V - 1) / (THREADS * V);
  p.nc = (p.S + T - 1) / T;
  const size_t items = (size_t)p.B * p.nc * p.tiles;
  cudaError_t err =
      cudaMemsetAsync(p.status, 0, sizeof(int) * (items + 1), stream);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)p.B * p.nc * p.W;
  p.counter = p.status + items;
  p.agg_a = fscratch;
  p.agg_e = fscratch + n;
  p.incl = fscratch + 2 * n;
  rglru_lookback_kernel<E_, V, REV><<<items, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// The forward: two lanes a thread where W, the pointers and the strides
// allow 8-byte (fp32) or 4-byte (bf16) loads, else one.
template <typename E_>
cudaError_t launch_fwd(Args<E_> p, float* fscratch, cudaStream_t stream) {
  const uintptr_t align = 2 * sizeof(E_);
  const bool pair = p.W % 2 == 0 && (p.sab | p.sas | p.sbb | p.sbs) % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(p.a) % align == 0 &&
                    reinterpret_cast<uintptr_t>(p.b) % align == 0 &&
                    reinterpret_cast<uintptr_t>(p.h0) % 8 == 0;
  if (pair) return launch<E_, 2, false>(p, fscratch, stream);
  return launch<E_, 1, false>(p, fscratch, stream);
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
  auto run = [&](auto* e) {
    using E_ = std::remove_pointer_t<decltype(e)>;
    Args<E_> p{};
    p.a = static_cast<const E_*>(a);
    p.b = static_cast<const E_*>(b);
    p.h0 = static_cast<const float*>(h0);
    p.out0 = static_cast<float*>(hseq);
    p.out1 = static_cast<float*>(hlast);
    p.status = static_cast<int*>(status);
    p.B = B, p.S = S, p.W = W, p.sab = sab, p.sas = sas, p.sbb = sbb;
    p.sbs = sbs;
    return launch_fwd(p, static_cast<float*>(fscratch),
                      static_cast<cudaStream_t>(stream));
  };
  if (dtype == 0) return run(static_cast<float*>(nullptr));
  if (dtype == 1) return run(static_cast<__nv_bfloat16*>(nullptr));
  return cudaErrorInvalidValue;
}

// The backward of the scan: dtype of a as above, a (B, S, W) with strides
// (b, s) and unit stride on W; g (B, S, W), g_last (B, W), hseq (B, S, W)
// the forward's output, h0 (B, W) or null; outputs da, db (B, S, W) and
// dh0 (B, W), all fp32 and contiguous.  One lane a thread; scratch as the
// forward's.
int rglru_scan_bwd_launch(const void* a, const void* g, const void* g_last,
                          const void* hseq, const void* h0, void* da,
                          void* db, void* dh0, void* status, void* fscratch,
                          int dtype, int B, int S, int W, int64_t sab,
                          int64_t sas, void* stream) {
  auto run = [&](auto* e) {
    using E_ = std::remove_pointer_t<decltype(e)>;
    Args<E_> p{};
    p.a = static_cast<const E_*>(a);
    p.g = static_cast<const float*>(g);
    p.g_last = static_cast<const float*>(g_last);
    p.hseq = static_cast<const float*>(hseq);
    p.h0 = static_cast<const float*>(h0);
    p.out0 = static_cast<float*>(da);
    p.out1 = static_cast<float*>(db);
    p.dh0 = static_cast<float*>(dh0);
    p.status = static_cast<int*>(status);
    p.B = B, p.S = S, p.W = W, p.sab = sab, p.sas = sas;
    return launch<E_, 1, true>(p, static_cast<float*>(fscratch),
                               static_cast<cudaStream_t>(stream));
  };
  if (dtype == 0) return run(static_cast<float*>(nullptr));
  if (dtype == 1) return run(static_cast<__nv_bfloat16*>(nullptr));
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
