// Rotary position embedding (RoPE) of q and k in one launch, for Hopper
// (sm_90a), written by hand.
//
// Replaces no TPU kernel: the JAX package rotates in jnp
// (src/repro/models/layers.py::apply_rope) and XLA fuses the chain.  The
// port's plain version of that chain is 17 PyTorch operations a call, two
// calls a layer, each a pass over fp32 copies of q and k.  See
// repro_torch/kernels/rope.py for the contract and the bound on the H100;
// in short:
//
//   * the op is far below the card's ridge (a handful of operations a
//     byte), so it is bound by bytes: q and k are read once and their
//     rotations written once, in their own dtype (4 bytes an element in
//     bf16), and the chain's launches become one;
//   * a block of 256 threads owns T consecutive tokens of the flattened
//     (B, S); a thread rotates chunks of V neighbouring pairs (x1[i],
//     x2[i]) = (x[i], x[i + Dh / 2]) of one head, with one 16-byte load and
//     store for each half of the chunk where the pointers and strides allow
//     (V = 8 in bf16, 4 in fp32), else V = 1;
//   * each thread first issues the loads of its first U = 4 chunks, then
//     the block fills a table in shared memory with the (cos, sin) of each
//     of its tokens' Dh / 2 angles, angle = float(position) * inv_freq[i],
//     while those loads are in flight; every query head and key head of a
//     token reuses the table;
//   * T is chosen from the shapes: as many tokens as give each thread at
//     most U chunks (one round of loads), at most 32 tokens and 48 KB of
//     table, halved while the grid has fewer than two blocks per SM (a
//     decode step's few tokens get one block each);
//   * the arithmetic is the plain version's, operation for operation in
//     fp32: the int64 position rounded to float, one rounded product for
//     the angle, sincosf (accurate: no fast-math in the build), then
//     x1 c - x2 s and x1 s + x2 c with every product and sum rounded on its
//     own (__fmul_rn / __fsub_rn / __fadd_rn: no FMA contraction), cast to
//     bf16 by round to nearest even.  ``negate`` rotates by minus the
//     angle (sin negated), which is the backward of the rotation;
//   * q, k and positions are read through their strides (unit stride on
//     Dh; positions' batch stride is 0 for a prefill's shared arange); the
//     outputs are contiguous (B, S, H, Dh) and (B, S, Hkv, Dh).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing.  The entry returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it cannot take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TOKENS = 32;              // tokens a block, at most
constexpr int TABLE_BYTES = 48 * 1024;      // the (cos, sin) table's limit
constexpr int U = 4;  // chunks a thread has in flight, and the aim for T
constexpr int64_t MIN_BLOCKS = 2 * 132;     // two a SM of an H100

// A launch's shape and strides, in elements; the C entry's ``Params``,
// filled once per signature by the Python wrapper.
struct Params {
  int64_t dtype;  // 0 = float32, 1 = bfloat16
  int64_t B, S, H, Hkv, D;
  int64_t sqb, sqs, sqh, skb, sks, skh, spb, sps;
};

template <typename E_>
struct Args {
  const E_* q;
  const E_* k;
  const int64_t* pos;
  const float* inv_freq;
  E_* qo;
  E_* ko;
  int S, H, Hkv, half, tokens, T, negate;
  int64_t sqb, sqs, sqh, skb, sks, skh, spb, sps;
};

// V neighbouring elements of one half of a head: 16 bytes where V fills
// them (one load, one store), else one element
template <typename E_, int V>
struct alignas(sizeof(E_) * V) Chunk {
  E_ v[V];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float& out) { out = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16& out) {
  out = __float2bfloat16_rn(x);
}

// Where chunk ``idx`` of a block's tokens lives: its token t within the
// block, its first pair i0 within the head, its input (through q's or k's
// strides) and its output (contiguous)
template <typename E_, int V>
__device__ __forceinline__ void locate(const Args<E_>& a, int first, int idx,
                                       int& t, int& i0, const E_*& src,
                                       E_*& dst) {
  const int per_head = a.half / V;
  const int per_token = (a.H + a.Hkv) * per_head;
  t = idx / per_token;
  const int r = idx - t * per_token;
  const int head = r / per_head;
  i0 = (r - head * per_head) * V;
  const int tok = first + t, b = tok / a.S, s = tok - b * a.S;
  if (head < a.H) {
    src = a.q + b * a.sqb + s * a.sqs + head * a.sqh + i0;
    dst = a.qo + (int64_t(tok) * a.H + head) * 2 * a.half + i0;
  } else {
    const int hk = head - a.H;
    src = a.k + b * a.skb + s * a.sks + hk * a.skh + i0;
    dst = a.ko + (int64_t(tok) * a.Hkv + hk) * 2 * a.half + i0;
  }
}

template <typename E_, int V>
__global__ void __launch_bounds__(THREADS) rope_kernel(const Args<E_> a) {
  using C = Chunk<E_, V>;
  extern __shared__ float table[];  // cos, then sin: T x half each
  const int half = a.half, tid = threadIdx.x;
  const int first = blockIdx.x * a.T;
  const int n_tok = min(a.T, a.tokens - first);
  const int n_items = n_tok * (a.H + a.Hkv) * (half / V);
  float* cos_t = table;
  float* sin_t = table + a.T * half;

  // the first U chunks of each thread are loaded before the table is
  // made, so the loads are in flight while the angles are computed
  C x1[U], x2[U];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * THREADS;
      if (idx < n_items) {
        int t, i0;
        const E_* src;
        E_* dst;
        locate<E_, V>(a, first, idx, t, i0, src, dst);
        x1[u] = *reinterpret_cast<const C*>(src);
        x2[u] = *reinterpret_cast<const C*>(src + half);
      }
    }
  };
  load(tid);

  for (int idx = tid; idx < n_tok * half; idx += THREADS) {
    const int t = idx / half, i = idx - t * half;
    const int tok = first + t, b = tok / a.S, s = tok - b * a.S;
    const float p = float(a.pos[b * a.spb + s * a.sps]);  // round to nearest
    float sn, cs;
    sincosf(__fmul_rn(p, a.inv_freq[i]), &sn, &cs);
    cos_t[idx] = cs;
    sin_t[idx] = a.negate ? -sn : sn;
  }
  __syncthreads();

  for (int base = tid; base < n_items; base += U * THREADS) {
    if (base != tid) load(base);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * THREADS;
      if (idx < n_items) {
        int t, i0;
        const E_* src;
        E_* dst;
        locate<E_, V>(a, first, idx, t, i0, src, dst);
        const float* c = cos_t + t * half + i0;
        const float* sv = sin_t + t * half + i0;
        C y1, y2;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f1 = to_float(x1[u].v[j]), f2 = to_float(x2[u].v[j]);
          from_float(__fsub_rn(__fmul_rn(f1, c[j]), __fmul_rn(f2, sv[j])),
                     y1.v[j]);
          from_float(__fadd_rn(__fmul_rn(f1, sv[j]), __fmul_rn(f2, c[j])),
                     y2.v[j]);
        }
        *reinterpret_cast<C*>(dst) = y1;
        *reinterpret_cast<C*>(dst + half) = y2;
      }
    }
  }
}

template <typename E_>
int launch(const Params& p, const void* q, const void* k, const void* pos,
           const void* inv_freq, void* qo, void* ko, int negate,
           cudaStream_t stream) {
  constexpr int64_t INT_LIMIT = 0x7fffffff;
  if (p.D < 2 || p.D % 2 || p.B < 1 || p.S < 1 || p.H < 1 || p.Hkv < 1 ||
      p.B * p.S > INT_LIMIT || (p.H + p.Hkv) * p.D > INT_LIMIT)
    return cudaErrorInvalidValue;
  Args<E_> a;
  a.q = static_cast<const E_*>(q);
  a.k = static_cast<const E_*>(k);
  a.pos = static_cast<const int64_t*>(pos);
  a.inv_freq = static_cast<const float*>(inv_freq);
  a.qo = static_cast<E_*>(qo);
  a.ko = static_cast<E_*>(ko);
  a.S = int(p.S), a.H = int(p.H), a.Hkv = int(p.Hkv), a.half = int(p.D / 2);
  a.tokens = int(p.B * p.S);
  a.sqb = p.sqb, a.sqs = p.sqs, a.sqh = p.sqh;
  a.skb = p.skb, a.sks = p.sks, a.skh = p.skh;
  a.spb = p.spb, a.sps = p.sps;
  a.negate = negate;
  // 16-byte chunks where every address a thread touches is aligned
  constexpr int VEC = 16 / sizeof(E_);
  const bool vec =
      a.half % VEC == 0 && p.sqb % VEC == 0 && p.sqs % VEC == 0 &&
      p.sqh % VEC == 0 && p.skb % VEC == 0 && p.sks % VEC == 0 &&
      p.skh % VEC == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(qo) | reinterpret_cast<uintptr_t>(ko)) %
       16) == 0;
  // tokens a block: as many as give each thread U chunks at most, within
  // the table's limit, halved while the grid is small
  const int64_t per_token = (p.H + p.Hkv) * (a.half / (vec ? VEC : 1));
  const int64_t fit = TABLE_BYTES / (2 * sizeof(float) * a.half);
  if (fit < 1) return cudaErrorInvalidValue;
  int64_t T = int64_t(U) * THREADS / per_token;
  T = T < 1 ? 1 : T;
  T = T > MAX_TOKENS ? MAX_TOKENS : T;
  T = T > fit ? fit : T;
  while (T > 1 && (a.tokens + T - 1) / T < MIN_BLOCKS) T /= 2;
  a.T = int(T);
  const unsigned blocks = unsigned((a.tokens + T - 1) / T);
  const size_t smem = 2 * sizeof(float) * T * a.half;
  if (vec)
    rope_kernel<E_, VEC><<<blocks, THREADS, smem, stream>>>(a);
  else
    rope_kernel<E_, 1><<<blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, D) and k (B, S, Hkv, D) in ``params->dtype`` with strides
// (b, s, h) and unit stride on D; positions (B, S) int64 with strides
// (b, s); inv_freq (D / 2) fp32; outputs qo, ko contiguous in q's dtype.
// negate: rotate by minus the angle (the backward).
int rope_launch(const void* q, const void* k, const void* positions,
                const void* inv_freq, void* qo, void* ko,
                const void* params, int negate, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.dtype == 0)
    return launch<float>(p, q, k, positions, inv_freq, qo, ko, negate, s);
  if (p.dtype == 1)
    return launch<__nv_bfloat16>(p, q, k, positions, inv_freq, qo, ko,
                                 negate, s);
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
