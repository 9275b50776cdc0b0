// mma.sync building blocks shared by the bf16 SSD kernels (ssd_scan.cu,
// ssd_scan_bwd.cu): bf16 staging with cp.async into XOR-swizzled shared
// memory, ldmatrix, the m16n8k16 product (bf16 in, fp32 accumulate) and the
// hi / lo split of an fp32 operand.  Included by each source;
// kernels/_build.py hashes every header in csrc/ into each library's name,
// so a change here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Byte offsets of the 16-byte piece c of row r, XOR-swizzled so that the
// eight rows an ldmatrix reads at one column hit eight distinct bank groups.
__device__ __forceinline__ int swz_bc(int r, int c) {  // 256-byte rows
  return r * 256 + ((c ^ (r & 7)) << 4);
}
__device__ __forceinline__ int swz_x(int r, int c) {  // 64-byte rows
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Ask the L2 for the 128-byte line at p.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b for one 16 x 8 tile: a the 16 x 16 A fragment, (b0, b1) the
// 16 x 8 B fragment, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// a packed bf16 pair as two floats
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// (u0, u1) -> hi = bf16(u), lo = bf16(u - hi), each a packed pair
__device__ __forceinline__ void split(float u0, float u1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u0, u1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(u0 - hf.x, u1 - hf.y));
}

// Rows [t0, t0 + ROWS) of a bf16 matrix with row stride rs (elements),
// CHUNKS 16-byte pieces a row (16: B or C, 4: 32 columns of x), into shared
// memory at their swizzled offsets, by NT threads; rows at or past S read
// as zero.  vec: 16-byte copies with cp.async, else element by element.
template <int CHUNKS, int NT = 128, int ROWS = 64>
__device__ __forceinline__ void stage(uint8_t* dst, const __nv_bfloat16* src,
                                      int64_t rs, int t0, int S, bool vec) {
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NT) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool in = t0 + r < S;
    const __nv_bfloat16* g = src + (int64_t)(t0 + r) * rs + c * 8;
    uint8_t* d = dst + (CHUNKS == 16 ? swz_bc(r, c) : swz_x(r, c));
    if (vec) {
      cp_async16(d, in ? g : src, in);
    } else {
      const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = in ? (uint32_t(gs[2 * e]) | (uint32_t(gs[2 * e + 1]) << 16))
                  : 0u;
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The hi / lo bf16 copy of a 128 x 32 fp32 state held in accumulators
// (warp w: rows 32w + 16mt + g and + 8, columns 8nt + 2q and + 1), rows n,
// 64-byte rows.
__device__ __forceinline__ void write_state(const float (&hacc)[2][4][4],
                                            uint8_t* hhi, uint8_t* hlo,
                                            int warp, int g, int q) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 32 * warp + 16 * mt + g + 8 * half;
        const int off = swz_x(n, nt) + 4 * q;
        uint32_t hi, lo;
        split(hacc[mt][nt][2 * half], hacc[mt][nt][2 * half + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(hhi + off) = hi;
        *reinterpret_cast<uint32_t*>(hlo + off) = lo;
      }
}

}  // namespace
