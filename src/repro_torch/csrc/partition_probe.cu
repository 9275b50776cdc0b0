// SM partitions of one card (CUDA green contexts) and a probe kernel that
// shows which SMs a partition's launches run on.
//
// No TPU kernel stands behind this file.  It is the H100 counterpart of the
// JAX package's launch/mesh.py::make_submesh, which carves a tpu-let out of
// a pod: here a gpu-let is a set of SMs of one card.
//
//   * partition_split carves the card's SM resource once, with
//     cuDevSmResourceSplitByCount, into a group of at least `min_count` SMs
//     and the remainder; each becomes a green context with a stream of its
//     own.  Two partitions made from one split are disjoint by
//     construction; two separate splits are not (each would take the same
//     first SMs).  The CUDA driver rounds a group up to its granularity and
//     reports the count it granted.  The caller keeps the contexts for the
//     life of the process (launch/partition.py says why);
//   * partition_probe_launch writes each block's %smid: a block spins for
//     `spin` clock cycles first, so that the blocks of one launch are
//     resident together and every SM of the partition takes some.
//
// The driver API is reached through cudaGetDriverEntryPoint, as
// flash_attention.cu reaches cuTensorMapEncodeTiled, so nothing links
// libcuda.  Plain C interface, loaded with ctypes.  The driver entries
// return a CUresult (0 is success; driver_error_string names the others);
// partition_probe_launch returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

// A driver entry point by name (green contexts and their streams need the
// 12.5 API; 12.8 is what the port's PyTorch needs of the driver anyway).
template <typename F>
F driver(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion(name, &p, 12080, cudaEnableDefault,
                                   &found);
#else
  cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  if (found != cudaDriverEntryPointSuccess) {
    fprintf(stderr, "partition_probe: driver entry point %s not found\n",
            name);
    return nullptr;
  }
  return reinterpret_cast<F>(p);
}

#define REPRO_DRIVER(name, ...)                                    \
  static auto name##_ = driver<CUresult (*)(__VA_ARGS__)>(#name); \
  if (!name##_) return CUDA_ERROR_NOT_FOUND;

__global__ void probe_kernel(int* out, long long spin) {
  unsigned int sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  const long long start = clock64();
  while (clock64() - start < spin) {
  }
  if (threadIdx.x == 0) out[blockIdx.x] = int(sm);
}

}  // namespace

extern "C" {

// Carve the SMs of card `ordinal` into a group of at least `min_count` SMs
// and the remainder.  Fills, for the group [0] and the remainder [1]: the
// green context, its CUcontext (to make current), a stream of its own
// (non-blocking) and the SMs granted.  [1] is left empty when no SM
// remains.
int partition_split(int ordinal, int min_count, void** gctx, void** ctx,
                    void** stream, int* sms) {
  REPRO_DRIVER(cuDeviceGet, CUdevice*, int)
  REPRO_DRIVER(cuDeviceGetDevResource, CUdevice, CUdevResource*,
               CUdevResourceType)
  REPRO_DRIVER(cuDevSmResourceSplitByCount, CUdevResource*, unsigned int*,
               const CUdevResource*, CUdevResource*, unsigned int,
               unsigned int)
  REPRO_DRIVER(cuDevResourceGenerateDesc, CUdevResourceDesc*, CUdevResource*,
               unsigned int)
  REPRO_DRIVER(cuGreenCtxCreate, CUgreenCtx*, CUdevResourceDesc, CUdevice,
               unsigned int)
  REPRO_DRIVER(cuCtxFromGreenCtx, CUcontext*, CUgreenCtx)
  REPRO_DRIVER(cuGreenCtxStreamCreate, CUstream*, CUgreenCtx, unsigned int,
               int)
  cudaFree(nullptr);  // the runtime, the driver and the primary context up
  CUdevice dev;
  CUresult r = cuDeviceGet_(&dev, ordinal);
  if (r != CUDA_SUCCESS) return r;
  CUdevResource all, parts[2];
  r = cuDeviceGetDevResource_(dev, &all, CU_DEV_RESOURCE_TYPE_SM);
  if (r != CUDA_SUCCESS) return r;
  unsigned int groups = 1;
  r = cuDevSmResourceSplitByCount_(&parts[0], &groups, &all, &parts[1], 0,
                                   unsigned(min_count));
  if (r != CUDA_SUCCESS) return r;
  if (groups != 1) return CUDA_ERROR_INVALID_VALUE;
  const int n = parts[1].sm.smCount > 0 ? 2 : 1;
  for (int i = 0; i < 2; ++i) {
    gctx[i] = ctx[i] = stream[i] = nullptr;
    sms[i] = 0;
  }
  for (int i = 0; i < n; ++i) {
    CUdevResourceDesc desc;
    r = cuDevResourceGenerateDesc_(&desc, &parts[i], 1);
    if (r != CUDA_SUCCESS) return r;
    CUgreenCtx g;
    r = cuGreenCtxCreate_(&g, desc, dev, CU_GREEN_CTX_DEFAULT_STREAM);
    if (r != CUDA_SUCCESS) return r;
    CUcontext c;
    r = cuCtxFromGreenCtx_(&c, g);
    if (r != CUDA_SUCCESS) return r;
    CUstream s;
    r = cuGreenCtxStreamCreate_(&s, g, CU_STREAM_NON_BLOCKING, 0);
    if (r != CUDA_SUCCESS) return r;
    gctx[i] = g;
    ctx[i] = c;
    stream[i] = s;
    sms[i] = int(parts[i].sm.smCount);
  }
  return CUDA_SUCCESS;
}

// Make a context current on the calling thread (pushed on its stack), and
// pop it again.
int partition_push(void* ctx) {
  REPRO_DRIVER(cuCtxPushCurrent, CUcontext)
  return cuCtxPushCurrent_(static_cast<CUcontext>(ctx));
}

int partition_pop(void) {
  REPRO_DRIVER(cuCtxPopCurrent, CUcontext*)
  CUcontext c;
  return cuCtxPopCurrent_(&c);
}

// n_blocks blocks of 32 threads on `stream`; out[i] = %smid of block i.
int partition_probe_launch(void* out, int n_blocks, long long spin,
                           void* stream) {
  probe_kernel<<<n_blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), spin);
  return cudaGetLastError();
}

const char* driver_error_string(int err) {
  static auto get = driver<CUresult (*)(CUresult, const char**)>(
      "cuGetErrorString");
  const char* s = nullptr;
  if (!get || get(static_cast<CUresult>(err), &s) != CUDA_SUCCESS || !s)
    return "unknown driver error";
  return s;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
