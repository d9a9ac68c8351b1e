// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel library is built on its own by nvcc into a shared library
// with a plain C interface (loaded from Python with ctypes). Each launcher
// returns the CUDA error code of its launches (0 = success) and never
// synchronizes; the Python wrapper raises on a non-zero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define RSPL_EXPORT extern "C" __attribute__((visibility("default")))

#define RSPL_RETURN_IF_ERROR(expr)                 \
  do {                                             \
    cudaError_t rspl_err_ = (expr);                \
    if (rspl_err_ != cudaSuccess) return (int)rspl_err_; \
  } while (0)

// Raises `kernel`'s dynamic shared-memory limit to `bytes` when a launch
// needs more than any earlier launch of it on the current device, so a path
// of fixed shapes makes one driver call per kernel and device, not one per
// launch. `limits` is the kernel's own table (a static of its launcher).
constexpr int kMaxDevices = 16;
inline cudaError_t reserve_dynamic_smem(const void* kernel, std::atomic<int> (&limits)[kMaxDevices],
                                        int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= limits[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) {
    int seen = limits[dev].load(std::memory_order_relaxed);
    while (seen < bytes && !limits[dev].compare_exchange_weak(seen, bytes)) {
    }
  }
  return err;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Running log-sum-exp state: m = running max, s = Σ exp(x - m).
struct LseState {
  float m;
  float s;
};

// One fast exponential per element (__expf: ~2 ulp, ample for log-plans
// compared at 1e-3); the running max keeps every argument <= 0.
__device__ __forceinline__ void lse_push(LseState& st, float a) {
  if (a <= st.m) {
    st.s += __expf(a - st.m);
  } else {
    st.s = st.s * __expf(st.m - a) + 1.0f;  // exp(-inf) = 0 on the first push
    st.m = a;
  }
}

__device__ __forceinline__ LseState lse_merge(LseState a, LseState b) {
  if (b.m == -INFINITY) return a;
  if (a.m == -INFINITY) return b;
  const float m = fmaxf(a.m, b.m);
  return LseState{m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}
