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

#define RSPL_EXPORT extern "C" __attribute__((visibility("default")))

#define RSPL_RETURN_IF_ERROR(expr)                 \
  do {                                             \
    cudaError_t rspl_err_ = (expr);                \
    if (rspl_err_ != cudaSuccess) return (int)rspl_err_; \
  } while (0)

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
