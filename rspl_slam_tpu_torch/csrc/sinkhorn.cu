// K3: masked log-domain Sinkhorn, all iterations in one launch.
//
// Replaces the Pallas TPU kernel rspl_slam_tpu/ops/sinkhorn_pallas.py
// (_sinkhorn_kernel, launched by log_optimal_transport_masked_pallas).
// Given the augmented coupling matrix Z0 = [[couplings, bins0], [bins1,
// alpha]] (B, M+1, N+1) and the log marginals, it runs `iters` sweeps of
//   u = log_mu - LSE_j(Z0 + v),   v = log_nu - LSE_i(Z0 + u)
// from u = v = 0 and writes Z0 + u + v (the wrapper subtracts the norm,
// as the TPU wrapper does). Masked slots carry -1e9 exactly as the TPU
// kernel's inputs do, so fully masked rows and columns stay finite.
//
// What bounds it on the H100: at SuperGlue's K = 400 one call is 100 x 2
// sweeps over 401 x 401 f32 (about 1.3e8 operations, ~2 us at the f32
// peak; 1.3 MB of compulsory traffic, ~0.4 us), so the bound is tiny; what
// limits this version is that one CTA works alone on one of 132 SMs.
//
// Design: the 643 KB Z0 does not fit in one CTA's 227 KB of shared memory,
// so this first version streams Z0 from global memory on every sweep (it
// stays resident in the 50 MB L2) with one CTA of 1024 threads per batch
// element, and keeps u, v and the column partial sums in shared memory.
// The row sweep gives one warp per row (lanes along the row: coalesced);
// the column sweep gives one thread per column and four row groups
// (coalesced along the row), merged through shared memory. Both use a
// running-max log-sum-exp with one fast exponential (__expf) per element:
// measured on the H100, one CTA is bound by its own SM's arithmetic here
// (issuing 8 loads per thread ahead of their use made it slower, not
// faster), so the instruction count per element is what sets its speed.
// The redesign that keeps Z0 resident across a 4-8 CTA cluster in
// distributed shared memory is queued in ROADMAP.md.
#include "common.cuh"

namespace {

constexpr int NT = 1024;
constexpr int COLS = 256;  // column-sweep threads per row group
constexpr int GROUPS = NT / COLS;

__device__ __forceinline__ LseState warp_merge(LseState st) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    LseState o{__shfl_xor_sync(0xffffffffu, st.m, off), __shfl_xor_sync(0xffffffffu, st.s, off)};
    st = lse_merge(st, o);
  }
  return st;
}

__global__ void __launch_bounds__(NT, 1)
sinkhorn_kernel(const float* __restrict__ Z0, const float* __restrict__ log_mu,
                const float* __restrict__ log_nu, float* __restrict__ out, int M1, int N1,
                int iters) {
  extern __shared__ __align__(16) float sm[];
  float* u = sm;                   // M1
  float* v = u + M1;               // N1
  float* pm = v + N1;              // GROUPS * N1 partial maxima
  float* ps = pm + GROUPS * N1;    // GROUPS * N1 partial sums

  const int b = blockIdx.x;
  const float* Z = Z0 + (size_t)b * M1 * N1;
  const float* mu = log_mu + (size_t)b * M1;
  const float* nu = log_nu + (size_t)b * N1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / COLS, col = tid % COLS;

  for (int i = tid; i < M1; i += NT) u[i] = 0.f;
  for (int j = tid; j < N1; j += NT) v[j] = 0.f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int i = warp; i < M1; i += NT / 32) {
      const float* row = Z + (size_t)i * N1;
      LseState st{-INFINITY, 0.f};
      for (int j = lane; j < N1; j += 32) lse_push(st, row[j] + v[j]);
      st = warp_merge(st);
      if (lane == 0) u[i] = mu[i] - (st.m + logf(st.s));
    }
    __syncthreads();
    for (int j = col; j < N1; j += COLS) {
      LseState st{-INFINITY, 0.f};
      for (int i = grp; i < M1; i += GROUPS) lse_push(st, Z[(size_t)i * N1 + j] + u[i]);
      pm[grp * N1 + j] = st.m;
      ps[grp * N1 + j] = st.s;
    }
    __syncthreads();
    for (int j = tid; j < N1; j += NT) {
      LseState st{pm[j], ps[j]};
#pragma unroll
      for (int g = 1; g < GROUPS; ++g) st = lse_merge(st, LseState{pm[g * N1 + j], ps[g * N1 + j]});
      v[j] = nu[j] - (st.m + logf(st.s));
    }
    __syncthreads();
  }

  float* o = out + (size_t)b * M1 * N1;
  for (int idx = tid; idx < M1 * N1; idx += NT) {
    const int i = idx / N1, j = idx - i * N1;
    o[idx] = Z[idx] + u[i] + v[j];
  }
}

}  // namespace

RSPL_EXPORT const char* sinkhorn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Z0 (B, M1, N1), log_mu (B, M1), log_nu (B, N1), out (B, M1, N1): f32.
RSPL_EXPORT int sinkhorn_launch(const void* Z0, const void* log_mu, const void* log_nu,
                                void* out, int B, int M1, int N1, int iters, void* stream) {
  const int smem = (M1 + N1 + 2 * GROUPS * N1) * (int)sizeof(float);
  RSPL_RETURN_IF_ERROR(cudaFuncSetAttribute(
      sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  sinkhorn_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(Z0), static_cast<const float*>(log_mu),
      static_cast<const float*>(log_nu), static_cast<float*>(out), M1, N1, iters);
  return (int)cudaGetLastError();
}
