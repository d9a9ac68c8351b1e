// K3: masked log-domain Sinkhorn, all iterations in one launch.
//
// Replaces the Pallas TPU kernel rspl_slam_tpu/ops/sinkhorn_pallas.py
// (_sinkhorn_kernel, launched by log_optimal_transport_masked_pallas).
// Given the augmented coupling matrix Z0 = [[couplings, bins0], [bins1,
// alpha]] (B, M1, N1) and the log marginals, it runs `iters` sweeps of
//   u = log_mu - LSE_j(Z0 + v),   v = log_nu - LSE_i(Z0 + u)
// from u = v = 0 and writes Z0 + u + v (the wrapper subtracts the norm,
// as the TPU wrapper does). Masked slots carry -1e9 exactly as the TPU
// kernel's inputs do, so fully masked rows and columns stay finite.
//
// What bounds it on the H100: 2 x iters x M1 x N1 exponentials at the SFU
// rate (16 per SM per clock on 132 SMs) -- 7.7 us at SuperGlue's K = 400
// -- above the f32 FMA and the byte times. On the 8 SMs of one cluster the
// same exponentials take 16.5x that (0.13 ms). What a single CTA cannot
// escape is that Z0 (643 KB at K = 400) does not fit in one SM's shared
// memory, so it would re-read Z0 from L2 twice per iteration on one SM.
//
// Design: one thread-block cluster per batch element (cluster size, band
// height and shared bytes come from the wrapper's cluster_plan). CTA r of
// the cluster loads rows [r*rows, (r+1)*rows) of Z0 into its shared memory
// once, so the whole matrix stays resident across the cluster's SMs for
// all iterations.
//  - Row sweep (u): local. Each half warp takes one row of the band,
//    against a CTA-local copy of the full v.
//  - Column sweep (v): each CTA reduces its band to per-column running
//    log-sum-exp partials (max, sum) in its own shared memory, the cluster
//    synchronizes once, and every CTA reads all C partial vectors through
//    distributed shared memory (cluster.map_shared_rank), all C loads in
//    flight at once, and merges them by lse_merge's rule (the max, then
//    sum * exp(m - max)), so each computes the full v itself and nothing
//    needs a second exchange. (Merging one remote partial at a time with
//    lse_merge left each thread waiting on C remote-load latencies in
//    turn.) The partials are double buffered by iteration parity: a CTA
//    cannot overwrite a buffer before every CTA passed the next cluster
//    barrier, by which time all reads of it are done. One cluster.sync()
//    per iteration, plus a last one so that no CTA exits while another may
//    still read its shared memory.
//  - Empty bands (M1 < C, or the last band when C does not divide M1) give
//    the partial (-inf, 0), which the merge passes through; bands of fully
//    masked rows stay finite as in the single-CTA kernel.
//  - Running-max log-sum-exp with __expf, four elements per step
//    (lse_push4: one max, then five exponentials, no branch) and
//    lse_push (common.cuh) for the remainder. The one-element push's
//    data-dependent branch and serial max chain made each sweep latency
//    bound: 1.18 ms per call at K = 400 against 0.70 ms with lse_push4, on
//    an H100 SXM at 700 W.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;           // threads per CTA (ops/sinkhorn_cuda.py)
constexpr int ROW_LANES = 16;      // lanes per row in the row sweep
constexpr int kErrUnplaceable = -2;  // no cluster of this plan fits the device

// Four elements into a running log-sum-exp: one max, five __expf, no
// branch. Each argument stays <= 0; the inputs are finite (-1e9 masking).
__device__ __forceinline__ void lse_push4(LseState& st, float a0, float a1, float a2, float a3) {
  const float m = fmaxf(st.m, fmaxf(fmaxf(a0, a1), fmaxf(a2, a3)));
  st.s = st.s * __expf(st.m - m) + ((__expf(a0 - m) + __expf(a1 - m)) +
                                    (__expf(a2 - m) + __expf(a3 - m)));
  st.m = m;
}

__device__ __forceinline__ LseState row_merge(LseState st) {  // over ROW_LANES lanes
#pragma unroll
  for (int off = ROW_LANES / 2; off > 0; off >>= 1) {
    LseState o{__shfl_xor_sync(0xffffffffu, st.m, off), __shfl_xor_sync(0xffffffffu, st.s, off)};
    st = lse_merge(st, o);
  }
  return st;
}

// Shared memory (floats), the layout cluster_plan sizes:
//   z rows*N1 | v N1 | u rows | mu rows | partials 2 x (max N1, sum N1)
template <int C>
__global__ void __launch_bounds__(NT, 1)
sinkhorn_cluster_kernel(const float* __restrict__ Z0, const float* __restrict__ log_mu,
                        const float* __restrict__ log_nu, float* __restrict__ out, int M1,
                        int N1, int iters, int rows) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int r0 = rank * rows;
  const int nr = max(0, min(rows, M1 - r0));

  float* z = sm;
  float* v = z + rows * N1;
  float* u = v + N1;
  float* mu = u + rows;
  float* part = mu + rows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Zb = Z0 + ((size_t)b * M1 + r0) * N1;
  const float* nu = log_nu + (size_t)b * N1;
  for (int i = tid; i < nr * N1; i += NT) z[i] = Zb[i];
  for (int i = tid; i < nr; i += NT) {
    u[i] = 0.f;
    mu[i] = log_mu[(size_t)b * M1 + r0 + i];
  }
  for (int j = tid; j < N1; j += NT) v[j] = 0.f;
  __syncthreads();

  const int half = lane / ROW_LANES, hl = lane % ROW_LANES;
  for (int it = 0; it < iters; ++it) {
    // u over the band: half warp per row; the loop bound is warp-uniform so
    // every lane reaches the shuffles
    for (int i0 = 2 * warp; i0 < nr; i0 += 2 * (NT / 32)) {
      const int i = i0 + half;
      LseState st{-INFINITY, 0.f};
      if (i < nr) {
        const float* row = z + i * N1;
        int j = hl;
        for (; j + 3 * ROW_LANES < N1; j += 4 * ROW_LANES)
          lse_push4(st, row[j] + v[j], row[j + ROW_LANES] + v[j + ROW_LANES],
                    row[j + 2 * ROW_LANES] + v[j + 2 * ROW_LANES],
                    row[j + 3 * ROW_LANES] + v[j + 3 * ROW_LANES]);
        for (; j < N1; j += ROW_LANES) lse_push(st, row[j] + v[j]);
      }
      st = row_merge(st);
      if (i < nr && hl == 0) u[i] = mu[i] - (st.m + logf(st.s));
    }
    __syncthreads();

    // column partials over the band, one thread per column
    float* pm = part + (it & 1) * 2 * N1;
    for (int j = tid; j < N1; j += NT) {
      LseState st{-INFINITY, 0.f};
      int i = 0;
      for (; i + 3 < nr; i += 4) {
        const float* zc = z + i * N1 + j;
        lse_push4(st, zc[0] + u[i], zc[N1] + u[i + 1], zc[2 * N1] + u[i + 2],
                  zc[3 * N1] + u[i + 3]);
      }
      for (; i < nr; ++i) lse_push(st, z[i * N1 + j] + u[i]);
      pm[j] = st.m;
      pm[N1 + j] = st.s;
    }
    cluster.sync();  // every band's partials of this iteration are visible

    for (int j = tid; j < N1; j += NT) {
      // all C partials in flight at once, then lse_merge's rule over C:
      // the max, then the sum of s * exp(m - max); an empty band's
      // (-inf, 0) adds nothing
      float pmq[C], psq[C];
      float m = -INFINITY;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const float* rp = cluster.map_shared_rank(pm, q);
        pmq[q] = rp[j];
        psq[q] = rp[N1 + j];
        m = fmaxf(m, pmq[q]);
      }
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < C; ++q) sum += psq[q] * expf(pmq[q] - m);
      v[j] = nu[j] - (m + logf(sum));
    }
    __syncthreads();
  }

  float* o = out + ((size_t)b * M1 + r0) * N1;
  for (int idx = tid; idx < nr * N1; idx += NT) {
    const int i = idx / N1, j = idx - i * N1;
    o[idx] = z[idx] + u[i] + v[j];
  }
  cluster.sync();  // no CTA exits while another may still read its partials
}

template <int C>
int launch_cluster(const float* Z0, const float* log_mu, const float* log_nu, float* out, int B,
                   int M1, int N1, int iters, int rows, int smem, cudaStream_t stream) {
  auto kernel = sinkhorn_cluster_kernel<C>;
  RSPL_RETURN_IF_ERROR(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (C > 8)
    RSPL_RETURN_IF_ERROR(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  RSPL_RETURN_IF_ERROR(cudaOccupancyMaxActiveClusters(&active, (const void*)kernel, &cfg));
  if (active < 1) return kErrUnplaceable;
  RSPL_RETURN_IF_ERROR(
      cudaLaunchKernelEx(&cfg, kernel, Z0, log_mu, log_nu, out, M1, N1, iters, rows));
  return (int)cudaGetLastError();
}

}  // namespace

RSPL_EXPORT const char* sinkhorn_error_string(int code) {
  if (code == kErrUnplaceable)
    return "no thread-block cluster of this size and shared memory fits the device";
  return cudaGetErrorString((cudaError_t)code);
}

// Z0 (B, M1, N1), log_mu (B, M1), log_nu (B, N1), out (B, M1, N1): f32.
// cluster (8 or 16), rows and smem (bytes) are the wrapper's cluster_plan.
RSPL_EXPORT int sinkhorn_launch(const void* Z0, const void* log_mu, const void* log_nu,
                                void* out, int B, int M1, int N1, int iters, int cluster,
                                int rows, int smem, void* stream) {
  const auto* z = static_cast<const float*>(Z0);
  const auto* mu = static_cast<const float*>(log_mu);
  const auto* nu = static_cast<const float*>(log_nu);
  auto* o = static_cast<float*>(out);
  const auto st = (cudaStream_t)stream;
  if (cluster == 8) return launch_cluster<8>(z, mu, nu, o, B, M1, N1, iters, rows, smem, st);
  if (cluster == 16) return launch_cluster<16>(z, mu, nu, o, B, M1, N1, iters, rows, smem, st);
  return (int)cudaErrorInvalidValue;
}
