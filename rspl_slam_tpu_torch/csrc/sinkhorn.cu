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
//
// Global-memory kernel (sinkhorn_global_kernel), for the plans no cluster
// holds: Z0 of more than 16 CTAs' shared memory (M1 = N1 >= 921; SuperGlue
// at max_keypoints 1024 or 2048). The wrapper (ops/sinkhorn_cuda.py)
// chooses it by shape, as it chooses the cluster of 8 or 16. Z0 stays in
// device memory, where it is L2-resident (2049^2 f32 is 16.8 MB of the 50
// MB L2). One cooperative launch runs every sweep, with grid-wide
// barriers between the phases of an iteration:
//  1. u: one warp per row of every batch element (lse_push4 over 128
//     columns per step, a 32-lane merge);
//  2. column partials: one warp per (batch, chunk of COL_ROWS rows, 32
//     columns), lane = column, so each row's 32 reads are one coalesced
//     128-byte line; (max, sum) per chunk into the scratch `part`;
//  3. v: one thread per column merges its chunks' partials by lse_merge's
//     rule, as the cluster kernel merges its bands.
// Three grid barriers per iteration plus one at the start: one launch per
// match. Nothing is atomic, so a plan repeats bit for bit. The bound is the
// cluster kernel's (the exponentials at the SFU rate); what holds it back
// is the L2 reads (Z0 twice per iteration) and the barriers.
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

constexpr int GT = 512;  // threads per CTA of the global-memory kernel

__device__ __forceinline__ LseState warp_lse_merge(LseState st) {  // over 32 lanes
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    LseState o{__shfl_xor_sync(0xffffffffu, st.m, off), __shfl_xor_sync(0xffffffffu, st.s, off)};
    st = lse_merge(st, o);
  }
  return st;
}

// u (B, M1), v (B, N1) and part (B, nchunks, 2, N1) are the wrapper's scratch
__global__ void __launch_bounds__(GT)
sinkhorn_global_kernel(const float* __restrict__ Z0, const float* __restrict__ log_mu,
                       const float* __restrict__ log_nu, float* __restrict__ out, float* u,
                       float* v, float* part, int B, int M1, int N1, int iters, int col_rows) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gthread = blockIdx.x * GT + threadIdx.x, nthreads = gridDim.x * GT;
  const int gwarp = gthread >> 5, nwarps = nthreads >> 5;
  const int nchunks = (M1 + col_rows - 1) / col_rows;
  const int ntiles = (N1 + 31) / 32;
  for (int i = gthread; i < B * N1; i += nthreads) v[i] = 0.f;
  grid.sync();
  for (int it = 0; it < iters; ++it) {
    for (int row = gwarp; row < B * M1; row += nwarps) {
      const float* z = Z0 + (size_t)row * N1;
      const float* vb = v + (size_t)(row / M1) * N1;
      LseState st{-INFINITY, 0.f};
      int j = lane;
      for (; j + 96 < N1; j += 128)
        lse_push4(st, z[j] + vb[j], z[j + 32] + vb[j + 32], z[j + 64] + vb[j + 64],
                  z[j + 96] + vb[j + 96]);
      for (; j < N1; j += 32) lse_push(st, z[j] + vb[j]);
      st = warp_lse_merge(st);
      if (lane == 0) u[row] = log_mu[row] - (st.m + logf(st.s));
    }
    grid.sync();
    for (int item = gwarp; item < B * nchunks * ntiles; item += nwarps) {
      const int tile = item % ntiles, bc = item / ntiles;  // bc = b * nchunks + chunk
      const int b = bc / nchunks, i0 = (bc % nchunks) * col_rows;
      const int i1 = min(M1, i0 + col_rows);
      const int j = 32 * tile + lane;
      if (j < N1) {
        const float* z = Z0 + (size_t)b * M1 * N1 + j;
        const float* ub = u + (size_t)b * M1;
        LseState st{-INFINITY, 0.f};
        int i = i0;
        for (; i + 3 < i1; i += 4)
          lse_push4(st, z[(size_t)i * N1] + ub[i], z[(size_t)(i + 1) * N1] + ub[i + 1],
                    z[(size_t)(i + 2) * N1] + ub[i + 2], z[(size_t)(i + 3) * N1] + ub[i + 3]);
        for (; i < i1; ++i) lse_push(st, z[(size_t)i * N1] + ub[i]);
        float* p = part + (size_t)bc * 2 * N1;
        p[j] = st.m;
        p[N1 + j] = st.s;
      }
    }
    grid.sync();
    for (int c = gthread; c < B * N1; c += nthreads) {
      const int b = c / N1, j = c - b * N1;
      const float* p = part + (size_t)b * nchunks * 2 * N1 + j;
      float m = -INFINITY;
      for (int q = 0; q < nchunks; ++q) m = fmaxf(m, p[(size_t)q * 2 * N1]);
      float sum = 0.f;
      for (int q = 0; q < nchunks; ++q)
        sum += p[(size_t)q * 2 * N1 + N1] * expf(p[(size_t)q * 2 * N1] - m);
      v[c] = log_nu[c] - (m + logf(sum));
    }
    grid.sync();
  }
  const size_t n = (size_t)B * M1 * N1;
  for (size_t idx = gthread; idx < n; idx += nthreads) {
    const size_t row = idx / N1;
    const int j = (int)(idx - row * N1);
    out[idx] = Z0[idx] + u[row] + v[(row / M1) * N1 + j];
  }
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

// The global-memory kernel (plans no cluster holds). Z0 (B, M1, N1), log_mu
// (B, M1), log_nu (B, N1), out (B, M1, N1); scratch u (B, M1), v (B, N1),
// part (B, ceil(M1 / col_rows), 2, N1): f32. One cooperative launch of as
// many CTAs as fit the device at once.
RSPL_EXPORT int sinkhorn_global_launch(const void* Z0, const void* log_mu, const void* log_nu,
                                       void* out, void* u, void* v, void* part, int B, int M1,
                                       int N1, int iters, int col_rows, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  RSPL_RETURN_IF_ERROR(cudaGetDevice(&dev));
  RSPL_RETURN_IF_ERROR(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  RSPL_RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sinkhorn_global_kernel, GT, 0));
  if (per_sm < 1) return kErrUnplaceable;
  const auto* z = static_cast<const float*>(Z0);
  const auto* mu = static_cast<const float*>(log_mu);
  const auto* nu = static_cast<const float*>(log_nu);
  auto* o = static_cast<float*>(out);
  auto* uu = static_cast<float*>(u);
  auto* vv = static_cast<float*>(v);
  auto* pp = static_cast<float*>(part);
  void* args[] = {(void*)&z, (void*)&mu, (void*)&nu, (void*)&o, (void*)&uu, (void*)&vv,
                  (void*)&pp, (void*)&B, (void*)&M1, (void*)&N1, (void*)&iters,
                  (void*)&col_rows};
  RSPL_RETURN_IF_ERROR(cudaLaunchCooperativeKernel((const void*)sinkhorn_global_kernel,
                                                   dim3(sms * per_sm), dim3(GT), args, 0,
                                                   (cudaStream_t)stream));
  return (int)cudaGetLastError();
}
