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
// at max_keypoints 1024 or 2048), rectangular plans such as (1025, 1201),
// and any B. The wrapper (ops/sinkhorn_cuda.py) chooses it by shape, as it
// chooses the cluster of 8 or 16. Its bound is the cluster kernel's, the
// exponentials at the SFU rate (0.050 ms at 1025^2, 0.201 at 2049^2).
// Design: one cooperative launch of persistent CTAs, one per SM, in
// clusters of GC = 8 (as many as the device holds at once: 15 on an H100
// SXM; ops/sinkhorn_cuda.grid_plan). The clusters split into `groups`,
// each on one batch element at a time (B <= clusters: one group per
// element; more: each group walks its elements in turn). Every CTA keeps a
// band of `rows` rows of its element's Z0 in shared memory for all
// iterations (Z0 read from device memory once: 2049^2 f32 is 16.8 MB, 18
// rows x 2052 x 4 B = 148 KB per CTA); rows past what shared memory holds
// (B = 2 at 2049^2, 4097^2) stay in device memory and both sweeps read
// them there. Per iteration:
//  1. u: one warp per row of the band, the max of z + v over 16-byte
//     columns, then the sum of exp (rows padded to 4 with -inf);
//  2. the band's column partials (max, sum of exp) into shared memory, one
//     thread per column (two at once past 1024 columns), eight rows per
//     step; cluster.sync();
//  3. CTA r of a cluster merges column slice r (N1/8 columns) of its 8
//     bands' partials through distributed shared memory and writes the
//     cluster's partial of the slice to device memory (gpart, double
//     buffered by iteration parity);
//  4. one barrier over the group's CTAs: an integer arrival counter, one
//     release add per CTA and an acquire spin; no float atomics, so a plan
//     repeats bit for bit;
//  5. CTA r reads slice r of all cpg cluster partials through L2, merges
//     them into v and writes v into every CTA of its cluster through
//     distributed shared memory; cluster.sync().
// So one grid-level barrier and two cluster barriers per iteration (the
// kernel it replaces: three grid barriers, Z0 read from L2 twice per
// iteration). Bytes exchanged per iteration and group through device
// memory: cpg x 2 x N1 x 4 written, cpg^2 x 2 x N1 x 4 read (cpg = 15 at
// 1025^2: 123 KB and 1.8 MB); through distributed shared memory, per
// cluster, 8 x 2 x N1 x 4 read and 8 x N1 x 4 written. The gpart parity
// makes one barrier enough: a cluster rewrites a parity only after the
// next iteration's barrier, which every reader of it passes after reading.
// A cooperative launch with a cluster dimension (cudaLaunchKernelEx with
// cudaLaunchAttributeCooperative) keeps every CTA resident at once, which
// the hand-written barrier needs. The exponentials are the SFU's ex2 with
// flush to zero (fexp). What holds it back (tests/torch_kernel_phases.py
// stamps each step; PERF.md §6): at 1025^2 the exchange, steps 3-5 with
// the two cluster barriers, takes more than half of an iteration; the row
// sweep is bound by shared-memory reads (z and v twice per element), the
// column sweep by the SFU. v, the band partials and u live in shared
// memory, so N1 is bounded by 3 x N1 x 4 B under the CTA's limit
// (grid_plan raises past it: N1 > ~19,300).
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

constexpr int GC = 8;            // CTAs per cluster of the global-memory kernel
constexpr int GT = 1024;         // threads per CTA of the global-memory kernel
constexpr int GW = GT / 32;      // its warps
constexpr int kSmemLimit = 232448;  // shared memory one H100 CTA may use
constexpr int MAXQ = 16;         // clusters per group, at most (ops/sinkhorn_cuda.MAX_GROUP_CLUSTERS)

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The global kernel's exponentials, by the SFU's ex2 with flush to zero:
// __expf's arithmetic without its denormal fix-ups. Arguments are <= 0 or
// -inf (giving 0); a result below 2^-126 flushes to 0, which no sum of
// these log-plans compared at 1e-3 sees.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float fexp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

__device__ __forceinline__ float max4(float4 a) { return fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)); }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float sum_exp4(float4 a, float m) {
  return (fexp(a.x - m) + fexp(a.y - m)) + (fexp(a.z - m) + fexp(a.w - m));
}

// Eight elements into a running log-sum-exp with fexp: one max over nine,
// nine independent exponentials, one rescale (the sweeps of the global
// kernel; its inputs are finite, so the max is, and arguments stay <= 0)
__device__ __forceinline__ void push8_fast(LseState& st, const float (&a)[8]) {
  const float m = fmaxf(st.m, fmaxf(fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3])),
                                    fmaxf(fmaxf(a[4], a[5]), fmaxf(a[6], a[7]))));
  const float s = ((fexp(a[0] - m) + fexp(a[1] - m)) + (fexp(a[2] - m) + fexp(a[3] - m))) +
                  ((fexp(a[4] - m) + fexp(a[5] - m)) + (fexp(a[6] - m) + fexp(a[7] - m)));
  st.s = st.s * fexp(st.m - m) + s;
  st.m = m;
}

__device__ __forceinline__ void push_fast(LseState& st, float a) {
  const float m = fmaxf(st.m, a);
  st.s = st.s * fexp(st.m - m) + fexp(a - m);
  st.m = m;
}

// lse_merge's rule with fexp
__device__ __forceinline__ LseState merge_fast(LseState a, LseState b) {
  if (b.m == -INFINITY) return a;
  if (a.m == -INFINITY) return b;
  const float m = fmaxf(a.m, b.m);
  return LseState{m, a.s * fexp(a.m - m) + b.s * fexp(b.m - m)};
}

// log-sum-exp state of row + v over its n4 float4 columns across the warp,
// the row in shared memory (16-byte aligned, padding columns -inf): the max
// first, then the sum of exp(x - max), one exponential per element
__device__ __forceinline__ LseState warp_row_lse_resident(const float4* row, const float4* v,
                                                          int n4, int lane) {
  float m = -INFINITY;
#pragma unroll 2
  for (int c = lane; c < n4; c += 32) m = fmaxf(m, max4(add4(row[c], v[c])));
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll 2
  for (int c = lane; c < n4; c += 32) sum += sum_exp4(add4(row[c], v[c]), m);
  return LseState{m, warp_sum(sum)};
}

// the same for a row of N1 in device memory, read once: each lane folds its
// columns (stride 32) eight at a time, then the warp merges
__device__ __forceinline__ LseState warp_row_lse_device(const float* row, const float* v, int N1,
                                                        int lane) {
  LseState st{-INFINITY, 0.f};
  int j = lane;
  for (; j + 7 * 32 < N1; j += 8 * 32) {
    float a[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = __ldg(row + j + 32 * e) + v[j + 32 * e];
    push8_fast(st, a);
  }
  for (; j < N1; j += 32) push_fast(st, __ldg(row + j) + v[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    st = merge_fast(st, LseState{__shfl_xor_sync(0xffffffffu, st.m, off),
                                 __shfl_xor_sync(0xffffffffu, st.s, off)});
  return st;
}

// the column partials of column j (z points at it) and, when `two`, of
// column j + GT, folded over rows [i, i1) (row stride ld) eight rows at a
// time, both columns' loads in flight; kDevice: z lies in device memory
template <bool kDevice>
__device__ __forceinline__ void col_lse2(LseState (&st)[2], const float* z, const float* u, int i,
                                         int i1, int ld, bool two) {
  const float* z1 = z + GT;
  for (; i + 7 < i1; i += 8) {
    float a[8], b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const size_t o = (size_t)(i + e) * ld;
      a[e] = (kDevice ? __ldg(z + o) : z[o]) + u[i + e];
      b[e] = two ? (kDevice ? __ldg(z1 + o) : z1[o]) + u[i + e] : 0.f;
    }
    push8_fast(st[0], a);
    if (two) push8_fast(st[1], b);
  }
  for (; i < i1; ++i) {
    const size_t o = (size_t)i * ld;
    push_fast(st[0], (kDevice ? __ldg(z + o) : z[o]) + u[i]);
    if (two) push_fast(st[1], (kDevice ? __ldg(z1 + o) : z1[o]) + u[i]);
  }
}

// The group's barrier: every CTA of the group arrives once on `counter` (an
// integer, zeroed by the wrapper) with a release add and waits, by acquire
// loads, until all `n` have arrived for the `target`-th time; the CTA
// barriers around it order the other threads' accesses (the pattern of
// CUTLASS's generic barrier).
__device__ __forceinline__ void group_barrier(unsigned* counter, unsigned& target, unsigned n) {
  __syncthreads();
  target += n;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// Shared memory (floats), the layout ops/sinkhorn_cuda.grid_plan sizes, each
// array padded to 4 floats (N1p = N1 rounded up to 4): z resident*N1p (row
// stride N1p, padding columns -inf) | v N1p | band partials (max N1p, sum
// N1p) | u rows | mu rows.
// gpart (groups, 2 parities, cpg, 2, N1) and bar (groups) are the wrapper's
// scratch; bar starts at zero.
__global__ void __launch_bounds__(GT, 1)
sinkhorn_global_kernel(const float* __restrict__ Z0, const float* __restrict__ log_mu,
                       const float* __restrict__ log_nu, float* __restrict__ out, float* gpart,
                       unsigned* bar, int B, int M1, int N1, int iters, int groups, int cpg,
                       int rows, int resident) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int cl = blockIdx.x / GC;
  const int g = cl / cpg, k = cl % cpg;  // the group, the cluster within it
  const int i0 = (k * GC + r) * rows;    // the band's first row
  const int nr = max(0, min(rows, M1 - i0));
  const int nres = min(nr, resident);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N1p = (N1 + 3) & ~3, rows4 = (rows + 3) & ~3;

  float* z = sm;
  float* v = z + (size_t)resident * N1p;
  float* pm = v + N1p;  // band partials: max [0, N1), sum [N1p, N1p + N1)
  float* u = pm + 2 * N1p;
  float* mu = u + rows4;

  const int cs = (N1 + GC - 1) / GC;  // columns this CTA merges: [j0, j1)
  const int j0 = min(N1, r * cs), j1 = min(N1, j0 + cs);
  const float4* z4 = reinterpret_cast<const float4*>(z);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  unsigned* counter = bar + g;
  unsigned target = 0;
  const unsigned arrivals = (unsigned)(cpg * GC);
  int parity = 0;

  for (int b = g; b < B; b += groups) {
    const float* Zb = Z0 + ((size_t)b * M1 + i0) * N1;  // the band in device memory
    const float* nu = log_nu + (size_t)b * N1;
    for (int i = 0; i < nres; ++i)
      for (int j = tid; j < N1p; j += GT)
        z[(size_t)i * N1p + j] = j < N1 ? Zb[(size_t)i * N1 + j] : -INFINITY;
    for (int i = tid; i < nr; i += GT) {
      u[i] = 0.f;
      mu[i] = log_mu[(size_t)b * M1 + i0 + i];
    }
    for (int j = tid; j < N1p; j += GT) v[j] = 0.f;
    __syncthreads();

    for (int it = 0; it < iters; ++it, parity ^= 1) {
      // 1. u over the band, one warp per row: its max, then the sum of exp
      for (int i = warp; i < nr; i += GW) {
        const LseState st =
            i < nres ? warp_row_lse_resident(z4 + (size_t)i * (N1p / 4), v4, N1p / 4, lane)
                     : warp_row_lse_device(Zb + (size_t)i * N1, v, N1, lane);
        if (lane == 0) u[i] = mu[i] - (st.m + logf(st.s));
      }
      __syncthreads();

      // 2. the band's column partials, one thread per column (two at once
      //    where N1 > GT), the resident rows, then the device rows
      for (int j = tid; j < N1; j += 2 * GT) {
        const bool two = j + GT < N1;
        LseState st[2] = {{-INFINITY, 0.f}, {-INFINITY, 0.f}};
        col_lse2<false>(st, z + j, u, 0, nres, N1p, two);
        col_lse2<true>(st, Zb + j, u, nres, nr, N1, two);
        pm[j] = st[0].m;
        pm[N1p + j] = st[0].s;
        if (two) {
          pm[j + GT] = st[1].m;
          pm[N1p + j + GT] = st[1].s;
        }
      }
      cluster.sync();  // the cluster's band partials are visible to every CTA of it

      // 3. the cluster's partial of columns [j0, j1): its GC bands merged by
      //    lse_merge's rule (all loads in flight, then the max, then the sum);
      //    an empty band's (-inf, 0) adds nothing, an empty cluster gives (-inf, 0)
      float* gp = gpart + ((size_t)g * 2 + parity) * cpg * 2 * N1;
      for (int j = j0 + tid; j < j1; j += GT) {
        float pmq[GC], psq[GC];
        float m = -INFINITY;
#pragma unroll
        for (int q = 0; q < GC; ++q) {
          const float* rp = cluster.map_shared_rank(pm, q);
          pmq[q] = rp[j];
          psq[q] = rp[N1p + j];
          m = fmaxf(m, pmq[q]);
        }
        const float base = m == -INFINITY ? 0.f : m;
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < GC; ++q) sum += psq[q] * fexp(pmq[q] - base);
        gp[(size_t)k * 2 * N1 + j] = m;
        gp[(size_t)k * 2 * N1 + N1 + j] = sum;
      }
      // 4. the one grid-level barrier of the iteration
      group_barrier(counter, target, arrivals);

      // 5. v of columns [j0, j1) from the group's cpg cluster partials (read
      //    through L2), written into every CTA of the cluster
      for (int j = j0 + tid; j < j1; j += GT) {
        // all cpg (<= MAXQ, grid_plan) partials loaded at once into
        // registers, merged by the max, then the sum
        float pmq[MAXQ], psq[MAXQ];
        float m = -INFINITY;
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) {
          const bool ok = q < cpg;
          pmq[q] = ok ? __ldcg(gp + (size_t)q * 2 * N1 + j) : -INFINITY;
          psq[q] = ok ? __ldcg(gp + (size_t)q * 2 * N1 + N1 + j) : 0.f;
          m = fmaxf(m, pmq[q]);
        }
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) sum += psq[q] * fexp(pmq[q] - m);
        const float vj = nu[j] - (m + logf(sum));
#pragma unroll
        for (int q = 0; q < GC; ++q) *cluster.map_shared_rank(v + j, q) = vj;
      }
      cluster.sync();  // every CTA holds the full v
    }

    float* o = out + ((size_t)b * M1 + i0) * N1;
    for (size_t idx = tid; idx < (size_t)nr * N1; idx += GT) {
      const int i = (int)(idx / N1), j = (int)(idx - (size_t)i * N1);
      o[idx] = (i < nres ? z[(size_t)i * N1p + j] : Zb[idx]) + u[i] + v[j];
    }
    __syncthreads();  // z, u and v are read before the next batch element loads them
  }
}

std::atomic<int> global_smem_limits[kMaxDevices];

cudaLaunchConfig_t global_config(int ctas, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute (&attr)[2]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(GT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = GC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
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

// The global-memory kernel's cluster count: how many clusters of GC CTAs at
// the largest shared memory a CTA may take the device holds at once (one CTA
// per SM), written to *clusters (host memory). ops/sinkhorn_cuda.grid_plan
// spreads the batch over that many.
RSPL_EXPORT int sinkhorn_global_clusters(void* clusters) {
  RSPL_RETURN_IF_ERROR(reserve_dynamic_smem((const void*)sinkhorn_global_kernel,
                                            global_smem_limits, kSmemLimit));
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = global_config(GC, kSmemLimit, 0, attr);
  cfg.numAttrs = 1;  // the occupancy query takes the cluster shape alone
  int n = 0;
  RSPL_RETURN_IF_ERROR(
      cudaOccupancyMaxActiveClusters(&n, (const void*)sinkhorn_global_kernel, &cfg));
  if (n < 1) return kErrUnplaceable;
  *static_cast<int*>(clusters) = n;
  return 0;
}

// The global-memory kernel (plans no cluster holds). Z0 (B, M1, N1), log_mu
// (B, M1), log_nu (B, N1), out (B, M1, N1): f32; scratch gpart (groups, 2,
// cpg, 2, N1) f32 and bar (groups) int32, zeroed. groups, cpg, rows,
// resident and smem (bytes) are the wrapper's grid_plan. One cooperative
// launch of groups x cpg clusters of GC CTAs.
RSPL_EXPORT int sinkhorn_global_launch(const void* Z0, const void* log_mu, const void* log_nu,
                                       void* out, void* gpart, void* bar, int B, int M1,
                                       int N1, int iters, int groups, int cpg, int rows,
                                       int resident, int smem, void* stream) {
  if (smem > kSmemLimit || cpg > MAXQ) return (int)cudaErrorInvalidValue;
  RSPL_RETURN_IF_ERROR(reserve_dynamic_smem((const void*)sinkhorn_global_kernel,
                                            global_smem_limits, smem));
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      global_config(groups * cpg * GC, smem, (cudaStream_t)stream, attr);
  RSPL_RETURN_IF_ERROR(cudaLaunchKernelEx(
      &cfg, sinkhorn_global_kernel, static_cast<const float*>(Z0),
      static_cast<const float*>(log_mu), static_cast<const float*>(log_nu),
      static_cast<float*>(out), static_cast<float*>(gpart), static_cast<unsigned*>(bar), B, M1,
      N1, iters, groups, cpg, rows, resident));
  return (int)cudaGetLastError();
}
