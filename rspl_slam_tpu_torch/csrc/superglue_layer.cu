// K2: one whole SuperGlue GNN layer (attentional propagation + message MLP
// + residual) for both keypoint sets of the stacked (2B, K, C) layout.
//
// Replaces the Pallas TPU kernel rspl_slam_tpu/ops/attention_pallas.py
// (_layer_kernel, launched by attention_layer_fused):
//   q, k, v = x Wq + bq, x Wk + bk, x Wv + bv     (k, v from the source set)
//   msg     = softmax_s(q_h k_h^T / sqrt(dh), -1e9 on masked sources) v_h
//   msg     = msg Wm + bm
//   h       = ReLU((x W1[:C] + msg W1[C:] + b1) * bn_scale + bn_shift)
//   out     = x + h W2 + b2
// A self layer attends within each set; a cross layer reads the other half
// of the stack as source (set s <-> set (s + B) mod 2B) with its mask, as
// models/superglue.py:292-304 does. C = 256, 4 heads of 64.
//
// Two-set variant (superglue_layer_two_set*_launch): the query set X (B, M)
// attends over a source set S (B, N) of another length under S's mask, the
// unstacked path that models/superglue.py:311-336 takes when M != N. The
// same kernels run it with the query and source lengths as two runtime
// parameters and the Q columns projected from X's rows into X's scratch,
// the K and V columns from S's rows into S's scratch, so a layer's two
// calls (X0 over S0, X1 over S1) project each set's Q, K and V once.
//
// Two modes, chosen by the wrapper's compute_dtype (ops/attention_cuda.py):
//
// bf16 (the main path; the JAX package's default compute_dtype). Every
// matmul operand rounds to bf16 where models/superglue.py rounds it (x for
// q/k/v; q and k for the logits; the normalized probabilities and v; the
// message for the merge; concat[x, msg] for the first MLP weight; h for the
// second) and every product accumulates in f32 on the tensor cores
// (mma.sync.m16n8k16 bf16 -> f32). Biases, the 1/sqrt(dh) scale (after the
// product), the -1e9 mask, the two-pass softmax, BN, ReLU and the residual
// stay f32. qkv is stored in bf16: JAX rounds q, k and v to bf16 before
// their only use, so that is exact under this contract.
//   What bounds it: 1.377 GFLOP per layer at K = S = 400 is 1.39 us at the
//   989 TFLOP/s bf16 peak, against ~2.95 MB of bf16 weights and f32 x in and
//   out (0.88 us), so operations bound it. At 800 rows the GEMMs are thin
//   (M = 800), so what limits it is latency and spreading the rows over
//   enough SMs.
//   Design, two launches:
//   1. qkv_bf16_kernel: QKV = bf16(bf16(X) Wqkv + bqkv) over all 2B*K rows,
//      a 32-row x 128-column tile per CTA (150 CTAs at 800 rows).
//   2. layer_bf16_kernel: the rest of the layer, one cluster of 4 CTAs per
//      (set, 32-query tile): CTA h runs head h's attention (Q, K, V of the
//      head in shared memory, the whole logit row in shared memory, softmax
//      in two passes with the normalized probabilities rounded to bf16 in
//      place; no online rescaling, which would round unnormalized values)
//      and then the h-th column slice of the merge (64), the first MLP
//      weight (128) and the second (64). After each step every CTA writes
//      its slice, rounded to bf16, into all four CTAs' shared tiles through
//      distributed shared memory, and one cluster barrier makes the full
//      row tile visible to each (104 CTAs at K = 400).
//   Weights are packed once by the wrapper (pack_mma_b) in the B operand's
//   register order, so each lane fetches a 16-byte fragment (two n8 tiles)
//   per k-step straight from L2 with 8 k-steps in flight; A operands come
//   from shared memory by ldmatrix (row strides an odd number of 16-byte
//   units, so the 8 rows of a phase hit distinct bank groups).
//   Ragged K: query rows past K are zero and never stored; keys past K get
//   -inf logits (no weight; masked keys keep -1e9 as in JAX, so a fully
//   masked source still gives the uniform softmax) and zero values.
//   Streamed attention (layer_bf16_kernel<true>, sources past MAX_K_BF16 =
//   752, where the whole logit row no longer fits the CTA's shared memory;
//   the wrapper chooses it by the source length, as cluster_plan chooses
//   K3's cluster): the same cluster, QKV launch and MLP, with K and V
//   streamed in two passes, so shared memory (97,280 B) no longer grows with
//   K and two CTAs fit an SM. JAX's _attend rounds the *normalized*
//   probabilities to bf16, so a row's max and sum are final before any P V
//   (no online rescaling of rounded values). Layout (FlashAttention-2's,
//   under that contract): warp w owns the 16 query rows of m16 tile w / 4
//   and keys [32 (w % 4), +32) of every chunk of CK = 128 keys.
//   - A ring of STAGES = 2 shared-memory slots, each a chunk's K rows, V
//     rows (pass 2) and mask, filled by cp.async groups: chunk t + 1 is in
//     flight while chunk t computes, one CTA barrier per chunk (the copy
//     into a slot waits for every warp to leave it). The stream runs pass
//     1's chunks, then pass 2's, without a drain between them.
//   - Logits stay in the MMA accumulators (the resident kernel's MMAs in
//     its order: the same bits). Pass 1 folds each chunk into a running
//     (max, sum of exp) per row in registers, reduced over the quad by
//     shuffles; the four key groups merge once, by lse_merge's rule,
//     through 1 KB of shared memory.
//   - Pass 2 packs P = bf16(exp(l - max) * (1 / sum)) from the accumulator
//     fragments straight into the A operand of the P V MMA (the m16n8k16
//     accumulator layout is the A layout), so no logit or probability
//     touches shared memory. The reciprocal product (faster than the
//     division on the card: tests/torch_kernel_phases.py --k2-variants)
//     stays within the resident kernel's one bf16 step
//     (tests/test_torch_kernel_plans.py). Each warp's P V over its
//     keys (16 x 64 f32) is summed over the four key groups in a fixed
//     order once at the end, in the drained ring; no float atomics.
//   Bound: at K = 1024 a stacked layer is 4.8 GFLOP (0.0049 ms at 989
//   TFLOP/s), 2.1 of them the attention, which runs QK^T in both passes
//   (3.2 GFLOP executed); every 32-query tile of a head reads the chunks
//   from L2, 3 x K x 128 B per CTA (K twice, V once: 101 MB per layer at
//   1024, 403 MB at 2048). What holds it back: the passes wait on their
//   chunks (L2), and the card holds 62 of its clusters at once, so 1024
//   keys (2 x 32 tiles = 64 clusters) run a second wave of two
//   (tests/torch_kernel_phases.py; PERF.md §6). At K <= 752 the resident
//   kernel runs, unchanged.
//
// f32 (compute_dtype=float32; the Pallas kernel's function). Nothing rounds
// to bf16, and every product runs on the tensor cores at f32 accuracy as
// 3xTF32 (mma.sync.m16n8k8 tf32 -> f32): each operand splits into hi =
// tf32(a) and lo = tf32(a - hi) (cvt.rna's rounding: to nearest, ties away;
// ops/attention_cuda.split_tf32 mirrors it), and lo_a hi_b + hi_a lo_b +
// hi_a hi_b accumulate in f32, so a product is off by ~2^-22 of itself
// (lo_a lo_b is left out): f32's order, not TF32's 2^-11. QKV, Q K^T, P V,
// the merge, W1 and W2 all run so. The design is the bf16 mode's, in f32
// tiles, two launches in both variants:
//   1. qkv_f32_kernel: QKV = X Wqkv + bqkv over all rows, a 32-row x
//      128-column tile per CTA (150 CTAs at 800 rows), into f32 scratch; the
//      two-set variant projects Q from X's rows and K, V from S's rows.
//   2. layer_f32_kernel: one cluster of 4 CTAs per (set, 32-query tile), CTA
//      h on head h. K and V always stream through a cp.async ring of
//      STAGES_F32 = 2 chunks of CK_F32 = 64 keys, in two passes: pass 1 folds
//      a running (max, sum of exp) per row and key group in registers, the
//      four key groups merged once in order; pass 2 forms P = exp(l - max) *
//      (1 / sum) from the logit accumulators and multiplies it into V. So
//      shared memory (165,376 B: the message tile and the larger of the
//      attention ring and the two MLP tiles; one CTA per SM) does not grow
//      with K, and no keypoint budget raises. The m16n8k8 accumulator holds
//      columns (2t, 2t + 1) of a row where the A operand wants (t, t + 4): P V
//      takes a tile's keys in that order (V rows 2t and 2t + 1 as k slots t
//      and t + 4), so P goes from the logit registers straight into the MMA.
//      Merge, W1 and W2 run by column slice over the 4 CTAs, each slice
//      written into every CTA's tile over DSMEM and one cluster barrier per
//      step, as in the bf16 kernel but in f32. The P V partials sum over the
//      key groups in a fixed order: no float atomics, so a shape repeats bit
//      for bit, and the stacked and two-set launches of equal sets agree bit
//      for bit.
//   Weights are packed once by the wrapper (pack_tf32_b) in the B operand's
//   register order, f32, not pre-split: a lane's 16-byte fragment per k-step
//   feeds two n8 tiles and splits in registers (weights stay 4 bytes per
//   element in L2). A operands come from shared memory by ldmatrix (a b16 8 x 8
//   matrix is an 8 x 4 f32 one, laid out as the tf32 fragment wants) with row
//   strides an odd number of 16-byte units. Each k-step's three products (3
//   MMAs) go into a fresh fragment, added to the running sum by rounded f32
//   adds: the tensor core's own accumulation drifts over a long chain (1.8e-5
//   off the plain layer against 1.3e-6), and fragments of two k-steps, as
//   close per layer, doubled the drift of an 18-layer match (PERF.md §6). The
//   TF32 rounding is an integer add and mask, cvt.rna's bits at a lower issue
//   cost.
//   Bound: a stacked layer at (2, 400, 256) is 1.377 GFLOP: 20.5 us at the 67
//   TFLOP/s f32 FMA peak; the design executes three TF32 products for each
//   (4.13 GFLOP, plus Q K^T again in pass 2), 8.3 us at the 495 TFLOP/s dense
//   TF32 peak (mma.sync reaches 314 TFLOP/s of it on an H100). What holds it
//   back: the operand splits and rounded adds are about six ALU instructions
//   per MMA, and one CTA per SM (8 warps) hides little latency; at 800 rows
//   the GEMMs are thin, as in the bf16 mode.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // threads per CTA; also the model width C
constexpr int C = 256;
constexpr int DH = 64;   // head width (C / 4 heads)

// ----------------------------------------------------------------- bf16 mode

constexpr int BR = 32;          // rows per QKV tile and query rows per cluster: two m16 tiles
constexpr int HEADS = 4;        // cluster size: CTA h owns head h and the h-th column slices
constexpr int LDX = C + 8;      // bf16 row stride of 256-wide tiles (528 B = 33 x 16 B)
constexpr int LDH = 2 * C + 8;  // 512-wide tiles (1040 B = 65 x 16 B)
constexpr int LDK = DH + 8;     // Q, K, V rows of one head (144 B = 9 x 16 B)
constexpr int kSmemLimit = 232448;  // shared memory one H100 CTA may use
constexpr int kErrSmem = -3;        // K too large for the resident bf16 kernel's shared memory
static_assert(DH == 64, "the logit scale below is 1/sqrt(64)");
constexpr float kInvSqrtDh = 0.125f;  // exact: JAX divides the product by sqrt(64) = 8

// Dynamic shared memory of layer_bf16_kernel (ops/attention_cuda.bf16_smem_bytes
// mirrors it): the message tile, then one region that holds the attention
// buffers (Q, K or V, logits, source mask over SP = K rounded up to 16 keys)
// and later the two MLP tiles.
inline int layer_bf16_smem(int K) {
  const int sp = (K + 15) & ~15;
  const int attn = BR * LDK * 2 + sp * LDK * 2 + BR * (sp + 4) * 4 + sp * 4;
  const int mlp = 2 * BR * LDH * 2;
  return BR * LDX * 2 + (attn > mlp ? attn : mlp);
}

// The streamed kernel's attention buffers, independent of K: K and V stream
// through a ring of STAGES slots, each a chunk of CK keys (K rows, V rows and
// the chunk's source mask); warp w owns the query rows of m16 tile w / KG and
// keys [KGW (w % KG), KGW (w % KG) + KGW) of every chunk
// (ops/attention_cuda.bf16_streamed_smem_bytes mirrors the layout).
constexpr int CK = 128;          // keys per chunk
constexpr int STAGES = 2;        // chunks in flight: chunk t + 1 lands while chunk t computes
constexpr int KG = 4;            // key groups: warps per m16 query tile
constexpr int KGW = CK / KG;     // keys per warp and chunk (32)
constexpr int JJ = KGW / 16;     // n16 key blocks per warp and chunk (2)
constexpr int LDO = DH + 8;      // f32 row stride of the P V partials (72: no bank conflict)
constexpr int STAGE_BYTES = 2 * CK * LDK * 2 + CK * 4;
constexpr int layer_bf16_streamed_smem() {
  constexpr int attn = BR * LDK * 2 + STAGES * STAGE_BYTES + KG * BR * 2 * 4;
  constexpr int mlp = 2 * BR * LDH * 2;
  return BR * LDX * 2 + (attn > mlp ? attn : mlp);
}
static_assert(KG * (BR / 16) == NT / 32, "one warp per (m16 tile, key group)");
static_assert(KGW % 16 == 0 && JJ >= 1, "each warp takes whole n16 key blocks of a chunk");
static_assert(2 * KG * 16 * LDO * 4 <= STAGES * STAGE_BYTES, "P V partials overlay the ring");

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte copy to shared memory; zero fill (src not read) when !valid
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d += a (16 x 16 bf16, row major) * b (16 x 8 bf16, column major), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[mt][tile] += A x B for this warp's n16 column block: A is MT m16 tiles
// at sA (row stride lda, bf16, KSTEPS*16 deep), B the block's packed fragments
// Bp[ks * 32 + lane] (ops/attention_cuda.pack_mma_b), PF k-steps of B in
// flight from L2.
template <int MT, int KSTEPS>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][2][4], const __nv_bfloat16* sA,
                                          int lda, const uint4* __restrict__ Bp) {
  constexpr int PF = KSTEPS < 8 ? KSTEPS : 8;
  const int lane = threadIdx.x & 31;
  uint4 b[PF];
#pragma unroll
  for (int i = 0; i < PF; ++i) b[i] = __ldg(Bp + i * 32 + lane);
  const uint32_t a0 = smem_addr(sA + (lane & 15) * lda + (lane >> 4) * 8);
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const uint4 bb = b[ks % PF];
    if (ks + PF < KSTEPS) b[ks % PF] = __ldg(Bp + (ks + PF) * 32 + lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, a0 + (mt * 16 * lda + ks * 16) * 2);
      mma_bf16(acc[mt][0], a, bb.x, bb.y);
      mma_bf16(acc[mt][1], a, bb.z, bb.w);
    }
  }
}

// fn(row, col, v0, v1) for each pair of adjacent columns a lane holds in acc,
// relative to the warp's tile: row = 16 mt + g (+ 8), col = 8 tile + 2 t
template <int MT, typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MT][2][4], F&& fn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        fn(16 * mt + (lane >> 2) + 8 * half, 8 * tile + 2 * (lane & 3), acc[mt][tile][2 * half],
           acc[mt][tile][2 * half + 1]);
}

// one bf16 pair to the same shared-memory address of every CTA in the cluster
__device__ __forceinline__ void cluster_store(cg::cluster_group& cluster,
                                              __nv_bfloat16* p, float v0, float v1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
#pragma unroll
  for (int q = 0; q < HEADS; ++q)
    *cluster.map_shared_rank(reinterpret_cast<__nv_bfloat162*>(p), q) = v;
}

// rows [row0, row0 + BR) x C of X (f32) into a bf16 tile, zero beyond nrows
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* sA, int lda,
                                               const float* __restrict__ X, int row0,
                                               int nrows) {
  for (int i = threadIdx.x; i < BR * C / 4; i += NT) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows)
      v = __ldg(reinterpret_cast<const float4*>(X + (size_t)(row0 + r) * C) + c4);
    auto* d = reinterpret_cast<__nv_bfloat162*>(sA + r * lda + 4 * c4);
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// (acc + bias) * bn_scale + bn_shift, ReLU: as two rounded f32 operations, as JAX
__device__ __forceinline__ float bn_relu(float v, float s, float t) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), t), 0.f);
}

// QKV = bf16(bf16(X) Wqkv + bqkv): a 32-row x 128-column tile per CTA, one
// n16 column block per warp. Column tiles 0-1 (Q) take X's rows into QX,
// tiles 2-5 (K, V) S's rows into QS; the stacked layer passes X = S.
__global__ void __launch_bounds__(NT)
qkv_bf16_kernel(const float* __restrict__ X, int nrows_x, const float* __restrict__ S,
                int nrows_s, const uint4* __restrict__ Wqkv, const float* __restrict__ bqkv,
                __nv_bfloat16* __restrict__ QX, __nv_bfloat16* __restrict__ QS) {
  __shared__ __align__(16) __nv_bfloat16 sA[BR * LDX];
  const bool q_cols = blockIdx.x < C / 128;
  const int nrows = q_cols ? nrows_x : nrows_s;
  __nv_bfloat16* QKV = q_cols ? QX : QS;
  const int row0 = blockIdx.y * BR;
  if (row0 >= nrows) return;  // the shorter set's row tiles past its end
  load_rows_bf16(sA, LDX, q_cols ? X : S, row0, nrows);
  __syncthreads();
  const int nb = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  float acc[2][2][4] = {};
  warp_gemm<2, C / 16>(acc, sA, LDX, Wqkv + (size_t)nb * (C / 16) * 32);
  for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    const int row = row0 + r, col = 16 * nb + c;
    if (row < nrows)
      *reinterpret_cast<__nv_bfloat162*>(QKV + (size_t)row * 3 * C + col) =
          __floats2bfloat162_rn(v0 + bqkv[col], v1 + bqkv[col + 1]);
  });
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4-byte copy to shared memory; zero fill (src not read) when !valid
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

// Chunk t of the streamed attention's two passes over n chunks into ring slot
// t % STAGES: K rows (pass 1, t < n) or K and V rows (pass 2) of keys [c0,
// c0 + CK) of head h's source, zero past K, and the chunk's source mask; one
// cp.async group per chunk (an empty one past the last chunk).
__device__ __forceinline__ void issue_chunk(unsigned char* ring, int t, int n,
                                            const __nv_bfloat16* s_rows,
                                            const float* __restrict__ src_mask, int K) {
  if (t < 2 * n) {
    const bool pass2 = t >= n;
    const int c0 = (pass2 ? t - n : t) * CK;
    auto* sK = reinterpret_cast<__nv_bfloat16*>(ring + (t % STAGES) * STAGE_BYTES);
    auto* sV = sK + CK * LDK;
    auto* sM = reinterpret_cast<float*>(sV + CK * LDK);
    for (int i = threadIdx.x; i < CK * 8; i += NT) {
      const int s = i >> 3, c = (i & 7) * 8;
      const bool ok = c0 + s < K;
      const __nv_bfloat16* row = s_rows + (size_t)(ok ? c0 + s : 0) * 3 * C;
      cp_async16_zfill(smem_addr(sK + s * LDK + c), row + C + c, ok);
      if (pass2) cp_async16_zfill(smem_addr(sV + s * LDK + c), row + 2 * C + c, ok);
    }
    for (int s = threadIdx.x; s < CK; s += NT) {
      const bool ok = c0 + s < K;
      cp_async4_zfill(smem_addr(sM + s), src_mask + (ok ? c0 + s : 0), ok);
    }
  }
  cp_async_commit();
}

// This warp's logits against keys [KGW kg, KGW kg + KGW) of the chunk at sK
// (keys c0..): l[jj][tile][e] is query row g + 8 (e >> 1) of the warp's m16
// tile, key 16 (JJ kg + jj) + 8 tile + 2 (lane & 3) + (e & 1) of the chunk;
// scaled, -1e9 on masked keys, -inf past K, as the resident kernel's logits
// (the same MMAs in the same order, so the same bits).
__device__ __forceinline__ void warp_logits(float (&l)[JJ][2][4], const __nv_bfloat16* sK,
                                            const float* sM, const uint32_t (&qa)[DH / 16][4],
                                            int kg, int c0, int K) {
  const int lane = threadIdx.x & 31;
  const uint32_t kb0 =
      smem_addr(sK + ((lane & 7) + ((lane >> 4) << 3)) * LDK + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int jj = 0; jj < JJ; ++jj) {
    const int j = JJ * kg + jj;
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[jj][tile][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kb0 + (16 * j * LDK + 16 * ks) * 2);
      mma_bf16(l[jj][0], qa[ks], kb[0], kb[1]);
      mma_bf16(l[jj][1], qa[ks], kb[2], kb[3]);
    }
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 16 * j + 8 * tile + 2 * (lane & 3) + (e & 1);
        l[jj][tile][e] = c0 + s < K ? (sM[s] > 0.f ? l[jj][tile][e] * kInvSqrtDh : -1e9f)
                                    : -INFINITY;
      }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Head h's attention of the 32-query tile over all K source keys, K and V
// streamed (see the notes at the top), written rounded to bf16 into columns
// [64 h, 64 h + 64) of every cluster CTA's message tile sMsg. Pass 1 keeps a
// running (max, sum of exp) per row and key group in registers; the four key
// groups merge once, by lse_merge's rule; pass 2 packs P = bf16(exp(l - max) *
// (1 / sum)) from the logit accumulators into the A operand of the P V MMAs. Each
// warp's P V partial (its keys only) is summed over the key groups in a fixed
// order. Contains the cluster barrier after which writes to the other CTAs'
// shared memory are safe.
__device__ __forceinline__ void streamed_attention(unsigned char* region, __nv_bfloat16* sMsg,
                                                   const __nv_bfloat16* q_rows,
                                                   const __nv_bfloat16* s_rows,
                                                   const float* __restrict__ src_mask, int q0,
                                                   int Kq, int K, int h,
                                                   cg::cluster_group& cluster) {
  auto* sQ = reinterpret_cast<__nv_bfloat16*>(region);  // BR x LDK
  unsigned char* ring = region + BR * LDK * 2;           // STAGES x (K, V, mask)
  auto* sRed = reinterpret_cast<float2*>(ring + STAGES * STAGE_BYTES);  // KG x BR (max, sum)
  auto* sO = reinterpret_cast<float*>(ring);  // (BR / 16) x KG x 16 x LDO, once the ring drains
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mt = warp / KG, kg = warp % KG, g = lane >> 2;
  const int n = (K + CK - 1) / CK;

  for (int i = tid; i < BR * 8; i += NT) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = q0 + r < Kq;
    cp_async16_zfill(smem_addr(sQ + r * LDK + c), q_rows + (size_t)(ok ? q0 + r : 0) * 3 * C + c,
                     ok);
  }
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue_chunk(ring, t, n, s_rows, src_mask, K);

  uint32_t qa[DH / 16][4];
  // rows g, g + 8: running max and sum of exp (pass 1), then the final max
  // and the sum's reciprocal (pass 2)
  float rmax[2] = {-INFINITY, -INFINITY}, rsum[2] = {0.f, 0.f}, rinv[2] = {0.f, 0.f};
  float o[DH / 16][2][4];
#pragma unroll
  for (int nb = 0; nb < DH / 16; ++nb)
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][tile][e] = 0.f;

  for (int t = 0; t < 2 * n; ++t) {
    cp_async_wait_group<STAGES - 2>();
    __syncthreads();  // chunk t landed; every warp is done with chunk t - 1's slot
    issue_chunk(ring, t + STAGES - 1, n, s_rows, src_mask, K);
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        ldmatrix_x4(qa[ks],
                    smem_addr(sQ + (16 * mt + (lane & 15)) * LDK + 16 * ks + (lane >> 4) * 8));
    }
    if (t == n) {  // the four key groups' (max, sum) of each row, merged in order
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * mt + g + 8 * hr;
        float m = -INFINITY;
#pragma unroll
        for (int q = 0; q < KG; ++q) m = fmaxf(m, sRed[q * BR + row].x);
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < KG; ++q) {
          const float2 p = sRed[q * BR + row];
          s += p.x == -INFINITY ? 0.f : p.y * expf(p.x - m);
        }
        rmax[hr] = m;
        rinv[hr] = 1.f / s;
      }
    }
    const unsigned char* slot = ring + (t % STAGES) * STAGE_BYTES;
    const auto* sK = reinterpret_cast<const __nv_bfloat16*>(slot);
    const auto* sV = sK + CK * LDK;
    const auto* sM = reinterpret_cast<const float*>(sV + CK * LDK);
    float l[JJ][2][4];
    warp_logits(l, sK, sM, qa, kg, (t < n ? t : t - n) * CK, K);
    if (t < n) {  // pass 1: fold the chunk into the running (max, sum) of rows g, g + 8
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float cm = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < JJ; ++jj)
#pragma unroll
          for (int tile = 0; tile < 2; ++tile)
            cm = fmaxf(cm, fmaxf(l[jj][tile][2 * hr], l[jj][tile][2 * hr + 1]));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
        const float m = fmaxf(rmax[hr], cm);
        const float base = m == -INFINITY ? 0.f : m;  // a slice of padding keys only
        float e = 0.f;
#pragma unroll
        for (int jj = 0; jj < JJ; ++jj)
#pragma unroll
          for (int tile = 0; tile < 2; ++tile)
            e += expf(l[jj][tile][2 * hr] - base) + expf(l[jj][tile][2 * hr + 1] - base);
        e += __shfl_xor_sync(0xffffffffu, e, 1);
        e += __shfl_xor_sync(0xffffffffu, e, 2);
        rsum[hr] = rsum[hr] * expf(rmax[hr] - base) + e;
        rmax[hr] = m;
      }
      if (t == n - 1 && (lane & 3) == 0) {
        sRed[kg * BR + 16 * mt + g] = make_float2(rmax[0], rsum[0]);
        sRed[kg * BR + 16 * mt + g + 8] = make_float2(rmax[1], rsum[1]);
      }
    } else {  // pass 2: P = bf16(exp(l - max) * (1 / sum)) straight into the A operand of P V
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
        uint32_t a[4];
#pragma unroll
        for (int tile = 0; tile < 2; ++tile)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            a[2 * tile + hr] = pack_bf16(expf(l[jj][tile][2 * hr] - rmax[hr]) * rinv[hr],
                                         expf(l[jj][tile][2 * hr + 1] - rmax[hr]) * rinv[hr]);
          }
        const uint32_t vrow = smem_addr(
            sV + (KGW * kg + 16 * jj + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK + (lane >> 4) * 8);
#pragma unroll
        for (int nb = 0; nb < DH / 16; ++nb) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + 16 * nb * 2);
          mma_bf16(o[nb][0], a, vb[0], vb[1]);
          mma_bf16(o[nb][1], a, vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait_group<0>();  // the empty trailing groups
  __syncthreads();           // every warp is done with the ring: its partials take the ring's place
  float* ow = sO + (mt * KG + kg) * 16 * LDO;
#pragma unroll
  for (int nb = 0; nb < DH / 16; ++nb)
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(ow + (g + 8 * hr) * LDO + 16 * nb + 8 * tile + 2 * (lane & 3)) =
            make_float2(o[nb][tile][2 * hr], o[nb][tile][2 * hr + 1]);
  // the partials are visible to the CTA, and every CTA of the cluster is
  // running before any writes to another's shared memory
  cluster.sync();
  for (int p = tid; p < BR * DH / 2; p += NT) {
    const int row = p / (DH / 2), col = 2 * (p % (DH / 2));
    const float* src = sO + ((row / 16) * KG * 16 + row % 16) * LDO + col;
    float2 acc = *reinterpret_cast<const float2*>(src);
#pragma unroll
    for (int q = 1; q < KG; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(src + q * 16 * LDO);
      acc.x += v.x;
      acc.y += v.y;
    }
    cluster_store(cluster, sMsg + row * LDX + h * DH + col, acc.x, acc.y);
  }
}

// The rest of the layer for one (set, 32-query tile), by a cluster of 4 CTAs;
// CTA h runs head h's attention, then column slice h of the merge, the first
// and the second MLP weight (see the notes at the top). Queries: Kq rows per
// set of X and QX; keys and values: K rows per set of QS, of set (set +
// shift) mod nsets, under its mask (nsets, K).
template <bool kStreamed>
__global__ void __cluster_dims__(HEADS, 1, 1) __launch_bounds__(NT, kStreamed ? 2 : 1)
layer_bf16_kernel(const float* __restrict__ X, const __nv_bfloat16* __restrict__ QX,
                  const __nv_bfloat16* __restrict__ QS, const float* __restrict__ mask,
                  const uint4* __restrict__ Wm, const float* __restrict__ bm,
                  const uint4* __restrict__ W1, const float* __restrict__ b1,
                  const float* __restrict__ s1, const float* __restrict__ t1,
                  const uint4* __restrict__ W2, const float* __restrict__ b2,
                  float* __restrict__ OUT, int nsets, int Kq, int K, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int h = (int)cluster.block_rank();
  const int q0 = blockIdx.y * BR, set = blockIdx.z;
  const int src = (set + shift) % nsets;
  const int SP = (K + 15) & ~15;  // keys padded to the MMA depth
  const int LS = SP + 4;          // logit row stride (f32): an odd number of 16-B units
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto* sMsg = reinterpret_cast<__nv_bfloat16*>(smem);  // BR x LDX, written by every CTA
  unsigned char* region = smem + BR * LDX * 2;
  auto* sXM = reinterpret_cast<__nv_bfloat16*>(region);  // BR x LDH: [x | merged msg]
  auto* sH = sXM + BR * LDH;                             // BR x LDH: MLP hidden
  const __nv_bfloat16* q_rows = QX + (size_t)set * Kq * 3 * C + h * DH;
  const __nv_bfloat16* s_rows = QS + (size_t)src * K * 3 * C + h * DH;

  if constexpr (kStreamed) {
    streamed_attention(region, sMsg, q_rows, s_rows, mask + (size_t)src * K, q0, Kq, K, h,
                       cluster);
  } else {
  auto* sQ = reinterpret_cast<__nv_bfloat16*>(region);  // BR x LDK
  auto* sKV = sQ + BR * LDK;                             // SP x LDK: K, then V
  auto* sL = reinterpret_cast<float*>(sKV + SP * LDK);   // BR x LS logits, then bf16 P
  float* sMask = sL + BR * LS;                           // SP

  // Q of head h for the query tile, K of head h for the source set (zero
  // beyond K), the source mask
  for (int i = tid; i < BR * 8; i += NT) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = q0 + r < Kq;
    cp_async16_zfill(smem_addr(sQ + r * LDK + c), q_rows + (size_t)(ok ? q0 + r : 0) * 3 * C + c,
                     ok);
  }
  for (int i = tid; i < SP * 8; i += NT) {
    const int s = i >> 3, c = (i & 7) * 8;
    const bool ok = s < K;
    cp_async16_zfill(smem_addr(sKV + s * LDK + c), s_rows + (size_t)(ok ? s : 0) * 3 * C + C + c,
                     ok);
  }
  for (int s = tid; s < SP; s += NT) sMask[s] = s < K ? mask[(size_t)src * K + s] : 0.f;
  cp_async_wait_all();
  // every CTA of the cluster is running before any writes to another's
  // shared memory; the copies above are visible to the whole CTA
  cluster.sync();

  {  // logits = (q k^T) / sqrt(dh); -1e9 on masked keys, -inf on padding keys
    uint32_t qa[2][DH / 16][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        ldmatrix_x4(qa[mt][ks],
                    smem_addr(sQ + (16 * mt + (lane & 15)) * LDK + 16 * ks + (lane >> 4) * 8));
    // B fragments of keys 16 j.. (two n8 tiles) straight from K's rows
    const uint32_t kb0 =
        smem_addr(sKV + ((lane & 7) + ((lane >> 4) << 3)) * LDK + ((lane >> 3) & 1) * 8);
    for (int j = warp; j < SP / 16; j += NT / 32) {
      float acc[2][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kb0 + (16 * j * LDK + 16 * ks) * 2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][0], qa[mt][ks], kb[0], kb[1]);
          mma_bf16(acc[mt][1], qa[mt][ks], kb[2], kb[3]);
        }
      }
      for_each_pair(acc, [&](int r, int c, float v0, float v1) {
        const int s = 16 * j + c;
        sL[r * LS + s] = s < K ? (sMask[s] > 0.f ? v0 * kInvSqrtDh : -1e9f) : -INFINITY;
        sL[r * LS + s + 1] =
            s + 1 < K ? (sMask[s + 1] > 0.f ? v1 * kInvSqrtDh : -1e9f) : -INFINITY;
      });
    }
  }
  __syncthreads();  // logits complete; K is no longer read

  // V of head h into K's buffer, landing while the softmax runs
  for (int i = tid; i < SP * 8; i += NT) {
    const int s = i >> 3, c = (i & 7) * 8;
    const bool ok = s < K;
    cp_async16_zfill(smem_addr(sKV + s * LDK + c),
                     s_rows + (size_t)(ok ? s : 0) * 3 * C + 2 * C + c, ok);
  }
  // softmax, one warp per logit row: max, sum of exp, then the normalized
  // probabilities rounded to bf16, written in place over the row's first half
  for (int r = warp; r < BR; r += NT / 32) {
    float* row = sL + r * LS;
    float m = -INFINITY;
    for (int s = lane; s < SP; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < SP; s += 32) sum += expf(row[s] - m);
    sum = warp_sum(sum);
    auto* prow = reinterpret_cast<__nv_bfloat16*>(row);
    for (int s0 = 0; s0 < SP; s0 += 32) {
      const int s = s0 + lane;
      const float p = s < SP ? expf(row[s] - m) / sum : 0.f;
      __syncwarp();  // bf16 slot s overlays f32 slot s / 2, read in this step or before
      if (s < SP) prow[s] = __float2bfloat16(p);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // V landed; every probability row is written

  {  // msg_h = P V: rows 16 mt.., columns 16 nb.. of the head, into every CTA's message tile
    const int mt = warp >> 2, nb = warp & 3;
    const auto* P = reinterpret_cast<const __nv_bfloat16*>(sL);  // row stride 2 LS
    const uint32_t pa = smem_addr(P + (16 * mt + (lane & 15)) * 2 * LS + (lane >> 4) * 8);
    const uint32_t vb0 =
        smem_addr(sKV + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDK + 16 * nb + (lane >> 4) * 8);
    float acc[1][2][4] = {};
    for (int ks = 0; ks < SP / 16; ++ks) {
      uint32_t a[4], vb[4];
      ldmatrix_x4(a, pa + ks * 16 * 2);
      ldmatrix_x4_trans(vb, vb0 + ks * 16 * LDK * 2);
      mma_bf16(acc[0][0], a, vb[0], vb[1]);
      mma_bf16(acc[0][1], a, vb[2], vb[3]);
    }
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      cluster_store(cluster, sMsg + (16 * mt + r) * LDX + h * DH + 16 * nb + c, v0, v1);
    });
  }
  }
  __syncthreads();  // this CTA is done with P and V: the region takes the MLP tiles
  load_rows_bf16(sXM, LDH, X + (size_t)set * Kq * C, q0, Kq);
  cluster.sync();  // all four heads' messages are in every CTA's sMsg

  {  // merged msg = msg Wm + bm, columns [64 h, 64 h + 64), into every [x | msg] tile
    const int mt = warp >> 2, nb = 4 * h + (warp & 3);
    float acc[1][2][4] = {};
    warp_gemm<1, C / 16>(acc, sMsg + 16 * mt * LDX, LDX, Wm + (size_t)nb * (C / 16) * 32);
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      const int col = 16 * nb + c;
      cluster_store(cluster, sXM + (16 * mt + r) * LDH + C + col, v0 + bm[col],
                    v1 + bm[col + 1]);
    });
  }
  cluster.sync();

  {  // hidden = ReLU((concat[x, msg] W1 + b1) * s1 + t1), columns [128 h, 128 h + 128)
    const int nb = 8 * h + warp;
    float acc[2][2][4] = {};
    warp_gemm<2, 2 * C / 16>(acc, sXM, LDH, W1 + (size_t)nb * (2 * C / 16) * 32);
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      const int col = 16 * nb + c;
      cluster_store(cluster, sH + r * LDH + col, bn_relu(v0 + b1[col], s1[col], t1[col]),
                    bn_relu(v1 + b1[col + 1], s1[col + 1], t1[col + 1]));
    });
  }
  cluster.sync();

  {  // out = x + (hidden W2 + b2), columns [64 h, 64 h + 64)
    const int mt = warp >> 2, nb = 4 * h + (warp & 3);
    float acc[1][2][4] = {};
    warp_gemm<1, 2 * C / 16>(acc, sH + 16 * mt * LDH, LDH, W2 + (size_t)nb * (2 * C / 16) * 32);
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      const int q = q0 + 16 * mt + r, col = 16 * nb + c;
      if (q < Kq) {
        const size_t o = ((size_t)set * Kq + q) * C + col;
        const float2 xv = *reinterpret_cast<const float2*>(X + o);
        *reinterpret_cast<float2*>(OUT + o) =
            make_float2(xv.x + (v0 + b2[col]), xv.y + (v1 + b2[col + 1]));
      }
    });
  }
  // no CTA reads another's shared memory after the last cluster barrier
}

// ------------------------------------------------------------------ f32 mode

constexpr int LDXF = C + 4;      // f32 row stride of 256-wide tiles (1040 B = 65 x 16 B)
constexpr int LDHF = 2 * C + 4;  // 512-wide tiles (2064 B = 129 x 16 B)
constexpr int LDKF = DH + 4;     // Q, K, V rows of one head (272 B = 17 x 16 B)
constexpr int CK_F32 = 64;       // keys per chunk
constexpr int STAGES_F32 = 2;    // chunks in flight: chunk t + 1 lands while chunk t computes
constexpr int KGW_F32 = CK_F32 / KG;  // keys per warp and chunk (16)
constexpr int JT_F32 = KGW_F32 / 8;   // n8 key tiles per warp and chunk (2)
constexpr int STAGE_BYTES_F32 = 2 * CK_F32 * LDKF * 4 + CK_F32 * 4;
constexpr int KF_F32 = 1;  // k-steps (or key tiles) per fresh fragment: 3 MMAs per rounded add

// Dynamic shared memory of layer_f32_kernel, whatever K
// (ops/attention_cuda.f32_smem_bytes mirrors it): the f32 message tile, then
// one region that holds the attention buffers (Q, the ring of K, V and mask
// chunks, the key groups' (max, sum) per row) and later the two MLP tiles.
constexpr int layer_f32_smem() {
  constexpr int attn = BR * LDKF * 4 + STAGES_F32 * STAGE_BYTES_F32 + KG * BR * 2 * 4;
  constexpr int mlp = 2 * BR * LDHF * 4;
  return BR * LDXF * 4 + (attn > mlp ? attn : mlp);
}
static_assert(KGW_F32 % 16 == 0, "each warp takes whole n16 blocks of keys of a chunk");
static_assert(8 % KF_F32 == 0 && JT_F32 % KF_F32 == 0, "whole fragments per trip and chunk");
static_assert(2 * KG * 16 * LDO * 4 <= STAGES_F32 * STAGE_BYTES_F32, "P V partials overlay the ring");
static_assert(layer_f32_smem() <= kSmemLimit, "one f32 layer CTA fits an SM");

// a rounded to tf32 (10 mantissa bits; to nearest, ties away from zero): the
// bits of cvt.rna.tf32.f32 for every finite a, as an integer add and mask,
// which issue faster than the conversion (tests/torch_kernel_phases.py
// --k2-f32)
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// the 3xTF32 operand split a = hi + lo (ops/attention_cuda.split_tf32)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32(const uint32_t (&a)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), hi[i], lo[i]);
}

// d += a (16 x 8 tf32, row major) * b (8 x 8 tf32, column major), f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at f32 accuracy (3xTF32): lo_a hi_b, hi_a lo_b, then hi_a hi_b.
// The tensor core's own f32 accumulation is not rounded to nearest, so a long
// chain of MMAs into one accumulator drifts: d is a fresh fragment of KF_F32
// k-steps, added to the running sum by rounded f32 adds (add_fragment), which
// keeps a long sum as an FMA loop keeps it (tests/torch_kernel_phases.py
// --k2-f32 measures the drift).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void add_fragment(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// acc[mt][tile] = A x B (3xTF32) for this warp's n16 column block: A is MT m16
// tiles of f32 at sA (row stride lda, KSTEPS*8 deep), B the block's packed f32
// fragments Bp[ks * 32 + lane] (ops/attention_cuda.pack_tf32_b), PF k-steps of
// B in flight from L2; KF_F32 k-steps per fresh fragment, in order. The loop
// runs PF k-steps per trip and is not unrolled further: fully unrolled, W1's 64
// k-steps are tens of KB of straight-line code that a CTA runs once, and the
// layer ran 15-25% slower so (tests/torch_kernel_phases.py --k2-f32).
template <int MT, int KSTEPS>
__device__ __forceinline__ void warp_gemm_f32(float (&acc)[MT][2][4], const float* sA, int lda,
                                              const uint4* __restrict__ Bp) {
  constexpr int PF = KSTEPS < 8 ? KSTEPS : 8;
  static_assert(KSTEPS % PF == 0, "whole trips of PF k-steps");
  const int lane = threadIdx.x & 31;
  uint4 b[PF];
#pragma unroll
  for (int i = 0; i < PF; ++i) b[i] = __ldg(Bp + i * 32 + lane);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][tile][e] = 0.f;
  const uint32_t a0 = smem_addr(sA + (lane & 15) * lda + (lane >> 4) * 4);
#pragma unroll 1
  for (int k0 = 0; k0 < KSTEPS; k0 += PF) {
#pragma unroll
    for (int f = 0; f < PF; f += KF_F32) {
      float d[MT][2][4] = {};
#pragma unroll
      for (int i = f; i < f + KF_F32; ++i) {
        const int ks = k0 + i;
        const uint4 bb = b[i];
        if (ks + PF < KSTEPS) b[i] = __ldg(Bp + (ks + PF) * 32 + lane);
        uint32_t bh[4], bl[4];  // n8 tile 0's (b0, b1), then tile 1's
        split_tf32(__uint_as_float(bb.x), bh[0], bl[0]);
        split_tf32(__uint_as_float(bb.y), bh[1], bl[1]);
        split_tf32(__uint_as_float(bb.z), bh[2], bl[2]);
        split_tf32(__uint_as_float(bb.w), bh[3], bl[3]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4], ah[4], al[4];
          ldmatrix_x4(a, a0 + (mt * 16 * lda + ks * 8) * 4);
          split_tf32(a, ah, al);
          mma_3xtf32(d[mt][0], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(d[mt][1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        add_fragment(acc[mt][0], d[mt][0]);
        add_fragment(acc[mt][1], d[mt][1]);
      }
    }
  }
}

// one f32 pair to the same shared-memory address of every CTA in the cluster
__device__ __forceinline__ void cluster_store_f32(cg::cluster_group& cluster, float* p, float v0,
                                                  float v1) {
  const float2 v = make_float2(v0, v1);
#pragma unroll
  for (int q = 0; q < HEADS; ++q) *cluster.map_shared_rank(reinterpret_cast<float2*>(p), q) = v;
}

// rows [row0, row0 + BR) x C of X into an f32 tile, zero beyond nrows
__device__ __forceinline__ void load_rows_f32(float* sA, int lda, const float* __restrict__ X,
                                              int row0, int nrows) {
  for (int i = threadIdx.x; i < BR * C / 4; i += NT) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows)
      v = __ldg(reinterpret_cast<const float4*>(X + (size_t)(row0 + r) * C) + c4);
    *reinterpret_cast<float4*>(sA + r * lda + 4 * c4) = v;
  }
}

// QKV = X Wqkv + bqkv (3xTF32): a 32-row x 128-column tile per CTA, one n16
// column block per warp. Column tiles 0-1 (Q) take X's rows into QX, tiles
// 2-5 (K, V) S's rows into QS; the stacked layer passes X = S.
__global__ void __launch_bounds__(NT)
qkv_f32_kernel(const float* __restrict__ X, int nrows_x, const float* __restrict__ S,
               int nrows_s, const uint4* __restrict__ Wqkv, const float* __restrict__ bqkv,
               float* __restrict__ QX, float* __restrict__ QS) {
  __shared__ __align__(16) float sA[BR * LDXF];
  const bool q_cols = blockIdx.x < C / 128;
  const int nrows = q_cols ? nrows_x : nrows_s;
  float* QKV = q_cols ? QX : QS;
  const int row0 = blockIdx.y * BR;
  if (row0 >= nrows) return;  // the shorter set's row tiles past its end
  load_rows_f32(sA, LDXF, q_cols ? X : S, row0, nrows);
  __syncthreads();
  const int nb = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  float acc[2][2][4];
  warp_gemm_f32<2, C / 8>(acc, sA, LDXF, Wqkv + (size_t)nb * (C / 8) * 32);
  for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    const int row = row0 + r, col = 16 * nb + c;
    if (row < nrows)
      *reinterpret_cast<float2*>(QKV + (size_t)row * 3 * C + col) =
          make_float2(v0 + bqkv[col], v1 + bqkv[col + 1]);
  });
}

// Chunk t of the f32 attention's two passes over n chunks into ring slot t %
// STAGES_F32: K rows (pass 1, t < n) or K and V rows (pass 2) of keys [c0, c0
// + CK_F32) of head h's source, zero past K, and the chunk's source mask; one
// cp.async group per chunk (an empty one past the last chunk).
__device__ __forceinline__ void issue_chunk_f32(unsigned char* ring, int t, int n,
                                                const float* s_rows,
                                                const float* __restrict__ src_mask, int K) {
  if (t < 2 * n) {
    const bool pass2 = t >= n;
    const int c0 = (pass2 ? t - n : t) * CK_F32;
    auto* sK = reinterpret_cast<float*>(ring + (t % STAGES_F32) * STAGE_BYTES_F32);
    float* sV = sK + CK_F32 * LDKF;
    float* sM = sV + CK_F32 * LDKF;
    for (int i = threadIdx.x; i < CK_F32 * (DH / 4); i += NT) {
      const int s = i >> 4, c = (i & 15) * 4;
      const bool ok = c0 + s < K;
      const float* row = s_rows + (size_t)(ok ? c0 + s : 0) * 3 * C;
      cp_async16_zfill(smem_addr(sK + s * LDKF + c), row + C + c, ok);
      if (pass2) cp_async16_zfill(smem_addr(sV + s * LDKF + c), row + 2 * C + c, ok);
    }
    for (int s = threadIdx.x; s < CK_F32; s += NT) {
      const bool ok = c0 + s < K;
      cp_async4_zfill(smem_addr(sM + s), src_mask + (ok ? c0 + s : 0), ok);
    }
  }
  cp_async_commit();
}

// This warp's logits against keys [KGW_F32 kg, KGW_F32 (kg + 1)) of the chunk at
// sK (keys c0..): l[tile][e] is query row g + 8 (e >> 1) of the warp's m16
// tile, key KGW_F32 kg + 8 tile + 2 (lane & 3) + (e & 1) of the chunk; scaled,
// -1e9 on masked keys, -inf past K. K's B fragments come by ldmatrix from its
// rows (keys g, dimensions t and t + 4), two n8 tiles per ldmatrix. Both
// passes compute the same bits.
__device__ __forceinline__ void warp_logits_f32(float (&l)[JT_F32][4], const float* sK,
                                                const float* sM,
                                                const uint32_t (&qh)[DH / 8][4],
                                                const uint32_t (&ql)[DH / 8][4], int kg, int c0,
                                                int K) {
  const int lane = threadIdx.x & 31;
  const uint32_t kb0 = smem_addr(
      sK + (KGW_F32 * kg + (lane & 7) + ((lane >> 4) << 3)) * LDKF + ((lane >> 3) & 1) * 4);
  float acc[JT_F32][4] = {};
#pragma unroll
  for (int f = 0; f < DH / 8; f += KF_F32) {
    float d[JT_F32][4] = {};
#pragma unroll
    for (int ks = f; ks < f + KF_F32; ++ks)
#pragma unroll
      for (int jj = 0; jj < JT_F32 / 2; ++jj) {  // n16 blocks of keys
        uint32_t kb[4], kh[4], kl[4];
        ldmatrix_x4(kb, kb0 + (16 * jj * LDKF + ks * 8) * 4);
        split_tf32(kb, kh, kl);
        mma_3xtf32(d[2 * jj], qh[ks], ql[ks], kh[0], kh[1], kl[0], kl[1]);
        mma_3xtf32(d[2 * jj + 1], qh[ks], ql[ks], kh[2], kh[3], kl[2], kl[3]);
      }
#pragma unroll
    for (int tile = 0; tile < JT_F32; ++tile) add_fragment(acc[tile], d[tile]);
  }
#pragma unroll
  for (int tile = 0; tile < JT_F32; ++tile)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = KGW_F32 * kg + 8 * tile + 2 * (lane & 3) + (e & 1);
      l[tile][e] = c0 + s < K ? (sM[s] > 0.f ? acc[tile][e] * kInvSqrtDh : -1e9f) : -INFINITY;
    }
}

// Head h's f32 attention of the 32-query tile over all K source keys, K and V
// streamed (see the notes at the top), written into columns [64 h, 64 h + 64)
// of every cluster CTA's message tile sMsg. Warp w owns the query rows of m16
// tile w / KG and keys [KGW_F32 (w % KG), +KGW_F32) of every chunk. Contains the cluster
// barrier after which writes to the other CTAs' shared memory are safe.
__device__ __forceinline__ void attention_f32(unsigned char* region, float* sMsg,
                                              const float* q_rows, const float* s_rows,
                                              const float* __restrict__ src_mask, int q0,
                                              int Kq, int K, int h, cg::cluster_group& cluster) {
  auto* sQ = reinterpret_cast<float*>(region);  // BR x LDKF
  unsigned char* ring = region + BR * LDKF * 4;  // STAGES_F32 x (K, V, mask)
  auto* sRed = reinterpret_cast<float2*>(ring + STAGES_F32 * STAGE_BYTES_F32);  // KG x BR
  auto* sO = reinterpret_cast<float*>(ring);  // (BR / 16) x KG x 16 x LDO, once the ring drains
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mt = warp / KG, kg = warp % KG, g = lane >> 2, tq = lane & 3;
  const int n = (K + CK_F32 - 1) / CK_F32;

  for (int i = tid; i < BR * (DH / 4); i += NT) {
    const int r = i >> 4, c = (i & 15) * 4;
    const bool ok = q0 + r < Kq;
    cp_async16_zfill(smem_addr(sQ + r * LDKF + c), q_rows + (size_t)(ok ? q0 + r : 0) * 3 * C + c,
                     ok);
  }
#pragma unroll
  for (int t = 0; t < STAGES_F32 - 1; ++t) issue_chunk_f32(ring, t, n, s_rows, src_mask, K);

  uint32_t qh[DH / 8][4], ql[DH / 8][4];  // the warp's Q rows, split once
  // rows g, g + 8: running max and sum of exp (pass 1), then the final max
  // and the sum's reciprocal (pass 2)
  float rmax[2] = {-INFINITY, -INFINITY}, rsum[2] = {0.f, 0.f}, rinv[2] = {0.f, 0.f};
  float o[DH / 8][4];
#pragma unroll
  for (int nb = 0; nb < DH / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;

  for (int t = 0; t < 2 * n; ++t) {
    cp_async_wait_group<STAGES_F32 - 2>();
    __syncthreads();  // chunk t landed; every warp is done with chunk t - 1's slot
    issue_chunk_f32(ring, t + STAGES_F32 - 1, n, s_rows, src_mask, K);
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < DH / 8; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(sQ + (16 * mt + (lane & 15)) * LDKF + 8 * ks + (lane >> 4) * 4));
        split_tf32(a, qh[ks], ql[ks]);
      }
    }
    if (t == n) {  // the four key groups' (max, sum) of each row, merged in order
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * mt + g + 8 * hr;
        float m = -INFINITY;
#pragma unroll
        for (int q = 0; q < KG; ++q) m = fmaxf(m, sRed[q * BR + row].x);
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < KG; ++q) {
          const float2 p = sRed[q * BR + row];
          s += p.x == -INFINITY ? 0.f : p.y * expf(p.x - m);
        }
        rmax[hr] = m;
        rinv[hr] = 1.f / s;
      }
    }
    const unsigned char* slot = ring + (t % STAGES_F32) * STAGE_BYTES_F32;
    const auto* sK = reinterpret_cast<const float*>(slot);
    const float* sV = sK + CK_F32 * LDKF;
    const float* sM = sV + CK_F32 * LDKF;
    float l[JT_F32][4];
    warp_logits_f32(l, sK, sM, qh, ql, kg, (t < n ? t : t - n) * CK_F32, K);
    if (t < n) {  // pass 1: fold the chunk into the running (max, sum) of rows g, g + 8
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float cm = -INFINITY;
#pragma unroll
        for (int tile = 0; tile < JT_F32; ++tile)
          cm = fmaxf(cm, fmaxf(l[tile][2 * hr], l[tile][2 * hr + 1]));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
        const float m = fmaxf(rmax[hr], cm);
        const float base = m == -INFINITY ? 0.f : m;  // a slice of padding keys only
        float e = 0.f;
#pragma unroll
        for (int tile = 0; tile < JT_F32; ++tile)
          e += expf(l[tile][2 * hr] - base) + expf(l[tile][2 * hr + 1] - base);
        e += __shfl_xor_sync(0xffffffffu, e, 1);
        e += __shfl_xor_sync(0xffffffffu, e, 2);
        rsum[hr] = rsum[hr] * expf(rmax[hr] - base) + e;
        rmax[hr] = m;
      }
      if (t == n - 1 && tq == 0) {
        sRed[kg * BR + 16 * mt + g] = make_float2(rmax[0], rsum[0]);
        sRed[kg * BR + 16 * mt + g + 8] = make_float2(rmax[1], rsum[1]);
      }
    } else {  // pass 2: P = exp(l - max) * (1 / sum) straight from the logits into P V
      uint32_t ah[JT_F32][4], al[JT_F32][4];
#pragma unroll
      for (int tile = 0; tile < JT_F32; ++tile) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = expf(l[tile][e] - rmax[e >> 1]) * rinv[e >> 1];
        // k slot tq <-> key 2 tq, slot tq + 4 <-> key 2 tq + 1: the A fragment
        // (rows g, g + 8) is the accumulator's column pair, reordered
        const uint32_t pa[4] = {__float_as_uint(p[0]), __float_as_uint(p[2]),
                                __float_as_uint(p[1]), __float_as_uint(p[3])};
        split_tf32(pa, ah[tile], al[tile]);
      }
#pragma unroll
      for (int f = 0; f < JT_F32; f += KF_F32)
#pragma unroll
        for (int nb = 0; nb < DH / 8; ++nb) {
          float d[4] = {};
#pragma unroll
          for (int tile = f; tile < f + KF_F32; ++tile) {
            const float* vrow = sV + (KGW_F32 * kg + 8 * tile + 2 * tq) * LDKF + g + 8 * nb;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(vrow[0], bh0, bl0);
            split_tf32(vrow[LDKF], bh1, bl1);
            mma_3xtf32(d, ah[tile], al[tile], bh0, bh1, bl0, bl1);
          }
          add_fragment(o[nb], d);
        }
    }
  }
  cp_async_wait_group<0>();  // the empty trailing groups
  __syncthreads();           // every warp is done with the ring: its partials take the ring's place
  float* ow = sO + (mt * KG + kg) * 16 * LDO;
#pragma unroll
  for (int nb = 0; nb < DH / 8; ++nb)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(ow + (g + 8 * hr) * LDO + 8 * nb + 2 * tq) =
          make_float2(o[nb][2 * hr], o[nb][2 * hr + 1]);
  // the partials are visible to the CTA, and every CTA of the cluster is
  // running before any writes to another's shared memory
  cluster.sync();
  for (int p = tid; p < BR * DH / 2; p += NT) {
    const int row = p / (DH / 2), col = 2 * (p % (DH / 2));
    const float* src = sO + ((row / 16) * KG * 16 + row % 16) * LDO + col;
    float2 acc = *reinterpret_cast<const float2*>(src);
#pragma unroll
    for (int q = 1; q < KG; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(src + q * 16 * LDO);
      acc.x += v.x;
      acc.y += v.y;
    }
    cluster_store_f32(cluster, sMsg + row * LDXF + h * DH + col, acc.x, acc.y);
  }
}

// The rest of the f32 layer for one (set, 32-query tile), by a cluster of 4
// CTAs; CTA h runs head h's attention, then column slice h of the merge, the
// first and the second MLP weight, every product 3xTF32 (see the notes at the
// top). Queries: Kq rows per set of X and QX; keys and values: K rows per set
// of QS, of set (set + shift) mod nsets, under its mask (nsets, K).
__global__ void __cluster_dims__(HEADS, 1, 1) __launch_bounds__(NT, 1)
layer_f32_kernel(const float* __restrict__ X, const float* __restrict__ QX,
                 const float* __restrict__ QS, const float* __restrict__ mask,
                 const uint4* __restrict__ Wm, const float* __restrict__ bm,
                 const uint4* __restrict__ W1, const float* __restrict__ b1,
                 const float* __restrict__ s1, const float* __restrict__ t1,
                 const uint4* __restrict__ W2, const float* __restrict__ b2,
                 float* __restrict__ OUT, int nsets, int Kq, int K, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int h = (int)cluster.block_rank();
  const int q0 = blockIdx.y * BR, set = blockIdx.z;
  const int src = (set + shift) % nsets;
  const int warp = threadIdx.x >> 5;

  auto* sMsg = reinterpret_cast<float*>(smem);  // BR x LDXF, written by every CTA
  unsigned char* region = smem + BR * LDXF * 4;
  auto* sXM = reinterpret_cast<float*>(region);  // BR x LDHF: [x | merged msg]
  float* sH = sXM + BR * LDHF;                   // BR x LDHF: MLP hidden

  attention_f32(region, sMsg, QX + (size_t)set * Kq * 3 * C + h * DH,
                QS + (size_t)src * K * 3 * C + h * DH, mask + (size_t)src * K, q0, Kq, K, h,
                cluster);
  __syncthreads();  // this CTA is done with the ring: the region takes the MLP tiles
  load_rows_f32(sXM, LDHF, X + (size_t)set * Kq * C, q0, Kq);
  cluster.sync();  // all four heads' messages are in every CTA's sMsg

  {  // merged msg = msg Wm + bm, columns [64 h, 64 h + 64), into every [x | msg] tile
    const int mt = warp >> 2, nb = 4 * h + (warp & 3);
    float acc[1][2][4];
    warp_gemm_f32<1, C / 8>(acc, sMsg + 16 * mt * LDXF, LDXF, Wm + (size_t)nb * (C / 8) * 32);
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      const int col = 16 * nb + c;
      cluster_store_f32(cluster, sXM + (16 * mt + r) * LDHF + C + col, v0 + bm[col],
                        v1 + bm[col + 1]);
    });
  }
  cluster.sync();

  {  // hidden = ReLU((concat[x, msg] W1 + b1) * s1 + t1), columns [128 h, 128 h + 128)
    const int nb = 8 * h + warp;
    float acc[2][2][4];
    warp_gemm_f32<2, 2 * C / 8>(acc, sXM, LDHF, W1 + (size_t)nb * (2 * C / 8) * 32);
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      const int col = 16 * nb + c;
      cluster_store_f32(cluster, sH + r * LDHF + col, bn_relu(v0 + b1[col], s1[col], t1[col]),
                        bn_relu(v1 + b1[col + 1], s1[col + 1], t1[col + 1]));
    });
  }
  cluster.sync();

  {  // out = x + (hidden W2 + b2), columns [64 h, 64 h + 64)
    const int mt = warp >> 2, nb = 4 * h + (warp & 3);
    float acc[1][2][4];
    warp_gemm_f32<1, 2 * C / 8>(acc, sH + 16 * mt * LDHF, LDHF,
                                W2 + (size_t)nb * (2 * C / 8) * 32);
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      const int q = q0 + 16 * mt + r, col = 16 * nb + c;
      if (q < Kq) {
        const size_t o = ((size_t)set * Kq + q) * C + col;
        const float2 xv = *reinterpret_cast<const float2*>(X + o);
        *reinterpret_cast<float2*>(OUT + o) =
            make_float2(xv.x + (v0 + b2[col]), xv.y + (v1 + b2[col + 1]));
      }
    });
  }
  // no CTA reads another's shared memory after the last cluster barrier
}

std::atomic<int> layer_bf16_smem_limits[kMaxDevices];
std::atomic<int> layer_bf16_streamed_smem_limits[kMaxDevices];
std::atomic<bool> streamed_carveout_set[kMaxDevices];
std::atomic<int> layer_f32_smem_limits[kMaxDevices];

}  // namespace

RSPL_EXPORT const char* superglue_layer_error_string(int code) {
  if (code == kErrSmem)
    return "K too large for the resident bf16 kernel's shared memory "
           "(ops/attention_cuda.MAX_K_BF16)";
  return cudaGetErrorString((cudaError_t)code);
}

namespace {

// the bf16 mode's two launches: Q of X's rows (nsets x Kq) into qx, K and V of
// S's rows (nsets x K) into qs, then the layer kernel, with the whole logit
// row resident (streamed == 0) or K and V streamed in chunks (streamed != 0)
int bf16_layer(const float* x, const float* src, const float* mask, const void* wqkv,
               const void* bqkv, const void* wm, const void* bm, const void* w1, const void* b1,
               const void* s1, const void* t1, const void* w2, const void* b2,
               __nv_bfloat16* qx, __nv_bfloat16* qs, float* out, int nsets, int Kq, int K,
               int shift, int streamed, cudaStream_t st) {
  const int smem = streamed ? layer_bf16_streamed_smem() : layer_bf16_smem(K);
  if (smem > kSmemLimit) return kErrSmem;
  const void* layer = streamed ? (const void*)layer_bf16_kernel<true>
                               : (const void*)layer_bf16_kernel<false>;
  RSPL_RETURN_IF_ERROR(reserve_dynamic_smem(
      layer, streamed ? layer_bf16_streamed_smem_limits : layer_bf16_smem_limits, smem));
  if (streamed) {  // the whole shared memory to the carveout: two streamed CTAs per SM
    int dev = 0;
    RSPL_RETURN_IF_ERROR(cudaGetDevice(&dev));
    if (dev >= kMaxDevices || !streamed_carveout_set[dev].exchange(true))
      RSPL_RETURN_IF_ERROR(cudaFuncSetAttribute(
          layer, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared));
  }
  const int nrows = nsets * (Kq > K ? Kq : K);
  qkv_bf16_kernel<<<dim3(3 * C / 128, (nrows + BR - 1) / BR), NT, 0, st>>>(
      x, nsets * Kq, src, nsets * K, static_cast<const uint4*>(wqkv),
      static_cast<const float*>(bqkv), qx, qs);
  RSPL_RETURN_IF_ERROR(cudaGetLastError());
  const dim3 grid(HEADS, (Kq + BR - 1) / BR, nsets);
  const auto* wm_ = static_cast<const uint4*>(wm);
  const auto* bm_ = static_cast<const float*>(bm);
  const auto* w1_ = static_cast<const uint4*>(w1);
  const auto* b1_ = static_cast<const float*>(b1);
  const auto* s1_ = static_cast<const float*>(s1);
  const auto* t1_ = static_cast<const float*>(t1);
  const auto* w2_ = static_cast<const uint4*>(w2);
  const auto* b2_ = static_cast<const float*>(b2);
  if (streamed)
    layer_bf16_kernel<true><<<grid, NT, smem, st>>>(x, qx, qs, mask, wm_, bm_, w1_, b1_, s1_,
                                                    t1_, w2_, b2_, out, nsets, Kq, K, shift);
  else
    layer_bf16_kernel<false><<<grid, NT, smem, st>>>(x, qx, qs, mask, wm_, bm_, w1_, b1_, s1_,
                                                     t1_, w2_, b2_, out, nsets, Kq, K, shift);
  return (int)cudaGetLastError();
}

// the f32 mode's two launches: Q of X's rows (nsets x Kq) into qx, K and V of
// S's rows (nsets x K) into qs, then the layer kernel, any K
int f32_layer(const float* x, const float* src, const float* mask, const void* wqkv,
              const void* bqkv, const void* wm, const void* bm, const void* w1, const void* b1,
              const void* s1, const void* t1, const void* w2, const void* b2, float* qx,
              float* qs, float* out, int nsets, int Kq, int K, int shift, cudaStream_t st) {
  constexpr int smem = layer_f32_smem();
  RSPL_RETURN_IF_ERROR(
      reserve_dynamic_smem((const void*)layer_f32_kernel, layer_f32_smem_limits, smem));
  const int nrows = nsets * (Kq > K ? Kq : K);
  qkv_f32_kernel<<<dim3(3 * C / 128, (nrows + BR - 1) / BR), NT, 0, st>>>(
      x, nsets * Kq, src, nsets * K, static_cast<const uint4*>(wqkv),
      static_cast<const float*>(bqkv), qx, qs);
  RSPL_RETURN_IF_ERROR(cudaGetLastError());
  layer_f32_kernel<<<dim3(HEADS, (Kq + BR - 1) / BR, nsets), NT, smem, st>>>(
      x, qx, qs, mask, static_cast<const uint4*>(wm), static_cast<const float*>(bm),
      static_cast<const uint4*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(s1), static_cast<const float*>(t1),
      static_cast<const uint4*>(w2), static_cast<const float*>(b2), out, nsets, Kq, K, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 mode. x (nsets, K, 256) f32; mask (nsets, K) f32 (1 valid, 0 padded);
// wqkv (256 x 768) = [Wq | Wk | Wv], wm (256 x 256), w1 (512 x 512), w2 (512 x
// 256) packed by ops/attention_cuda.pack_tf32_b (f32); bqkv (768,), bm (256,),
// b1, s1, t1 (512,), b2 (256,) f32; scratch qkv (nsets*K, 768) f32; out
// (nsets, K, 256). 4 heads of 64. cross != 0 attends to the other half of
// the stack. Two launches, any K.
RSPL_EXPORT int superglue_layer_launch(const void* x, const void* mask, const void* wqkv,
                                       const void* bqkv, const void* wm, const void* bm,
                                       const void* w1, const void* b1, const void* s1,
                                       const void* t1, const void* w2, const void* b2,
                                       void* qkv, void* out, int nsets, int K, int cross,
                                       void* stream) {
  const auto* xf = static_cast<const float*>(x);
  auto* q = static_cast<float*>(qkv);
  return f32_layer(xf, xf, static_cast<const float*>(mask), wqkv, bqkv, wm, bm, w1, b1, s1, t1,
                   w2, b2, q, q, static_cast<float*>(out), nsets, K, K, cross ? nsets / 2 : 0,
                   (cudaStream_t)stream);
}

// bf16 mode. x (nsets, K, 256) f32; mask (nsets, K) f32 (1 valid, 0 padded);
// wqkv (256 x 768), wm (256 x 256), w1 (512 x 512), w2 (512 x 256) packed by
// ops/attention_cuda.pack_mma_b (bf16); bqkv, bm, b1, s1, t1, b2 f32; scratch
// qkv (nsets*K, 768) bf16; out (nsets, K, 256) f32. streamed != 0 takes the
// streamed attention (any K), else the resident one (K <= MAX_K_BF16). Two
// launches.
RSPL_EXPORT int superglue_layer_bf16_launch(const void* x, const void* mask, const void* wqkv,
                                            const void* bqkv, const void* wm, const void* bm,
                                            const void* w1, const void* b1, const void* s1,
                                            const void* t1, const void* w2, const void* b2,
                                            void* qkv, void* out, int nsets, int K, int cross,
                                            int streamed, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  auto* q = static_cast<__nv_bfloat16*>(qkv);
  return bf16_layer(xf, xf, static_cast<const float*>(mask), wqkv, bqkv, wm, bm, w1, b1, s1, t1,
                    w2, b2, q, q, static_cast<float*>(out), nsets, K, K, cross ? nsets / 2 : 0,
                    streamed, (cudaStream_t)stream);
}

// Two-set variant, f32 mode: x (B, M, 256) attends over src (B, N, 256) under
// src_mask (B, N) f32. Scratch qkv_x (B*M, 768) f32, whose Q columns are
// written, qkv_s (B*N, 768) f32, whose K and V columns are written (the same
// buffer when src is x); out (B, M, 256). Weights as superglue_layer_launch.
// Two launches, any N.
RSPL_EXPORT int superglue_layer_two_set_launch(const void* x, const void* src,
                                               const void* src_mask, const void* wqkv,
                                               const void* bqkv, const void* wm, const void* bm,
                                               const void* w1, const void* b1, const void* s1,
                                               const void* t1, const void* w2, const void* b2,
                                               void* qkv_x, void* qkv_s, void* out, int B, int M,
                                               int N, void* stream) {
  return f32_layer(static_cast<const float*>(x), static_cast<const float*>(src),
                   static_cast<const float*>(src_mask), wqkv, bqkv, wm, bm, w1, b1, s1, t1, w2,
                   b2, static_cast<float*>(qkv_x), static_cast<float*>(qkv_s),
                   static_cast<float*>(out), B, M, N, 0, (cudaStream_t)stream);
}

// Two-set variant, bf16 mode: as superglue_layer_two_set_launch with the
// weights packed as superglue_layer_bf16_launch takes them and bf16 scratch
// qkv_x (B*M, 768), qkv_s (B*N, 768); streamed as
// superglue_layer_bf16_launch. Two launches.
RSPL_EXPORT int superglue_layer_two_set_bf16_launch(const void* x, const void* src,
                                                    const void* src_mask, const void* wqkv,
                                                    const void* bqkv, const void* wm,
                                                    const void* bm, const void* w1,
                                                    const void* b1, const void* s1,
                                                    const void* t1, const void* w2,
                                                    const void* b2, void* qkv_x, void* qkv_s,
                                                    void* out, int B, int M, int N,
                                                    int streamed, void* stream) {
  return bf16_layer(static_cast<const float*>(x), static_cast<const float*>(src),
                    static_cast<const float*>(src_mask), wqkv, bqkv, wm, bm, w1, b1, s1, t1, w2,
                    b2, static_cast<__nv_bfloat16*>(qkv_x), static_cast<__nv_bfloat16*>(qkv_s),
                    static_cast<float*>(out), B, M, N, 0, streamed, (cudaStream_t)stream);
}
