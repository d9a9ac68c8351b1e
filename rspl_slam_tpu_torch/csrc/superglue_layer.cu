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
// models/superglue.py:292-304 does. Everything is f32, as in the TPU kernel.
//
// What bounds it on the H100: at K = S = 400, C = 256 one launch of the
// three covers 2 x 400 rows: 1.38 GFLOP in f32 (20.5 us at the 67 TFLOP/s
// non-tensor peak) against ~4.3 MB of weights and activations (1.3 us), so
// f32 arithmetic bounds it.
//
// Design: one CTA per set (the TPU design) would leave 130 of 132 SMs idle,
// so the layer is three launches that each spread over the card:
//   1. qkv_kernel: the QKV projection over all 2B*K rows, 16 rows per CTA;
//      each thread owns 3 output columns x 16 rows and streams the weight
//      rows (coalesced, L2 resident) against the row tile held in shared
//      memory (float4 broadcast reads).
//   2. attn_kernel: one CTA per (set, head, 16-query tile): the 16 x S
//      logits live in shared memory, K and V stream through in 64-row
//      chunks (row stride 65 against bank conflicts), the masked softmax
//      reduces over 16-lane groups with shuffles.
//   3. mlp_kernel: merge + the split first MLP weight + folded BN/ReLU + the
//      second MLP weight + residual, 16 rows per CTA with every intermediate
//      row in shared memory (80 KB, dynamic).
// Plain FMA throughout; a tensor-core (TF32/bf16 wgmma) redesign is queued.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA; also the model width C
constexpr int R = 16;    // rows per CTA (kernels 1 and 3), queries per CTA (kernel 2)
constexpr int C = 256;
constexpr int DH = 64;   // head width (C / 4 heads)
constexpr int CH = 64;   // source rows per K/V chunk
constexpr int KS = DH + 1;

// acc[r][c] += sum_k sA[r * lda + k] * W[k * ldw + n0 + c * NT], k < Kd (Kd % 4 == 0)
template <int NC>
__device__ __forceinline__ void rowtile_mac(float (&acc)[R][NC], const float* sA, int lda,
                                            int Kd, const float* __restrict__ W, int ldw,
                                            int n0) {
#pragma unroll 1
  for (int k = 0; k < Kd; k += 4) {
    float wv[4][NC];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) wv[kk][c] = __ldg(W + (size_t)(k + kk) * ldw + n0 + c * NT);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(sA + r * lda + k);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float s = acc[r][c];
        s = fmaf(a.x, wv[0][c], s);
        s = fmaf(a.y, wv[1][c], s);
        s = fmaf(a.z, wv[2][c], s);
        s = fmaf(a.w, wv[3][c], s);
        acc[r][c] = s;
      }
    }
  }
}

// load rows [row0, row0 + R) x C of X into sX (zero beyond nrows)
__device__ __forceinline__ void load_rows(float* sX, const float* __restrict__ X, int row0,
                                          int nrows) {
  const int tid = threadIdx.x;
  for (int i = tid; i < R * C / 4; i += NT) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) v = reinterpret_cast<const float4*>(X + (size_t)(row0 + r) * C)[c4];
    reinterpret_cast<float4*>(sX + r * C)[c4] = v;
  }
}

__global__ void __launch_bounds__(NT)
qkv_kernel(const float* __restrict__ X, const float* __restrict__ Wqkv,
           const float* __restrict__ bqkv, float* __restrict__ QKV, int nrows) {
  __shared__ __align__(16) float sX[R * C];
  const int row0 = blockIdx.x * R;
  load_rows(sX, X, row0, nrows);
  __syncthreads();
  float acc[R][3];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[r][c] = 0.f;
  const int n0 = threadIdx.x;
  rowtile_mac<3>(acc, sX, C, C, Wqkv, 3 * C, n0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float bb = bqkv[n0 + c * NT];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (row0 + r < nrows) QKV[(size_t)(row0 + r) * 3 * C + n0 + c * NT] = acc[r][c] + bb;
  }
}

__global__ void __launch_bounds__(NT)
attn_kernel(const float* __restrict__ QKV, const float* __restrict__ mask,
            float* __restrict__ MSG, int nsets, int K, int cross) {
  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;              // R x DH
  float* sKV = sQ + R * DH;    // CH x KS
  float* sL = sKV + CH * KS;   // R x K logits / probabilities

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * R;
  const int h = blockIdx.y;
  const int set = blockIdx.z;
  const int src = cross ? (set + nsets / 2) % nsets : set;
  const float* msk = mask + (size_t)src * K;
  const float scale = rsqrtf((float)DH);
  const int r = tid >> 4, l16 = tid & 15;

  for (int i = tid; i < R * DH; i += NT) {
    const int rr = i / DH, d = i % DH;
    sQ[i] = (q0 + rr < K) ? QKV[(size_t)(set * K + q0 + rr) * 3 * C + h * DH + d] : 0.f;
  }

  for (int s0 = 0; s0 < K; s0 += CH) {
    __syncthreads();  // sQ ready / previous chunk consumed
    for (int i = tid; i < CH * DH; i += NT) {
      const int s = i / DH, d = i % DH;
      sKV[s * KS + d] =
          (s0 + s < K) ? QKV[(size_t)(src * K + s0 + s) * 3 * C + C + h * DH + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CH / 16; ++j) {
      const int s = l16 + 16 * j;
      if (s0 + s < K) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) dot = fmaf(sQ[r * DH + d], sKV[s * KS + d], dot);
        sL[r * K + s0 + s] = (msk[s0 + s] > 0.f) ? dot * scale : -1e9f;
      }
    }
  }
  __syncthreads();

  // masked softmax per query row: 16 threads per row (one half-warp)
  float mx = -INFINITY;
  for (int s = l16; s < K; s += 16) mx = fmaxf(mx, sL[r * K + s]);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
  float sum = 0.f;
  for (int s = l16; s < K; s += 16) {
    const float e = expf(sL[r * K + s] - mx);
    sL[r * K + s] = e;
    sum += e;
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
  const float inv = 1.f / sum;
  for (int s = l16; s < K; s += 16) sL[r * K + s] *= inv;

  float acc[DH / 16] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < K; s0 += CH) {
    __syncthreads();  // probabilities written / previous chunk consumed
    for (int i = tid; i < CH * DH; i += NT) {
      const int s = i / DH, d = i % DH;
      sKV[s * KS + d] =
          (s0 + s < K) ? QKV[(size_t)(src * K + s0 + s) * 3 * C + 2 * C + h * DH + d] : 0.f;
    }
    __syncthreads();
    const int n = min(CH, K - s0);
    for (int s = 0; s < n; ++s) {
      const float p = sL[r * K + s0 + s];
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) acc[j] = fmaf(p, sKV[s * KS + l16 + 16 * j], acc[j]);
    }
  }
  if (q0 + r < K) {
#pragma unroll
    for (int j = 0; j < DH / 16; ++j)
      MSG[(size_t)(set * K + q0 + r) * C + h * DH + l16 + 16 * j] = acc[j];
  }
}

__global__ void __launch_bounds__(NT)
mlp_kernel(const float* __restrict__ X, const float* __restrict__ MSG,
           const float* __restrict__ Wm, const float* __restrict__ bm,
           const float* __restrict__ W1, const float* __restrict__ b1,
           const float* __restrict__ s1, const float* __restrict__ t1,
           const float* __restrict__ W2, const float* __restrict__ b2,
           float* __restrict__ OUT, int nrows) {
  extern __shared__ __align__(16) float sm[];
  float* sX = sm;            // R x C
  float* sM = sX + R * C;    // R x C  (raw message)
  float* sM2 = sM + R * C;   // R x C  (merged message)
  float* sH = sM2 + R * C;   // R x 2C (hidden)
  const int row0 = blockIdx.x * R;
  const int n0 = threadIdx.x;
  load_rows(sX, X, row0, nrows);
  load_rows(sM, MSG, row0, nrows);
  __syncthreads();

  {  // merge projection
    float acc[R][1];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = 0.f;
    rowtile_mac<1>(acc, sM, C, C, Wm, C, n0);
    const float bb = bm[n0];
#pragma unroll
    for (int r = 0; r < R; ++r) sM2[r * C + n0] = acc[r][0] + bb;
  }
  __syncthreads();
  {  // first MLP layer over concat[x, msg] with the weight split in two
    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
    rowtile_mac<2>(acc, sX, C, C, W1, 2 * C, n0);
    rowtile_mac<2>(acc, sM2, C, C, W1 + (size_t)C * 2 * C, 2 * C, n0);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + c * NT;
      const float bb = b1[n], sc = s1[n], sh = t1[n];
#pragma unroll
      for (int r = 0; r < R; ++r) sH[r * 2 * C + n] = fmaxf((acc[r][c] + bb) * sc + sh, 0.f);
    }
  }
  __syncthreads();
  {  // second MLP layer + residual
    float acc[R][1];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = 0.f;
    rowtile_mac<1>(acc, sH, 2 * C, 2 * C, W2, C, n0);
    const float bb = b2[n0];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (row0 + r < nrows)
        OUT[(size_t)(row0 + r) * C + n0] = sX[r * C + n0] + acc[r][0] + bb;
  }
}

}  // namespace

RSPL_EXPORT const char* superglue_layer_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (nsets, K, 256) f32; mask (nsets, K) f32 (1 valid, 0 padded);
// wqkv (256, 768) = [Wq | Wk | Wv], bqkv (768,); wm (256, 256), bm (256,);
// w1 (512, 512), b1, s1, t1 (512,); w2 (512, 256), b2 (256,);
// scratch qkv (nsets*K, 768) and msg (nsets*K, 256); out (nsets, K, 256).
// 4 heads of 64. cross != 0 attends to the other half of the stack.
RSPL_EXPORT int superglue_layer_launch(const void* x, const void* mask, const void* wqkv,
                                       const void* bqkv, const void* wm, const void* bm,
                                       const void* w1, const void* b1, const void* s1,
                                       const void* t1, const void* w2, const void* b2,
                                       void* qkv, void* msg, void* out, int nsets, int K,
                                       int cross, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nrows = nsets * K;
  const int row_blocks = (nrows + R - 1) / R;
  qkv_kernel<<<row_blocks, NT, 0, st>>>(static_cast<const float*>(x),
                                         static_cast<const float*>(wqkv),
                                         static_cast<const float*>(bqkv),
                                         static_cast<float*>(qkv), nrows);
  RSPL_RETURN_IF_ERROR(cudaGetLastError());

  const int attn_smem = (R * DH + CH * KS + R * K) * (int)sizeof(float);
  RSPL_RETURN_IF_ERROR(cudaFuncSetAttribute(
      attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, attn_smem));
  const dim3 agrid((K + R - 1) / R, C / DH, nsets);
  attn_kernel<<<agrid, NT, attn_smem, st>>>(static_cast<const float*>(qkv),
                                            static_cast<const float*>(mask),
                                            static_cast<float*>(msg), nsets, K, cross);
  RSPL_RETURN_IF_ERROR(cudaGetLastError());

  const int mlp_smem = (3 * R * C + R * 2 * C) * (int)sizeof(float);
  RSPL_RETURN_IF_ERROR(cudaFuncSetAttribute(
      mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mlp_smem));
  mlp_kernel<<<row_blocks, NT, mlp_smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(msg),
      static_cast<const float*>(wm), static_cast<const float*>(bm),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(s1), static_cast<const float*>(t1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(out), nrows);
  return (int)cudaGetLastError();
}
