// K1: fused 3x3 conv (64 -> 64 channels) + bias + ReLU + 2x2 max-pool, with
// an optional side output: the full-resolution f32 map
// side[b, y, x] = sum_c side_w[c] * ReLU(conv(x) + bias)[b, y, x, c].
//
// Replaces the Pallas TPU kernel rspl_slam_tpu/ops/conv_stem_pallas.py
// (_conv_kernel, launched by conv3x3_nhcw), used by SuperPoint's conv1b
// (superpoint_stem) and RCF's conv1_2 with its stage-1 side score.
//
// What bounds it on the H100: at SuperPoint's conv1b shape (2 x 480 x 752 x
// 64 bf16 in) the layer is 53.2 GFLOP against 115 MB of compulsory traffic,
// so arithmetic bounds it (54 us at the bf16 tensor-core peak, 34 us of
// bytes). This first version computes in f32 FMA (67 TFLOP/s peak, i.e.
// >= 0.8 ms) and leaves the tensor cores to a later redesign (wgmma on a
// 576-deep implicit GEMM).
//
// Design: activations are NHWC bf16 (64 ch x 2 B = 128 B per pixel, 16-B
// vector loads), not the NHCW layout, lane rolls or 16-row tiles of the TPU
// kernel, which were Mosaic artefacts. A CTA of 256 threads owns a 16 x 16
// output tile: it stages the (18 x 18 x 64) bf16 halo once in shared memory
// (zero padded at the image border = SAME padding; channel stride padded
// to 66 to spread banks) and the 9 x 64 x 64 f32 weights (147 KB, dynamic
// shared memory above 48 KB). Each thread owns one 2x2 pool window x 16
// output channels (64 f32 accumulators): per input channel it reads its
// 4x4 input window once and reuses it for all 9 taps, and the 16 weights of
// a (tap, channel) are a warp-uniform broadcast read. The epilogue applies
// bias and ReLU in f32, reduces the side dot at full resolution across the
// four channel groups through shared memory, and takes the whole 2x2 max
// before rounding to bf16. Ragged tiles (e.g. 360-row half-scale images)
// are masked in the kernel.
#include "common.cuh"

namespace {

constexpr int C = 64;
constexpr int TH = 16, TW = 16;          // output pixels per CTA
constexpr int HH = TH + 2, HW = TW + 2;  // halo tile
constexpr int CS = C + 2;                // padded channel stride of the halo (bf16)
constexpr int NT = 256;
constexpr int W_FLOATS = 9 * C * C;
constexpr int SMEM_W = W_FLOATS * 4;
constexpr int SMEM_IN = HH * HW * CS * 2;
constexpr int SMEM_SIDE = 4 * 64 * 4 * 4;
constexpr int SMEM = SMEM_W + SMEM_IN + SMEM_SIDE;

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__global__ void __launch_bounds__(NT, 1)
conv3x3_relu_pool_kernel(const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ side_w,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ side_out, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_w = reinterpret_cast<float*>(smem);
  uint16_t* s_in = reinterpret_cast<uint16_t*>(smem + SMEM_W);
  float* s_side = reinterpret_cast<float*>(smem + SMEM_W + SMEM_IN);

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  const float4* w4 = reinterpret_cast<const float4*>(w);
  float4* s_w4 = reinterpret_cast<float4*>(s_w);
  for (int i = tid; i < W_FLOATS / 4; i += NT) s_w4[i] = w4[i];

  // halo: HH*HW pixels, each 64 bf16 = 8 x uint4
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  for (int i = tid; i < HH * HW * 8; i += NT) {
    const int p = i >> 3, q = i & 7;
    const int hy = p / HW, hx = p - hy * HW;
    const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = x4[(((size_t)b * H + gy) * W + gx) * 8 + q];
    uint32_t* dst = reinterpret_cast<uint32_t*>(s_in + p * CS + q * 8);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();

  const int g = tid >> 6;  // 16-channel output group, warp-uniform
  const int cell = tid & 63;
  const int pr = cell >> 3, pc = cell & 7;  // pool window within the tile

  float acc[4][16];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[p][j] = 0.f;

  const uint16_t* base = s_in + ((2 * pr) * HW + 2 * pc) * CS;
#pragma unroll 1
  for (int c2 = 0; c2 < C / 2; ++c2) {
    uint32_t win[4][4];  // 4x4 input window, channels (2*c2, 2*c2+1)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        win[r][c] = *reinterpret_cast<const uint32_t*>(base + (r * HW + c) * CS + 2 * c2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float xin[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) xin[r][c] = h ? bf_hi(win[r][c]) : bf_lo(win[r][c]);
      const int ci = 2 * c2 + h;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) {
          const float4* wp =
              reinterpret_cast<const float4*>(s_w + ((a * 3 + bb) * C + ci) * C + g * 16);
          const float4 t0 = wp[0], t1 = wp[1], t2 = wp[2], t3 = wp[3];
          const float wv[16] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w,
                                t2.x, t2.y, t2.z, t2.w, t3.x, t3.y, t3.z, t3.w};
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
              const float v = xin[dy + a][dx + bb];
#pragma unroll
              for (int j = 0; j < 16; ++j) acc[dy * 2 + dx][j] = fmaf(v, wv[j], acc[dy * 2 + dx][j]);
            }
        }
    }
  }

  const int Ho = H >> 1, Wo = W >> 1;
  const int py = blockIdx.y * (TH / 2) + pr, px = blockIdx.x * (TW / 2) + pc;
  const bool valid = (py < Ho) && (px < Wo);
  float sp[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t pk[8];
#pragma unroll
  for (int j2 = 0; j2 < 8; ++j2) {
    float m[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * j2 + e;
      const int co = g * 16 + j;
      const float bj = bias[co];
      float v[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) v[p] = fmaxf(acc[p][j] + bj, 0.f);
      if (side_w != nullptr) {
        const float s = side_w[co];
#pragma unroll
        for (int p = 0; p < 4; ++p) sp[p] = fmaf(s, v[p], sp[p]);
      }
      m[e] = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
    }
    __nv_bfloat162 h2 = __floats2bfloat162_rn(m[0], m[1]);
    pk[j2] = *reinterpret_cast<uint32_t*>(&h2);
  }
  if (valid) {
    uint4* dst = reinterpret_cast<uint4*>(out + (((size_t)b * Ho + py) * Wo + px) * C + g * 16);
    dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
  }
  if (side_out != nullptr) {  // uniform across the CTA
#pragma unroll
    for (int p = 0; p < 4; ++p) s_side[(g * 64 + cell) * 4 + p] = sp[p];
    __syncthreads();
    if (g == 0 && valid) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float s = s_side[cell * 4 + p] + s_side[(64 + cell) * 4 + p] +
                        s_side[(128 + cell) * 4 + p] + s_side[(192 + cell) * 4 + p];
        const int yy = 2 * py + (p >> 1), xx = 2 * px + (p & 1);
        side_out[((size_t)b * H + yy) * W + xx] = s;
      }
    }
  }
}

}  // namespace

RSPL_EXPORT const char* conv_stem_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (B, H, W, 64) bf16 NHWC; w (9, 64, 64) f32 [tap][c_in][c_out];
// bias (64,) f32; side_w (64,) f32 or null; out (B, H/2, W/2, 64) bf16;
// side_out (B, H, W) f32 or null (both null or both set). H, W even.
RSPL_EXPORT int conv_stem_launch(const void* x, const void* w, const void* bias,
                                 const void* side_w, void* out, void* side_out, int B,
                                 int H, int W, void* stream) {
  RSPL_RETURN_IF_ERROR(cudaFuncSetAttribute(
      conv3x3_relu_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
  const dim3 grid((W / 2 + TW / 2 - 1) / (TW / 2), (H / 2 + TH / 2 - 1) / (TH / 2), B);
  conv3x3_relu_pool_kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(side_w),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(side_out), H, W);
  return (int)cudaGetLastError();
}
