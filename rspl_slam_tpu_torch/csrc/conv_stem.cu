// K1: fused 3x3 conv (64 -> 64 channels) + bias + ReLU + 2x2 max-pool, with
// an optional side output: the full-resolution f32 map
// side[b, y, x] = sum_c side_w[c] * ReLU(conv(x) + bias)[b, y, x, c].
//
// Replaces the Pallas TPU kernel rspl_slam_tpu/ops/conv_stem_pallas.py
// (_conv_kernel, launched by conv3x3_nhcw), used by SuperPoint's conv1b
// (superpoint_stem) and RCF's conv1_2 with its stage-1 side score.
//
// Numeric contract (the TPU kernel's): bf16 activations and weights, f32
// products and sums; bias, ReLU, pool and the side dot in f32; the pooled
// output rounds to bf16. Tensor-core bf16 x bf16 -> f32 MMAs compute that
// function; only the summation order differs.
//
// What bounds it on the H100: at SuperPoint's conv1b shape (2 x 480 x 752 x
// 64 bf16 in) the layer is 53.2 GFLOP against 115 MB of compulsory traffic,
// so the tensor cores bound it (54 us at the bf16 peak, 34 us of bytes).
//
// Activations are NHWC bf16 (128 B per pixel); the TPU kernel's NHCW
// layout, lane rolls and 16-row tiles were Mosaic artefacts.
//
// Design: an implicit GEMM, M = output pixels, N = 64 output channels,
// K = 576 = 9 taps x 64 input channels in the TPU's im2col order
// (a*3 + b)*64 + c_in, on wgmma.m64n64k16 (bf16 -> f32) with A from
// registers and B from shared memory. A (the activations) is gathered by
// ldmatrix, which takes one row address per lane, so a shifted 3x3 tap
// window over the halo tile costs nothing; a shared-memory descriptor
// would need uniformly strided 8-row core matrices, which a tap window is
// not. B (the weights) is the same for every tile, so it sits once in
// shared memory in wgmma's canonical layout and the hardware reads it once
// per warpgroup rather than once per warp as mma.sync would (an
// mma.sync.m16n8k16 version of this kernel was limited by its issue rate,
// at 0.146 ms on an H100 SXM at 700 W, against 0.106 ms for this one).
//  - Weights: packed once per weight tensor by the wrapper, bf16 in
//    K-major core-matrix order [c_out / 8][576 / 8][8][8] (no swizzle),
//    72 KB resident in shared memory.
//  - Persistent CTAs, one per SM (156 KB of shared memory), each walking
//    16 x 16 output tiles. The (18 x 18 x 64) bf16 halo is double buffered
//    and arrives as one TMA tensor copy per tile, issued by one thread and
//    completed on an mbarrier; the next tile's copy overlaps this tile's
//    MMAs, and TMA's zero fill of out-of-image pixels is the SAME padding
//    (16-B cp.async copies issued by all threads were slower). The copy
//    uses the 128-byte swizzle, so 8 consecutive pixels of an ldmatrix
//    phase (128 B apart) hit 8 distinct bank groups.
//  - 8 warps = 2 warpgroups; warp w owns output rows 2w and 2w+1 of the
//    tile and all 64 channels: two m16 row blocks, each 8 columns of row 2w
//    followed by the same 8 columns of row 2w+1. Per k-step of 16 a
//    warpgroup issues two m64n64k16 (one per row block) and loads the next
//    step's A fragments while they run (two register buffers).
//  - Epilogue in registers: accumulator rows g and g+8 are vertical
//    neighbours (same thread) and the horizontal neighbour sits in lane ^4,
//    so the 2x2 max-pool is one max and one __shfl_xor_sync; the side
//    score's 64-channel dot is a quad reduction (lanes ^1, ^2) over the
//    warp's eight n8 column blocks. Ragged tiles (the side mode's 376-wide
//    map, 360-row half-scale images) are masked at the stores.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int C = 64;
constexpr int TILE = 16;                    // output pixels per tile side
constexpr int HALO = TILE + 2;              // halo tile side
constexpr int KDIM = 9 * C;                 // GEMM depth
constexpr int NT = 256;                     // 8 warps
constexpr int SMEM_W = C * KDIM * 2;        // 73,728 B, core-matrix order
constexpr int HALO_BYTES = HALO * HALO * C * 2;      // 41,472 B (TMA box)
constexpr int SMEM_HALO = 41 * 1024;                  // buffer stride, 1 KB aligned
constexpr int SMEM = 1024 + SMEM_W + 2 * SMEM_HALO + 16;  // + alignment, 2 mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One tile's (64 ch, 18, 18, 1) halo box in a single TMA copy; pixels
// outside the image arrive as zeros (SAME padding).
__device__ __forceinline__ void tma_halo(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int x0, int y0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(x0), "r"(y0), "r"(b), "r"(bar)
      : "memory");
}

// wgmma B operand descriptor: K-major, no swizzle. Core matrices of 8 rows
// x 16 B, stored as 128 contiguous bytes; LBO = stride between core
// matrices along K (128 B), SBO = stride along N (72 x 128 B).
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)(128 >> 4) << 16;
  d |= (uint64_t)((KDIM / 8) * 128 >> 4) << 32;
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the accumulators in place across the asynchronous wgmma
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, f32) += A (64 x 16 bf16, registers) * B (16 x 64 bf16, descriptor)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

struct TileCoord {
  int b, ty, tx;
};

__device__ __forceinline__ TileCoord tile_coord(int tile, int tiles_x, int tiles_y) {
  const int tx = tile % tiles_x;
  const int rest = tile / tiles_x;
  return TileCoord{rest / tiles_y, rest % tiles_y, tx};
}

template <bool SIDE>
__global__ void __launch_bounds__(NT, 1)
conv3x3_relu_pool_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __nv_bfloat16* __restrict__ wp,
                         const float* __restrict__ bias,
                         const float* __restrict__ side_w,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ side_out, int B, int H, int W) {
  // [pad to 1 KB] weights | halo x 2 | 2 mbarriers
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_w = (smem_addr(smem) + 1023u) & ~1023u;  // 128B swizzle atoms
  const uint32_t s_halo0 = s_w + SMEM_W;
  const uint32_t s_bar = s_halo0 + 2 * SMEM_HALO;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  const int ntiles = tiles_x * tiles_y * B;
  const int Ho = H >> 1, Wo = W >> 1;

  // this thread's channels in the epilogue: n8 tile nt, channels 2*t4, +1
  float bias_r[8][2], sw_r[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bias_r[nt][e] = bias[nt * 8 + 2 * t4 + e];
      sw_r[nt][e] = SIDE ? side_w[nt * 8 + 2 * t4 + e] : 0.f;
    }

  auto load_halo = [&](int t, int bf) {
    const TileCoord c = tile_coord(t, tiles_x, tiles_y);
    mbar_expect_tx(s_bar + 8 * bf, HALO_BYTES);
    tma_halo(s_halo0 + bf * SMEM_HALO, &x_map, s_bar + 8 * bf, c.tx * TILE - 1,
             c.ty * TILE - 1, c.b);
  };
  int tile = blockIdx.x;
  if (tid == 0) {
    mbar_init(s_bar);
    mbar_init(s_bar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (tile < ntiles) load_halo(tile, 0);
  }
  // weights once, then visible to wgmma (the async proxy)
  for (int i = tid; i < SMEM_W / 16; i += NT) cp_async16(s_w + i * 16, wp + i * 8);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // ldmatrix row address of this lane for A row block mt: row r = lane & 15
  // is pixel (2*warp + r / 8, 8*mt + r % 8) of the tile (its halo index at
  // tap (0, 0)), 16-B channel chunk lane / 16 of the k-step.
  int a_pix[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    a_pix[mt] = (2 * warp + ((lane >> 3) & 1)) * HALO + 8 * mt + (lane & 7);
  const int a_chunk = lane >> 4;

  int buf = 0;
  uint32_t phase = 0;  // bit b: parity of buffer b's next completion
  for (; tile < ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (tid == 0 && next < ntiles) load_halo(next, buf ^ 1);
    mbar_wait(s_bar + 8 * buf, (phase >> buf) & 1);
    phase ^= 1u << buf;
    float acc[2][32];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[mt][e] = 0.f;

    const uint32_t s_halo = s_halo0 + buf * SMEM_HALO;
    uint32_t af[2][2][4];
    auto load_a = [&](int ks, int st) {
      const int tap = ks >> 2, kc = ks & 3;
      const int tap_pix = (tap / 3) * HALO + tap % 3;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = a_pix[mt] + tap_pix;  // 128B swizzle: chunk ^ (pixel % 8)
        ldmatrix_x4(af[st][mt], s_halo + p * 128 + (((2 * kc + a_chunk) ^ (p & 7)) << 4));
      }
    };
    load_a(0, 0);
    reg_fence(acc[0]);
    reg_fence(acc[1]);
#pragma unroll
    for (int ks = 0; ks < KDIM / 16; ++ks) {
      wg_fence();
      const uint64_t desc = wg_desc(s_w + ks * 256);
      wgmma_m64n64k16(acc[0], af[ks & 1][0], desc);
      wgmma_m64n64k16(acc[1], af[ks & 1][1], desc);
      wg_commit();
      if (ks + 1 < KDIM / 16) {  // the group of step ks - 1 has read the other buffer
        wg_wait<1>();
        load_a(ks + 1, (ks + 1) & 1);
      }
    }
    wg_wait<0>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    __syncthreads();  // every warp is done with this halo: the next load may reuse it

    // epilogue: accumulator e = 0, 1 is pixel (2*warp, 8*mt + g), e = 2, 3
    // pixel (2*warp + 1, 8*mt + g); channels nt*8 + 2*t4 + (e & 1)
    const TileCoord tc = tile_coord(tile, tiles_x, tiles_y);
    const int py = tc.ty * (TILE / 2) + warp;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float s_top = 0.f, s_bot = 0.f;
      uint32_t pk[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = fmaxf(acc[mt][4 * nt + e] + bias_r[nt][e & 1], 0.f);
        if (SIDE) {
          s_top = fmaf(sw_r[nt][0], v[0], fmaf(sw_r[nt][1], v[1], s_top));
          s_bot = fmaf(sw_r[nt][0], v[2], fmaf(sw_r[nt][1], v[3], s_bot));
        }
        float m0 = fmaxf(v[0], v[2]), m1 = fmaxf(v[1], v[3]);
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
        __nv_bfloat162 h2 = __floats2bfloat162_rn(m0, m1);
        pk[nt] = *reinterpret_cast<uint32_t*>(&h2);
      }
      // lanes g and g^1 hold the same pooled pixel: even g stores n8 tiles
      // 0-3, odd g tiles 4-7
      const int px = tc.tx * (TILE / 2) + 4 * mt + (g >> 1);
      if (py < Ho && px < Wo) {
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(out + (((size_t)tc.b * Ho + py) * Wo + px) * C);
        const int n0 = (g & 1) * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k) dst[(n0 + k) * 4 + t4] = pk[n0 + k];
      }
      if (SIDE) {
        s_top += __shfl_xor_sync(0xffffffffu, s_top, 1);
        s_top += __shfl_xor_sync(0xffffffffu, s_top, 2);
        s_bot += __shfl_xor_sync(0xffffffffu, s_bot, 1);
        s_bot += __shfl_xor_sync(0xffffffffu, s_bot, 2);
        const int yy = tc.ty * TILE + 2 * warp + t4;  // t4 = 0: top row, 1: bottom row
        const int xx = tc.tx * TILE + 8 * mt + g;
        if (t4 < 2 && yy < H && xx < W)
          side_out[((size_t)tc.b * H + yy) * W + xx] = t4 ? s_bot : s_top;
      }
    }
    buf ^= 1;
  }
}

}  // namespace

RSPL_EXPORT const char* conv_stem_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (B, H, W, 64) bf16 NHWC; wp (8, 72, 8, 8) bf16, the packed weights:
// w[n][k] (n = c_out, k = (a*3 + b)*64 + c_in) at [n / 8][k / 8][n % 8][k % 8];
// bias (64,) f32;
// side_w (64,) f32 or null; out (B, H/2, W/2, 64) bf16; side_out (B, H, W)
// f32 or null (both null or both set). H, W even.
RSPL_EXPORT int conv_stem_launch(const void* x, const void* wp, const void* bias,
                                 const void* side_w, void* out, void* side_out, int B,
                                 int H, int W, void* stream) {
  using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static EncodeFn encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    RSPL_RETURN_IF_ERROR(cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                 reinterpret_cast<void**>(&encode),
                                                 cudaEnableDefault, &q));
    if (q != cudaDriverEntryPointSuccess || encode == nullptr) return (int)cudaErrorNotSupported;
  }
  CUtensorMap map;
  const cuuint64_t dims[4] = {C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {C * 2, (cuuint64_t)W * C * 2, (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {C, HALO, HALO, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  RSPL_RETURN_IF_ERROR(cudaGetDevice(&dev));
  RSPL_RETURN_IF_ERROR(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int ntiles = ((W + TILE - 1) / TILE) * ((H + TILE - 1) / TILE) * B;
  const int grid = ntiles < sms ? ntiles : sms;
  const auto* wb = static_cast<const __nv_bfloat16*>(wp);
  const auto* bf = static_cast<const float*>(bias);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (side_out != nullptr) {
    RSPL_RETURN_IF_ERROR(cudaFuncSetAttribute(
        conv3x3_relu_pool_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
    conv3x3_relu_pool_kernel<true><<<grid, NT, SMEM, (cudaStream_t)stream>>>(
        map, wb, bf, static_cast<const float*>(side_w), ob, static_cast<float*>(side_out), B,
        H, W);
  } else {
    RSPL_RETURN_IF_ERROR(cudaFuncSetAttribute(
        conv3x3_relu_pool_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
    conv3x3_relu_pool_kernel<false><<<grid, NT, SMEM, (cudaStream_t)stream>>>(
        map, wb, bf, nullptr, ob, nullptr, B, H, W);
  }
  return (int)cudaGetLastError();
}
