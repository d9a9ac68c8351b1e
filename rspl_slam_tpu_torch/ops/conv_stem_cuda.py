"""K1 wrapper: fused 3×3 conv + bias + ReLU + 2×2 max-pool (+ side score),
and SuperPoint's fused stage-1 stem (port of ops/conv_stem_pallas.py).

``conv3x3_relu_pool`` launches ``csrc/conv_stem.cu`` for CUDA tensors and
runs :func:`conv3x3_relu_pool_plain` for CPU tensors; nothing else picks
the path. Layout is NHWC at the public boundary. The kernel takes its
weights as :func:`pack_weights` lays them out, packed once per weight
tensor by the caller (``SuperPoint`` caches them); the plain version takes
HWIO weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rspl_slam_tpu_torch.ops import cuda_build

__all__ = ["conv3x3_relu_pool", "conv3x3_relu_pool_plain", "pack_weights",
           "conv1a", "superpoint_stem"]

KDIM = 9 * 64  # GEMM depth of the 3×3×64 window
PACKED = (64 // 8, KDIM // 8, 8, 8)  # packed weight shape (csrc/conv_stem.cu)

launches = 0  # SuperPoint-mode launches (no side output)
side_launches = 0  # side-output-mode launches (RCF stage 1)


def conv3x3_relu_pool_plain(x, w, b, side_w=None):
    """Plain PyTorch version. x (B, H, W, C) NHWC; w (3, 3, C, C_out) HWIO;
    b (C_out,). Weights round to x's dtype (the TPU kernel casts them to
    bf16); the conv accumulates, adds the bias and applies ReLU in f32.
    Returns pooled (B, H/2, W/2, C_out) in x's dtype and, with ``side_w``,
    the full-resolution f32 side score (B, H, W)."""
    xf = x.float().permute(0, 3, 1, 2)
    wf = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = torch.relu(F.conv2d(xf, wf, padding=1) + b.float()[None, :, None, None])
    out = F.max_pool2d(y, 2).permute(0, 2, 3, 1).to(x.dtype).contiguous()
    if side_w is None:
        return out
    side = torch.einsum("bchw,c->bhw", y, side_w.float())
    return out, side


def pack_weights(w):
    """HWIO (3, 3, 64, 64) conv weights → K1's packed operand: bf16
    (8, 72, 8, 8), the GEMM matrix w[n][k] (n = c_out, k = (a·3 + b)·64 +
    c_in, the TPU kernel's im2col order) in the kernel's K-major
    core-matrix order [n / 8][k / 8][n % 8][k % 8]. Pack once per weight
    tensor."""
    wnk = w.reshape(KDIM, -1).t().to(torch.bfloat16)
    return wnk.reshape(PACKED[0], 8, PACKED[1], 8).permute(0, 2, 1, 3).contiguous()


def conv3x3_relu_pool(x, w, b, side_w=None):
    """ReLU(conv3×3(x) + b) with the whole 2×2 max-pool fused, SAME zero
    padding; optional full-resolution side score Σ_c side_w[c]·ReLU(·)[c].

    CUDA tensors launch K1 (bf16 x, C = C_out = 64, even H and W, ``w``
    packed once by :func:`pack_weights`) or raise; CPU tensors take the
    plain version with HWIO ``w``."""
    global launches, side_launches
    if x.device.type == "cpu":
        return conv3x3_relu_pool_plain(x, w, b, side_w)
    cuda_build.refuse_grad("conv3x3_relu_pool", x, w, b, side_w)
    B, H, W, C = x.shape
    if C != 64 or H % 2 or W % 2:
        raise ValueError(f"conv_stem kernel takes (B, H, W, 64) with even H, W; "
                         f"got {tuple(x.shape)}")
    if tuple(w.shape) != PACKED:
        raise ValueError(f"conv_stem kernel takes weights packed by pack_weights "
                         f"{PACKED}; got {tuple(w.shape)}")
    cuda_build.require_cuda(x, "x", torch.bfloat16)
    cuda_build.require_cuda(w, "w", torch.bfloat16)
    bk = b.float().contiguous()
    cuda_build.require_cuda(bk, "b", torch.float32, (64,))
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv_stem kernel needs 16-byte aligned x and w")
    out = torch.empty((B, H // 2, W // 2, 64), dtype=torch.bfloat16, device=x.device)
    side = None
    swk = None
    if side_w is not None:
        swk = side_w.float().contiguous()
        cuda_build.require_cuda(swk, "side_w", torch.float32, (64,))
        side = torch.empty((B, H, W), dtype=torch.float32, device=x.device)
    cuda_build.launch("conv_stem", "conv_stem_launch", x, w, bk, swk, out, side,
                      B, H, W, cuda_build.stream_of(x))
    with cuda_build.count_lock:
        if side is None:
            launches += 1
        else:
            side_launches += 1
    return out if side is None else (out, side)


def conv1a(images, w, b, dtype):
    """SuperPoint conv1a (c_in = 1) + ReLU in plain torch, NHWC out —
    the JAX package computes it outside Pallas too. Operands round to
    ``dtype``; accumulation, bias and ReLU in f32; output in ``dtype``.
    It opens the K1 stem, so on the card it refuses grad as K1 does."""
    if images.is_cuda:
        cuda_build.refuse_grad("conv1a", images, w, b)
    x = images.to(dtype).float()[:, None]
    wf = w.to(dtype).float().permute(3, 2, 0, 1)
    y = torch.relu(F.conv2d(x, wf, padding=1) + b.float()[None, :, None, None])
    return y.to(dtype).permute(0, 2, 3, 1).contiguous()


def superpoint_stem(w1a, b1a, w1b, b1b, images, dtype=torch.bfloat16):
    """Fused SuperPoint stage-1 stem: conv1a, then conv1b + the first
    max-pool through K1 (``w1b`` as :func:`conv3x3_relu_pool` takes it).
    images (B, H, W) in [0, 1] → (B, H/2, W/2, 64) NHWC in ``dtype``."""
    return conv3x3_relu_pool(conv1a(images, w1a, b1a, dtype), w1b, b1b)
