"""Keypoint post-processing: NMS, border mask, top-K, descriptor sampling
(port of ops/keypoints.py: the cell path that ``extract`` takes for
``nms_radius`` 3..8, and the pixel-space path it takes for other radii),
batched over images.

``simple_nms_cell`` keeps the JAX signature (cell-layout (B, Hc, Wc, 64)
in and out, channel c = 8·dy + dx) but computes the NMS in pixel space
with ``max_pool2d`` (−inf padding, stride 1): the result is the same map
bit for bit. The cell-layout shifting of the JAX function avoided a
relayout that is slow on the TPU; on the GPU the pixel shuffle is cheap.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

__all__ = ["simple_nms", "border_mask", "top_k_keypoints", "simple_nms_cell",
           "cell_border_mask", "top_k_keypoints_cell", "sample_descriptors"]


def _max_pool_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    return F.max_pool2d(x[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]


def simple_nms(scores: torch.Tensor, nms_radius: int = 4) -> torch.Tensor:
    """Iterated max-pool NMS on (B, H, W) scores."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == _max_pool_same(scores, nms_radius)
    for _ in range(2):
        supp_mask = _max_pool_same(max_mask.to(scores.dtype), nms_radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _max_pool_same(supp_scores, nms_radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


@lru_cache(maxsize=16)
def border_mask(H: int, W: int, border: int, device=None) -> torch.Tensor:
    """(H, W) mask, False within ``border`` px of the image edge
    (super_point.cpp:168-183; a constant per shape and device)."""
    rows = torch.arange(H)[:, None]
    cols = torch.arange(W)[None, :]
    m = (rows >= border) & (rows < H - border) & (cols >= border) & (cols < W - border)
    return m.to(device)


def top_k_keypoints(scores: torch.Tensor, k: int, threshold: float, border: int = 4):
    """Exactly-K keypoints from (B, H, W) NMS'd scores: the border zeroed,
    one top-K over each flattened map. Returns (xy (B, K, 2) f32 pixels,
    score (B, K), valid (B, K)); invalid slots sit at (0, 0) with score 0.
    Exactly-equal scores may come out in another order than ``lax.top_k``
    gives."""
    B, H, W = scores.shape
    masked = torch.where(border_mask(H, W, border, scores.device), scores,
                         torch.zeros_like(scores))
    vals, idx = masked.reshape(B, -1).topk(k, dim=-1)
    valid = vals > threshold
    ys = (idx // W).to(torch.float32)
    xs = (idx % W).to(torch.float32)
    xy = torch.where(valid[..., None], torch.stack([xs, ys], -1), 0.0)
    return xy, torch.where(valid, vals, 0.0), valid


def _cells_to_pixels(probs: torch.Tensor, s: int = 8) -> torch.Tensor:
    B, Hc, Wc, _ = probs.shape
    return probs.reshape(B, Hc, Wc, s, s).permute(0, 1, 3, 2, 4).reshape(B, Hc * s, Wc * s)


def _pixels_to_cells(scores: torch.Tensor, s: int = 8) -> torch.Tensor:
    B, H, W = scores.shape
    return scores.reshape(B, H // s, s, W // s, s).permute(0, 1, 3, 2, 4).reshape(
        B, H // s, W // s, s * s)


def simple_nms_cell(probs: torch.Tensor, nms_radius: int = 4) -> torch.Tensor:
    """:func:`simple_nms` on the (B, Hc, Wc, 64) cell layout."""
    return _pixels_to_cells(simple_nms(_cells_to_pixels(probs), nms_radius))


@lru_cache(maxsize=16)
def cell_border_mask(Hc: int, Wc: int, border: int, s: int = 8, device=None) -> torch.Tensor:
    """(Hc, Wc, s·s) mask: :func:`border_mask` in the cell layout (a
    constant per shape and device)."""
    m = border_mask(Hc * s, Wc * s, border)
    return m.reshape(Hc, s, Wc, s).permute(0, 2, 1, 3).reshape(Hc, Wc, s * s).to(device)


def top_k_keypoints_cell(scores: torch.Tensor, k: int, threshold: float,
                         border: int = 4, s: int = 8, cell_k: int = 8):
    """Exactly-K keypoints from (B, Hc, Wc, s·s) NMS'd scores: per-cell
    top-``cell_k``, then a global top-K over the candidates. Returns
    (xy (B, K, 2) f32 pixels, score (B, K), valid (B, K)); invalid slots
    sit at (0, 0) with score 0. Exactly-equal scores may come out in
    another order than ``lax.top_k`` gives."""
    B, Hc, Wc, C = scores.shape
    masked = torch.where(cell_border_mask(Hc, Wc, border, s, scores.device),
                         scores, torch.zeros_like(scores))
    ck = min(cell_k, C)
    v1, c1 = masked.topk(ck, dim=-1)
    kk = min(k, Hc * Wc * ck)
    vals, i2 = v1.reshape(B, -1).topk(kk, dim=-1)
    if kk < k:
        vals = torch.cat([vals, vals.new_zeros(B, k - kk)], 1)
        i2 = torch.cat([i2, i2.new_zeros(B, k - kk)], 1)
    cc = torch.gather(c1.reshape(B, -1), 1, i2)
    cell = i2 // ck
    Y, X = cell // Wc, cell % Wc
    valid = vals > threshold
    ys = (s * Y + cc // s).to(torch.float32)
    xs = (s * X + cc % s).to(torch.float32)
    xy = torch.where(valid[..., None], torch.stack([xs, ys], -1), 0.0)
    return xy, torch.where(valid, vals, 0.0), valid


def sample_descriptors(xy: torch.Tensor, desc_map: torch.Tensor, s: int = 8) -> torch.Tensor:
    """Bilinear (align_corners) sampling of (B, C, Hc, Wc) descriptors at
    (B, K, 2) pixels + L2 normalization → (B, K, C)."""
    B, C, Hc, Wc = desc_map.shape
    kx = (xy[..., 0] - s / 2 + 0.5) / (Wc * s - s / 2 - 0.5)
    ky = (xy[..., 1] - s / 2 + 0.5) / (Hc * s - s / 2 - 0.5)
    gx = kx * (Wc - 1)
    gy = ky * (Hc - 1)
    x0 = torch.floor(gx).clamp(0, Wc - 2)
    y0 = torch.floor(gy).clamp(0, Hc - 2)
    wx = (gx - x0).clamp(0.0, 1.0)[:, None]
    wy = (gy - y0).clamp(0.0, 1.0)[:, None]
    flat = desc_map.reshape(B, C, Hc * Wc)
    base = y0.long() * Wc + x0.long()

    def g(off):
        return torch.gather(flat, 2, (base + off)[:, None, :].expand(B, C, -1))

    d = (g(0) * ((1 - wy) * (1 - wx)) + g(1) * ((1 - wy) * wx)
         + g(Wc) * (wy * (1 - wx)) + g(Wc + 1) * (wy * wx))  # (B, C, K)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True).clamp_min(1e-12)
    return d.transpose(1, 2)
