"""Multi-view point triangulation, the robust 3D line fit and the
endpoint refresh of an optimized line (port of geometry/triangulation.py),
batched over landmarks.
"""

from __future__ import annotations

import numpy as np
import torch

from rspl_slam_tpu_torch.geometry import plucker
from rspl_slam_tpu_torch.geometry.linalg import eigvalsh3, solve3

__all__ = ["triangulate_point_multiview", "fit_line3d_to_points",
           "triangulate_line_endpoints", "COS_MIN_PARALLAX"]

# minimum accepted parallax between some pair of observing rays: 0.5°
COS_MIN_PARALLAX = float(np.cos(np.deg2rad(0.5)))


def triangulate_point_multiview(Twc: torch.Tensor, uv_norm: torch.Tensor,
                                mask: torch.Tensor):
    """Bearing least-squares triangulation with rank, parallax and
    cheirality checks.

    Twc (..., M, 4, 4) observer world poses, uv_norm (..., M, 2) normalized
    image coords, mask (..., M) bool. Returns (point (..., 3), ok (...,)).
    """
    m = mask.to(Twc.dtype)
    d_cam = torch.cat([uv_norm, torch.ones_like(uv_norm[..., :1])], -1)
    R = Twc[..., :3, :3]
    t = Twc[..., :3, 3]
    d_w = (R @ d_cam[..., None])[..., 0]
    d_w = d_w / torch.linalg.norm(d_w, dim=-1, keepdim=True).clamp_min(1e-12)
    eye = torch.eye(3, dtype=Twc.dtype, device=Twc.device)
    P = eye - d_w[..., :, None] * d_w[..., None, :]
    P = P * m[..., None, None]
    A = P.sum(-3)
    b = (P @ t[..., None])[..., 0].sum(-2)
    M = mask.shape[-1]
    pair = (mask[..., :, None] & mask[..., None, :]
            & ~torch.eye(M, dtype=torch.bool, device=mask.device))
    dots = (d_w @ d_w.transpose(-1, -2)).clamp(-1.0, 1.0)
    min_dot = torch.where(pair, dots, torch.ones_like(dots)).amin((-1, -2))
    ok_parallax = min_dot < COS_MIN_PARALLAX
    w = eigvalsh3(A)
    ok_rank = w[..., 0] > 1e-6 * w[..., 2].clamp_min(1e-12)
    x = solve3(A + 1e-9 * eye, b)
    p_cam_z = (d_w * (x[..., None, :] - t)).sum(-1)
    ok_cheir = torch.where(mask, p_cam_z > 0, torch.ones_like(mask)).all(-1)
    ok = (mask.sum(-1) >= 2) & ok_rank & ok_parallax & ok_cheir
    return x, ok


def fit_line3d_to_points(pts: torch.Tensor, mask: torch.Tensor,
                         inlier_dist: float = 0.05, min_inliers: int = 3):
    """Robust 3D line fit, batched: deterministic pair-hypothesis RANSAC
    (every pair of well-separated candidates proposes a line; the largest
    consensus within ``inlier_dist`` wins), then the PCA fit of the
    consensus set, with endpoints at its extreme projections.

    pts (..., P, 3), mask (..., P) bool. Returns (plucker (..., 6),
    endpoints (..., 2, 3), ok (...,)). The direction's sign is the
    eigenvector's, which is arbitrary: p1/p2 and the Plücker sign may
    flip against another solver.
    """
    P = pts.shape[-2]
    d = pts[..., None, :, :] - pts[..., :, None, :]  # d[i, j] = p_j − p_i
    dn = torch.linalg.norm(d, dim=-1, keepdim=True)
    d = d / dn.clamp_min(1e-9)
    pair_ok = mask[..., :, None] & mask[..., None, :] & (dn[..., 0] > 0.2)
    # distance of every point k to line (i, j): ‖r − ⟨r, d⟩d‖, r = p_k − p_i
    r = pts[..., None, None, :, :] - pts[..., :, None, None, :]
    proj = (r * d[..., :, :, None, :]).sum(-1)
    dist = torch.linalg.norm(r - proj[..., None] * d[..., :, :, None, :], dim=-1)
    inl = (dist < inlier_dist) & mask[..., None, None, :]
    counts = (inl.sum(-1) * pair_ok).flatten(-2)  # (..., P·P)
    best = counts.argmax(-1)  # the first maximum, as jnp.argmax
    have_pair = counts.gather(-1, best[..., None])[..., 0] > 0
    idx = best[..., None, None].expand(*best.shape, 1, P)
    consensus = inl.flatten(-3, -2).gather(-2, idx)[..., 0, :] & mask & have_pair[..., None]
    w = consensus.to(pts.dtype)
    cnt = w.sum(-1).clamp_min(1.0)
    c = (pts * w[..., None]).sum(-2) / cnt[..., None]
    X = (pts - c[..., None, :]) * w[..., None]
    _, evecs = torch.linalg.eigh(X.transpose(-1, -2) @ X)
    dirn = evecs[..., :, 2]
    t = ((pts - c[..., None, :]) * dirn[..., None, :]).sum(-1)
    big = torch.full_like(t, 1e9)
    tmin = torch.where(consensus, t, big).amin(-1)
    tmax = torch.where(consensus, t, -big).amax(-1)
    p1 = c + tmin[..., None] * dirn
    p2 = c + tmax[..., None] * dirn
    ok = (consensus.sum(-1) >= min_inliers) & (tmax - tmin > 1e-3)
    return plucker.from_endpoints(p1, p2), torch.stack([p1, p2], -2), ok


def triangulate_line_endpoints(L_world: torch.Tensor, anchor_pts: torch.Tensor,
                               mask: torch.Tensor):
    """Cartesian endpoints of (optimized) infinite Plücker lines (..., 6):
    the extreme projections onto each line of its supporting mappoints
    (..., P, 3) under ``mask`` (..., P). Returns (endpoints (..., 2, 3),
    ok (...,): at least two supporting points)."""
    n, d = L_world[..., :3], L_world[..., 3:]
    dn = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-12)
    # closest point of the line to the origin: p0 = d × n / ‖d‖²
    p0 = torch.linalg.cross(d, n) / (d * d).sum(-1, keepdim=True).clamp_min(1e-12)
    proj = ((anchor_pts - p0[..., None, :]) * dn[..., None, :]).sum(-1)
    big = torch.full_like(proj, 1e9)
    tmin = torch.where(mask, proj, big).amin(-1)
    tmax = torch.where(mask, proj, -big).amax(-1)
    eps = torch.stack([p0 + tmin[..., None] * dn, p0 + tmax[..., None] * dn], -2)
    return eps, mask.sum(-1) >= 2
