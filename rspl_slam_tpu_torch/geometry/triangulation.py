"""Multi-view point triangulation (port of geometry/triangulation.py
``triangulate_point_multiview``), batched over landmarks.

The line fits of the JAX module belong to the lines slice (ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from rspl_slam_tpu_torch.geometry.linalg import eigvalsh3, solve3

__all__ = ["triangulate_point_multiview", "COS_MIN_PARALLAX"]

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
