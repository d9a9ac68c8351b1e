"""Point reprojection residuals + analytic pose Jacobians (port of the
point terms of backend/residuals.py). Line terms belong to the lines slice.

Conventions as in the JAX package: ``Tcw`` camera-from-world, r = meas −
prediction, left-multiplicative pose perturbation ξ = [ω, v], identity
information; the uR component is zeroed on mono rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CameraIntrinsics", "transform_to_cam", "point_residual",
           "point_pose_jacobian", "huber_weight"]


class CameraIntrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float


def transform_to_cam(Tcw: torch.Tensor, Xw: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) × (..., N, 3) → (..., N, 3) camera-frame points."""
    return Xw @ Tcw[..., :3, :3].transpose(-1, -2) + Tcw[..., None, :3, 3]


def point_residual(K: CameraIntrinsics, Tcw, Xw, meas, is_stereo):
    """Returns (r (..., N, 3), z (..., N)); chi² = ‖r‖²."""
    Xc = transform_to_cam(Tcw, Xw)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = z.clamp_min(1e-6)
    u = K.fx * x / zs + K.cx
    v = K.fy * y / zs + K.cy
    ur = u - K.bf / zs
    r = meas - torch.stack([u, v, ur], -1)
    r = torch.cat([r[..., :2],
                   torch.where(is_stereo, r[..., 2], 0.0)[..., None]], -1)
    return r, z


def point_pose_jacobian(K: CameraIntrinsics, Tcw, Xw, is_stereo):
    """∂r/∂ξ, (..., N, 3, 6)."""
    Xc = transform_to_cam(Tcw, Xw)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z = z.clamp_min(1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy, bf = K.fx, K.fy, K.bf
    zero = torch.zeros_like(x)
    Jp = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], -1),
        torch.stack([zero, fy * iz, -fy * y * iz2], -1),
        torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], -1),
    ], -2)
    neg_hat = torch.stack([
        torch.stack([zero, z, -y], -1),
        torch.stack([-z, zero, x], -1),
        torch.stack([y, -x, zero], -1),
    ], -2)
    I3 = torch.eye(3, dtype=Xw.dtype, device=Xw.device).expand(neg_hat.shape)
    J = -(Jp @ torch.cat([neg_hat, I3], -1))
    return torch.cat([J[..., :2, :],
                      torch.where(is_stereo[..., None], J[..., 2, :],
                                  0.0)[..., None, :]], -2)


def huber_weight(chi2: torch.Tensor, delta) -> torch.Tensor:
    """IRLS Huber weight min(1, δ/√chi²)."""
    e = torch.sqrt(chi2.clamp_min(1e-12))
    return torch.clamp(delta / e, max=1.0)
