"""Reprojection residuals + analytic Jacobians (port of
backend/residuals.py): point residuals with their pose and landmark
Jacobians, and the line residual (normalized distances of the observed
segment endpoints to the projected Plücker line, left and right camera).

Conventions as in the JAX package: ``Tcw`` camera-from-world, r = meas −
prediction, left-multiplicative pose perturbation ξ = [ω, v], additive
world-point perturbation, identity information; the uR component is zeroed
on mono rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rspl_slam_tpu_torch.geometry import plucker

__all__ = ["CameraIntrinsics", "transform_to_cam", "point_residual",
           "point_pose_jacobian", "point_landmark_jacobian", "line_residual",
           "huber_weight"]


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


def _projection_jacobian(K: CameraIntrinsics, Xc):
    """∂[u, v, uR]/∂Xc at camera-frame points (..., N, 3) → (..., N, 3, 3)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z = z.clamp_min(1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy, bf = K.fx, K.fy, K.bf
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], -1),
        torch.stack([zero, fy * iz, -fy * y * iz2], -1),
        torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], -1),
    ], -2)


def _mask_right(J, is_stereo):
    """Zero the uR row of (..., N, 3, D) Jacobians on mono rows."""
    return torch.cat([J[..., :2, :],
                      torch.where(is_stereo[..., None], J[..., 2, :], 0.0)[..., None, :]], -2)


def point_pose_jacobian(K: CameraIntrinsics, Tcw, Xw, is_stereo):
    """∂r/∂ξ, (..., N, 3, 6)."""
    Xc = transform_to_cam(Tcw, Xw)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2].clamp_min(1e-6)
    zero = torch.zeros_like(x)
    Jp = _projection_jacobian(K, Xc)
    neg_hat = torch.stack([
        torch.stack([zero, z, -y], -1),
        torch.stack([-z, zero, x], -1),
        torch.stack([y, -x, zero], -1),
    ], -2)
    I3 = torch.eye(3, dtype=Xw.dtype, device=Xw.device).expand(neg_hat.shape)
    return _mask_right(-(Jp @ torch.cat([neg_hat, I3], -1)), is_stereo)


def point_landmark_jacobian(K: CameraIntrinsics, Tcw, Xw, is_stereo):
    """∂r/∂Xw for an additive world-point perturbation, (..., N, 3, 3):
    −J_proj · R."""
    Jp = _projection_jacobian(K, transform_to_cam(Tcw, Xw))
    return _mask_right(-(Jp @ Tcw[..., None, :3, :3]), is_stereo)


def line_residual(K: CameraIntrinsics, Tcw, L_world, endpoints, endpoints_right,
                  is_stereo):
    """Line reprojection residual (..., N, 4): the normalized distances of
    the observed left endpoints (..., N, 2, 2) to the projected line, then
    those of the right endpoints to the line in the right camera (the
    camera displaced by the baseline b = bf/fx); mono rows zero the right
    pair. ``Tcw`` (..., 4, 4), ``L_world`` (..., N, 6) Plücker.

    Written out of place (the right camera's pose is assembled, not
    edited), so ``torch.func`` transforms apply."""
    Tcw = Tcw[..., None, :, :]
    t = Tcw[..., :3, 3]
    t_right = torch.stack([t[..., 0] - K.bf / K.fx, t[..., 1], t[..., 2]], -1)
    Trw = torch.cat([Tcw[..., :3, :3], t_right[..., None]], -1)  # (..., 1, 3, 4)
    out = []
    for T, eps in ((Tcw, endpoints), (Trw, endpoints_right)):
        line2d = plucker.project_to_image(plucker.transform(T, L_world),
                                          K.fx, K.fy, K.cx, K.cy)
        out += [plucker.point_line_dist_2d(line2d, eps[..., 0, :]),
                plucker.point_line_dist_2d(line2d, eps[..., 1, :])]
    s = is_stereo.to(L_world.dtype)
    return torch.stack([out[0], out[1], out[2] * s, out[3] * s], -1)


def huber_weight(chi2: torch.Tensor, delta) -> torch.Tensor:
    """IRLS Huber weight min(1, δ/√chi²)."""
    e = torch.sqrt(chi2.clamp_min(1e-12))
    return torch.clamp(delta / e, max=1.0)
