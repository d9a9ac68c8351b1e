"""SE(3) / SO(3) operations on torch tensors (port of geometry/se3.py).

Poses are (4, 4) homogeneous matrices; every function broadcasts over
leading batch dimensions. ξ = [ω, v] ordering as in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = [
    "hat", "exp_so3", "log_so3", "exp_se3", "log_se3", "inverse",
    "quat_from_rot", "rot_from_quat",
]


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors → (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _homogeneous(top: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) → (..., 4, 4) with bottom row [0, 0, 0, 1], built on the
    tensor's device (no host→device copy inside the solvers' loops)."""
    T = torch.cat([top, torch.zeros_like(top[..., :1, :])], -2)
    T[..., 3, 3] = 1.0
    return T


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential (..., 3) → (..., 3, 3), Taylor-guarded at 0."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2.clamp_min(1e-24))
    small = theta2 < 1e-12
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp_min(1e-24))
    W = hat(w)
    return _eye3_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def _V(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2.clamp_min(1e-24))
    small = theta2 < 1e-12
    t2 = theta2.clamp_min(1e-24)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (t2 * theta))
    W = hat(w)
    return _eye3_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: (..., 6) [ω, v] → (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    t = (_V(w) @ v[..., None])[..., 0]
    return _homogeneous(torch.cat([R, t[..., None]], -1))


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 3) axis-angle via the quaternion (stable near π)."""
    q = quat_from_rot(R)
    qw, qv = q[..., 0], q[..., 1:]
    n = torch.linalg.norm(qv, dim=-1)
    angle = 2.0 * torch.atan2(n, qw)
    scale = torch.where(n < 1e-9, 2.0 / qw.clamp_min(1e-9),
                        angle / n.clamp_min(1e-12))
    return qv * scale[..., None]


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`exp_se3`: (..., 4, 4) → (..., 6)."""
    from rspl_slam_tpu_torch.geometry.linalg import inv3

    w = log_so3(T[..., :3, :3])
    v = (inv3(_V(w)) @ T[..., :3, 3][..., None])[..., 0]
    return torch.cat([w, v], -1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ T[..., :3, 3][..., None])[..., 0]
    return _homogeneous(torch.cat([Rt, ti[..., None]], -1))


def quat_from_rot(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → unit quaternion (..., 4) wxyz, qw ≥ 0
    (branch-free max-pivot construction)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx0 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy0 = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1)
    qz0 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)
    idx = torch.stack([tr, m00, m11, m22], -1).argmax(-1)
    cands = torch.stack([qw0, qx0, qy0, qz0], -2)  # (..., 4, 4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rot_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz → (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = 2.0 / (w * w + x * x + y * y + z * z).clamp_min(1e-24)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], -2)
