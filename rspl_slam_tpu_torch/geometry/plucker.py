"""Plücker 3D line algebra + 4-DoF orthonormal parameterization (port of
geometry/plucker.py).

Representation: L = (n, d) ∈ R⁶ with n = p × q (moment) for two points p, q
on the line and d = q − p (direction). The projection of the infinite line
into a pinhole camera uses only n:
    l2d = [fy·n₀, fx·n₁, Kv·n],  Kv = [−cx·fy, −fx·cy, fx·fy].
Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

from rspl_slam_tpu_torch.geometry.se3 import exp_so3

__all__ = [
    "from_endpoints", "transform", "project_to_image", "orthonormal_from_plucker",
    "plucker_from_orthonormal", "orthonormal_update", "point_line_dist_2d",
    "normalize",
]


def from_endpoints(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Two (..., 3) points → (..., 6) Plücker [n, d]."""
    return torch.cat([torch.linalg.cross(p, q), q - p], -1)


def normalize(L: torch.Tensor) -> torch.Tensor:
    """Scale so ‖d‖ = 1 (direction-normalized Plücker)."""
    s = torch.linalg.norm(L[..., 3:], dim=-1, keepdim=True)
    return L / s.clamp_min(1e-12)


def transform(T: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Rigid transform of Plücker lines: for T = [R t] mapping points
    p' = R p + t, the line maps as n' = R n + [t]× R d, d' = R d."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rd = (R @ L[..., 3:, None])[..., 0]
    Rn = (R @ L[..., :3, None])[..., 0]
    return torch.cat([Rn + torch.linalg.cross(t, Rd), Rd], -1)


def project_to_image(L_cam: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Plücker line in the camera frame → image line (a, b, c) with
    a·u + b·v + c = 0."""
    n = L_cam[..., :3]
    a = fy * n[..., 0]
    b = fx * n[..., 1]
    c = -cx * fy * n[..., 0] - fx * cy * n[..., 1] + fx * fy * n[..., 2]
    return torch.stack([a, b, c], -1)


def point_line_dist_2d(line_abc: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Signed normalized distance of pixel (..., 2) to line (..., 3)."""
    a, b, c = line_abc[..., 0], line_abc[..., 1], line_abc[..., 2]
    denom = torch.sqrt((a * a + b * b).clamp_min(1e-12))
    return (a * uv[..., 0] + b * uv[..., 1] + c) / denom


def orthonormal_from_plucker(L: torch.Tensor):
    """Plücker (..., 6) → orthonormal (U ∈ SO(3), W ∈ SO(2)): U's columns
    are [n̂, d̂, n̂ × d̂]; W holds (‖n‖, ‖d‖) as a direction on the circle."""
    n, d = L[..., :3], L[..., 3:]
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    nd = torch.linalg.norm(d, dim=-1, keepdim=True)
    u1 = n / nn.clamp_min(1e-12)
    u2 = d / nd.clamp_min(1e-12)
    U = torch.stack([u1, u2, torch.linalg.cross(u1, u2)], -1)
    s = torch.sqrt((nn * nn + nd * nd).clamp_min(1e-24))[..., 0]
    w1 = nn[..., 0] / s
    w2 = nd[..., 0] / s
    W = torch.stack([torch.stack([w1, -w2], -1), torch.stack([w2, w1], -1)], -2)
    return U, W


def plucker_from_orthonormal(U: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    n = W[..., 0, 0][..., None] * U[..., :, 0]
    d = W[..., 1, 0][..., None] * U[..., :, 1]
    return torch.cat([n, d], -1)


def _rot2(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def orthonormal_update(L: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Apply a 4-DoF update δ = (δθ₁, δθ₂, δθ₃, δφ) through the orthonormal
    representation: U ← U·exp([δθ]×), W ← W·rot2(δφ)."""
    U, W = orthonormal_from_plucker(L)
    return plucker_from_orthonormal(U @ exp_so3(delta[..., :3]),
                                    W @ _rot2(delta[..., 3]))
