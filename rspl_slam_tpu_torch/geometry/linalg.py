"""Closed-form small-matrix linear algebra (port of geometry/linalg.py).

``inv3``/``solve3`` are the adjugate forms, ``inv4_spd`` the 2×2 block
inverse and ``eigvalsh3`` the Cardano solution, as in the JAX package.
``solve_spd`` uses ``cholesky_ex`` + ``cholesky_solve``: the ``_ex`` form
reports failure in a tensor instead of raising, so a solve inside the
tracking or BA loop never synchronizes the host with the device. Where the
factorization fails the solution is NaN, as the JAX package's NaN-filled
Cholesky factor makes it: the solvers' accept tests reject such a step.
"""

from __future__ import annotations

import math

import torch

__all__ = ["inv3", "inv4_spd", "solve3", "solve_spd", "eigvalsh3"]


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (..., 3, 3) via the adjugate (A nonsingular)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], -2)
    return adj / det[..., None, None]


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x = (..., 3) through the adjugate inverse."""
    return (inv3(A) @ b[..., None])[..., 0]


def _inv2(M: torch.Tensor) -> torch.Tensor:
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj / det[..., None, None]


def inv4_spd(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse of symmetric positive-definite (..., 4, 4) matrices
    by 2×2 block inversion (Schur complement) with closed-form 2×2s. Not
    valid for indefinite matrices."""
    P, Q = A[..., :2, :2], A[..., :2, 2:]
    R, S = A[..., 2:, :2], A[..., 2:, 2:]
    Pi = _inv2(P)
    Mi = _inv2(S - R @ Pi @ Q)
    PiQ = Pi @ Q
    top = torch.cat([Pi + PiQ @ Mi @ R @ Pi, -PiQ @ Mi], -1)
    bot = torch.cat([-Mi @ R @ Pi, Mi], -1)
    return torch.cat([top, bot], -2)


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of symmetric (..., 3, 3) matrices (Cardano)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt((p2 / 6.0).clamp_min(0.0))
    ps = p.clamp_min(1e-30)
    B00, B11, B22 = d0 / ps, d1 / ps, d2 / ps
    B01, B02, B12 = a01 / ps, a02 / ps, a12 / ps
    detB = (B00 * (B11 * B22 - B12 * B12)
            - B01 * (B01 * B22 - B12 * B02)
            + B02 * (B01 * B12 - B11 * B02))
    r = (detB / 2.0).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lmid = 3.0 * q - lmax - lmin
    return torch.stack([lmin, lmid, lmax], -1)


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (batched); ``b`` is (..., N) or (..., N, K).
    A system whose Cholesky factorization fails gets an all-NaN solution."""
    L, info = torch.linalg.cholesky_ex(A)
    vec = b.dim() == A.dim() - 1
    x = torch.cholesky_solve(b[..., None] if vec else b, L)
    x = torch.where((info > 0)[..., None, None], torch.nan, x)
    return x[..., 0] if vec else x
