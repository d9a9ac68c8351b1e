"""Pose-only Levenberg–Marquardt (port of backend/pose_solver.py).

Same schedule as the JAX package: 4 rounds × 10 LM iterations, each round
restarting from the initial pose with the current inlier set, Huber kernel
on the first two rounds, chi² re-gating after every round. Accept/reject
decisions stay on the device as ``torch.where``, so the whole solve is
queued without a host synchronization.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rspl_slam_tpu_torch.backend import residuals as res
from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
from rspl_slam_tpu_torch.geometry import linalg as glin
from rspl_slam_tpu_torch.geometry import se3

__all__ = ["PoseOnlyResult", "optimize_pose"]


class PoseOnlyResult(NamedTuple):
    Tcw: torch.Tensor  # (4, 4)
    inlier: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # ()
    chi2: torch.Tensor  # (N,)


def _lm_rounds(K, Tcw0, Xw, meas, is_stereo, valid, chi2_mono, chi2_stereo,
               rounds, iters):
    dtype = Tcw0.dtype
    thr = torch.where(is_stereo, chi2_stereo, chi2_mono).to(dtype)
    delta = torch.sqrt(thr)
    eps6 = 1e-10 * torch.eye(6, dtype=dtype, device=Tcw0.device)

    def constraint_chi2(Tcw):
        r, z = res.point_residual(K, Tcw, Xw, meas, is_stereo)
        return (r * r).sum(-1), r, z

    def cost(chi2, w, z, active):
        pen = delta * delta
        return ((torch.where(w > 0, chi2, 0.0) * w.clamp(max=1.0)).sum()
                + ((active & ~(z > 1e-6)).to(dtype) * pen).sum())

    def weights(chi2, z, use_huber, active):
        w = res.huber_weight(chi2, delta) if use_huber else torch.ones_like(chi2)
        return torch.where(active & (z > 1e-6), w, 0.0)

    chi2_0, r_0, z_0 = constraint_chi2(Tcw0)
    Tcw, inlier = Tcw0, valid
    for round_idx in range(rounds):
        use_huber = round_idx < 2
        active = inlier & valid
        Tcw = Tcw0
        lam = torch.full((), 1e-4, dtype=dtype, device=Tcw0.device)
        chi2, r, z = chi2_0, r_0, z_0
        for _ in range(iters):
            w = weights(chi2, z, use_huber, active)
            J = res.point_pose_jacobian(K, Tcw, Xw, is_stereo)
            Jw = J * w[:, None, None]
            H = torch.einsum("nij,nik->jk", Jw, J)
            g = torch.einsum("nij,ni->j", Jw, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + eps6
            Tcw_new = se3.exp_se3(-glin.solve_spd(Hd, g)) @ Tcw
            cost_old = cost(chi2, w, z, active)
            chi2_new, r_new, zn = constraint_chi2(Tcw_new)
            w_new = weights(chi2_new, zn, use_huber, active)
            accept = cost(chi2_new, w_new, zn, active) < cost_old
            Tcw = torch.where(accept, Tcw_new, Tcw)
            chi2 = torch.where(accept, chi2_new, chi2)
            r = torch.where(accept, r_new, r)
            z = torch.where(accept, zn, z)
            lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-10, 1e6)
        inlier = (chi2 <= thr) & (z > 1e-6) & valid
    chi2, _, _ = constraint_chi2(Tcw)
    return Tcw, inlier, chi2


def optimize_pose(K: CameraIntrinsics, Twc0, Xw, meas, is_stereo, valid,
                  chi2_mono: float = 50.0, chi2_stereo: float = 75.0,
                  rounds: int = 4, iters: int = 10) -> PoseOnlyResult:
    """Functional equivalent of FrameOptimization. ``Twc0`` (4, 4) world
    pose; returns the optimized camera-from-world pose and inlier mask."""
    Tcw, inlier, chi2 = _lm_rounds(
        K, se3.inverse(Twc0), Xw, meas, is_stereo, valid,
        float(chi2_mono), float(chi2_stereo), rounds, iters)
    return PoseOnlyResult(Tcw=Tcw, inlier=inlier,
                          num_inliers=inlier.sum(), chi2=chi2)
