"""Robust PnP initialization (port of backend/pnp.py): batched
hypothesize-and-refine RANSAC.

H random 4-point subsets are each polished by Gauss-Newton from the prior
pose, all H at once as a batch dimension, scored by 20-px inlier count in
one (H, N) residual matrix; the winner is refined on its consensus set.

Subsets are drawn with ``torch.multinomial`` from an explicit
``torch.Generator`` (with replacement, as ``jax.random.categorical`` draws
them). The two frameworks' random streams differ, so the port is held to
the JAX function by outcome, not by sample. Nothing here synchronizes the
host with the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rspl_slam_tpu_torch.backend import residuals as res
from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
from rspl_slam_tpu_torch.geometry import linalg as glin
from rspl_slam_tpu_torch.geometry import se3

__all__ = ["PnPResult", "pnp_ransac"]


class PnPResult(NamedTuple):
    Tcw: torch.Tensor  # (4, 4)
    inlier: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int
    ok: torch.Tensor  # () bool


def _gn_refine(K: CameraIntrinsics, Tcw, Xw, uv, weight, iters: int):
    """Gauss-Newton on mono reprojection with per-point weights. ``Tcw``
    (..., 4, 4) and ``weight`` (..., N) may carry a batch of hypotheses."""
    meas = torch.cat([uv, torch.zeros_like(uv[:, :1])], -1)
    no_stereo = torch.zeros(Xw.shape[0], dtype=torch.bool, device=Xw.device)
    eye6 = 1e-6 * torch.eye(6, dtype=Tcw.dtype, device=Tcw.device)
    for _ in range(iters):
        r, z = res.point_residual(K, Tcw, Xw, meas, no_stereo)
        w = weight * (z > 1e-6)
        J = res.point_pose_jacobian(K, Tcw, Xw, no_stereo)
        Jw = J * w[..., None, None]
        H = torch.einsum("...nij,...nik->...jk", Jw, J) + eye6
        g = torch.einsum("...nij,...ni->...j", Jw, r)
        Tcw = se3.exp_se3(-glin.solve_spd(H, g)) @ Tcw
    return Tcw


def _score(K: CameraIntrinsics, Tcw, Xw, uv, valid, threshold_px: float):
    Xc = res.transform_to_cam(Tcw, Xw)
    z = Xc[..., 2].clamp_min(1e-6)
    u = K.fx * Xc[..., 0] / z + K.cx
    v = K.fy * Xc[..., 1] / z + K.cy
    err = torch.linalg.norm(uv - torch.stack([u, v], -1), dim=-1)
    inl = (err < threshold_px) & (Xc[..., 2] > 1e-6) & valid
    return inl.sum(-1), inl


def pnp_ransac(K: CameraIntrinsics, Twc_prior, Xw, uv, valid,
               generator: torch.Generator, num_hypotheses: int = 128,
               subset_size: int = 4, gn_iters: int = 5,
               threshold_px: float = 20.0) -> PnPResult:
    """Twc_prior (4, 4), Xw (N, 3), uv (N, 2), valid (N,) bool, all on one
    device; ``generator`` lives on that device."""
    N = Xw.shape[0]
    Tcw_prior = se3.inverse(Twc_prior)
    n_valid = valid.sum()
    # categorical over valid slots; uniform over all when none is valid
    # (the JAX logits are then all equal)
    probs = (valid | (n_valid == 0)).to(Xw.dtype)
    idx = torch.multinomial(probs.expand(num_hypotheses, N).contiguous(),
                            subset_size,
                            replacement=True, generator=generator)
    w = torch.zeros(num_hypotheses, N, dtype=Xw.dtype, device=Xw.device)
    w.scatter_(1, idx, 1.0)
    Tcws = _gn_refine(K, Tcw_prior.expand(num_hypotheses, 4, 4), Xw, uv, w,
                      gn_iters)
    counts, inliers = _score(K, Tcws, Xw, uv, valid, threshold_px)
    best = counts.argmax()
    Tcw_final = _gn_refine(K, Tcws[best], Xw, uv, inliers[best].to(Xw.dtype),
                           gn_iters)
    n_final, inl_final = _score(K, Tcw_final, Xw, uv, valid, threshold_px)
    ok = (n_valid >= 8) & (n_final >= torch.clamp(n_valid, max=8))
    return PnPResult(Tcw=Tcw_final, inlier=inl_final, num_inliers=n_final,
                     ok=ok)
