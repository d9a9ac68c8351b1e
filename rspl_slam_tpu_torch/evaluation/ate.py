"""In-repo ATE evaluation, equivalent to ``evo_ape tum <gt> <traj> -a``
(run_batch.py:48): SE(3) Umeyama alignment of the estimated trajectory to
ground truth, then RMSE of translational APE.

The reference shells out to the `evo` package; here the whole evaluation is
a few numpy lines so the benchmark harness is self-contained.
"""

from __future__ import annotations

import numpy as np

__all__ = ["align_umeyama", "absolute_trajectory_error", "associate"]


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/SE(3) alignment est → gt.

    est, gt: (N, 3). Returns (s, R, t) with gt ≈ s·R·est + t.
    """
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    X = est - mu_e
    Y = gt - mu_g
    C = Y.T @ X / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (X**2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02):
    """Associate timestamps (nearest neighbor within max_dt). Returns index
    pairs (idx_est, idx_gt)."""
    j = np.searchsorted(t_gt, t_est)
    j = np.clip(j, 1, len(t_gt) - 1)
    left = t_gt[j - 1]
    right = t_gt[j]
    pick = np.where(np.abs(t_est - left) < np.abs(t_est - right), j - 1, j)
    ok = np.abs(t_gt[pick] - t_est) <= max_dt
    return np.nonzero(ok)[0], pick[ok]


def absolute_trajectory_error(
    t_est: np.ndarray,
    p_est: np.ndarray,
    t_gt: np.ndarray,
    p_gt: np.ndarray,
    max_dt: float = 0.02,
) -> dict:
    """SE3-aligned ATE. Positions (N,3) with timestamps. Returns dict with
    rmse/mean/median/max in meters and the number of associated poses."""
    ie, ig = associate(t_est, t_gt, max_dt)
    if len(ie) < 3:
        return {"rmse": float("inf"), "n": int(len(ie))}
    e = p_est[ie]
    g = p_gt[ig]
    s, R, t = align_umeyama(e, g, with_scale=False)
    e_aligned = (s * (R @ e.T)).T + t
    err = np.linalg.norm(e_aligned - g, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "max": float(np.max(err)),
        "n": int(len(ie)),
    }
