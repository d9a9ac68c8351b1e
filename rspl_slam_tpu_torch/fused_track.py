"""Fused per-frame tracking step (port of fused_track.py): temporal
matching + map association + PnP-RANSAC + pose-only LM queued on the
device as one chain, with ONE packed host→device upload of the per-frame
host state and ONE packed device→host copy of every result.

The query features stay on the device from extraction
(``FrameFeatures.dev``); the reference keyframe's are cached by identity.
A lazy frame still awaiting its stereo completion is tracked all-mono
without copying its features down. The RANSAC draws come from a
``torch.Generator`` reseeded per frame with the caller's seed, as the JAX
tracker derives a PRNG key per frame.
"""

from __future__ import annotations

import numpy as np
import torch

from rspl_slam_tpu_torch.backend import pnp, pose_solver
from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
from rspl_slam_tpu_torch.geometry import se3

__all__ = ["fused_track_core", "FusedTracker"]


@torch.no_grad()
def fused_track_core(match_fn, K: CameraIntrinsics,
                     q_xy, q_score, q_desc, q_valid,
                     r_xy, r_score, r_desc, r_valid,
                     q_ur, ref_pos, ref_good, Twc_last,
                     generator: torch.Generator, chi2_mono: float,
                     chi2_stereo: float) -> torch.Tensor:
    """Returns the packed track vector [i0; inlier; Twc (16); n_inl] (f32)."""
    i0 = match_fn(q_xy[None], q_score[None], q_desc[None], q_valid[None],
                  r_xy[None], r_score[None], r_desc[None], r_valid[None])[0].long()
    j = i0.clamp_min(0)
    valid = (i0 >= 0) & q_valid & ref_good[j]
    Xw = torch.where(valid[:, None], ref_pos[j], 0.0)
    stereo = valid & (q_ur > 0)
    meas = torch.cat([torch.where(valid[:, None], q_xy, 0.0),
                      torch.where(stereo, q_ur, 0.0)[:, None]], -1)
    n_valid = valid.sum()

    pr = pnp.pnp_ransac(K, Twc_last, Xw, meas[:, :2], valid, generator)
    Twc_pnp = se3.inverse(pr.Tcw)
    jump = torch.linalg.norm(Twc_pnp[:3, 3] - Twc_last[:3, 3])
    use_prior = (~pr.ok) | (jump > 0.5)
    Twc_init = torch.where(use_prior, Twc_last, Twc_pnp)
    out = pose_solver.optimize_pose(K, Twc_init, Xw, meas, stereo, valid,
                                    chi2_mono=chi2_mono, chi2_stereo=chi2_stereo)
    # under-constrained (< 8 correspondences): hold the last pose, 0 inliers
    enough = n_valid >= 8
    Twc_opt = torch.where(enough, se3.inverse(out.Tcw), Twc_last)
    n_inl = torch.where(enough, out.num_inliers, 0)
    inlier = out.inlier & enough
    f32 = torch.float32
    return torch.cat([i0.to(f32), inlier.to(f32), Twc_opt.reshape(16).to(f32),
                      n_inl.reshape(1).to(f32)])


class FusedTracker:
    """Binds a NeuralFrontend's device matcher and the camera / gate config
    into the one-chain tracking step."""

    def __init__(self, frontend, K: CameraIntrinsics, chi2_mono: float,
                 chi2_stereo: float):
        self.frontend = frontend
        self.device = frontend.device
        self.K = K
        self.chi2 = (float(chi2_mono), float(chi2_stereo))
        self._ref_obj = None  # strong ref: identity stays valid while held
        self._ref_dev = None
        self._gen = torch.Generator(device=self.device)

    def ref_features(self, ref_feats):
        """The reference keyframe's device features, cached by identity."""
        if self._ref_obj is not ref_feats:
            self._ref_dev = self.frontend.device_features(ref_feats)
            self._ref_obj = ref_feats
        return self._ref_dev

    def generator(self, seed: int) -> torch.Generator:
        """The RANSAC generator, reseeded for one frame."""
        self._gen.manual_seed(seed)
        return self._gen

    def track(self, feats, ref_feats, ref_pos: np.ndarray, ref_good: np.ndarray,
              Twc_last: np.ndarray, seed: int):
        """Returns host (i0, Twc, n_inliers, inlier)."""
        r = self.ref_features(ref_feats)
        q = self.frontend.device_features(feats)
        Kp = int(q[0].shape[0])
        host = np.empty(5 * Kp + 16, np.float32)
        ur = feats.stereo_ur()
        host[:Kp] = -1.0 if ur is None else ur
        host[Kp: 4 * Kp] = np.asarray(ref_pos, np.float32).reshape(-1)
        host[4 * Kp: 5 * Kp] = ref_good
        host[5 * Kp:] = np.asarray(Twc_last, np.float32).reshape(-1)
        h = torch.from_numpy(host).to(self.device)  # the one upload
        packed = fused_track_core(
            self.frontend.match_indices, self.K, *q, *r,
            h[:Kp], h[Kp: 4 * Kp].reshape(Kp, 3), h[4 * Kp: 5 * Kp] > 0.5,
            h[5 * Kp:].reshape(4, 4), self.generator(seed), *self.chi2)
        buf = packed.cpu().numpy()  # the one download
        i0 = buf[:Kp].astype(np.int64)
        inlier = buf[Kp: 2 * Kp] > 0.5
        Twc = buf[2 * Kp: 2 * Kp + 16].reshape(4, 4).astype(np.float64)
        return i0, Twc, int(buf[2 * Kp + 16]), inlier
