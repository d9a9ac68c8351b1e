"""Combined per-frame step of the lazy-right schedule (port of frame_step.py):
extraction AND tracking of a frame as one chain on the device.

Left-eye extraction (``NeuralFrontend.lazy_extract``: SuperPoint at B = 1,
with lines on RCF + Hough) feeds ``fused_track_core`` directly, all-mono
(``q_ur = −1``: a tracked frame has no right eye yet). The per-frame host
state [ref_pos; ref_good; Twc_last] goes up in ONE pinned copy, and ONE copy
brings down the small buffer: the [xy, score, valid] keypoint rows, the
segment rows and the track result. The (K, D) descriptors stay on the
device as an f16 handle that comes down only when the frame becomes a
keyframe (with its stereo completion), so the host's descriptors are
f16-rounded where the JAX package rounds them.
"""

from __future__ import annotations

import numpy as np
import torch

from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
from rspl_slam_tpu_torch.frontend.frontends import FrameFeatures, _host_to_u8
from rspl_slam_tpu_torch.fused_track import FusedTracker, fused_track_core

__all__ = ["CombinedTracker"]


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host→device copy: pinned and ``non_blocking`` on a card."""
    t = torch.from_numpy(host)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class CombinedTracker:
    """One chain per tracked frame for a lazy-right NeuralFrontend: binds
    its extraction and matcher to the tracking solver, caches the reference
    keyframe's device features, and parses the one copy into
    (FrameFeatures, i0, pose result)."""

    def __init__(self, frontend, K: CameraIntrinsics, chi2_mono: float, chi2_stereo: float):
        self.fe = frontend
        self.tracker = FusedTracker(frontend, K, chi2_mono, chi2_stereo)

    def supported(self) -> bool:
        """The JAX package's rule, kept so that the same frames take the same
        route in both packages: a lazy-right frontend, and with lines on RCF
        at the detection scale (downsample > 1) on an image whose sides are
        multiples of 4·downsample, and no epipolar filter (which the JAX
        package runs on its host match path). (K1 itself needs only even
        sides.)"""
        fe = self.fe
        if not fe.lazy_right or fe._orej:
            return False
        ld = fe.cfg.line_detector
        ds = max(1, int(ld.downsample))
        cam = fe.cfg.camera
        return (not fe.use_lines) or (
            ds > 1 and ld.rcf_at_detection_scale
            and cam.image_height % (4 * ds) == 0 and cam.image_width % (4 * ds) == 0)

    def _desc_from_handle(self, buf: np.ndarray) -> dict:
        self.fe.desc_downloads += 1
        return {"desc": buf.astype(np.float32)}

    @torch.no_grad()
    def step(self, img_l: np.ndarray, img_r: np.ndarray, ref_feats, ref_pos: np.ndarray,
             ref_good: np.ndarray, Twc_last: np.ndarray, seed: int):
        """Returns (FrameFeatures, i0, Twc, n_inliers, inlier), all host."""
        fe = self.fe
        dev = fe.device
        K = fe.cfg.superpoint.max_keypoints
        LN = int(fe.cfg.line_detector.max_lines)
        feats, packed, img = fe.lazy_extract(img_l)
        host = np.empty(4 * K + 16, np.float32)
        host[: 3 * K] = np.asarray(ref_pos, np.float32).reshape(-1)
        host[3 * K: 4 * K] = ref_good
        host[4 * K:] = np.asarray(Twc_last, np.float32).reshape(-1)
        h = _upload(host, dev)
        q = (feats.xy[0], feats.score[0], feats.desc[0].float(), feats.valid[0])
        t = self.tracker
        track = fused_track_core(
            fe.match_indices, t.K, *q, *t.ref_features(ref_feats),
            torch.full((K,), -1.0, device=dev), h[: 3 * K].reshape(K, 3),
            h[3 * K: 4 * K] > 0.5, h[4 * K:].reshape(4, 4), t.generator(seed), *t.chi2)
        row = 4 + q[2].shape[-1]
        small = torch.cat([packed[: K * row].reshape(K, row)[:, :4].reshape(-1),
                           packed[K * row:], track])
        buf = small.cpu().numpy()  # the frame's one device→host copy
        n_extract = 4 * K + (5 * LN if fe.use_lines else 0)
        ff = FrameFeatures(pending_right=_host_to_u8(img_r), dev=q, packed=q[2].half(),
                           unpack=self._desc_from_handle,
                           **fe._lazy_unpack(with_desc=False)(buf[:n_extract]))
        ff.desc_f16 = True
        if fe.keep_images:
            ff.image = img[0].cpu().numpy()
        tb = buf[n_extract:]
        i0 = tb[:K].astype(np.int64)
        inlier = tb[K: 2 * K] > 0.5
        Twc = tb[2 * K: 2 * K + 16].reshape(4, 4).astype(np.float64)
        return ff, i0, Twc, int(tb[2 * K + 16]), inlier
