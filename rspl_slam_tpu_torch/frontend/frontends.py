"""Neural frontend (port of frontend/frontends.py: ``FrameFeatures``,
``NeuralFrontend`` on the eager both-eyes schedule).

One ``extract_pair`` uploads the stereo pair as 8-bit when lossless,
converts and rectifies it on the device, runs SuperPoint on the B = 2 pair
and the left↔right matcher there, and brings every host-bound result back
in ONE copy; the disparity gate runs on the host. The frame's (xy, score,
desc, valid) stay on the device in ``FrameFeatures.dev`` for tracking.
"""

from __future__ import annotations

import numpy as np
import torch

from rspl_slam_tpu_torch.camera import build_rectify_maps, remap_bilinear
from rspl_slam_tpu_torch.config import SystemConfig
from rspl_slam_tpu_torch.models import superglue, superpoint
from rspl_slam_tpu_torch.models.weights import (load_params, superglue_from_numpy,
                                                superpoint_from_numpy)
from rspl_slam_tpu_torch.ops.matching import cosine_mutual_match

__all__ = ["FrameFeatures", "NeuralFrontend", "resolve_device"]


class FrameFeatures:
    """Left-image features + stereo association for one frame (host numpy).

    xy (K, 2) · score (K,) · desc (K, D) · valid (K,) · meas (K, 3)
    [uL, vL, uR (−1 = mono)] · depth (K,); ``dev`` holds the device copies
    of (xy, score, desc, valid). Line fields stay None in this slice.
    """

    def __init__(self, xy=None, score=None, desc=None, valid=None, meas=None,
                 depth=None, image=None, dev=None):
        self.xy = xy
        self.score = score
        self.desc = desc
        self.valid = valid
        self.meas = meas
        self.depth = depth
        self.image = image
        self.dev = dev
        self.lines = None
        self.line_members = None
        self.pending_right = None


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA request without a visible
    card raises (the port never carries on silently on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is visible; "
            "pass device='cpu' to run the port on the CPU")
    return dev


def _to_unit_float(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] → f32 [0, 1]; float input passes through as f32."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) / 255.0
    return img.to(torch.float32)


def _host_to_u8(img: np.ndarray) -> np.ndarray:
    """Lossless 8-bit repack when the float image sits on the k/255 grid;
    off-grid input stays float32."""
    if img.dtype == np.uint8:
        return img
    u8 = np.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    if np.array_equal(u8.astype(np.float32) / np.float32(255.0), img):
        return u8
    return np.asarray(img, np.float32)


def _stereo_associate(cfg: SystemConfig, xyL, xyR, validL, validR, i0):
    """Left-right matches → per-left-keypoint uR/depth through the disparity
    gate min_x_diff < uL−uR < max_x_diff, |vL−vR| ≤ max_y_diff."""
    cam = cfg.camera
    j = np.maximum(i0, 0)
    matched = (i0 >= 0) & validL & validR[j]
    dx = xyL[:, 0] - xyR[j, 0]
    dy = np.abs(xyL[:, 1] - xyR[j, 1])
    ok = matched & (dx > cam.min_x_diff) & (dx < cam.max_x_diff) & (dy <= cam.max_y_diff)
    uR = np.where(ok, xyR[j, 0], -1.0).astype(np.float32)
    depth = np.where(ok, cam.bf / np.maximum(dx, 1e-9), 0.0).astype(np.float32)
    return uR, depth


class NeuralFrontend:
    """Production frontend: SuperPoint + SuperGlue (or the cosine
    mutual-NN matcher) on one device.

    ``sp_params`` / ``sg_params``: parameter pytrees in the JAX layout
    (numpy or array-like leaves), or None for the config's ``.npz`` weight
    files or a seeded random init. ``device`` defaults to the card.
    """

    def __init__(self, cfg: SystemConfig, sp_params=None, sg_params=None,
                 compute_dtype=torch.bfloat16, seed: int = 0, rcf_params=None,
                 use_lines: bool | None = None, matcher: str = "superglue",
                 rectify: bool = True, keep_images: bool = False,
                 lazy_right: bool | None = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_lines = cfg.use_lines if use_lines is None else use_lines
        if self.use_lines or rcf_params is not None:
            raise NotImplementedError(
                "use_lines=True: RCF + Hough lines are not ported yet "
                "(ROADMAP.md, remaining slice 1)")
        lazy = cfg.pipeline.lazy_right_extraction if lazy_right is None else lazy_right
        if lazy:
            raise NotImplementedError(
                "lazy_right_extraction=True: the lazy-right schedule is not "
                "ported yet (ROADMAP.md, remaining slice 3)")
        if cfg.pipeline.match_outlier_rejection:
            raise NotImplementedError(
                "match_outlier_rejection: the epipolar RANSAC filter is not "
                "ported yet (ROADMAP.md, modules to port)")
        if matcher not in ("superglue", "cosine"):
            raise ValueError(f"matcher must be 'superglue' or 'cosine', got {matcher!r}")
        self.lazy_right = False
        self.matcher = matcher
        self.keep_images = keep_images
        self.compute_dtype = compute_dtype
        if self.device.type == "cuda":
            # f32 stays f32 on the card: cuDNN would run f32 convs in TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._rect_maps = None
        if rectify:
            ml = build_rectify_maps(cfg.camera, "left")
            mr = build_rectify_maps(cfg.camera, "right")
            if ml is not None and mr is not None:
                self._rect_maps = torch.from_numpy(np.stack([ml, mr])).to(self.device)
        if sp_params is None:
            sp_params = (load_params(cfg.superpoint.weights_path)
                         if cfg.superpoint.weights_path
                         else superpoint.init_params(seed))
        if sg_params is None:
            sg_params = (load_params(cfg.superglue.weights_path)
                         if cfg.superglue.weights_path
                         else superglue.init_params(cfg.superglue, seed + 1))
        self.sp = superpoint_from_numpy(sp_params, self.device)
        self.sg = superglue_from_numpy(sg_params, cfg.superglue, self.device)

    # ------------------------------------------------------------- matching
    def match_indices(self, xy0, sc0, d0, v0, xy1, sc1, d1, v1) -> torch.Tensor:
        """Batched matching of (B, K, ·) device tensors → indices0 (B, K)
        int32 on the device."""
        if self.matcher == "cosine":
            return cosine_mutual_match(d0, v0, d1, v1)
        return superglue.match_pair(self.sg, xy0, sc0, d0, v0, xy1, sc1, d1, v1,
                                    self.cfg.superglue).indices0

    def _match_indices(self, xy0, sc0, d0, v0, xy1, sc1, d1, v1) -> np.ndarray:
        """:meth:`match_indices` with the result on the host."""
        return self.match_indices(xy0, sc0, d0, v0, xy1, sc1, d1, v1).cpu().numpy()

    def device_features(self, ff: FrameFeatures):
        """(xy, score, desc, valid) of a frame on the device."""
        if ff.dev is not None:
            return ff.dev
        t = lambda a: torch.as_tensor(np.asarray(a)).to(self.device)  # noqa: E731
        ff.dev = (t(ff.xy).float(), t(ff.score).float(), t(ff.desc).float(),
                  t(ff.valid).bool())
        return ff.dev

    def match(self, fA: FrameFeatures, fB: FrameFeatures) -> np.ndarray:
        """Temporal matching A→B: indices0 (K,) into B or −1 (host)."""
        a = [t[None] for t in self.device_features(fA)]
        b = [t[None] for t in self.device_features(fB)]
        return self._match_indices(*a, *b)[0].astype(np.int64)

    # ----------------------------------------------------------- extraction
    @torch.no_grad()
    def extract_pair(self, img_l: np.ndarray, img_r: np.ndarray) -> FrameFeatures:
        imgs = np.stack([_host_to_u8(img_l), _host_to_u8(img_r)])
        img = _to_unit_float(torch.from_numpy(imgs).to(self.device))
        if self._rect_maps is not None:
            img = remap_bilinear(img, self._rect_maps)
        feats = superpoint.extract(self.sp, img, self.cfg.superpoint, self.compute_dtype)
        i0 = self.match_indices(
            feats.xy[:1], feats.score[:1], feats.desc[:1], feats.valid[:1],
            feats.xy[1:], feats.score[1:], feats.desc[1:], feats.valid[1:])[0]
        f32 = torch.float32
        packed = torch.cat([
            feats.xy[0], feats.score[0][:, None], feats.valid[0][:, None].to(f32),
            feats.xy[1], feats.valid[1][:, None].to(f32), i0[:, None].to(f32),
            feats.desc[0].to(f32),
        ], -1)
        buf = packed.cpu().numpy()  # the one device→host copy of the frame
        xyL = np.ascontiguousarray(buf[:, 0:2])
        validL = buf[:, 3] > 0.5
        xyR = np.ascontiguousarray(buf[:, 4:6])
        validR = buf[:, 6] > 0.5
        i0 = buf[:, 7].astype(np.int64)
        uR, depth = _stereo_associate(self.cfg, xyL, xyR, validL, validR, i0)
        ff = FrameFeatures(
            xy=xyL, score=np.ascontiguousarray(buf[:, 2]),
            desc=np.ascontiguousarray(buf[:, 8:]), valid=validL,
            meas=np.concatenate([xyL, uR[:, None]], -1), depth=depth,
            dev=(feats.xy[0], feats.score[0], feats.desc[0].to(f32), feats.valid[0]),
        )
        if self.keep_images:
            ff.image = img[0].cpu().numpy()
        return ff
