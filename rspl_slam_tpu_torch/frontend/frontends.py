"""Neural frontend (port of frontend/frontends.py: ``FrameFeatures``,
``NeuralFrontend`` on the eager both-eyes schedule and on the lazy-right
schedule).

Eager: one ``extract_pair`` uploads the stereo pair as 8-bit when lossless,
converts and rectifies it on the device, runs SuperPoint on the B = 2 pair
and the left↔right matcher there and, with lines on, RCF on the pair and
the Hough detector on both edge maps, and brings every host-bound result
back in ONE copy. The disparity gate and the line merge, point assignment
and stereo line matching run on the host. The frame's (xy, score, desc,
valid) stay on the device in ``FrameFeatures.dev`` for tracking.

Lazy right (``lazy_right_extraction``, the reference's own schedule):
``extract_pair`` runs SuperPoint at B = 1 and, with lines on, RCF + Hough on
the LEFT image only, and packs the host-bound results into one device
buffer that nothing copies down until the host first reads a numpy field
(a keyframe, or the promote fallback). The raw right image waits on the
host in ``pending_right`` until :meth:`NeuralFrontend.complete_stereo`
runs the right eye and the stereo match when the frame becomes a keyframe.
Tracked frames are all-mono.

With ``match_outlier_rejection`` every match, stereo and temporal, goes
through the epipolar RANSAC filter (``ops.matching.
fundamental_ransac_inliers``) inside :meth:`NeuralFrontend.match_indices`.

``OracleFrontend`` observes a synthetic scene with known ground truth
(``cli synth`` and the tests): exact projections plus noise, on the JAX
package's numpy random stream, so one seed gives both packages the same
observations.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from rspl_slam_tpu_torch.camera import build_rectify_maps, remap_bilinear
from rspl_slam_tpu_torch.config import SystemConfig
from rspl_slam_tpu_torch.evaluation import synthetic as synth
from rspl_slam_tpu_torch.models import rcf, superglue, superpoint
from rspl_slam_tpu_torch.models.weights import (load_params, rcf_from_numpy,
                                                superglue_from_numpy, superpoint_from_numpy)
from rspl_slam_tpu_torch.ops import lines as lops
from rspl_slam_tpu_torch.ops.matching import (cosine_mutual_match, fundamental_ransac_inliers,
                                             sample_hypotheses)

__all__ = ["FrameFeatures", "NeuralFrontend", "OracleFrontend", "resolve_device"]

_LAZY_FIELDS = ("xy", "score", "desc", "valid", "meas", "depth", "lines",
                "line_valid", "lines_right", "line_has_right", "line_members")


class FrameFeatures:
    """Left-image features + stereo association for one frame (host numpy).

    xy (K, 2) · score (K,) · desc (K, D) · valid (K,) · meas (K, 3)
    [uL, vL, uR (−1 = mono)] · depth (K,); ``dev`` holds the device copies
    of (xy, score, desc, valid).

    Line fields (None with lines off): lines (L, 4) left segments
    [x1, y1, x2, y2] · line_valid (L,) · lines_right (L, 4) the stereo-
    matched right segment · line_has_right (L,) · line_members (L, K)
    keypoints on each line; line_tracks (L,) is stamped with the mapline of
    each line when the frame becomes a keyframe.

    Deferred fields: a frame built with ``packed`` (a device tensor) and
    ``unpack`` (its host parser) copies nothing down until a numpy field
    that is still None is first read; then ONE copy fills every field the
    parser returns. ``pending_right`` holds the raw 8-bit right image of a
    lazy frame until its stereo completion; ``desc_f16`` marks host
    descriptors that come from an f16 device handle (the combined frame
    step's), rounded as the JAX package rounds them.
    """

    def __init__(self, xy=None, score=None, desc=None, valid=None, meas=None,
                 depth=None, lines=None, line_valid=None, lines_right=None,
                 line_has_right=None, line_members=None, image=None, dev=None,
                 pending_right=None, packed=None, unpack=None):
        self._np = {"xy": xy, "score": score, "desc": desc, "valid": valid,
                    "meas": meas, "depth": depth, "lines": lines,
                    "line_valid": line_valid, "lines_right": lines_right,
                    "line_has_right": line_has_right, "line_members": line_members}
        self._packed = packed
        self._unpack = unpack
        self.image = image
        self.dev = dev
        self.pending_right = pending_right
        self.line_tracks = None
        self.desc_f16 = False

    def _materialize(self):
        if self._packed is not None:
            buf = self._packed.cpu().numpy()  # the one device→host copy
            self._packed = None
            self._np.update(self._unpack(buf))
            self._unpack = None

    def __getattr__(self, name):
        # only reached for names not found normally: the fields live in _np
        np_store = object.__getattribute__(self, "_np")
        if name in np_store:
            if np_store[name] is None and object.__getattribute__(self, "_packed") is not None:
                self._materialize()
            return np_store[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in _LAZY_FIELDS:
            self._np[name] = value
        else:
            object.__setattr__(self, name, value)

    @property
    def is_materialized(self) -> bool:
        return self._packed is None

    def device_tensors(self) -> list:
        """Every device tensor the frame holds (``dev`` and a deferred
        buffer), for a consumer on another stream to mark as in use."""
        out = list(self.dev or ())
        if torch.is_tensor(self._packed):
            out.append(self._packed)
        return out

    def stereo_ur(self):
        """The uR column without forcing the download: None for a frame
        still awaiting its stereo completion (all mono by construction)."""
        if self._np["meas"] is None and self._packed is not None \
                and self.pending_right is not None:
            return None
        return self.meas[:, 2]


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
    """uint8 [0, 255] → f32 [0, 1]; float input passes through as f32. The
    divisor is a tensor on the image's device: CUDA divides by a Python
    scalar as a product with its reciprocal, one ulp from ``u8 / 255`` on
    some levels, where the host's loaders (and :func:`_host_to_u8`'s
    lossless check) divide."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) / torch.full((), 255.0, device=img.device)
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


def _host_stack(imgs) -> np.ndarray:
    """Host images → one (B, H, W) array for one upload: 8-bit where every
    image repacks losslessly, else float32 with the 8-bit ones as k/255
    (a plain ``np.stack`` of 8-bit and float images would read 8-bit
    levels as [0, 255] floats)."""
    packed = [_host_to_u8(im) for im in imgs]
    if all(p.dtype == np.uint8 for p in packed):
        return np.stack(packed)
    return np.stack([p.astype(np.float32) / np.float32(255.0) if p.dtype == np.uint8 else p
                     for p in packed])


def _downsample_max(edges: torch.Tensor, ds: int) -> torch.Tensor:
    """(B, H, W) edge maps → (B, H // ds, W // ds) by max-pooling (keeps
    thin ridges that averaging would wash out)."""
    return F.max_pool2d(edges[:, None], ds)[:, 0]


def _downsample_mean(images: torch.Tensor, ds: int) -> torch.Tensor:
    """(B, H, W) images → (B, H // ds, W // ds) by area averaging, the
    reference's ×1/ds resize before line detection."""
    return F.avg_pool2d(images[:, None], ds)[:, 0]


def _mark(device: torch.device):
    """A mark in the device's timeline: a CUDA event on the card, the host
    clock on the CPU (where the work is synchronous)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _elapsed_s(a, b) -> float:
    """Seconds between two :func:`_mark` marks; on the card, once the
    device has passed ``b``."""
    return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a


def _clip_segment(p0, p1, W, H):
    """Liang-Barsky clip of a segment to the image rectangle. Returns
    (q0, q1) or None if fully outside."""
    d = p1 - p0
    t0, t1 = 0.0, 1.0
    for p, q in ((-d[0], p0[0]), (d[0], W - 1 - p0[0]),
                 (-d[1], p0[1]), (d[1], H - 1 - p0[1])):
        if abs(p) < 1e-12:
            if q < 0:
                return None
            continue
        r = q / p
        if p < 0:
            t0 = max(t0, r)
        else:
            t1 = min(t1, r)
        if t0 > t1:
            return None
    return p0 + t0 * d, p0 + t1 * d


def _pad_lines(segs: np.ndarray, max_lines: int):
    out = np.zeros((max_lines, 4), np.float32)
    n = min(len(segs), max_lines)
    if n:
        out[:n] = segs[:n]
    return out, np.arange(max_lines) < n


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

    ``sp_params`` / ``sg_params`` / ``rcf_params``: parameter pytrees in
    the JAX layout (numpy or array-like leaves), or None for the config's
    ``.npz`` weight files or a seeded random init (random RCF weights see
    no edges: ``models.rcf.edge_detector_params`` makes test weights that
    do). ``sp_params`` may also be another frontend's ``sp`` module, which
    the two then share (``parallel.multi_sequence`` batches the extraction
    of frontends that share it). ``device`` defaults to the card.
    """

    def __init__(self, cfg: SystemConfig, sp_params=None, sg_params=None,
                 compute_dtype=torch.bfloat16, seed: int = 0, rcf_params=None,
                 use_lines: bool | None = None, matcher: str = "superglue",
                 rectify: bool = True, keep_images: bool = False,
                 lazy_right: bool | None = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_lines = cfg.use_lines if use_lines is None else use_lines
        # the optional epipolar filter on every match (point_matching.cc:35-45),
        # its hypotheses drawn from a generator on the device, seeded as the
        # JAX package seeds its key (seed + 7)
        self._orej = bool(cfg.pipeline.match_outlier_rejection)
        self._orej_gen = torch.Generator(device=self.device)
        self._orej_gen.manual_seed(seed + 7)
        if matcher not in ("superglue", "cosine"):
            raise ValueError(f"matcher must be 'superglue' or 'cosine', got {matcher!r}")
        self.lazy_right = cfg.pipeline.lazy_right_extraction if lazy_right is None else lazy_right
        # the lazy schedule's transfer contract, counted: right eyes run by
        # complete_stereo, and frames whose descriptors came to the host
        self.stereo_completions = 0
        self.desc_downloads = 0
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
        if isinstance(sp_params, superpoint.SuperPoint):
            self.sp = sp_params
        else:
            if sp_params is None:
                sp_params = (load_params(cfg.superpoint.weights_path, "superpoint")
                             if cfg.superpoint.weights_path
                             else superpoint.init_params(seed))
            self.sp = superpoint_from_numpy(sp_params, self.device)
        if sg_params is None:
            sg_params = (load_params(cfg.superglue.weights_path, "superglue", cfg.superglue)
                         if cfg.superglue.weights_path
                         else superglue.init_params(cfg.superglue, seed + 1))
        self.sg = superglue_from_numpy(sg_params, cfg.superglue, self.device)
        self.timings: dict[str, list] = {}  # rcf_hough (device), lines_host
        self.rcf = None
        if self.use_lines:
            ld = cfg.line_detector
            if rcf_params is None:
                rcf_params = (load_params(ld.rcf_weights_path, "rcf") if ld.rcf_weights_path
                              else rcf.init_params(seed + 1))
            self.rcf = rcf_from_numpy(rcf_params, self.device)

    # ------------------------------------------------------------- matching
    def match_indices(self, xy0, sc0, d0, v0, xy1, sc1, d1, v1) -> torch.Tensor:
        """Batched matching of (B, K, ·) device tensors → indices0 (B, K)
        int32 on the device."""
        if self.matcher == "cosine":
            i0 = cosine_mutual_match(d0, v0, d1, v1)
        else:
            i0 = superglue.match_pair(self.sg, xy0, sc0, d0, v0, xy1, sc1, d1, v1,
                                      self.cfg.superglue,
                                      compute_dtype=self.compute_dtype).indices0
        return self._reject_epipolar(xy0, xy1, i0) if self._orej else i0

    def _reject_epipolar(self, xy0, xy1, i0) -> torch.Tensor:
        """``match_outlier_rejection``: each match of the batch through
        ``fundamental_ransac_inliers``; rejected rows become −1."""
        out = []
        for b in range(i0.shape[0]):
            matched = i0[b] >= 0
            ok = fundamental_ransac_inliers(xy0[b], xy1[b][i0[b].long().clamp_min(0)], matched,
                                            hypotheses=self._orej_hypotheses(matched))
            out.append(torch.where(ok, i0[b], -1))
        return torch.stack(out)

    def _orej_hypotheses(self, matched: torch.Tensor) -> torch.Tensor:
        """One epipolar RANSAC call's (128, 8) hypotheses from the
        frontend's generator."""
        return sample_hypotheses(matched, self._orej_gen)

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

    def _host_equal_features(self, ff: FrameFeatures):
        """:meth:`device_features` with the descriptors the frame's host
        fields hold: f16-rounded where they come from an f16 handle (the
        JAX package matches host fields here)."""
        xy, sc, d, v = self.device_features(ff)
        return xy, sc, (d.half().float() if ff.desc_f16 else d), v

    def match(self, fA: FrameFeatures, fB: FrameFeatures) -> np.ndarray:
        """Temporal matching A→B: indices0 (K,) into B or −1 (host)."""
        a = [t[None] for t in self._host_equal_features(fA)]
        b = [t[None] for t in self._host_equal_features(fB)]
        return self._match_indices(*a, *b)[0].astype(np.int64)

    def _t(self, name: str, seconds: float):
        self.timings.setdefault(name, []).append(seconds)

    # ----------------------------------------------------------- extraction
    def _edge_maps(self, img: torch.Tensor) -> torch.Tensor:
        """RCF edge maps of the rectified (B, H, W) stack at the detection
        scale, on the device. RCF runs at ×1/downsample on the downsampled
        image where the config asks for it and the size allows; otherwise at
        full size, with the edge map max-pooled down to the detection
        scale."""
        ld = self.cfg.line_detector
        ds = max(1, int(ld.downsample))
        _, H, W = img.shape
        if ds > 1 and ld.rcf_at_detection_scale and H % (4 * ds) == 0 \
                and W % (4 * ds) == 0:
            return rcf.edge_map(self.rcf, _downsample_mean(img, ds), self.compute_dtype)
        edges = rcf.edge_map(self.rcf, img, self.compute_dtype)
        return _downsample_max(edges, ds) if ds > 1 else edges

    def _detect_lines(self, edges: torch.Tensor):
        """Hough segments of each (B, h, w) edge map, on the device: (segs
        (B, S, 4) at the detection scale, valid (B, S))."""
        ld = self.cfg.line_detector
        segs, valid, _ = lops.detect_line_segments(
            edges, min_length=float(ld.length_threshold),
            inlier_dist=float(ld.distance_threshold), max_segments=int(ld.max_lines))
        return segs, valid

    def _extract_lines(self, img: torch.Tensor):
        """:meth:`_edge_maps` → :meth:`_detect_lines` for the (B, H, W)
        stack."""
        return self._detect_lines(self._edge_maps(img))

    def _host_merge(self, segs: np.ndarray) -> np.ndarray:
        """The two-pass merge/filter host stage: 30 px filter → merge →
        60 px filter."""
        ld = self.cfg.line_detector
        if ld.do_merge:
            segs = lops.filter_short_lines(segs, 30.0)
            if len(segs):
                segs = lops.merge_lines(segs, ld.angle_thr, ld.distance_thr, ld.ep_thr)
            segs = lops.filter_short_lines(segs, 60.0)
        return segs

    def _merge_stack(self, sv: np.ndarray) -> list:
        """(B, S, 5) host rows [segment at the detection scale; valid] →
        each image's merged segments at full scale."""
        ds = max(1, int(self.cfg.line_detector.downsample))
        return [self._host_merge(np.ascontiguousarray(e[e[:, 4] > 0.5, :4]) * ds) for e in sv]

    def _upload(self, imgs: np.ndarray, eyes: slice) -> torch.Tensor:
        """(B, H, W) host images (8-bit when lossless) → rectified f32 [0, 1]
        on the device, with the rectify maps of ``eyes``."""
        img = _to_unit_float(torch.from_numpy(imgs).to(self.device))
        if self._rect_maps is not None:
            img = remap_bilinear(img, self._rect_maps[eyes])
        return img

    def _eager_features(self, fk: np.ndarray, feats, li: int):
        """One frame's host rows [xyL, score, validL, xyR, validR, i0, desc]
        (K, 8 + D) → (FrameFeatures with the disparity gate applied and the
        device handles of image ``li`` of ``feats``, xyR, validR, i0, uR)."""
        xyL = np.ascontiguousarray(fk[:, 0:2])
        validL = fk[:, 3] > 0.5
        xyR = np.ascontiguousarray(fk[:, 4:6])
        validR = fk[:, 6] > 0.5
        i0 = fk[:, 7].astype(np.int64)
        uR, depth = _stereo_associate(self.cfg, xyL, xyR, validL, validR, i0)
        ff = FrameFeatures(
            xy=xyL, score=np.ascontiguousarray(fk[:, 2]),
            desc=np.ascontiguousarray(fk[:, 8:]), valid=validL,
            meas=np.concatenate([xyL, uR[:, None]], -1), depth=depth,
            dev=(feats.xy[li], feats.score[li], feats.desc[li].to(torch.float32),
                 feats.valid[li]))
        return ff, xyR, validR, i0, uR

    @torch.no_grad()
    def extract_pair(self, img_l: np.ndarray, img_r: np.ndarray) -> FrameFeatures:
        if self.lazy_right:
            return self._extract_left_lazy(img_l, img_r)
        img = self._upload(_host_stack([img_l, img_r]), slice(0, 2))
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
        K = packed.shape[0]
        parts = [packed.reshape(-1)]
        if self.use_lines:
            span = [_mark(self.device)]
            segs, valid = self._extract_lines(img)  # both eyes in one call
            parts += [torch.cat([segs, valid[..., None].to(f32)], -1).reshape(-1)]
            span.append(_mark(self.device))
        buf = torch.cat(parts).cpu().numpy()  # the one device→host copy of the frame
        ff, xyR, validR, i0, uR = self._eager_features(buf[: packed.numel()].reshape(K, -1),
                                                       feats, 0)
        if self.use_lines:
            t0 = time.perf_counter()
            segs_pair = self._merge_stack(buf[packed.numel():].reshape(2, -1, 5))
            self._attach_lines(ff, xyR, validR, i0, uR, segs_pair)
            self._t("rcf_hough", _elapsed_s(*span))
            self._t("lines_host", time.perf_counter() - t0)
        if self.keep_images:
            ff.image = img[0].cpu().numpy()
        return ff

    # ------------------------------------------------------- lazy right eye
    @torch.no_grad()
    def lazy_extract(self, img_l: np.ndarray):
        """Left-eye extraction of the lazy schedule, on the device: the
        8-bit upload and rectification, SuperPoint at B = 1 and, with lines
        on, RCF + Hough. Returns (features, packed, rectified image):
        ``packed`` holds every host-bound result in one f32 buffer, rows
        [xy, score, valid, desc] and then, with lines on, rows [x1, y1, x2,
        y2, valid]."""
        img = self._upload(_host_to_u8(img_l)[None], slice(0, 1))
        feats = superpoint.extract(self.sp, img, self.cfg.superpoint, self.compute_dtype)
        f32 = torch.float32
        parts = [torch.cat([feats.xy[0], feats.score[0][:, None],
                            feats.valid[0][:, None].to(f32), feats.desc[0].to(f32)],
                           -1).reshape(-1)]
        if self.use_lines:
            segs, valid = self._extract_lines(img)
            parts.append(torch.cat([segs[0], valid[0][:, None].to(f32)], -1).reshape(-1))
        return feats, torch.cat(parts), img

    def _lazy_unpack(self, with_desc: bool = True):
        """Host parser of a :meth:`lazy_extract` buffer: keypoint rows
        [xy, score, valid(, desc)], then the segment rows, merged, padded
        and assigned keypoints here. ``with_desc=False`` parses the combined
        frame step's small buffer, whose rows leave the descriptors on the
        device."""
        K = self.cfg.superpoint.max_keypoints
        D = self.cfg.superglue.descriptor_dim
        LN = int(self.cfg.line_detector.max_lines)

        def unpack(buf):
            row = 4 + (D if with_desc else 0)
            fk = buf[: K * row].reshape(K, row)
            xy = np.ascontiguousarray(fk[:, :2])
            valid = fk[:, 3] > 0.5
            out = dict(xy=xy, score=np.ascontiguousarray(fk[:, 2]), valid=valid,
                       meas=np.concatenate([xy, np.full((K, 1), -1.0, np.float32)], -1),
                       depth=np.zeros(K, np.float32))
            if with_desc:
                out["desc"] = np.ascontiguousarray(fk[:, 4:])
                self.desc_downloads += 1
            if self.use_lines:
                sv = buf[K * row: K * row + 5 * LN].reshape(1, LN, 5)
                lines, line_valid = _pad_lines(self._merge_stack(sv)[0], LN)
                members = np.zeros((LN, K), bool)
                nl = int(line_valid.sum())
                if nl:
                    members[:nl] = lops.assign_points_to_lines(lines[:nl], xy, valid)
                out.update(lines=lines, line_valid=line_valid,
                           lines_right=np.zeros((LN, 4), np.float32),
                           line_has_right=np.zeros(LN, bool), line_members=members)
            return out

        return unpack

    def _extract_left_lazy(self, img_l: np.ndarray, img_r: np.ndarray) -> FrameFeatures:
        """The lazy schedule's per-frame extraction: the left eye on the
        device (:meth:`lazy_extract`), its buffer left there until the host
        reads a field, the raw right image held on the host as 8-bit."""
        feats, packed, img = self.lazy_extract(img_l)
        ff = FrameFeatures(pending_right=_host_to_u8(img_r),
                           dev=(feats.xy[0], feats.score[0], feats.desc[0].float(),
                                feats.valid[0]),
                           packed=packed, unpack=self._lazy_unpack())
        if self.keep_images:
            ff.image = img[0].cpu().numpy()
        return ff

    @torch.no_grad()
    def complete_stereo(self, ff: FrameFeatures) -> FrameFeatures:
        """Finish a lazily extracted frame when it becomes a keyframe: one
        chain on the device (upload and rectify the right image, SuperPoint
        at B = 1, the left↔right match against ``ff.dev``, with lines on
        RCF + Hough on the right eye and, for a frame whose descriptors are
        still a device handle, the left descriptors as f16) and ONE copy
        down; then the disparity gate, the right-segment merge and the
        stereo line match on the host. Mutates ``ff`` and returns it; a
        frame without a pending right image is returned as it is."""
        if ff.pending_right is None:
            return ff
        K = self.cfg.superpoint.max_keypoints
        LN = int(self.cfg.line_detector.max_lines)
        img = self._upload(np.asarray(ff.pending_right)[None], slice(1, 2))
        featsR = superpoint.extract(self.sp, img, self.cfg.superpoint, self.compute_dtype)
        q = self.device_features(ff)
        i0 = self.match_indices(*[t[None] for t in q], featsR.xy, featsR.score,
                                featsR.desc, featsR.valid)[0]
        f32 = torch.float32
        parts = [featsR.xy[0].reshape(-1), featsR.valid[0].to(f32), i0.to(f32)]
        if self.use_lines:
            segs, valid = self._extract_lines(img)
            parts.append(torch.cat([segs[0], valid[0][:, None].to(f32)], -1).reshape(-1))
        # a combined-step frame (host xy, device descriptors): its left
        # descriptors ride this copy as f16 pairs in f32 words
        want_desc = (ff._np["desc"] is None and ff._packed is not None
                     and ff._np["xy"] is not None)
        if want_desc:
            parts.append(q[2].half().reshape(-1).view(f32))
        buf = torch.cat(parts).cpu().numpy()  # the one device→host copy
        self.stereo_completions += 1
        xyR = np.ascontiguousarray(buf[: 2 * K].reshape(K, 2))
        validR = buf[2 * K: 3 * K] > 0.5
        i0 = buf[3 * K: 4 * K].astype(np.int64)
        end = 4 * K
        segs_r = None
        if self.use_lines:
            segs_r = self._merge_stack(buf[end: end + 5 * LN].reshape(1, LN, 5))[0]
            end += 5 * LN
        if want_desc:
            D = q[2].shape[-1]
            d16 = np.ascontiguousarray(buf[end: end + K * D // 2]).view(np.float16)
            ff.desc = d16.astype(np.float32).reshape(K, D)
            ff._packed = None  # the f16 handle is no longer needed
            ff._unpack = None
            self.desc_downloads += 1
        uR, depth = _stereo_associate(self.cfg, ff.xy, xyR, ff.valid, validR, i0)
        ff.meas[:, 2] = uR
        ff.depth = depth
        if self.use_lines and ff.lines is not None:
            nl = int(ff.line_valid.sum())
            if nl and len(segs_r):
                members_r = lops.assign_points_to_lines(segs_r, xyR, validR)
                lm = lops.match_lines(ff.line_members[:nl], members_r, np.where(uR >= 0, i0, -1))
                hit = np.nonzero(lm >= 0)[0]
                ff.lines_right[hit] = segs_r[lm[hit]]
                ff.line_has_right[hit] = True
        ff.pending_right = None
        return ff

    # ----------------------------------------------------- multi-sequence batch
    @torch.no_grad()
    def extract_pairs_batched(self, pairs, frontends) -> list:
        """Eager extraction for N sequences that share this frontend's
        networks: ONE upload of all 2N images (each frontend's rectify maps
        concatenated, identity where it has none), ONE SuperPoint call (K1
        once over the 2N images), ONE matcher call over the N stereo
        problems, and ONE device→host copy of every host-bound result. The
        disparity gate runs per sequence on the host; lines stay per
        sequence (each line-enabled frontend's RCF + Hough on its rectified
        pair, then ``_attach_lines``). ``pairs``: N (img_l, img_r);
        ``frontends``: the per-sequence NeuralFrontends. Returns N
        FrameFeatures."""
        N = len(pairs)
        host = _host_stack([im for p in pairs for im in p])  # (2N, H, W)
        img = _to_unit_float(torch.from_numpy(host).to(self.device))
        if any(fe._rect_maps is not None for fe in frontends):
            H, W = img.shape[-2:]
            ident = None
            maps = []
            for fe in frontends:
                if fe._rect_maps is None and ident is None:
                    ys, xs = torch.meshgrid(
                        torch.arange(H, dtype=torch.float32, device=self.device),
                        torch.arange(W, dtype=torch.float32, device=self.device),
                        indexing="ij")
                    ident = torch.stack([xs, ys], -1)[None].expand(2, H, W, 2)
                maps.append(fe._rect_maps if fe._rect_maps is not None else ident)
            img = remap_bilinear(img, torch.cat(maps))
        feats = superpoint.extract(self.sp, img, self.cfg.superpoint, self.compute_dtype)
        left, right = slice(0, 2 * N, 2), slice(1, 2 * N, 2)
        i0 = self.match_indices(feats.xy[left], feats.score[left], feats.desc[left],
                                feats.valid[left], feats.xy[right], feats.score[right],
                                feats.desc[right], feats.valid[right])  # (N, K)
        f32 = torch.float32
        packed = torch.cat([
            feats.xy[left], feats.score[left][..., None], feats.valid[left][..., None].to(f32),
            feats.xy[right], feats.valid[right][..., None].to(f32), i0[..., None].to(f32),
            feats.desc[left].to(f32)], -1)  # (N, K, 8 + D)
        parts = [packed.reshape(-1)]
        with_lines = [s for s, fe in enumerate(frontends) if fe.use_lines]
        for s in with_lines:
            segs, valid = frontends[s]._extract_lines(img[2 * s: 2 * s + 2])
            parts.append(torch.cat([segs, valid[..., None].to(f32)], -1).reshape(-1))
        buf = torch.cat(parts).cpu().numpy()  # the one device→host copy of the step
        fk_all = buf[: packed.numel()].reshape(packed.shape)
        seg_rows = buf[packed.numel():].reshape(len(with_lines), 2, -1, 5) if with_lines else None
        out = []
        for s, fe in enumerate(frontends):
            ff, xyR, validR, i0s, uR = self._eager_features(fk_all[s], feats, 2 * s)
            if fe.use_lines:
                segs_pair = fe._merge_stack(seg_rows[with_lines.index(s)])
                fe._attach_lines(ff, xyR, validR, i0s, uR, segs_pair)
            if fe.keep_images:
                ff.image = img[2 * s].cpu().numpy()
            out.append(ff)
        return out

    @torch.no_grad()
    def match_batched(self, pairs) -> list:
        """Temporal matching of N (fA, fB) frame pairs in ONE matcher call
        and one copy down: indices0 (K,) into each fB, or −1."""
        a = [self._host_equal_features(fa) for fa, _ in pairs]
        b = [self._host_equal_features(fb) for _, fb in pairs]
        stack = lambda fs: [torch.stack(t) for t in zip(*fs)]  # noqa: E731
        i0 = self._match_indices(*stack(a), *stack(b)).astype(np.int64)
        return list(i0)

    def _attach_lines(self, ff: FrameFeatures, xyR, validR, i0, uR, segs_pair):
        """Pad the merged left segments, assign keypoints to them, and match
        them to the right segments through the gated stereo point matches."""
        segs_l, segs_r = segs_pair
        LN = self.cfg.line_detector.max_lines
        lines, line_valid = _pad_lines(segs_l, LN)
        members = np.zeros((LN, len(ff.xy)), bool)
        nl = int(line_valid.sum())
        if nl:
            members[:nl] = lops.assign_points_to_lines(lines[:nl], ff.xy, ff.valid)
        lines_right = np.zeros((LN, 4), np.float32)
        has_right = np.zeros(LN, bool)
        if nl and len(segs_r):
            members_r = lops.assign_points_to_lines(segs_r, xyR, validR)
            lm = lops.match_lines(members[:nl], members_r, np.where(uR >= 0, i0, -1))
            hit = np.nonzero(lm >= 0)[0]
            lines_right[hit] = segs_r[lm[hit]]
            has_right[hit] = True
        ff.lines = lines
        ff.line_valid = line_valid
        ff.lines_right = lines_right
        ff.line_has_right = has_right
        ff.line_members = members
        return ff


class OracleFrontend:
    """Synthetic-scene frontend with known ground truth.

    Keypoints are exact projections of scene landmarks (+ noise and
    outliers); descriptors are the scene's per-landmark unit vectors, so
    mutual-NN cosine matching is exact. Draws follow the JAX package's
    numpy stream call for call. It has no ``matcher``, so ``SLAMSystem``
    tracks it on the unfused path (host matching, then PnP and pose-only LM
    on ``device``)."""

    def __init__(self, cfg: SystemConfig, scene: synth.SyntheticScene,
                 noise_px: float = 0.3, outlier_frac: float = 0.0,
                 desc_noise: float = 0.02, seed: int = 0,
                 use_lines: bool | None = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_lines = cfg.use_lines if use_lines is None else use_lines
        self.scene = scene
        self.noise_px = noise_px
        self.outlier_frac = outlier_frac
        self.desc_noise = desc_noise
        self.rng = np.random.default_rng(seed)
        self._frame_idx = 0
        self.poses = None  # (N, 4, 4) ground-truth trajectory, set by the caller

    def observe(self, Twc: np.ndarray) -> FrameFeatures:
        cfg = self.cfg
        K = cfg.superpoint.max_keypoints
        obs = synth.observe_points(self.scene, cfg.camera, Twc, noise_px=self.noise_px,
                                   outlier_frac=self.outlier_frac,
                                   seed=int(self.rng.integers(1 << 31)))
        vis = np.nonzero(obs["visible"])[0]
        self.rng.shuffle(vis)
        vis = vis[:K]
        n = len(vis)
        D = self.scene.descriptors.shape[1]
        xy = np.zeros((K, 2), np.float32)
        meas = np.full((K, 3), -1.0, np.float32)
        depth = np.zeros(K, np.float32)
        desc = np.zeros((K, D), np.float32)
        valid = np.zeros(K, bool)
        xy[:n] = obs["uv_left"][vis]
        meas[:n, :2] = obs["uv_left"][vis]
        meas[:n, 2] = obs["uv_right"][vis, 0]
        depth[:n] = obs["depth"][vis]
        d = (self.scene.descriptors[vis]
             + self.rng.standard_normal((n, D)).astype(np.float32) * self.desc_noise)
        desc[:n] = d / np.linalg.norm(d, axis=1, keepdims=True)
        valid[:n] = True
        ff = FrameFeatures(xy=xy, score=valid.astype(np.float32) * 0.9, desc=desc,
                           valid=valid, meas=meas, depth=depth)
        ff.landmark_ids = np.full(K, -1, np.int64)
        ff.landmark_ids[:n] = vis
        if self.use_lines and len(self.scene.lines):
            self._add_oracle_lines(ff, Twc)
        return ff

    def _add_oracle_lines(self, ff: FrameFeatures, Twc: np.ndarray):
        """Project the scene's 3D segments into both cameras, clip them to
        the image, and attach them with point membership and right
        segments."""
        cam = self.cfg.camera
        LN = self.cfg.line_detector.max_lines
        H, W = cam.image_height, cam.image_width
        Tcw = np.linalg.inv(Twc)
        segs_l, segs_r, ids = [], [], []
        for li, seg in enumerate(self.scene.lines):
            Pc = seg @ Tcw[:3, :3].T + Tcw[:3, 3]
            if (Pc[:, 2] < cam.depth_lower_thr).any():
                continue
            u = cam.fx * Pc[:, 0] / Pc[:, 2] + cam.cx
            v = cam.fy * Pc[:, 1] / Pc[:, 2] + cam.cy
            ur = u - cam.bf / Pc[:, 2]
            cl = _clip_segment(np.array([u[0], v[0]]), np.array([u[1], v[1]]), W, H)
            cr = _clip_segment(np.array([ur[0], v[0]]), np.array([ur[1], v[1]]), W, H)
            if cl is None or np.linalg.norm(cl[1] - cl[0]) < 20:
                continue
            segs_l.append(np.concatenate(cl) + self.rng.standard_normal(4) * self.noise_px)
            if cr is not None and np.linalg.norm(cr[1] - cr[0]) >= 20:
                segs_r.append(np.concatenate(cr) + self.rng.standard_normal(4) * self.noise_px)
            else:
                segs_r.append(None)
            ids.append(li)
        lines = np.zeros((LN, 4), np.float32)
        line_valid = np.zeros(LN, bool)
        lines_right = np.zeros((LN, 4), np.float32)
        has_right = np.zeros(LN, bool)
        members = np.zeros((LN, len(ff.xy)), bool)
        line_ids = np.full(LN, -1, np.int64)
        n = min(len(segs_l), LN)
        for i in range(n):
            lines[i] = segs_l[i]
            line_valid[i] = True
            line_ids[i] = ids[i]
            if segs_r[i] is not None:
                lines_right[i] = segs_r[i]
                has_right[i] = True
        if n:
            members[:n] = lops.assign_points_to_lines(lines[:n], ff.xy, ff.valid)
        ff.lines = lines
        ff.line_valid = line_valid
        ff.lines_right = lines_right
        ff.line_has_right = has_right
        ff.line_members = members
        ff.line_ids = line_ids

    def extract_pair(self, img_l, img_r) -> FrameFeatures:
        """The images are ignored: the pose comes from ``poses`` by call
        order."""
        if self.poses is None:
            raise RuntimeError("OracleFrontend.poses must be set")
        ff = self.observe(self.poses[self._frame_idx])
        self._frame_idx += 1
        return ff

    def complete_stereo(self, ff: FrameFeatures) -> FrameFeatures:
        """Oracle features always carry full stereo."""
        return ff

    def match(self, fA: FrameFeatures, fB: FrameFeatures) -> np.ndarray:
        """Mutual-NN cosine matching on the host (exact for oracle
        descriptors)."""
        sim = fA.desc @ fB.desc.T
        sim[~fA.valid] = -2.0
        sim[:, ~fB.valid] = -2.0
        a2b = sim.argmax(1)
        b2a = sim.argmax(0)
        rows = np.arange(len(a2b))
        ok = fA.valid & fB.valid[a2b] & (b2a[a2b] == rows) & (sim[rows, a2b] > 0.7)
        return np.where(ok, a2b, -1).astype(np.int64)
