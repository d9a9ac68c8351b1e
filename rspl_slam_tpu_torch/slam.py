"""Top-level SLAM system (port of slam.py: the main path and the lazy-right
schedule).

Per-frame flow, as in the JAX package: stereo extraction (points and,
with lines on, RCF + Hough segments) → (first frame) map initialization →
fused tracking against the reference keyframe (temporal SuperGlue + map
association + PnP-RANSAC + pose-only LM on the device) with the
promote-last-frame fallback → keyframe policy → keyframe insertion on the
host map store with batched multi-view point triangulation, temporal line
matching, mapline bookkeeping and batched 3D line fits on the device →
local BA of the keyframe's covisibility window (points and lines). Host
bookkeeping stays numpy f64 where the JAX package has it.

Local BA runs after every keyframe insertion once the map holds two
keyframes. With ``async_ba`` (the default) the window's solve is issued on
a side CUDA stream, its packed result copied into pinned host memory
behind an event, and applied at the next :meth:`SLAMSystem.flush_ba` (the
next keyframe insertion, or a trajectory save): tracking goes on against
the map as it was, as the JAX package's async mode does. On CPU tensors
the solve runs at dispatch and is applied at the flush, so the map passes
through the same states. ``async_ba=False`` solves and applies at once.

With ``lazy_right_extraction`` (the reference's own schedule) a frame's right
eye waits on the host until the frame initializes the map or becomes a
keyframe (``NeuralFrontend.complete_stereo``, called at the top of
:meth:`SLAMSystem._init_map` and, after the BA flush, of
:meth:`SLAMSystem._insert_keyframe`); tracked frames are all-mono. Once the
map is initialized, :meth:`SLAMSystem.add_frame` runs extraction and
tracking as one chain (``frame_step.CombinedTracker``) where
:meth:`SLAMSystem.wants_images` says so; ``pipeline.PipelinedRunner``
consults the same method.

Tracking is fused (match, association, PnP and pose-only LM as one device
chain) for a frontend whose ``matcher`` is SuperGlue or cosine, as in the
JAX package; other frontends (``OracleFrontend``) take the unfused path:
``frontend.match`` on the host, then :meth:`SLAMSystem._pose_optimize`.
:meth:`SLAMSystem.save_map` and :meth:`SLAMSystem.resume_from_map` write and
resume a map checkpoint; :meth:`SLAMSystem.cull_redundant_keyframes` bounds
the map on an endless feed.

Not ported yet, and raising ``NotImplementedError`` rather than degrading:
loop closure and relocalization (ROADMAP.md).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from rspl_slam_tpu_torch.backend import local_ba, map_store, pnp, pose_solver
from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
from rspl_slam_tpu_torch.config import SystemConfig
from rspl_slam_tpu_torch.datasets import write_tum_trajectory
from rspl_slam_tpu_torch.frontend.frontends import FrameFeatures
from rspl_slam_tpu_torch.geometry import se3, triangulation
from rspl_slam_tpu_torch.ops import lines as lops

__all__ = ["SLAMSystem", "INIT_POSE", "FrameRecord"]

# the reference's hard-coded gravity-aligned first pose (map_builder.cc:368-371)
INIT_POSE = np.array(
    [[1.0, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 1], [0, 0, 0, 1]]
)


@dataclass
class FrameRecord:
    frame_id: int
    time: float
    Twc: np.ndarray
    is_keyframe: bool = False
    kf_slot: int = -1
    num_inliers: int = 0


def _members_to_lists(members: np.ndarray, width: int = 32) -> np.ndarray:
    """(L, K) bool membership → (L, width) int32 keypoint index lists."""
    out = np.full((members.shape[0], width), -1, np.int32)
    rank = members.cumsum(1) - 1  # per-row rank of each member
    li, ki = np.nonzero(members)
    r = rank[li, ki]
    m = r < width
    out[li[m], r[m]] = ki[m]
    return out


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


class SLAMSystem:
    # wants_images() runs on the PipelinedRunner's extract thread while
    # add_frame* runs on the tracking thread: the CombinedTracker is built
    # once under this lock (class-level, so a SLAMSystem stays deep-copyable)
    _combined_lock = threading.Lock()

    def __init__(self, cfg: SystemConfig, frontend, enable_ba: bool = True,
                 enable_lines: bool | None = None,
                 enable_loop_closure: bool = False,
                 enable_relocalization: bool | None = None,
                 reloc_after: int = 3, global_ba_on_loop: bool = False,
                 fused_tracking: bool | None = None):
        if enable_loop_closure or enable_relocalization or global_ba_on_loop:
            _unported("loop closure / relocalization", "remaining slice 5")
        if cfg.pipeline.match_outlier_rejection:
            _unported("match_outlier_rejection", "modules to port")
        if cfg.pipeline.track_local_map:
            _unported("track_local_map (search by projection)", "modules to port")
        self.cfg = cfg
        self.frontend = frontend
        self.device = frontend.device
        self.enable_ba = enable_ba
        # fused tracking for frontends with a device-side matcher
        if fused_tracking is None:
            fused_tracking = getattr(frontend, "matcher", None) in ("superglue", "cosine")
        self._fused_enabled = fused_tracking
        self._pending_ba = None  # in-flight async local BA
        self._ba_stream = None  # the side stream of async BA on a card
        self.ba_windows: list[dict] = []  # per solved window: frames, constraints
        self.enable_lines = cfg.use_lines if enable_lines is None else enable_lines
        self._fused = None
        self._combined = None  # the lazy schedule's frame_step.CombinedTracker
        self._track_seed = 0  # RANSAC seed of the next tracked frame, on either route
        cam = cfg.camera
        self.K = CameraIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        self.map = map_store.MapStore(
            cfg.superpoint.max_keypoints, cfg.line_detector.max_lines,
            cfg.pipeline, desc_dim=cfg.superglue.descriptor_dim,
        )
        self.map.set_intrinsics(cam.fx, cam.fy, cam.cx, cam.cy)
        self.initialized = False
        self.records: list[FrameRecord] = []
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(7)
        self._last_Twc = INIT_POSE.copy()
        self._ref_kf = -1
        self._ref_feats: FrameFeatures | None = None
        self._last_feats: FrameFeatures | None = None
        self._last_frame_meta = None  # (frame_id, time, Twc)
        self._last_track_ok = True
        self._lost_count = 0
        self._index_offset = 0  # shifts caller frame ids after a resume
        self._capacity_warned = False
        self.timings: dict[str, list] = {}

    # ------------------------------------------------------------------ api
    def add_frame(self, index: int, t: float, img_l, img_r) -> FrameRecord:
        if self.wants_images():
            return self._add_frame_combined(index, t, img_l, img_r)
        t0 = time.perf_counter()
        feats = self.frontend.extract_pair(img_l, img_r)
        self._t("extract", t0)
        return self.add_frame_features(index, t, feats)

    def wants_images(self) -> bool:
        """True where the combined frame step applies (an initialized map,
        ``combined_frame_step``, a lazy-right frontend the step supports):
        raw images should reach :meth:`add_frame` rather than go through a
        separate extraction stage."""
        if not (self.initialized and self._fused_enabled
                and self.cfg.pipeline.combined_frame_step
                and getattr(self.frontend, "lazy_right", False)):
            return False
        if self._combined is None:
            with self._combined_lock:
                if self._combined is None:
                    from rspl_slam_tpu_torch.frame_step import CombinedTracker

                    tcfg = self.cfg.optimization.tracking
                    self._combined = CombinedTracker(self.frontend, self.K,
                                                     tcfg.mono_point, tcfg.stereo_point)
        return self._combined.supported()

    def _next_seed(self) -> int:
        self._track_seed = (self._track_seed + 1) % (1 << 22)
        return self._track_seed

    def _add_frame_combined(self, index: int, t: float, img_l, img_r) -> FrameRecord:
        """Extraction + tracking as one chain (``CombinedTracker``), then the
        tracking policy."""
        t0 = time.perf_counter()
        index = index + self._index_offset
        ref_pos, ref_good = self._ref_landmarks()
        ff, i0, Twc, n_inl, inlier = self._combined.step(
            img_l, img_r, self._ref_feats, ref_pos, ref_good, self._last_Twc,
            self._next_seed())
        if np.linalg.norm(Twc[:3, 3] - self._last_Twc[:3, 3]) > 0.5:
            Twc = self._last_Twc.copy()
        self._t("frame_combined", t0)
        return self._record(index, t, ff, self._track(
            index, t, ff, i0=i0, fused_pose=(Twc, n_inl, inlier)))

    def add_frame_features(self, index: int, t: float, feats) -> FrameRecord:
        index = index + self._index_offset
        if not self.initialized:
            rec = self._init_map(index, t, feats)
        else:
            rec = self._track(index, t, feats)
        return self._record(index, t, feats, rec)

    def _record(self, index: int, t: float, feats, rec: FrameRecord) -> FrameRecord:
        self.records.append(rec)
        self._last_feats = feats
        self._last_frame_meta = (index, t, rec.Twc)
        return rec

    def save_trajectory(self, path: str, keyframes_only: bool = True):
        self.flush_ba()
        if keyframes_only:
            times, poses = self.map.keyframe_trajectory()
        else:
            times = np.asarray([r.time for r in self.records])
            poses = np.stack([r.Twc for r in self.records])
        write_tum_trajectory(path, times, poses)

    def save_map(self, path: str):
        self.flush_ba()
        self.map.save(path)

    def resume_from_map(self, path: str):
        """Load a saved map checkpoint and resume tracking against it. The
        tracking anchor becomes the last stored keyframe, its features
        rebuilt from the map arrays; caller frame indices are shifted past
        the stored ones, so drivers may restart at 0."""
        self._pending_ba = None  # any in-flight solve targets the old map
        self.map = map_store.MapStore.load(path, self.cfg.pipeline)
        if self.map.K != self.cfg.superpoint.max_keypoints:
            raise ValueError(
                f"checkpoint keypoint capacity K={self.map.K} != configured "
                f"max_keypoints={self.cfg.superpoint.max_keypoints}; resume "
                f"with the config the map was built under")
        self.initialized = self.map.n_kf > 0
        self.records = []
        if self.initialized:
            self._ref_kf = self.map.n_kf - 1
            self._ref_feats = self._features_from_keyframe(self._ref_kf)
            self._last_Twc = self.map.kf_pose[self._ref_kf].copy()
            self._last_feats = None
            self._last_frame_meta = None
            self._last_track_ok = True
            self._lost_count = 0
            self._index_offset = int(self.map.kf_frame_id[: self.map.n_kf].max()) + 1

    def _features_from_keyframe(self, kf: int) -> FrameFeatures:
        """A matching-sufficient FrameFeatures view of a stored keyframe
        (xy, score, desc, valid, meas, depth from the map arrays)."""
        m = self.map
        meas = m.kf_meas[kf].copy()
        uR = meas[:, 2]
        depth = np.where(uR > 0, self.K.bf / np.maximum(meas[:, 0] - uR, 1e-6),
                         0.0).astype(np.float32)
        return FrameFeatures(xy=meas[:, :2].copy(), score=m.kf_score[kf].astype(np.float32),
                             desc=m.kf_desc[kf].astype(np.float32),
                             valid=m.kf_kpt_valid[kf].copy(), meas=meas, depth=depth)

    def cull_redundant_keyframes(self, min_other_obs: int = 3, ratio: float = 0.9,
                                 keep_recent: int = 3) -> int:
        """Remove keyframes whose GOOD landmarks are ≥ ``ratio`` covered by
        ≥ ``min_other_obs`` other keyframes; never the gauge frames, the
        tracking anchor or the ``keep_recent`` newest. Returns the number
        culled."""
        self.flush_ba()
        m = self.map
        if m.n_kf < keep_recent + 2:
            return 0
        protect = {self._ref_kf} | set(range(max(0, m.n_kf - keep_recent), m.n_kf))
        victims = m.find_redundant_keyframes(min_other_obs=min_other_obs, ratio=ratio,
                                             protect=protect)
        for k in victims:
            m.cull_keyframe(int(k))
        return len(victims)

    def flush_ba(self):
        """Apply an in-flight async BA result, if any: wait for its event,
        unpack the one packed copy, scatter it into the map and refresh the
        window's line endpoints. Called before the next window gather and
        before trajectory saves; a no-op otherwise. Tracking's anchor pose
        is deliberately left alone: tracking has moved past the solved
        window's centre."""
        if self._pending_ba is None:
            return
        result, start, done, mapping = self._pending_ba
        self._pending_ba = None
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
            self.timings.setdefault("ba_device", []).append(start.elapsed_time(done) / 1e3)
            host, dims = result
            result = local_ba.unpack_result(host.numpy(), dims)
        self.map.scatter_ba_result(result, mapping)
        self._refresh_line_endpoints(mapping["lns"])
        self._t("ba_apply", t0)

    # ----------------------------------------------------------------- init
    def _init_map(self, index: int, t: float, feats: FrameFeatures) -> FrameRecord:
        # initialization needs the stereo gates: a lazy frame completes here
        feats = self._complete_stereo(feats)
        n_kpts = int(feats.valid.sum())
        stereo_ok = feats.valid & (feats.depth > 0)
        if n_kpts < 150 or int(stereo_ok.sum()) < 100:
            return FrameRecord(index, t, INIT_POSE.copy())
        Twc = INIT_POSE.copy()
        kf = self.map.add_keyframe(index, t, Twc, feats.meas, feats.valid,
                                   feats.desc, feats.score, fixed=True,
                                   **self._line_args(feats))
        idx = np.nonzero(stereo_ok)[0]
        pw = self._back_project(feats, idx, Twc)
        pts = self.map.new_mappoints_batch(pw, feats.desc[idx])
        self.map.add_point_obs_batch(pts, kf, idx)
        if self._has_lines(feats):
            self._process_keyframe_lines(kf, feats, np.full(len(feats.xy), -1))
        self.initialized = True
        self._ref_kf = kf
        self._ref_feats = feats
        self._last_Twc = Twc
        return FrameRecord(index, t, Twc, True, kf, len(idx))

    def _back_project(self, feats: FrameFeatures, idx: np.ndarray, Twc) -> np.ndarray:
        cam = self.cfg.camera
        d = feats.depth[idx]
        pc = np.stack([
            (feats.xy[idx, 0] - cam.cx) / cam.fx * d,
            (feats.xy[idx, 1] - cam.cy) / cam.fy * d,
            d,
        ], -1)
        return pc @ Twc[:3, :3].T + Twc[:3, 3]

    # ------------------------------------------------------------- tracking
    def _ref_landmarks(self):
        ref_pt = self.map.kf_track[self._ref_kf]
        safe = np.maximum(ref_pt, 0)
        ref_good = (ref_pt >= 0) & (self.map.pt_status[safe] == map_store.PT_GOOD)
        return self.map.pt_pos[safe], ref_good

    def _fused_track(self, feats: FrameFeatures):
        if self._fused is None:
            from rspl_slam_tpu_torch.fused_track import FusedTracker

            tcfg = self.cfg.optimization.tracking
            self._fused = FusedTracker(self.frontend, self.K,
                                       tcfg.mono_point, tcfg.stereo_point)
        ref_pos, ref_good = self._ref_landmarks()
        i0, Twc, n_inl, inlier = self._fused.track(
            feats, self._ref_feats, ref_pos, ref_good, self._last_Twc, self._next_seed())
        if np.linalg.norm(Twc[:3, 3] - self._last_Twc[:3, 3]) > 0.5:
            Twc = self._last_Twc.copy()
        return i0, (Twc, n_inl, inlier)

    def _track(self, index: int, t: float, feats: FrameFeatures, i0=None,
               fused_pose=None) -> FrameRecord:
        t0 = time.perf_counter()
        if fused_pose is None and i0 is None and self._fused_enabled:
            i0, fused_pose = self._fused_track(feats)
            self._t("track_fused", t0)
        elif i0 is None:
            i0 = self.frontend.match(feats, self._ref_feats)
            self._t("match", t0)
        num_match = int((i0 >= 0).sum())
        # fallback: weak association with the ref keyframe → promote the
        # previous frame to keyframe and re-anchor (never a frame that
        # already IS the reference keyframe)
        if (
            num_match < self.cfg.keyframe.min_num_match
            and self._last_feats is not None
            and self._last_track_ok
            and self._last_frame_meta is not None
            and self._last_frame_meta[0] != int(self.map.kf_frame_id[self._ref_kf])
        ):
            self._promote_last_frame_to_keyframe()
            i0 = self.frontend.match(feats, self._ref_feats)
            fused_pose = None
        if fused_pose is not None:
            Twc, n_inl, inlier_row = fused_pose
        else:
            Twc, n_inl, inlier_row = self._pose_optimize(feats, i0)
        track_ok = n_inl >= max(self.cfg.keyframe.min_num_match, 10)
        if not track_ok:
            Twc = self._last_Twc.copy()
        self._lost_count = 0 if track_ok else self._lost_count + 1
        self._last_track_ok = track_ok
        self._last_Twc = Twc
        rec = FrameRecord(index, t, Twc, num_inliers=n_inl)
        if track_ok and self._should_add_keyframe(Twc, index, n_inl):
            kf = self._insert_keyframe(index, t, Twc, feats, i0, inlier_row)
            rec.is_keyframe = True
            rec.kf_slot = kf
        return rec

    def _complete_stereo(self, feats: FrameFeatures) -> FrameFeatures:
        """A lazy frame's right eye and stereo association, where it is
        still pending (``NeuralFrontend.complete_stereo``)."""
        if feats.pending_right is None:
            return feats
        t0 = time.perf_counter()
        feats = self.frontend.complete_stereo(feats)
        self._t("complete_stereo", t0)
        return feats

    def _cap_new_landmarks(self, idx: np.ndarray) -> np.ndarray:
        room = self.map.points_remaining
        if len(idx) > room:
            if not self._capacity_warned:
                print(f"map point capacity reached ({self.map.n_pt}): new "
                      "landmark creation saturates; tracking continues on "
                      "the existing map")
                self._capacity_warned = True
            idx = idx[:room]
        return idx

    @torch.no_grad()
    def _pose_optimize(self, feats: FrameFeatures, i0: np.ndarray):
        """PnP init + pose-only LM against mappoints matched via the
        reference keyframe (the unfused path of the promote fallback)."""
        K_cap = len(i0)
        ref_tracks = self.map.kf_track[self._ref_kf]
        pt = ref_tracks[np.maximum(i0, 0)]
        valid = ((i0 >= 0) & feats.valid & (pt >= 0)
                 & (self.map.pt_status[np.maximum(pt, 0)] == map_store.PT_GOOD))
        Xw = np.where(valid[:, None], self.map.pt_pos[np.where(valid, pt, 0)], 0.0)
        stereo = valid & (feats.meas[:, 2] > 0)
        meas = np.zeros((K_cap, 3))
        meas[:, :2] = np.where(valid[:, None], feats.xy, 0.0)
        meas[:, 2] = np.where(stereo, feats.meas[:, 2], 0.0)
        if int(valid.sum()) < 8:
            return self._last_Twc.copy(), 0, valid & False
        t0 = time.perf_counter()
        dev = self.device
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        b = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        pr = pnp.pnp_ransac(self.K, f(self._last_Twc), f(Xw), f(meas[:, :2]),
                            b(valid), self._gen)
        Twc_init = se3.inverse(pr.Tcw).cpu().numpy().astype(np.float64)
        if (not bool(pr.ok)) or np.linalg.norm(
                Twc_init[:3, 3] - self._last_Twc[:3, 3]) > 0.5:
            Twc_init = self._last_Twc.copy()
        tcfg = self.cfg.optimization.tracking
        out = pose_solver.optimize_pose(
            self.K, f(Twc_init), f(Xw), f(meas), b(stereo), b(valid),
            chi2_mono=tcfg.mono_point, chi2_stereo=tcfg.stereo_point)
        self._t("pose_opt", t0)
        Twc = se3.inverse(out.Tcw).cpu().numpy().astype(np.float64)
        n_inl = int(out.num_inliers)
        if np.linalg.norm(Twc[:3, 3] - self._last_Twc[:3, 3]) > 0.5:
            Twc = self._last_Twc.copy()
        return Twc, n_inl, out.inlier.cpu().numpy()

    def _should_add_keyframe(self, Twc, index, num_match) -> bool:
        kf_cfg = self.cfg.keyframe
        last_kf_pose = self.map.kf_pose[self._ref_kf]
        dR = last_kf_pose[:3, :3].T @ Twc[:3, :3]
        d_angle = float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        d_dist = float(np.linalg.norm(Twc[:3, 3] - last_kf_pose[:3, 3]))
        passed = index - int(self.map.kf_frame_id[self._ref_kf])
        return (num_match < kf_cfg.max_num_match or d_angle > kf_cfg.max_angle
                or d_dist > kf_cfg.max_distance or passed > kf_cfg.max_num_passed_frame)

    def _promote_last_frame_to_keyframe(self):
        """Make the previous frame a keyframe (its pose re-optimized on its
        matches to the current reference) and re-anchor tracking on it."""
        if self._last_feats is None or self._last_frame_meta is None:
            return
        index, t, Twc = self._last_frame_meta
        feats = self._last_feats
        i0 = self.frontend.match(feats, self._ref_feats)
        Twc_opt, n_inl, inlier_row = self._pose_optimize(feats, i0)
        if n_inl >= max(self.cfg.keyframe.min_num_match, 10):
            Twc = Twc_opt
        self._insert_keyframe(index, t, Twc, feats, i0, inlier_row)

    # -------------------------------------------------------------- keyframe
    def _insert_keyframe(self, index, t, Twc, feats: FrameFeatures,
                         i0: np.ndarray, inlier_row: np.ndarray) -> int:
        t0 = time.perf_counter()
        self.flush_ba()
        # a lazy frame's right eye runs now, where the reference runs it
        feats = self._complete_stereo(feats)
        kf = self.map.add_keyframe(index, t, Twc, feats.meas, feats.valid,
                                   feats.desc, feats.score, **self._line_args(feats))
        ref_tracks = self.map.kf_track[self._ref_kf]
        K_cap = len(i0)
        valid = np.asarray(feats.valid, bool)
        j = np.asarray(i0)
        pt = np.where(j >= 0, ref_tracks[np.maximum(j, 0)], -1)
        status = self.map.pt_status[np.maximum(pt, 0)]
        inl_ok = (np.ones(K_cap, bool) if len(inlier_row) == 0
                  else (np.asarray(inlier_row, bool) | (j < 0)))
        extend_good = valid & (pt >= 0) & (status == map_store.PT_GOOD) & inl_ok
        new_stereo = valid & ~extend_good & (feats.depth > 0)
        extend_pend = (valid & ~extend_good & ~new_stereo & (pt >= 0)
                       & (status == map_store.PT_UNTRIANGULATED))
        new_mono = valid & ~extend_good & ~new_stereo & ~extend_pend
        # extend existing mappoints; several keypoints on one landmark keep
        # the first
        idx = np.nonzero(extend_good | extend_pend)[0]
        if len(idx):
            _, first = np.unique(pt[idx], return_index=True)
            idx = idx[np.sort(first)]
            self.map.add_point_obs_batch(pt[idx], kf, idx)
        idx = self._cap_new_landmarks(np.nonzero(new_stereo)[0])
        if len(idx):
            new_pts = self.map.new_mappoints_batch(
                self._back_project(feats, idx, Twc), feats.desc[idx])
            self.map.add_point_obs_batch(new_pts, kf, idx)
        idx = self._cap_new_landmarks(np.nonzero(new_mono)[0])
        if len(idx):
            new_pts = self.map.new_mappoints_batch(
                np.zeros((len(idx), 3)), feats.desc[idx],
                status=map_store.PT_UNTRIANGULATED)
            self.map.add_point_obs_batch(new_pts, kf, idx)
        self._triangulate_pending_points(kf)
        if self._has_lines(feats):
            self._process_keyframe_lines(kf, feats, i0)
            feats.line_tracks = self.map.kf_line_track[kf].copy()
        self.map.update_covisibility(kf)
        self._t("kf_insert", t0)
        if self.enable_ba and self.map.n_kf >= 2:
            t0 = time.perf_counter()
            # (any in-flight solve was settled at the top of this method,
            # before the map mutated)
            if self.cfg.pipeline.async_ba:
                self._dispatch_local_ba(kf)
            else:
                self._run_local_ba(kf)
            self._t("local_ba", t0)
        self._ref_kf = kf
        self._ref_feats = feats
        return kf

    @torch.no_grad()
    def _triangulate_pending_points(self, kf: int):
        """Batched multi-view triangulation of untriangulated mappoints that
        gained their ≥2nd observation: one upload of the rays and a
        keyframe pose table, one download of [points; ok]."""
        cam = self.cfg.camera
        tracks = self.map.kf_track[kf]
        cand = tracks[tracks >= 0]
        cand = np.unique(cand[self.map.pt_status[cand] == map_store.PT_UNTRIANGULATED])
        cand = cand[self.map.pt_obs_n[cand] >= 2]
        if len(cand) == 0:
            return
        okf = self.map.pt_obs_kf[cand]  # (n, MAX_OBS)
        okp = self.map.pt_obs_kpt[cand]
        mask = okf >= 0
        uv = self.map.kf_meas[np.maximum(okf, 0), np.maximum(okp, 0), :2]
        uvn = np.where(mask[..., None], (uv - [cam.cx, cam.cy]) / [cam.fx, cam.fy],
                       0.0).astype(np.float32)
        dev = self.device
        pose_table = torch.as_tensor(self.map.kf_pose[: self.map.n_kf], dtype=torch.float32,
                                     device=dev)
        Twc = pose_table[torch.as_tensor(np.maximum(okf, 0), device=dev)]
        pts, ok = triangulation.triangulate_point_multiview(
            Twc, torch.as_tensor(uvn, device=dev), torch.as_tensor(mask, device=dev))
        buf = torch.cat([pts.reshape(-1), ok.to(torch.float32)]).cpu().numpy()
        n = len(cand)
        pts = buf[: 3 * n].reshape(n, 3)
        ok = buf[3 * n:] > 0.5
        sel = cand[ok]
        self.map.pt_pos[sel] = pts[ok]
        self.map.pt_status[sel] = map_store.PT_GOOD
        self.map.update_mappoint_descriptors(sel)

    # ------------------------------------------------------------ local BA
    def gather_ba_problem(self, center_kf: int):
        """The BA window around ``center_kf`` as (BAProblem of numpy arrays,
        mapping), or (None, None) when under-constrained."""
        p = self.cfg.pipeline
        o = self.cfg.optimization
        self.flush_ba()  # settle any in-flight window before gathering
        problem_np, mapping = self.map.gather_ba_window(
            center_kf, max_frames=o.max_window_keyframes, max_points=p.ba_max_points,
            max_lines_w=p.ba_max_lines, cp_capacity=p.ba_max_points * 4,
            cl_capacity=p.ba_max_lines * 4)
        if mapping["ncp"] < 30:
            return None, None
        return local_ba.BAProblem(**problem_np), mapping

    def apply_ba_result(self, result, mapping, center_kf: int):
        """Scatter a solved window into the map (one packed copy of a device
        result) and re-anchor tracking on the optimized centre keyframe."""
        self.map.scatter_ba_result(local_ba.fetch_result(result), mapping)
        self._refresh_line_endpoints(mapping["lns"])
        self._last_Twc = self.map.kf_pose[center_kf].copy()

    def _optimize(self, prob, mapping):
        """Upload a gathered window and issue its solve on the current
        stream (no host synchronization)."""
        o = self.cfg.optimization
        b = o.backend
        self.ba_windows.append({"frames": len(mapping["frames"]), "ncp": int(mapping["ncp"]),
                                "ncl": int(mapping["ncl"])})
        return local_ba.optimize_local_map(
            self.K, local_ba.upload_problem(prob, self.device),
            chi2_mono=b.mono_point, chi2_stereo=b.stereo_point,
            chi2_mono_line=b.mono_line, chi2_stereo_line=b.stereo_line,
            iters1=o.ba_iters_phase1, iters2=o.ba_iters_phase2)

    def _run_local_ba(self, center_kf: int):
        prob, mapping = self.gather_ba_problem(center_kf)
        if prob is not None:
            self.apply_ba_result(self._optimize(prob, mapping), mapping, center_kf)

    def _dispatch_local_ba(self, center_kf: int):
        """Async mode. On a card: the upload, the solve and the packed copy
        into pinned host memory are issued on a side stream, which first
        waits for the current stream, and an event is recorded behind them;
        :meth:`flush_ba` waits for it. Every tensor of the solve is
        allocated on the side stream, so the caching allocator hands its
        memory to nothing else before that stream's work is done. On the
        CPU the solve runs now and is applied at the flush."""
        prob, mapping = self.gather_ba_problem(center_kf)
        if prob is None:
            return
        if self.device.type != "cuda":
            self._pending_ba = (local_ba.fetch_result(self._optimize(prob, mapping)),
                                None, None, mapping)
            return
        if self._ba_stream is None:
            self._ba_stream = torch.cuda.Stream(self.device)
        side = self._ba_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record(side)
            host = local_ba.fetch_result_async(self._optimize(prob, mapping))
            done.record(side)
        self._pending_ba = (host, start, done, mapping)

    @torch.no_grad()
    def _refresh_line_endpoints(self, lns: np.ndarray):
        """After BA, refresh the cartesian endpoints of the window's
        maplines from their supporting mappoints: one batched device call,
        one download of [endpoints; ok]."""
        P = 32
        keep, arrs, count = [], [], []
        for ln in lns:
            uniq, _ = self._mapline_support(ln)
            if len(uniq) < 2:
                continue
            pts = self.map.pt_pos[uniq][:P]
            a = np.zeros((P, 3))
            a[: len(pts)] = pts
            keep.append(int(ln))
            arrs.append(a)
            count.append(len(pts))
        if not keep:
            return
        n = len(keep)
        mask = np.arange(P)[None] < np.asarray(count)[:, None]
        dev = self.device
        eps, ok = triangulation.triangulate_line_endpoints(
            torch.as_tensor(self.map.ln_plucker[keep], dtype=torch.float32, device=dev),
            torch.as_tensor(np.stack(arrs), dtype=torch.float32, device=dev),
            torch.as_tensor(mask, device=dev))
        buf = torch.cat([eps.reshape(-1), ok.to(torch.float32)]).cpu().numpy()
        ok = buf[6 * n:] > 0.5
        self.map.ln_endpoints[np.asarray(keep)[ok]] = buf[: 6 * n].reshape(n, 2, 3)[ok]

    # ----------------------------------------------------------------- lines
    def _has_lines(self, feats: FrameFeatures) -> bool:
        return self.enable_lines and feats.lines is not None

    def _line_args(self, feats: FrameFeatures) -> dict:
        """The frame's 2D lines as ``MapStore.add_keyframe`` takes them."""
        if not self._has_lines(feats):
            return {}
        return dict(lines=feats.lines, lines_right=feats.lines_right,
                    line_valid=feats.line_valid, line_has_right=feats.line_has_right,
                    line_points=_members_to_lists(feats.line_members))

    def _process_keyframe_lines(self, kf: int, feats: FrameFeatures, i0: np.ndarray):
        """Line landmarks at keyframe insertion: temporal line matching
        against the reference keyframe through the point-vote matrix,
        mapline creation or extension, and the 3D fits of this keyframe's
        maplines from their on-line mappoints."""
        nl = int(feats.line_valid.sum())
        if nl == 0:
            return
        line_match = np.full(nl, -1, np.int64)
        ref = self._ref_feats
        if self._ref_kf >= 0 and ref is not None and ref.line_members is not None:
            line_match = lops.match_lines(feats.line_members[:nl],
                                          ref.line_members[: int(ref.line_valid.sum())], i0)
        for li in range(nl):
            ln = -1
            if line_match[li] >= 0:
                cand = self.map.kf_line_track[self._ref_kf, line_match[li]]
                if cand >= 0 and self.map.ln_valid[cand]:
                    ln = int(cand)
            if ln < 0:
                if self.map.lines_remaining == 0:
                    continue  # capacity saturated (see _cap_new_landmarks)
                ln = self.map.new_mapline()
            self.map.add_line_obs(ln, kf, li)
        self._triangulate_keyframe_maplines(kf, nl)

    def _mapline_support(self, ln: int):
        """Unique GOOD mappoints on all of mapline ``ln``'s observed 2D
        lines, with their multi-view repeat counts."""
        m = self.map
        n = m.ln_obs_n[ln]
        kfs = m.ln_obs_kf[ln, :n]
        lis = m.ln_obs_idx[ln, :n]
        ok = kfs >= 0
        kfs, lis = kfs[ok], lis[ok]
        ks = m.kf_line_points[kfs, lis]  # (n, 32) keypoint slots
        pts = m.kf_track[kfs[:, None], np.maximum(ks, 0)]
        flat = pts[(ks >= 0) & (pts >= 0)]
        flat = flat[m.pt_status[flat] == map_store.PT_GOOD]
        return np.unique(flat, return_counts=True)

    def _gather_mapline_points(self, ln: int) -> np.ndarray:
        """Mappoint positions supporting a mapline; points seen on the line
        from ≥ 2 viewpoints are preferred (accidental projective members
        differ between viewpoints, true on-line points repeat)."""
        uniq, counts = self._mapline_support(ln)
        multi = uniq[counts >= 2]
        return self.map.pt_pos[multi if len(multi) >= 3 else uniq]

    @torch.no_grad()
    def _triangulate_keyframe_maplines(self, kf: int, nl: int, P: int = 32):
        """(Re)fit the 3D line of every mapline the keyframe's first ``nl``
        lines observe, from ≥ 3 supporting mappoints and ≥ 2 observations:
        one batched fit on the device, one download of [plücker; endpoints;
        ok]."""
        lns, arr, count = [], [], []
        for li in range(nl):
            ln = self.map.kf_line_track[kf, li]
            if ln < 0:
                continue
            pts = self._gather_mapline_points(ln)[:P]
            # a single observation is projectively ambiguous
            if len(pts) < 3 or self.map.ln_obs_n[ln] < 2:
                continue
            a = np.zeros((P, 3))
            a[: len(pts)] = pts
            lns.append(int(ln))
            arr.append(a)
            count.append(len(pts))
        if not lns:
            return
        n = len(lns)
        mask = np.arange(P)[None] < np.asarray(count)[:, None]
        dev = self.device
        L, eps, ok = triangulation.fit_line3d_to_points(
            torch.as_tensor(np.stack(arr), dtype=torch.float32, device=dev),
            torch.as_tensor(mask, device=dev))
        buf = torch.cat([L.reshape(-1), eps.reshape(-1), ok.to(torch.float32)]).cpu().numpy()
        ok = buf[12 * n:] > 0.5
        sel = np.asarray(lns)[ok]
        self.map.ln_plucker[sel] = buf[: 6 * n].reshape(n, 6)[ok]
        self.map.ln_endpoints[sel] = buf[6 * n: 12 * n].reshape(n, 2, 3)[ok]
        self.map.ln_has_endpoints[sel] = True

    def _t(self, name, t0):
        self.timings.setdefault(name, []).append(time.perf_counter() - t0)
