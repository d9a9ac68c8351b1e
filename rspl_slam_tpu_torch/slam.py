"""Top-level SLAM system (port of slam.py: the point main path).

Per-frame flow, as in the JAX package: eager stereo extraction → (first
frame) map initialization → fused tracking against the reference keyframe
(temporal SuperGlue + map association + PnP-RANSAC + pose-only LM on the
device) with the promote-last-frame fallback → keyframe policy → keyframe
insertion on the host map store with batched multi-view triangulation on
the device. Host bookkeeping stays numpy f64 where the JAX package has it.

Not ported in this slice, and raising ``NotImplementedError`` rather than
degrading: lines (RCF + Hough), local BA, loop closure and relocalization,
and the lazy-right schedule (ROADMAP.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from rspl_slam_tpu_torch.backend import map_store, pnp, pose_solver
from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
from rspl_slam_tpu_torch.config import SystemConfig
from rspl_slam_tpu_torch.datasets import write_tum_trajectory
from rspl_slam_tpu_torch.frontend.frontends import FrameFeatures
from rspl_slam_tpu_torch.geometry import se3, triangulation

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


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


class SLAMSystem:
    def __init__(self, cfg: SystemConfig, frontend, enable_ba: bool = True,
                 enable_lines: bool | None = None,
                 enable_loop_closure: bool = False,
                 enable_relocalization: bool | None = None,
                 reloc_after: int = 3, global_ba_on_loop: bool = False,
                 fused_tracking: bool | None = None):
        if enable_ba:
            _unported("enable_ba=True (local bundle adjustment)", "remaining slice 2")
        if cfg.use_lines if enable_lines is None else enable_lines:
            _unported("use_lines=True (RCF + Hough lines)", "remaining slice 1")
        if enable_loop_closure or enable_relocalization or global_ba_on_loop:
            _unported("loop closure / relocalization", "remaining slice 5")
        if cfg.pipeline.lazy_right_extraction or getattr(frontend, "lazy_right", False):
            _unported("lazy_right_extraction=True", "remaining slice 3")
        if cfg.pipeline.match_outlier_rejection:
            _unported("match_outlier_rejection", "modules to port")
        if cfg.pipeline.track_local_map:
            _unported("track_local_map (search by projection)", "modules to port")
        if fused_tracking is False:
            _unported("the unfused tracking path", "modules to port")
        self.cfg = cfg
        self.frontend = frontend
        self.device = frontend.device
        self.enable_ba = False
        self.enable_lines = False
        self._fused = None
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
        self._capacity_warned = False
        self.timings: dict[str, list] = {}

    # ------------------------------------------------------------------ api
    def add_frame(self, index: int, t: float, img_l, img_r) -> FrameRecord:
        t0 = time.perf_counter()
        feats = self.frontend.extract_pair(img_l, img_r)
        self._t("extract", t0)
        return self.add_frame_features(index, t, feats)

    def add_frame_features(self, index: int, t: float, feats) -> FrameRecord:
        if not self.initialized:
            rec = self._init_map(index, t, feats)
        else:
            rec = self._track(index, t, feats)
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

    def flush_ba(self):
        """No-op: local BA is not part of this slice."""

    # ----------------------------------------------------------------- init
    def _init_map(self, index: int, t: float, feats: FrameFeatures) -> FrameRecord:
        n_kpts = int(feats.valid.sum())
        stereo_ok = feats.valid & (feats.depth > 0)
        if n_kpts < 150 or int(stereo_ok.sum()) < 100:
            return FrameRecord(index, t, INIT_POSE.copy())
        Twc = INIT_POSE.copy()
        kf = self.map.add_keyframe(index, t, Twc, feats.meas, feats.valid,
                                   feats.desc, feats.score, fixed=True)
        idx = np.nonzero(stereo_ok)[0]
        pw = self._back_project(feats, idx, Twc)
        pts = self.map.new_mappoints_batch(pw, feats.desc[idx])
        self.map.add_point_obs_batch(pts, kf, idx)
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
            feats, self._ref_feats, ref_pos, ref_good, self._last_Twc)
        if np.linalg.norm(Twc[:3, 3] - self._last_Twc[:3, 3]) > 0.5:
            Twc = self._last_Twc.copy()
        return i0, (Twc, n_inl, inlier)

    def _track(self, index: int, t: float, feats: FrameFeatures) -> FrameRecord:
        t0 = time.perf_counter()
        i0, fused_pose = self._fused_track(feats)
        self._t("track_fused", t0)
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
        kf = self.map.add_keyframe(index, t, Twc, feats.meas, feats.valid,
                                   feats.desc, feats.score)
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
        self.map.update_covisibility(kf)
        self._t("kf_insert", t0)
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

    def _t(self, name, t0):
        self.timings.setdefault(name, []).append(time.perf_counter() - t0)
