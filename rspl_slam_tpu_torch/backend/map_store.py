"""Host-side SLAM map: keyframes, mappoints, maplines, covisibility.

Replaces the reference's pointer-graph map (Frame/Mappoint/Mapline/Map,
frame.cc / mappoint.cc / mapline.cc / map.cc) with preallocated
struct-of-arrays numpy storage. Insertion/bookkeeping is cheap host work;
every compute-heavy step (triangulation, BA) GATHERS a fixed-shape window,
runs a jitted kernel, and SCATTERS results back — the TPU-native split of
mutable-graph bookkeeping vs. dense batched math.

Covisibility is a dense (KF, KF) uint16 weight matrix (shared valid
mappoints, map.cc:897-938); neighbor selection for BA is a top-k slice of
one row instead of the reference's BFS with ordered sets (map.cc:471-525).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from rspl_slam_tpu_torch.config import PipelineConfig

__all__ = ["MapStore"]

# mappoint status (mappoint.h type enum)
PT_INVALID = 0
PT_UNTRIANGULATED = 1
PT_GOOD = 2
PT_BAD = 3

MAX_OBS = 16  # static per-landmark observer capacity (local BA window ≤ 10)


class MapStore:
    def __init__(self, max_keypoints: int, max_lines: int,
                 cfg: PipelineConfig | None = None, desc_dim: int = 256):
        cfg = cfg or PipelineConfig()
        self.cfg = cfg
        KF = cfg.max_map_keyframes
        MP = cfg.max_map_points
        ML = cfg.max_map_lines
        K = max_keypoints
        LN = max_lines
        self.K = K
        self.LN = LN

        # keyframes
        self.kf_valid = np.zeros(KF, bool)
        self.kf_frame_id = np.full(KF, -1, np.int64)
        self.kf_time = np.zeros(KF)
        self.kf_pose = np.tile(np.eye(4), (KF, 1, 1))  # Twc
        self.kf_fixed = np.zeros(KF, bool)
        # per-keyframe features (meas = [u, v, uR]; uR<0 → mono)
        self.kf_meas = np.zeros((KF, K, 3), np.float32)
        self.kf_kpt_valid = np.zeros((KF, K), bool)
        self.kf_desc = np.zeros((KF, K, desc_dim), np.float16)
        self.kf_score = np.zeros((KF, K), np.float16)
        self.kf_track = np.full((KF, K), -1, np.int64)  # → mappoint slot
        # per-keyframe 2D lines (left + right) and line→mapline links
        self.kf_lines = np.zeros((KF, LN, 4), np.float32)
        self.kf_lines_right = np.zeros((KF, LN, 4), np.float32)
        self.kf_line_valid = np.zeros((KF, LN), bool)
        self.kf_line_has_right = np.zeros((KF, LN), bool)
        self.kf_line_track = np.full((KF, LN), -1, np.int64)  # → mapline slot
        # points-on-line membership: for each frame line, keypoint slots on it
        self.kf_line_points = np.full((KF, LN, 32), -1, np.int32)
        self.n_kf = 0

        # mappoints
        self.pt_status = np.zeros(MP, np.int8)
        self.pt_pos = np.zeros((MP, 3))
        self.pt_desc = np.zeros((MP, desc_dim), np.float16)
        self.pt_obs_kf = np.full((MP, MAX_OBS), -1, np.int32)  # kf slot
        self.pt_obs_kpt = np.full((MP, MAX_OBS), -1, np.int32)
        self.pt_obs_n = np.zeros(MP, np.int32)
        self.n_pt = 0

        # maplines
        self.ln_valid = np.zeros(ML, bool)
        self.ln_plucker = np.zeros((ML, 6))
        self.ln_endpoints = np.zeros((ML, 2, 3))
        self.ln_has_endpoints = np.zeros(ML, bool)
        self.ln_obs_kf = np.full((ML, MAX_OBS), -1, np.int32)
        self.ln_obs_idx = np.full((ML, MAX_OBS), -1, np.int32)
        self.ln_obs_n = np.zeros(ML, np.int32)
        self.n_ln = 0

        # covisibility weights (shared valid mappoints)
        self.covis = np.zeros((KF, KF), np.uint16)
        # pixel intrinsics for projection-based search (set_intrinsics)
        self._fx = self._fy = 400.0
        self._cx = self._cy = 200.0

    # ------------------------------------------------------------------ kfs
    def add_keyframe(self, frame_id, time, Twc, meas, kpt_valid, desc, score,
                     fixed=False, lines=None, lines_right=None,
                     line_valid=None, line_has_right=None, line_points=None):
        k = self.n_kf
        assert k < self.kf_valid.shape[0], "keyframe capacity exceeded"
        self.kf_valid[k] = True
        self.kf_frame_id[k] = frame_id
        self.kf_time[k] = time
        self.kf_pose[k] = Twc
        self.kf_fixed[k] = fixed
        n = meas.shape[0]
        self.kf_meas[k, :n] = meas
        self.kf_kpt_valid[k, :n] = kpt_valid
        self.kf_desc[k, :n] = desc
        self.kf_score[k, :n] = score
        if lines is not None:
            m = lines.shape[0]
            self.kf_lines[k, :m] = lines
            self.kf_line_valid[k, :m] = line_valid
            if lines_right is not None:
                self.kf_lines_right[k, :m] = lines_right
                self.kf_line_has_right[k, :m] = line_has_right
            if line_points is not None:
                self.kf_line_points[k, :m, : line_points.shape[1]] = line_points
        self.n_kf += 1
        return k

    # --------------------------------------------------------------- points
    @property
    def points_remaining(self) -> int:
        """Free mappoint slots (creation saturates when this hits 0 —
        slam._insert_keyframe caps new-landmark batches so a long sequence
        degrades to extending existing landmarks instead of crashing)."""
        return int(self.pt_status.shape[0] - self.n_pt)

    @property
    def lines_remaining(self) -> int:
        return int(self.ln_valid.shape[0] - self.n_ln)

    def new_mappoint(self, pos, desc, status=PT_GOOD) -> int:
        i = self.n_pt
        assert i < self.pt_status.shape[0], "mappoint capacity exceeded"
        self.pt_status[i] = status
        self.pt_pos[i] = pos
        self.pt_desc[i] = desc
        # clear observation state in case the slot is ever reused
        self.pt_obs_kf[i] = -1
        self.pt_obs_kpt[i] = -1
        self.pt_obs_n[i] = 0
        self.n_pt += 1
        return i

    def new_mappoints_batch(self, pos: np.ndarray, desc: np.ndarray,
                            status=PT_GOOD) -> np.ndarray:
        """Allocate n mappoint slots in one shot (the keyframe-insertion hot
        path creates up to K landmarks per keyframe — per-slot Python calls
        dominated the host loop). Returns the new slot indices."""
        n = len(pos)
        i0 = self.n_pt
        assert i0 + n <= self.pt_status.shape[0], "mappoint capacity exceeded"
        sl = slice(i0, i0 + n)
        self.pt_status[sl] = status
        self.pt_pos[sl] = pos
        self.pt_desc[sl] = desc
        self.pt_obs_kf[sl] = -1
        self.pt_obs_kpt[sl] = -1
        self.pt_obs_n[sl] = 0
        self.n_pt += n
        return np.arange(i0, i0 + n, dtype=np.int64)

    def add_point_obs_batch(self, pts: np.ndarray, kf: int, kpts: np.ndarray):
        """Record observations of many mappoints from ONE keyframe.
        ``pts`` must be unique (one observation per landmark per frame —
        the reference's observer map had the same key structure)."""
        pts = np.asarray(pts, np.int64)
        kpts = np.asarray(kpts, np.int64)
        n_arr = self.pt_obs_n[pts]
        simple = n_arr < MAX_OBS
        ps, ns = pts[simple], n_arr[simple]
        self.pt_obs_kf[ps, ns] = kf
        self.pt_obs_kpt[ps, ns] = kpts[simple]
        self.pt_obs_n[ps] = ns + 1
        for p, k in zip(pts[~simple], kpts[~simple]):  # rare: full rings
            self.add_point_obs(int(p), kf, int(k))
        self.kf_track[kf, kpts] = pts

    def add_point_obs(self, pt: int, kf: int, kpt: int):
        n = self.pt_obs_n[pt]
        if n < MAX_OBS:
            self.pt_obs_kf[pt, n] = kf
            self.pt_obs_kpt[pt, n] = kpt
            self.pt_obs_n[pt] = n + 1
        else:  # ring-replace the oldest observation
            # the evicted observation stays REAL: its kf_track back-pointer
            # is kept, so the full-table gather (gather_ba_window with
            # full_obs=True — the global-BA path) still sees it. Only true
            # removals (outlier rejection, culling) clear back-pointers.
            self.pt_obs_kf[pt, :-1] = self.pt_obs_kf[pt, 1:]
            self.pt_obs_kpt[pt, :-1] = self.pt_obs_kpt[pt, 1:]
            self.pt_obs_kf[pt, -1] = kf
            self.pt_obs_kpt[pt, -1] = kpt
        self.kf_track[kf, kpt] = pt

    def remove_point_obs(self, pt: int, kf: int):
        n = self.pt_obs_n[pt]
        keep = self.pt_obs_kf[pt, :n] != kf
        kpts = self.pt_obs_kpt[pt, :n][~keep]
        for kp in kpts:
            self.kf_track[kf, kp] = -1
        m = keep.sum()
        self.pt_obs_kf[pt, :m] = self.pt_obs_kf[pt, :n][keep]
        self.pt_obs_kpt[pt, :m] = self.pt_obs_kpt[pt, :n][keep]
        self.pt_obs_kf[pt, m:n] = -1
        self.pt_obs_kpt[pt, m:n] = -1
        self.pt_obs_n[pt] = m
        if m == 0:
            self.pt_status[pt] = PT_BAD

    # -------------------------------------------------------------- culling
    def find_redundant_keyframes(self, min_other_obs: int = 3,
                                 ratio: float = 0.9,
                                 protect=()) -> np.ndarray:
        """Keyframes whose GOOD landmarks are ≥``ratio`` covered by at
        least ``min_other_obs`` OTHER keyframes (the ORB-SLAM redundancy
        criterion; the reference has no culling and grows unboundedly).
        ``protect``: slots never reported (gauge frame, tracking anchor,
        recent window)."""
        out = []
        protect = set(int(p) for p in protect)
        for k in range(self.n_kf):
            if not self.kf_valid[k] or self.kf_fixed[k] or k in protect:
                continue
            pts = self.kf_track[k]
            pts = pts[pts >= 0]
            pts = pts[self.pt_status[pts] == PT_GOOD]
            if len(pts) == 0:
                out.append(k)
                continue
            covered = self.pt_obs_n[pts] >= min_other_obs + 1
            if covered.mean() >= ratio:
                out.append(k)
        return np.asarray(out, np.int64)

    def cull_keyframe(self, kf: int):
        """Remove keyframe ``kf`` from the map: drop all of its point/line
        observations (landmarks left observer-less become BAD/invalid),
        zero its covisibility, and mark the slot invalid. Slot indices of
        other keyframes are unchanged (fixed-shape store); consumers filter
        on ``kf_valid``."""
        for pt in np.unique(self.kf_track[kf][self.kf_track[kf] >= 0]):
            self.remove_point_obs(int(pt), kf)
        lt = self.kf_line_track[kf]
        for ln in np.unique(lt[lt >= 0]):
            self.remove_line_obs(int(ln), kf)
        self.kf_track[kf] = -1
        self.kf_line_track[kf] = -1
        self.covis[kf, :] = 0
        self.covis[:, kf] = 0
        self.kf_valid[kf] = False

    # ---------------------------------------------------------------- lines
    def new_mapline(self) -> int:
        i = self.n_ln
        assert i < self.ln_valid.shape[0], "mapline capacity exceeded"
        self.ln_valid[i] = True
        self.n_ln += 1
        return i

    def remove_line_obs(self, ln: int, kf: int):
        """Drop keyframe ``kf``'s observation of mapline ``ln``
        (RemoveLineOutliers, map.cc:736-757)."""
        n = self.ln_obs_n[ln]
        keep = self.ln_obs_kf[ln, :n] != kf
        for idx in self.ln_obs_idx[ln, :n][~keep]:
            self.kf_line_track[kf, idx] = -1
        m = keep.sum()
        self.ln_obs_kf[ln, :m] = self.ln_obs_kf[ln, :n][keep]
        self.ln_obs_idx[ln, :m] = self.ln_obs_idx[ln, :n][keep]
        self.ln_obs_kf[ln, m:n] = -1
        self.ln_obs_idx[ln, m:n] = -1
        self.ln_obs_n[ln] = m
        if m == 0:
            self.ln_valid[ln] = False

    def add_line_obs(self, ln: int, kf: int, idx: int):
        n = self.ln_obs_n[ln]
        if n < MAX_OBS:
            self.ln_obs_kf[ln, n] = kf
            self.ln_obs_idx[ln, n] = idx
            self.ln_obs_n[ln] = n + 1
        else:
            self.ln_obs_kf[ln, :-1] = self.ln_obs_kf[ln, 1:]
            self.ln_obs_idx[ln, :-1] = self.ln_obs_idx[ln, 1:]
            self.ln_obs_kf[ln, -1] = kf
            self.ln_obs_idx[ln, -1] = idx
        self.kf_line_track[kf, idx] = ln

    # ---------------------------------------------------------- covisibility
    def update_covisibility(self, kf: int):
        """Recompute covisibility weights of ``kf`` against earlier KFs:
        weight = number of shared valid mappoints (map.cc:897-938)."""
        tracks = self.kf_track[kf]
        pts = tracks[(tracks >= 0)]
        pts = pts[self.pt_status[pts] == PT_GOOD]
        counts = np.zeros(self.n_kf, np.int64)
        obs_kf = self.pt_obs_kf[pts]  # (n, MAX_OBS)
        flat = obs_kf[obs_kf >= 0]
        flat = flat[flat != kf]
        if len(flat):
            binc = np.bincount(flat, minlength=self.n_kf)
            counts[: len(binc)] = binc[: self.n_kf]
        self.covis[kf, : self.n_kf] = np.minimum(counts, 65535)
        self.covis[: self.n_kf, kf] = self.covis[kf, : self.n_kf]

    def neighbor_keyframes(self, kf: int, max_n: int = 9) -> np.ndarray:
        """Top covisible keyframes of ``kf`` (including itself first) — the
        BA window (SearchNeighborFrames, map.cc:471-525)."""
        w = self.covis[kf, : self.n_kf].astype(np.int64).copy()
        w[kf] = 0
        order = np.argsort(-w)
        sel = [kf] + [int(i) for i in order[: max_n - 1] if w[i] > 0]
        return np.asarray(sel, np.int64)

    def decay_covisibility(self, kf_a: int, kf_b: int, amount: int = 1):
        w = int(self.covis[kf_a, kf_b])
        w = max(0, w - amount)
        self.covis[kf_a, kf_b] = w
        self.covis[kf_b, kf_a] = w

    # ------------------------------------------------------------- gathering
    def gather_ba_window(self, center_kf: int, max_frames: int,
                         max_points: int, max_lines_w: int,
                         cp_capacity: int, cl_capacity: int,
                         frames: np.ndarray | None = None,
                         full_obs: bool = False):
        """Assemble a fixed-shape BAProblem around ``center_kf``.

        Window = top covisible KFs; plus ONE extra frame held fixed (the
        oldest in the window — the reference fixes frames outside the window
        or the earliest, map.cc:575-607; with ≤1 fixed frame). Landmarks:
        mappoints with ≥1 stereo or ≥2 mono observations inside the window
        (map.cc:652), maplines likewise (map.cc:707).

        ``frames`` overrides the covisibility window with an explicit
        keyframe-slot list (≤ max_frames) — the global-BA path passes every
        keyframe here.

        ``full_obs`` gathers constraints from the COMPLETE back-pointer
        tables (kf_track / kf_line_track) instead of the per-landmark
        observation rings: the rings hold each landmark's newest MAX_OBS
        (16) observers, so on loops longer than 16 keyframes a ring gather
        would optimize against a truncated observation set. The global-BA
        path sets this so "all keyframes jointly" is literally true.

        Returns (problem_dict, mapping) where mapping carries the global
        indices needed to scatter results back. problem_dict contains numpy
        arrays ready to wrap in local_ba.BAProblem.
        """
        if frames is None:
            frames = self.neighbor_keyframes(center_kf, max_frames)
        else:
            frames = np.asarray(frames, np.int64)[:max_frames]
        F = max_frames
        fsel = np.zeros(F, np.int64)
        fsel[: len(frames)] = frames
        f_used = np.zeros(F, bool)
        f_used[: len(frames)] = True
        # pose slot lookup as a dense array (loop-free membership tests)
        slot_arr = np.full(self.n_kf, -1, np.int64)
        slot_arr[frames] = np.arange(len(frames))
        # fixed: the first keyframe globally stays fixed; additionally if
        # only one frame, fix it. Else fix the oldest frame in the window.
        fixed = np.ones(F, bool)  # padding slots fixed (inert identity rows)
        fixed[: len(frames)] = False
        oldest = int(frames[np.argmin(self.kf_frame_id[frames])])
        fixed[slot_arr[oldest]] = True
        fixed[: len(frames)] |= self.kf_fixed[frames]

        if full_obs:
            # complete observation table: every kf_track back-pointer in
            # the window rows — per-landmark count is UNBOUNDED (not capped
            # at the MAX_OBS ring), so long-loop global BA sees evicted
            # observations too
            tr = self.kf_track[frames]  # (f, K)
            fi, ki = np.nonzero(tr >= 0)
            p_all = tr[fi, ki]
            goodm = self.pt_status[p_all] == PT_GOOD
            fi, ki, p_all = fi[goodm], ki[goodm], p_all[goodm]
            meas_flat = self.kf_meas[frames[fi], ki]
            stereo_flat = meas_flat[:, 2] > 0
            cand, inv = np.unique(p_all, return_inverse=True)
            n_rows = np.bincount(inv, minlength=len(cand))
            n_st = np.bincount(inv[stereo_flat], minlength=len(cand))
            # landmark admission: ≥1 stereo or ≥2 mono obs (map.cc:652)
            admitted = np.nonzero((n_st > 0) | (n_rows >= 2))[0][:max_points]
            remap = np.full(len(cand), -1, np.int64)
            remap[admitted] = np.arange(len(admitted))
            selm = remap[inv] >= 0
            pts_sel = cand[admitted]
            p_point = remap[inv[selm]]
            p_pose = fi[selm].astype(np.int64)
            p_meas = meas_flat[selm].astype(np.float64)
            p_stereo = stereo_flat[selm]
        else:
            # candidate points: union of tracks in window frames (ascending)
            cand = np.unique(
                self.kf_track[frames][self.kf_track[frames] >= 0])
            cand = cand[self.pt_status[cand] == PT_GOOD]

            # all observations of all candidates, gathered in one shot
            obs_kf = self.pt_obs_kf[cand]  # (n, MAX_OBS)
            obs_kp = self.pt_obs_kpt[cand]
            slots = np.where(
                obs_kf >= 0, slot_arr[np.maximum(obs_kf, 0)], -1)
            in_win = slots >= 0
            meas = self.kf_meas[np.maximum(obs_kf, 0), np.maximum(obs_kp, 0)]
            stereo = in_win & (meas[..., 2] > 0)
            n_rows = in_win.sum(1)
            n_st = stereo.sum(1)
            # landmark admission: ≥1 stereo or ≥2 mono obs (map.cc:652)
            keep = np.nonzero((n_rows > 0) & ((n_st > 0) | (n_rows >= 2)))[0]
            keep = keep[:max_points]
            pts_sel = cand[keep]
            ci, oi = np.nonzero(in_win[keep])  # row-major: grouped by point
            p_point = ci.astype(np.int64)
            p_pose = slots[keep][ci, oi].astype(np.int64)
            p_meas = meas[keep][ci, oi].astype(np.float64)
            p_stereo = stereo[keep][ci, oi]

        if full_obs:
            # complete line observation table (kf_line_track back-pointers)
            ltr = self.kf_line_track[frames]  # (f, LN)
            lfi, lli = np.nonzero(ltr >= 0)
            ln_all = ltr[lfi, lli]
            lgood = self.ln_valid[ln_all] & self.ln_has_endpoints[ln_all]
            lfi, lli, ln_all = lfi[lgood], lli[lgood], ln_all[lgood]
            lseg_flat = self.kf_lines[frames[lfi], lli]
            lsegr_flat = self.kf_lines_right[frames[lfi], lli]
            lst_flat = self.kf_line_has_right[frames[lfi], lli]
            lcand, linv = np.unique(ln_all, return_inverse=True)
            lrows = np.bincount(linv, minlength=len(lcand))
            lsts = np.bincount(linv[lst_flat], minlength=len(lcand))
            ladm = np.nonzero((lsts > 0) | (lrows >= 2))[0][:max_lines_w]
            lremap = np.full(len(lcand), -1, np.int64)
            lremap[ladm] = np.arange(len(ladm))
            lselm = lremap[linv] >= 0
            lns_sel = lcand[ladm]
            l_line = lremap[linv[lselm]]
            l_pose = lfi[lselm].astype(np.int64)
            l_eps = lseg_flat[lselm].reshape(-1, 2, 2).astype(np.float64)
            l_eps_r = lsegr_flat[lselm].reshape(-1, 2, 2).astype(np.float64)
            l_stereo = lst_flat[lselm]
        else:
            # candidate lines (same structure; Lw is small)
            ltracks = self.kf_line_track[frames]
            lcand = np.unique(ltracks[ltracks >= 0])
            lcand = lcand[self.ln_valid[lcand] & self.ln_has_endpoints[lcand]]
            lobs_kf = self.ln_obs_kf[lcand]
            lobs_ix = self.ln_obs_idx[lcand]
            lslots = np.where(
                lobs_kf >= 0, slot_arr[np.maximum(lobs_kf, 0)], -1)
            l_in = lslots >= 0
            lkf = np.maximum(lobs_kf, 0)
            lix = np.maximum(lobs_ix, 0)
            lseg = self.kf_lines[lkf, lix]  # (m, MAX_OBS, 4)
            lsegr = self.kf_lines_right[lkf, lix]
            lst = l_in & self.kf_line_has_right[lkf, lix]
            ln_rows = l_in.sum(1)
            ln_st = lst.sum(1)
            lkeep = np.nonzero(
                (ln_rows > 0) & ((ln_st > 0) | (ln_rows >= 2)))[0]
            lkeep = lkeep[:max_lines_w]
            lns_sel = lcand[lkeep]
            lci, loi = np.nonzero(l_in[lkeep])
            l_line = lci.astype(np.int64)
            l_pose = lslots[lkeep][lci, loi].astype(np.int64)
            l_eps = lseg[lkeep][lci, loi].reshape(-1, 2, 2).astype(np.float64)
            l_eps_r = lsegr[lkeep][lci, loi].reshape(
                -1, 2, 2).astype(np.float64)
            l_stereo = lst[lkeep][lci, loi]

        def pad_arr(arr, cap, shape, dtype=np.float64):
            out = np.zeros((cap, *shape), dtype)
            n = min(len(arr), cap)
            if n:
                out[:n] = np.asarray(arr[:n], dtype)
            return out, n

        P = max_points
        Lw = max_lines_w
        points = np.zeros((P, 3))
        if len(pts_sel):
            points[: len(pts_sel)] = self.pt_pos[pts_sel]
        lines = np.tile(np.array([0, 0, 1.0, 1, 0, 0]), (Lw, 1))
        if len(lns_sel):
            lines[: len(lns_sel)] = self.ln_plucker[lns_sel]

        Tcw = np.linalg.inv(self.kf_pose[fsel])
        Tcw[~f_used] = np.eye(4)

        p_pose_a, ncp = pad_arr(p_pose, cp_capacity, (), np.int32)
        p_point_a, _ = pad_arr(p_point, cp_capacity, (), np.int32)
        p_meas_a, _ = pad_arr(p_meas, cp_capacity, (3,))
        p_stereo_a, _ = pad_arr(p_stereo, cp_capacity, (), bool)
        l_pose_a, ncl = pad_arr(l_pose, cl_capacity, (), np.int32)
        l_line_a, _ = pad_arr(l_line, cl_capacity, (), np.int32)
        l_eps_a, _ = pad_arr(l_eps, cl_capacity, (2, 2))
        l_eps_r_a, _ = pad_arr(l_eps_r, cl_capacity, (2, 2))
        l_stereo_a, _ = pad_arr(l_stereo, cl_capacity, (), bool)

        problem = dict(
            Tcw=Tcw,
            pose_fixed=fixed,
            points=points,
            lines=lines,
            p_pose=p_pose_a, p_point=p_point_a, p_meas=p_meas_a,
            p_stereo=p_stereo_a,
            p_valid=np.arange(cp_capacity) < ncp,
            l_pose=l_pose_a, l_line=l_line_a, l_eps=l_eps_a,
            l_eps_r=l_eps_r_a, l_stereo=l_stereo_a,
            l_valid=np.arange(cl_capacity) < ncl,
        )
        mapping = dict(
            frames=frames, pts=np.asarray(pts_sel, np.int64),
            lns=np.asarray(lns_sel, np.int64),
            p_pose=p_pose, p_point=p_point,
            l_pose=l_pose, l_line=l_line,
            ncp=ncp, ncl=ncl,
        )
        return problem, mapping

    def scatter_ba_result(self, result, mapping, remove_outliers=True):
        """Write optimized poses/points/lines back; drop outlier
        observations and decay covisibility (map.cc:733-807)."""
        frames = mapping["frames"]
        Tcw = np.asarray(result.Tcw, np.float64)
        for i, kf in enumerate(frames):
            self.kf_pose[kf] = np.linalg.inv(Tcw[i])
        if len(mapping["pts"]):
            self.pt_pos[mapping["pts"]] = np.asarray(result.points, np.float64)[
                : len(mapping["pts"])
            ]
        if len(mapping["lns"]):
            self.ln_plucker[mapping["lns"]] = np.asarray(result.lines, np.float64)[
                : len(mapping["lns"])
            ]
        if remove_outliers:
            inl = np.asarray(result.p_inlier)[: mapping["ncp"]]
            for c in np.nonzero(~inl)[0]:
                pt = int(mapping["pts"][mapping["p_point"][c]])
                kf = int(frames[mapping["p_pose"][c]])
                # decay covisibility between the losing pair(s) before the
                # observation disappears (map.cc:781-798 DecreaseWeight)
                for o in range(self.pt_obs_n[pt]):
                    kf2 = int(self.pt_obs_kf[pt, o])
                    if kf2 >= 0 and kf2 != kf:
                        self.decay_covisibility(kf, kf2)
                self.remove_point_obs(pt, kf)
            # line outliers likewise (RemoveLineOutliers, map.cc:736-757)
            l_inl = np.asarray(result.l_inlier)[: mapping["ncl"]]
            for c in np.nonzero(~l_inl)[0]:
                ln = int(mapping["lns"][mapping["l_line"][c]])
                kf = int(frames[mapping["l_pose"][c]])
                self.remove_line_obs(ln, kf)

    # ------------------------------------------------------- map maintenance
    def update_mappoint_descriptors(self, pts: np.ndarray):
        """Representative descriptor per mappoint = the observation whose
        median cosine distance 2(1−cos) to the others is minimal
        (UpdateMappointDescriptor, map.cc:421-469; distance utils.cc:14-16).
        """
        for pt in np.atleast_1d(pts):
            n = self.pt_obs_n[pt]
            if n < 2:
                continue
            descs = np.stack([
                self.kf_desc[self.pt_obs_kf[pt, o], self.pt_obs_kpt[pt, o]]
                .astype(np.float32)
                for o in range(n)
            ])
            sims = descs @ descs.T
            dist = 2.0 * (1.0 - sims)
            med = np.median(dist, axis=1)
            self.pt_desc[pt] = descs[int(np.argmin(med))]

    def search_by_projection(self, kf: int, pt_indices: np.ndarray,
                             radius_px: float = 15.0,
                             best_thr: float = 0.35,
                             ratio_thr: float = 0.6) -> list[tuple[int, int]]:
        """Project mappoints into keyframe ``kf`` and match against its
        unassociated keypoints by descriptor — the local-map association of
        Map::SearchByProjection (map.cc:952-1005): accept when the best
        distance 2(1−cos) < 0.35 and < 0.6 × second best.

        Returns [(pt, kpt_idx)] candidate associations (not applied).
        """
        cam_pose = np.linalg.inv(self.kf_pose[kf])
        out: list[tuple[int, int]] = []
        kp_valid = self.kf_kpt_valid[kf] & (self.kf_track[kf] < 0)
        if not kp_valid.any():
            return out
        kp_xy = self.kf_meas[kf, :, :2]
        kp_desc = self.kf_desc[kf].astype(np.float32)
        for pt in np.atleast_1d(pt_indices):
            if self.pt_status[pt] != PT_GOOD:
                continue
            Xc = cam_pose[:3, :3] @ self.pt_pos[pt] + cam_pose[:3, 3]
            if Xc[2] <= 0.1:
                continue
            du = kp_xy[:, 0] - (Xc[0] / Xc[2] * self._fx + self._cx)
            dv = kp_xy[:, 1] - (Xc[1] / Xc[2] * self._fy + self._cy)
            near = kp_valid & (du * du + dv * dv < radius_px * radius_px)
            idx = np.nonzero(near)[0]
            if len(idx) == 0:
                continue
            d = 2.0 * (1.0 - kp_desc[idx] @ self.pt_desc[pt].astype(np.float32))
            order = np.argsort(d)
            best = d[order[0]]
            second = d[order[1]] if len(order) > 1 else np.inf
            if best < best_thr and best < ratio_thr * second:
                out.append((int(pt), int(idx[order[0]])))
        return out

    def set_intrinsics(self, fx: float, fy: float, cx: float, cy: float):
        """Pixel intrinsics for projection-based search."""
        self._fx, self._fy, self._cx, self._cy = fx, fy, cx, cy

    # ------------------------------------------------------------------- io
    def save(self, path: str):
        """Checkpoint the full map state (npz). The reference could only
        write text dumps it never reads back (map.cc:1026-1077); here
        save/load round-trips so mapping can resume."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **{
            k: v for k, v in self.__dict__.items()
            if isinstance(v, np.ndarray)
        }, n_kf=self.n_kf, n_pt=self.n_pt, n_ln=self.n_ln, K=self.K,
            LN=self.LN,
            capacities=np.asarray([
                self.kf_valid.shape[0], self.pt_status.shape[0],
                self.ln_valid.shape[0],
            ]),
            intrinsics=np.asarray([self._fx, self._fy, self._cx, self._cy]))

    @classmethod
    def load(cls, path: str, cfg: PipelineConfig | None = None):
        """Restore a checkpoint. Capacities and intrinsics come from the
        file, so maps saved under any config reload correctly."""
        import dataclasses

        data = np.load(path)
        cfg = cfg or PipelineConfig()
        if "capacities" in data:
            kf_cap, pt_cap, ln_cap = (int(x) for x in data["capacities"])
            cfg = dataclasses.replace(
                cfg, max_map_keyframes=kf_cap, max_map_points=pt_cap,
                max_map_lines=ln_cap,
            )
        self = cls(int(data["K"]), int(data["LN"]), cfg,
                   desc_dim=int(data["pt_desc"].shape[1]))
        for k in data.files:
            if k in ("n_kf", "n_pt", "n_ln", "K", "LN", "capacities",
                     "intrinsics"):
                continue
            getattr(self, k)[...] = data[k]
        self.n_kf = int(data["n_kf"])
        self.n_pt = int(data["n_pt"])
        self.n_ln = int(data["n_ln"])
        if "intrinsics" in data:
            self.set_intrinsics(*(float(x) for x in data["intrinsics"]))
        return self

    def save_map_text(self, dirpath: str):
        """Text map dump in the reference's SaveMap layout (map.cc:
        1026-1077): one per-keyframe file of keypoints + track ids, plus a
        global ``mappoints.txt`` of id x y z. The npz checkpoint (save) is
        the richer format; this one exists for tool compatibility."""
        os.makedirs(dirpath, exist_ok=True)
        for kf in range(self.n_kf):
            fid = int(self.kf_frame_id[kf])
            with open(os.path.join(dirpath, f"keyframe_{fid}.txt"), "w") as f:
                for k in np.nonzero(self.kf_kpt_valid[kf])[0]:
                    u, v, ur = self.kf_meas[kf, k]
                    f.write(f"{int(self.kf_track[kf, k])} {u:.3f} {v:.3f} {ur:.3f}\n")
        with open(os.path.join(dirpath, "mappoints.txt"), "w") as f:
            for pt in range(self.n_pt):
                if self.pt_status[pt] != PT_GOOD:
                    continue
                x, y, z = self.pt_pos[pt]
                f.write(f"{pt} {x:.6f} {y:.6f} {z:.6f}\n")

    def apply_pose_corrections(self, new_Twc: np.ndarray):
        """Apply globally-optimized keyframe poses (backend/pose_graph.py)
        and rigidly re-anchor landmarks: each mappoint/mapline moves with
        the correction of its FIRST observing keyframe
        (X' = Twc_new · Tcw_old · X). The reference has no global backend;
        this is the standard PGO map update."""
        n = self.n_kf
        old_Twc = self.kf_pose[:n].copy()
        corr = np.einsum(
            "kij,kjl->kil", new_Twc[:n], np.linalg.inv(old_Twc)
        )  # (n, 4, 4) world-to-world per keyframe
        self.kf_pose[:n] = new_Twc[:n]
        # mappoints: anchor = first observation's keyframe
        pts = np.nonzero((self.pt_status[: self.n_pt] != PT_BAD)
                         & (self.pt_obs_n[: self.n_pt] > 0))[0]
        if len(pts):
            anchor = self.pt_obs_kf[pts, 0]
            okp = (anchor >= 0) & (anchor < n)
            pts = pts[okp]
            anchor = anchor[okp]
            X = self.pt_pos[pts]
            R = corr[anchor, :3, :3]
            t = corr[anchor, :3, 3]
            self.pt_pos[pts] = np.einsum("kij,kj->ki", R, X) + t
        # maplines: endpoints move rigidly; Plücker L' = [R n + t̂ R d; R d]
        lns = np.nonzero(self.ln_valid[: self.n_ln]
                         & (self.ln_obs_n[: self.n_ln] > 0))[0]
        for ln in lns:
            a = self.ln_obs_kf[ln, 0]
            if not (0 <= a < n):
                continue
            Rc = corr[a, :3, :3]
            tc = corr[a, :3, 3]
            if self.ln_has_endpoints[ln]:
                self.ln_endpoints[ln] = self.ln_endpoints[ln] @ Rc.T + tc
            nvec, dvec = self.ln_plucker[ln, :3], self.ln_plucker[ln, 3:]
            nd = Rc @ nvec + np.cross(tc, Rc @ dvec)
            self.ln_plucker[ln] = np.concatenate([nd, Rc @ dvec])

    def keyframe_trajectory(self):
        """(times, poses) of valid keyframes in insertion order — feeds the
        TUM writer (SaveKeyframeTrajectory, map.cc:1007-1024)."""
        sel = np.nonzero(self.kf_valid[: self.n_kf])[0]
        return self.kf_time[sel], self.kf_pose[sel]
