"""Loop-closure detection and relocalization (port of
backend/loop_closure.py): place recognition + geometric verification.

A copy of the JAX package's module, which is host numpy there too:
detection runs at keyframe rate on at most a few hundred keyframes × 256-d
descriptors and ≤ 400 keypoints, and its RANSAC draws from
``np.random.default_rng(seed)``, so given the same map arrays both packages
accept the same constraints, bit for bit.

Per new keyframe:
1. **Place recognition**: a global descriptor per keyframe, the
   L2-normalized mean of its SuperPoint keypoint descriptors. One
   (F, D) @ (D,) matvec scores the query against every stored keyframe;
   candidates must be temporally distant (slot gap ≥ ``min_gap``) and
   covisibility-disjoint, so adjacent keyframes never masquerade as loops.
2. **Geometric verification**: mutual nearest-neighbour descriptor
   matching between the two keyframes (the reference's 2(1−cos) metric,
   utils.cc:14-16), pairs where both frames have a stereo depth,
   back-projected each into its own camera frame (d = bf/(uL−uR)), and the
   relative pose T_ci←cj fitted by Horn/Umeyama RANSAC over 3-point
   hypotheses + an all-inlier refit. A loop is accepted with
   ≥ ``min_inliers`` geometric inliers.

The accepted constraint Z = T_ci←cj = Tcw_i · Twc_j feeds
``pose_graph.relative_constraints_from_covisibility(loops=...)``: a
measured relative pose that disagrees with the drifted odometry chain.
:meth:`LoopDetector.relocalize` runs the same recognition and verification
for a lost frame against every keyframe.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["LoopConstraint", "LoopDetector"]


@dataclass
class LoopConstraint:
    i: int                 # keyframe slot (earlier)
    j: int                 # keyframe slot (query, later)
    Z: np.ndarray          # (4, 4) measured Tcw_i · Twc_j  (= T_ci←cj)
    weight: float          # confidence ≙ geometric inlier count
    n_inliers: int
    similarity: float


def global_descriptor(desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """L2-normalized mean of the valid keypoint descriptors — a compact
    whole-image signature for place recognition. Rows of ``desc`` are
    already unit-norm (SuperPoint post-process), so the mean direction
    captures the dominant descriptor mass of the view."""
    v = np.asarray(valid, bool)
    if not v.any():
        return np.zeros(desc.shape[1], np.float32)
    g = np.asarray(desc, np.float32)[v].mean(0)
    n = float(np.linalg.norm(g))
    return g / n if n > 1e-9 else g


def mutual_nn_matches(desc_a: np.ndarray, valid_a: np.ndarray,
                      desc_b: np.ndarray, valid_b: np.ndarray,
                      max_dist: float = 0.7) -> np.ndarray:
    """Mutual nearest-neighbour cosine matching. Returns (Ka,) indices
    into b (−1 = unmatched). ``max_dist`` is on the reference's
    2(1−cos) ∈ [0, 4] descriptor distance (utils.cc:14-16)."""
    A = np.asarray(desc_a, np.float32)
    B = np.asarray(desc_b, np.float32)
    sim = A @ B.T  # unit-norm rows → cosine
    sim = np.where(valid_a[:, None] & valid_b[None, :], sim, -2.0)
    dist = 2.0 * (1.0 - sim)
    row_best = sim.argmax(1)
    col_best = sim.argmax(0)
    ka = np.arange(len(A))
    mutual = col_best[row_best] == ka
    good = mutual & (dist[ka, row_best] < max_dist) & valid_a
    return np.where(good, row_best, -1)


def _umeyama_se3(src: np.ndarray, dst: np.ndarray):
    """Rigid (no-scale) alignment dst ≈ R @ src + t by Horn's method."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(Vt.T @ U.T) < 0:
        S[2, 2] = -1.0
    R = Vt.T @ S @ U.T
    t = mu_d - R @ mu_s
    return R, t


def ransac_rigid_align(p_src: np.ndarray, p_dst: np.ndarray,
                       iters: int = 256, inlier_dist: float = 0.15,
                       min_inliers: int = 12, seed: int = 0):
    """RANSAC over 3-point rigid hypotheses: finds R, t with
    ‖p_dst − (R p_src + t)‖ < inlier_dist for the most pairs, then refits
    on all inliers. Returns (T 4×4, inlier_mask) or (None, None)."""
    n = len(p_src)
    if n < max(3, min_inliers):
        return None, None
    rng = np.random.default_rng(seed)
    # batched hypotheses: (iters, 3) index triples → vectorized Horn fits
    picks = rng.integers(0, n, size=(iters, 3))
    degenerate = (
        (picks[:, 0] == picks[:, 1]) | (picks[:, 1] == picks[:, 2])
        | (picks[:, 0] == picks[:, 2])
    )
    best_mask = None
    best_n = min_inliers - 1
    for it in range(iters):
        if degenerate[it]:
            continue
        s = p_src[picks[it]]
        d = p_dst[picks[it]]
        # reject near-collinear triples (unstable rotation)
        if np.linalg.norm(np.cross(s[1] - s[0], s[2] - s[0])) < 1e-6:
            continue
        R, t = _umeyama_se3(s, d)
        err = np.linalg.norm(p_dst - (p_src @ R.T + t), axis=1)
        mask = err < inlier_dist
        ni = int(mask.sum())
        if ni > best_n:
            best_n = ni
            best_mask = mask
    if best_mask is None:
        return None, None
    R, t = _umeyama_se3(p_src[best_mask], p_dst[best_mask])
    err = np.linalg.norm(p_dst - (p_src @ R.T + t), axis=1)
    mask = err < inlier_dist
    if int(mask.sum()) < min_inliers:
        return None, None
    R, t = _umeyama_se3(p_src[mask], p_dst[mask])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T, mask


@dataclass
class LoopDetector:
    """Stateful per-map detector. Call :meth:`add_keyframe` for every new
    keyframe, then :meth:`detect` to test it against the database."""

    bf: float                       # stereo baseline × fx (depth = bf/disp)
    sim_thr: float = 0.92           # place-recognition cosine gate
    reloc_sim_thr: float = 0.5      # recovery gate — deliberately permissive
    #                                 (partial view overlap dilutes pooled
    #                                 descriptors); precision comes from the
    #                                 3D-3D RANSAC verification, which a
    #                                 wrong place essentially cannot pass
    #                                 (≥min_inliers at inlier_dist metres)
    min_gap: int = 25               # slot distance before a loop is possible
    min_matches: int = 30           # descriptor matches to attempt geometry
    min_inliers: int = 20           # geometric inliers to accept
    inlier_dist: float = 0.15       # metres, 3D-3D residual gate
    max_desc_dist: float = 0.7      # 2(1−cos) matching gate
    ransac_iters: int = 256
    _gdesc: list = field(default_factory=list)

    def _ensure_gdesc(self, m, n: int):
        """Lazily extend the global-descriptor database to ``n`` keyframes
        from the map store (robust to checkpoint reload — the database is
        derivable state)."""
        while len(self._gdesc) < n:
            k = len(self._gdesc)
            self._gdesc.append(
                global_descriptor(m.kf_desc[k], m.kf_kpt_valid[k])
            )

    def _back_project(self, meas: np.ndarray, idx: np.ndarray, fx, fy, cx, cy):
        u, v, ur = meas[idx, 0], meas[idx, 1], meas[idx, 2]
        d = self.bf / np.maximum(u - ur, 1e-6)
        return np.stack([(u - cx) / fx * d, (v - cy) / fy * d, d], -1)

    def detect(self, m, q: int) -> LoopConstraint | None:
        """Test keyframe slot ``q`` against all earlier keyframes in map
        store ``m``. Returns a verified LoopConstraint or None."""
        self._ensure_gdesc(m, q + 1)
        n = q  # candidates: strictly earlier slots
        if n <= self.min_gap:
            return None
        G = np.stack(self._gdesc[:n])
        sims = G @ self._gdesc[q]
        sims[~m.kf_valid[:n]] = -1.0  # culled keyframes are not candidates
        # temporal + covisibility exclusion: a loop must be a re-visit,
        # not the local window seen again
        sims[max(0, q - self.min_gap):] = -1.0
        covis = np.maximum(m.covis, m.covis.T)
        sims[np.nonzero(covis[q, :n] > 0)[0]] = -1.0
        c = int(sims.argmax())
        sim = float(sims[c])
        if sim < self.sim_thr:
            return None
        # geometric verification
        fx, fy, cx, cy = m._fx, m._fy, m._cx, m._cy
        i0 = mutual_nn_matches(
            m.kf_desc[q], m.kf_kpt_valid[q],
            m.kf_desc[c], m.kf_kpt_valid[c],
            max_dist=self.max_desc_dist,
        )
        kq = np.nonzero(i0 >= 0)[0]
        if len(kq) < self.min_matches:
            return None
        kc = i0[kq]
        stereo = (m.kf_meas[q, kq, 2] > 0) & (m.kf_meas[c, kc, 2] > 0)
        kq, kc = kq[stereo], kc[stereo]
        if len(kq) < self.min_inliers:
            return None
        p_q = self._back_project(m.kf_meas[q], kq, fx, fy, cx, cy)
        p_c = self._back_project(m.kf_meas[c], kc, fx, fy, cx, cy)
        # T maps query-camera points into candidate-camera frame: T_cc←cq
        T, mask = ransac_rigid_align(
            p_q, p_c, iters=self.ransac_iters,
            inlier_dist=self.inlier_dist, min_inliers=self.min_inliers,
            seed=q,
        )
        if T is None:
            return None
        # constraint (i=c earlier, j=q later): Z = Tcw_i · Twc_j = T_ci←cj
        return LoopConstraint(
            i=c, j=q, Z=T, weight=float(mask.sum()),
            n_inliers=int(mask.sum()), similarity=sim,
        )

    def relocalize(self, m, desc: np.ndarray, valid: np.ndarray,
                   meas: np.ndarray, top_k: int = 3):
        """Kidnapped-robot recovery: match a LOST frame's raw features
        against the whole keyframe database and return
        (kf_slot, Twc, n_inliers) — the absolute pose of the query camera —
        or None. Same place-recognition signature and 3D-3D RANSAC
        verification as :meth:`detect`, but with no temporal/covisibility
        exclusion (ANY keyframe is a valid anchor) and a more permissive
        similarity gate (recall matters; a wrong candidate still has to pass
        geometry). The reference has no equivalent — on tracking failure it
        re-anchors on the previous frame and keeps drifting
        (map_builder.cc:218-236)."""
        n = m.n_kf
        if n == 0:
            return None
        self._ensure_gdesc(m, n)
        G = np.stack(self._gdesc[:n])
        sims = G @ global_descriptor(desc, valid)
        sims[~m.kf_valid[:n]] = -1.0  # culled keyframes cannot anchor
        fx, fy, cx, cy = m._fx, m._fy, m._cx, m._cy
        for c in np.argsort(sims)[::-1][:top_k]:
            c = int(c)
            if sims[c] < self.reloc_sim_thr:
                break
            i0 = mutual_nn_matches(desc, valid, m.kf_desc[c],
                                   m.kf_kpt_valid[c],
                                   max_dist=self.max_desc_dist)
            kq = np.nonzero(i0 >= 0)[0]
            if len(kq) < self.min_matches:
                continue
            kc = i0[kq]
            stereo = (meas[kq, 2] > 0) & (m.kf_meas[c, kc, 2] > 0)
            kq, kc = kq[stereo], kc[stereo]
            if len(kq) < self.min_inliers:
                continue
            p_q = self._back_project(meas, kq, fx, fy, cx, cy)
            p_c = self._back_project(m.kf_meas[c], kc, fx, fy, cx, cy)
            # T = T_cc←cq maps query-camera points into candidate camera;
            # T = Tcw_c · Twc_q  ⇒  Twc_q = Twc_c · T
            T, mask = ransac_rigid_align(
                p_q, p_c, iters=self.ransac_iters,
                inlier_dist=self.inlier_dist, min_inliers=self.min_inliers,
                seed=c + 1,
            )
            if T is None:
                continue
            return c, m.kf_pose[c] @ T, int(mask.sum())
        return None
