"""Synthetic stereo scenes with known ground truth.

The reference's only end-to-end quality signal was "run EuRoC and compare
trajectories" (run_batch.py). This container has no datasets, so the
framework ships a synthetic-scene harness instead: random 3D points/lines +
a smooth trajectory + an exact stereo camera give controlled inputs with
perfect ground truth for every subsystem (matching, triangulation, pose
solving, BA, the full SLAM loop) and for the benchmark.

Two observation modes:
- :func:`observe_points` — oracle features: exact projections + per-landmark
  random descriptors (unit vectors), optional pixel noise and outliers.
  Tests SLAM logic deterministically without the convnets.
- :func:`render_images` — draws Gaussian blobs (points) and dark segments
  (lines) into stereo images, for full-stack tests through SuperPoint/RCF.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from rspl_slam_tpu_torch.config import CameraConfig

__all__ = ["SyntheticScene", "make_scene", "make_trajectory", "make_ring_scene",
           "make_loop_trajectory", "observe_points", "render_images", "make_ba_window"]


@dataclass
class SyntheticScene:
    points: np.ndarray  # (P, 3) world
    descriptors: np.ndarray  # (P, D) unit norm
    lines: np.ndarray  # (L, 2, 3) world segment endpoints


def make_scene(
    num_points: int = 300,
    num_lines: int = 12,
    extent=(8.0, 5.0, 14.0),
    depth_offset: float = 2.0,
    desc_dim: int = 256,
    seed: int = 0,
    on_line_frac: float = 0.35,
) -> SyntheticScene:
    """Points/lines in a box in front of the origin, looking down +z.

    ``on_line_frac`` of the points are sampled ON the 3D line segments
    (tiny jitter): real detectors fire along edges, and the reference's
    whole line machinery (point-on-line assignment, vote matching,
    points-based mapline triangulation) assumes such keypoints exist.
    """
    rng = np.random.default_rng(seed)
    ex, ey, ez = extent
    lo = [-ex / 2, -ey / 2, depth_offset]
    hi = [ex / 2, ey / 2, depth_offset + ez]
    starts = rng.uniform(lo, hi, (num_lines, 3))
    dirs = rng.standard_normal((num_lines, 3)) if num_lines else np.zeros((0, 3))
    if num_lines:
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    lens = rng.uniform(1.5, 3.5, (num_lines, 1))
    ends = starts + dirs * lens
    lines = np.stack([starts, ends], 1) if num_lines else np.zeros((0, 2, 3))

    n_on = int(num_points * on_line_frac) if num_lines else 0
    n_free = num_points - n_on
    pts_free = rng.uniform(lo, hi, (n_free, 3))
    if n_on:
        which = rng.integers(0, num_lines, n_on)
        t = rng.uniform(0.05, 0.95, (n_on, 1))
        pts_on = starts[which] + t * (ends[which] - starts[which])
        pts_on += rng.standard_normal((n_on, 3)) * 0.003
        pts = np.concatenate([pts_free, pts_on], 0)
    else:
        pts = pts_free
    desc = rng.standard_normal((num_points, desc_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return SyntheticScene(points=pts.astype(np.float64), descriptors=desc,
                          lines=lines.astype(np.float64))


def make_trajectory(n: int = 60, step: float = 0.06, yaw_rate: float = 0.004,
                    bob: float = 0.01) -> np.ndarray:
    """(n, 4, 4) world-from-camera poses: forward motion with gentle yaw and
    vertical bob (keeps the scene box in view)."""
    poses = np.zeros((n, 4, 4))
    yaw = 0.0
    pos = np.zeros(3)
    for i in range(n):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = pos + np.array([0.0, bob * np.sin(i * 0.4), 0.0])
        poses[i] = T
        pos = pos + R @ np.array([0.0, 0.0, step])
        yaw += yaw_rate
    return poses


def make_ring_scene(num_points: int = 2000, num_lines: int = 24, path_radius: float = 3.0,
                    inner: float = 1.5, outer=(5.0, 9.0), height=(-2.0, 2.0),
                    desc_dim: int = 256, seed: int = 0) -> SyntheticScene:
    """A place to drive a loop in: points (and dark segments) around the
    vertical axis through (``path_radius``, 0, 0), the centre of
    :func:`make_loop_trajectory`'s circle, in an outer wall
    (``outer`` radii) and an inner pillar (radius < ``inner``), over
    ``height`` in y. Every view along the circle sees new structure, and
    the start's view returns only when the circle closes."""
    rng = np.random.default_rng(seed)
    n_in = num_points // 5
    r = np.concatenate([np.sqrt(rng.uniform(0.0, inner ** 2, n_in)),
                        np.sqrt(rng.uniform(outer[0] ** 2, outer[1] ** 2, num_points - n_in))])
    th = rng.uniform(0.0, 2 * np.pi, num_points)
    pts = np.stack([path_radius + r * np.cos(th), rng.uniform(*height, num_points),
                    r * np.sin(th)], -1)
    lines = np.zeros((num_lines, 2, 3))
    if num_lines:
        rl = rng.uniform(*outer, num_lines)
        tl = rng.uniform(0.0, 2 * np.pi, num_lines)
        starts = np.stack([path_radius + rl * np.cos(tl), rng.uniform(*height, num_lines),
                           rl * np.sin(tl)], -1)
        dirs = rng.standard_normal((num_lines, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        lines = np.stack([starts, starts + dirs * rng.uniform(1.5, 3.5, (num_lines, 1))], 1)
    desc = rng.standard_normal((num_points, desc_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    return SyntheticScene(points=pts, descriptors=desc, lines=lines)


def make_loop_trajectory(n: int, per_lap: int, radius: float = 3.0,
                         bob: float = 0.01) -> np.ndarray:
    """(n, 4, 4) world-from-camera poses driving a circle of ``radius``
    counter-clockwise seen from above, ``per_lap`` frames per lap, looking
    along the path: frame 0 at the origin facing +z, frame ``per_lap``
    back on it (a loop), with a vertical bob."""
    poses = np.zeros((n, 4, 4))
    for i in range(n):
        yaw = 2 * np.pi * i / per_lap
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T[:3, 3] = [radius * (1 - c), bob * np.sin(i * 0.4), radius * s]
        poses[i] = T
    return poses


def observe_points(
    scene: SyntheticScene,
    cam: CameraConfig,
    Twc: np.ndarray,  # (4, 4)
    noise_px: float = 0.0,
    outlier_frac: float = 0.0,
    seed: int = 0,
):
    """Project every scene point into the rectified stereo pair.

    Returns dict with uv_left (P,2), uv_right (P,2), depth (P,), and
    ``visible`` (P,) — in both images, inside the border, depth within the
    camera's configured range. Noise is added to both images independently;
    ``outlier_frac`` of visible points get their left observation replaced
    by a uniform random pixel (gross mismatch, exercises robust gating).
    """
    rng = np.random.default_rng(seed)
    Tcw = np.linalg.inv(Twc)
    Xc = scene.points @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = Xc[:, 2]
    zs = np.maximum(z, 1e-9)
    u = cam.fx * Xc[:, 0] / zs + cam.cx
    v = cam.fy * Xc[:, 1] / zs + cam.cy
    ur = u - cam.bf / zs
    b = 8.0
    visible = (
        (z > cam.depth_lower_thr)
        & (z < cam.depth_upper_thr)
        & (u > b) & (u < cam.image_width - b)
        & (v > b) & (v < cam.image_height - b)
        & (ur > b) & (ur < cam.image_width - b)
    )
    uv_l = np.stack([u, v], -1) + rng.standard_normal((len(u), 2)) * noise_px
    uv_r = np.stack([ur, v], -1) + rng.standard_normal((len(u), 2)) * noise_px
    if outlier_frac > 0:
        n_out = int(visible.sum() * outlier_frac)
        vis_idx = np.nonzero(visible)[0]
        out_idx = rng.choice(vis_idx, size=n_out, replace=False)
        uv_l[out_idx] = rng.uniform(
            [b, b], [cam.image_width - b, cam.image_height - b], (n_out, 2)
        )
    return {
        "uv_left": uv_l,
        "uv_right": uv_r,
        "depth": z,
        "visible": visible,
    }


def render_images(
    scene: SyntheticScene,
    cam: CameraConfig,
    Twc: np.ndarray,
    blob_sigma: float = 1.3,
    line_width: float = 1.5,
    noise: float = 0.02,
    seed: int = 0,
):
    """Render the scene into a stereo pair (H, W) float32 in [0, 1]:
    bright Gaussian blobs at point projections on a mid-gray background,
    dark anti-aliased line segments. Good enough to drive SuperPoint/RCF."""
    rng = np.random.default_rng(seed)
    H, W = cam.image_height, cam.image_width
    obs = observe_points(scene, cam, Twc)
    imgs = []
    for side in ("uv_left", "uv_right"):
        img = np.full((H, W), 0.45, np.float32)
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        for (x, y), vis in zip(obs[side], obs["visible"]):
            if not vis:
                continue
            x0, x1 = max(0, int(x) - 4), min(W, int(x) + 5)
            y0, y1 = max(0, int(y) - 4), min(H, int(y) + 5)
            if x0 >= x1 or y0 >= y1:
                continue
            patch = np.exp(
                -((xx[y0:y1, x0:x1] - x) ** 2 + (yy[y0:y1, x0:x1] - y) ** 2)
                / (2 * blob_sigma**2)
            )
            img[y0:y1, x0:x1] = np.minimum(1.0, img[y0:y1, x0:x1] + 0.5 * patch)
        imgs.append(img)
    # lines: project endpoints, draw dark segments with distance falloff
    Tcw = np.linalg.inv(Twc)
    shift = np.array([0.0, 0.0])
    for li, img in enumerate(imgs):
        for seg in scene.lines:
            Pc = seg @ Tcw[:3, :3].T + Tcw[:3, 3]
            if (Pc[:, 2] < 0.2).any():
                continue
            u = cam.fx * Pc[:, 0] / Pc[:, 2] + cam.cx - (cam.bf / Pc[:, 2] if li else 0.0)
            v = cam.fy * Pc[:, 1] / Pc[:, 2] + cam.cy
            p0, p1 = np.array([u[0], v[0]]), np.array([u[1], v[1]])
            d = p1 - p0
            L = np.linalg.norm(d)
            if L < 2:
                continue
            n_samples = int(L * 2)
            ts = np.linspace(0, 1, n_samples)
            for t in ts:
                x, y = p0 + t * d
                xi, yi = int(round(x)), int(round(y))
                if 1 <= xi < W - 1 and 1 <= yi < H - 1:
                    img[yi - 1 : yi + 2, xi - 1 : xi + 2] = np.minimum(
                        img[yi - 1 : yi + 2, xi - 1 : xi + 2], 0.12
                    )
    out = []
    for img in imgs:
        img = img + rng.standard_normal((H, W)).astype(np.float32) * noise
        out.append(np.clip(img, 0.0, 1.0))
    return out[0], out[1]


def make_ba_window(cam: CameraConfig, frames: int = 10, points: int = 1536,
                   lines: int = 128, views: int = 4, noise_px: float = 0.3,
                   outlier_frac: float = 0.05, seed: int = 0):
    """A full local-BA window with ground truth, as numpy arrays in the
    fields of ``backend.local_ba.BAProblem``: ``frames`` cameras in steps
    of (0.2, 0.1, 0.15) m (the first fixed), ``points`` points and
    ``lines`` 3D segments 3-9 m ahead, each seen from ``views`` distinct
    frames with mono and stereo rows mixed, ``noise_px`` pixel noise and
    ``outlier_frac`` of the observations displaced (points by 40-90 px,
    left line endpoints by 20-40 px). The
    initial state is the truth perturbed (poses ~1 cm and 0.01 rad,
    points 5 cm, line endpoints 2 cm). Capacities equal the counts
    (Cp = views · points, Cl = views · lines): every row is valid.

    Returns (problem dict, {"Tcw", "points", "lines"} ground truth)."""
    rng = np.random.default_rng(seed)
    Twc = np.tile(np.eye(4), (frames, 1, 1))
    Twc[:, :3, 3] = np.arange(frames)[:, None] * np.array([0.2, 0.1, 0.15])
    Tcw_gt = np.linalg.inv(Twc)

    def project(f, X):  # (n,) frames, (n, 3) world → (n, 3) [u, v, uR]
        Xc = np.einsum("nij,nj->ni", Tcw_gt[f, :3, :3], X) + Tcw_gt[f, :3, 3]
        u = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx
        v = cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy
        return np.stack([u, v, u - cam.bf / Xc[:, 2]], -1)

    def observers(n):  # each landmark's `views` distinct frames, ascending
        return np.sort(np.argsort(rng.uniform(size=(n, frames)), 1)[:, :views], 1).ravel()

    pts_gt = rng.uniform([-3, -2, 3], [3, 2, 9], (points, 3))
    p_point = np.repeat(np.arange(points), views)
    p_pose = observers(points)
    p_meas = project(p_pose, pts_gt[p_point]) + rng.normal(0, noise_px, (len(p_pose), 3))
    bad = rng.uniform(size=len(p_pose)) < outlier_frac
    p_meas[bad, :2] += rng.uniform(40, 90, (bad.sum(), 2)) * np.sign(
        rng.standard_normal((bad.sum(), 2)))
    p_stereo = rng.uniform(size=len(p_pose)) < 0.5

    a = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (lines, 3))
    d = rng.standard_normal((lines, 3))
    b = a + d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(1, 2, (lines, 1))
    l_line = np.repeat(np.arange(lines), views)
    l_pose = observers(lines)
    ends = [project(l_pose, e[l_line]) for e in (a, b)]
    ends = [e + rng.normal(0, noise_px, e.shape) for e in ends]
    l_eps = np.stack([e[:, :2] for e in ends], 1)
    l_eps_r = np.stack([e[:, [2, 1]] for e in ends], 1)
    bad = rng.uniform(size=len(l_pose)) < outlier_frac
    l_eps[bad] += rng.uniform(20, 40, (bad.sum(), 1, 2))
    l_stereo = rng.uniform(size=len(l_pose)) < 0.5

    def plucker(p, q):
        return np.concatenate([np.cross(p, q), q - p], -1)

    Tcw0 = Tcw_gt.copy()
    for f in range(1, frames):
        Tcw0[f] = _exp_se3(rng.normal(0, 0.01, 6)) @ Tcw_gt[f]
    problem = dict(
        Tcw=Tcw0, pose_fixed=np.arange(frames) == 0,
        points=pts_gt + rng.normal(0, 0.05, pts_gt.shape),
        lines=plucker(a + rng.normal(0, 0.02, a.shape), b + rng.normal(0, 0.02, b.shape)),
        p_pose=p_pose.astype(np.int32), p_point=p_point.astype(np.int32), p_meas=p_meas,
        p_stereo=p_stereo, p_valid=np.ones(len(p_pose), bool),
        l_pose=l_pose.astype(np.int32), l_line=l_line.astype(np.int32), l_eps=l_eps,
        l_eps_r=l_eps_r, l_stereo=l_stereo, l_valid=np.ones(len(l_pose), bool))
    return problem, {"Tcw": Tcw_gt, "points": pts_gt, "lines": plucker(a, b)}


def _exp_se3(xi: np.ndarray) -> np.ndarray:
    """SE(3) exponential of [ω, v] (numpy f64, ‖ω‖ > 0)."""
    w, v = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    A, B, C = np.sin(th) / th, (1 - np.cos(th)) / th**2, (th - np.sin(th)) / th**3
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + A * W + B * W @ W
    T[:3, 3] = (np.eye(3) + B * W + C * W @ W) @ v
    return T
