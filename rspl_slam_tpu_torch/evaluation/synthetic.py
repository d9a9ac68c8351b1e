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

__all__ = ["SyntheticScene", "make_scene", "make_trajectory", "observe_points",
           "render_images"]


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
