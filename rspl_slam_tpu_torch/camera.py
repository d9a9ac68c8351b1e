"""Rectified stereo camera helpers (port of camera.py): projection,
back-projection and the stereo gates on torch tensors over a
:class:`CameraConfig`, the rectification maps built on the host in numpy
(a copy — the JAX module imports jax) and the bilinear remap with the JAX
border clamp."""

from __future__ import annotations

import numpy as np
import torch

from rspl_slam_tpu_torch.config import CameraConfig

__all__ = [
    "project", "back_project", "stereo_project", "back_project_stereo",
    "disparity_to_depth", "stereo_gate", "build_rectify_maps", "remap_bilinear",
]


def project(cfg: CameraConfig, p_cam: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points → (..., 2) pixels (camera.h:42-49)."""
    z = p_cam[..., 2]
    u = cfg.fx * p_cam[..., 0] / z + cfg.cx
    v = cfg.fy * p_cam[..., 1] / z + cfg.cy
    return torch.stack([u, v], -1)


def back_project(cfg: CameraConfig, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels + depth → camera-frame 3D (camera.h:51-58)."""
    x = (uv[..., 0] - cfg.cx) / cfg.fx * depth
    y = (uv[..., 1] - cfg.cy) / cfg.fy * depth
    return torch.stack([x, y, depth], -1)


def stereo_project(cfg: CameraConfig, p_cam: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3) [uL, vL, uR] with uR = uL − bf/z (camera.h:60-70)."""
    z = p_cam[..., 2]
    u = cfg.fx * p_cam[..., 0] / z + cfg.cx
    v = cfg.fy * p_cam[..., 1] / z + cfg.cy
    return torch.stack([u, v, u - cfg.bf / z], -1)


def disparity_to_depth(cfg: CameraConfig, disparity: torch.Tensor) -> torch.Tensor:
    """depth = bf / (uL − uR) (camera.cc:157-162), the disparity held ≥ 1e-6."""
    return cfg.bf / disparity.clamp_min(1e-6)


def back_project_stereo(cfg: CameraConfig, uvL: torch.Tensor, uR: torch.Tensor) -> torch.Tensor:
    return back_project(cfg, uvL, disparity_to_depth(cfg, uvL[..., 0] - uR))


def stereo_gate(cfg: CameraConfig, uvL: torch.Tensor, uvR: torch.Tensor) -> torch.Tensor:
    """Valid-stereo-association mask: min_x_diff < uL−uR < max_x_diff and
    |vL−vR| ≤ max_y_diff (frame.cc:157-167)."""
    dx = uvL[..., 0] - uvR[..., 0]
    dy = (uvL[..., 1] - uvR[..., 1]).abs()
    return (dx > cfg.min_x_diff) & (dx < cfg.max_x_diff) & (dy <= cfg.max_y_diff)


def _distort_radtan(x, y, D):
    k1, k2, p1, p2, k3 = (list(D) + [0.0] * 5)[:5]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def _distort_equidistant(x, y, D):
    k1, k2, k3, k4 = (list(D) + [0.0] * 4)[:4]
    r = np.sqrt(np.maximum(x * x + y * y, 1e-16))
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = theta_d / r
    return x * scale, y * scale


def build_rectify_maps(cfg: CameraConfig, side: str = "left") -> np.ndarray | None:
    """Build (H, W, 2) map of source pixel coordinates (x, y) per rectified
    pixel — equivalent of cv::initUndistortRectifyMap (camera.cc:53-64).

    For each rectified pixel: unproject through P, rotate by R⁻¹, apply the
    distortion model, project through raw K. Returns None when no raw
    calibration is configured (input already rectified).
    """
    K = getattr(cfg, f"{side}_K")
    D = getattr(cfg, f"{side}_D")
    R = getattr(cfg, f"{side}_R")
    P = getattr(cfg, f"{side}_P")
    if K is None or P is None:
        return None
    K = np.asarray(K, np.float64).reshape(3, 3)
    D = np.asarray(D if D is not None else [0.0] * 5, np.float64).ravel()
    R = np.asarray(R if R is not None else np.eye(3), np.float64).reshape(3, 3)
    P = np.asarray(P, np.float64).reshape(3, 4)

    H, W = cfg.image_height, cfg.image_width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    pts = np.stack([x, y, np.ones_like(x)], 0).reshape(3, -1)
    rays = R.T @ pts  # rotate rectified rays back into the raw camera
    xn = rays[0] / rays[2]
    yn = rays[1] / rays[2]
    if cfg.distortion_type == 0:
        xd, yd = _distort_radtan(xn, yn, D)
    else:
        xd, yd = _distort_equidistant(xn, yn, D)
    us = K[0, 0] * xd + K[0, 2]
    vs = K[1, 1] * yd + K[1, 2]
    return np.stack([us, vs], -1).reshape(H, W, 2).astype(np.float32)


def remap_bilinear(image: torch.Tensor, src_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear remap ≙ cv::remap INTER_LINEAR, batched.

    image (..., H, W) float; src_xy (..., H, W, 2) source (x, y) per output
    pixel. Sample corners clamp to [0, W-2] × [0, H-2] and the weights to
    [0, 1] — the border clamp of the JAX function, which differs from
    ``grid_sample``'s zero or reflection padding on a ≤1-px frame.
    """
    H, W = image.shape[-2:]
    x = src_xy[..., 0]
    y = src_xy[..., 1]
    x0 = torch.floor(x).clamp(0, W - 2)
    y0 = torch.floor(y).clamp(0, H - 2)
    wx = (x - x0).clamp(0.0, 1.0)
    wy = (y - y0).clamp(0.0, 1.0)
    flat = image.reshape(image.shape[:-2] + (H * W,))
    base = (y0.long() * W + x0.long()).reshape(flat.shape[:-1] + (H * W,))

    def g(off):
        return torch.gather(flat, -1, base + off).reshape(image.shape)

    v00, v01, v10, v11 = g(0), g(1), g(W), g(W + 1)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)
