"""Trajectory output (port of ``datasets.write_tum_trajectory``)."""

from __future__ import annotations

import os

import numpy as np
import torch

from rspl_slam_tpu_torch.geometry import se3

__all__ = ["write_tum_trajectory"]


def write_tum_trajectory(path: str, times, poses) -> None:
    """TUM format ``t x y z qx qy qz qw``; ``poses`` (N, 4, 4) world-from-camera."""
    poses = np.asarray(poses, np.float64)
    qs = se3.quat_from_rot(torch.from_numpy(poses[:, :3, :3])).numpy()  # wxyz
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for t, T, q in zip(times, poses, qs):
            x, y, z = T[:3, 3]
            w, qx, qy, qz = q
            f.write(f"{t:.9f} {x:.9f} {y:.9f} {z:.9f} {qx:.9f} {qy:.9f} {qz:.9f} {w:.9f}\n")
