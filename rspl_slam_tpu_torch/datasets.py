"""Dataset readers and trajectory IO (port of datasets.py).

The EuRoC-layout stereo reader and the TUM trajectory reader and writer.
Images decode through the port's own PNG/PGM reader (``png.py``), not PIL:
gray float32 in [0, 1], as the JAX package's reader returns them. With
``compiled=True`` (the CLI sets it when the run's device is the card) the
PNG row unfilter runs in the host C++ loop of ``csrc/png_unfilter.cu``;
otherwise in numpy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from rspl_slam_tpu_torch import png
from rspl_slam_tpu_torch.geometry import se3

__all__ = ["StereoFrame", "EurocDataset", "open_dataset", "write_tum_trajectory",
           "read_tum_trajectory"]


@dataclass
class StereoFrame:
    index: int
    time: float
    image_left: np.ndarray  # (H, W) float32 in [0, 1] or uint8
    image_right: np.ndarray


def _load_gray(path: str, compiled: bool = False) -> np.ndarray:
    return png.read_gray(path, compiled).astype(np.float32) / 255.0


# candidate (left, right) camera sub-directory pairs, tried in order:
# EuRoC/OIVIO converted layout, plain left/right (UMA conversions), KITTI
_CAM_DIR_PAIRS = [
    (os.path.join("cam0", "data"), os.path.join("cam1", "data")),
    ("left", "right"),
    ("image_0", "image_1"),
]


class EurocDataset:
    """Stereo sequence reader over the layouts of the JAX package's reader:

    - converted EuRoC/OIVIO/UMA: ``<root>/cam0/data/*.png`` +
      ``<root>/cam1/data/*.png``;
    - raw EuRoC: the same nested one level under ``<root>/mav0/``, with
      ``cam0/data.csv`` (``timestamp_ns,filename``) supplying timestamps;
    - plain ``left/``+``right/`` or KITTI ``image_0/``+``image_1/`` dirs.

    Timestamps: data.csv when present, else nanoseconds parsed from a
    filename stem of ≥ 13 digits, else the frame index at 20 Hz."""

    def __init__(self, dataroot: str, compiled: bool = False):
        if not os.path.isdir(os.path.join(dataroot, "cam0")) and os.path.isdir(
                os.path.join(dataroot, "mav0", "cam0")):
            dataroot = os.path.join(dataroot, "mav0")  # raw EuRoC nesting
        self.dataroot = dataroot
        self.compiled = compiled
        for left_sub, right_sub in _CAM_DIR_PAIRS:
            ld = os.path.join(dataroot, left_sub)
            rd = os.path.join(dataroot, right_sub)
            if os.path.isdir(ld) and os.path.isdir(rd):
                self.left_dir, self.right_dir = ld, rd
                break
        else:
            raise FileNotFoundError(
                f"no stereo image dirs under {dataroot} (tried {_CAM_DIR_PAIRS})")
        rights = set(os.listdir(self.right_dir))
        self.names = [n for n in sorted(os.listdir(self.left_dir)) if n in rights]
        self._csv_times = self._load_csv_times()

    def _load_csv_times(self):
        """EuRoC-raw ``cam0/data.csv``: ``timestamp_ns,filename`` rows."""
        csv = os.path.join(os.path.dirname(self.left_dir), "data.csv")
        if not os.path.exists(csv):
            return None
        times = {}
        with open(csv) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(",")
                if len(parts) >= 2:
                    times[parts[1].strip()] = float(parts[0]) * 1e-9
        return times or None

    def __len__(self) -> int:
        return len(self.names)

    def timestamp(self, idx: int) -> float:
        name = self.names[idx]
        if self._csv_times is not None and name in self._csv_times:
            return self._csv_times[name]
        stem = os.path.splitext(name)[0]
        if stem.isdigit() and len(stem) >= 13:
            return float(stem) * 1e-9
        return idx / 20.0

    def __getitem__(self, idx: int) -> StereoFrame:
        name = self.names[idx]
        return StereoFrame(
            index=idx, time=self.timestamp(idx),
            image_left=_load_gray(os.path.join(self.left_dir, name), self.compiled),
            image_right=_load_gray(os.path.join(self.right_dir, name), self.compiled))

    def file_lists(self):
        """(left_paths, right_paths)."""
        return ([os.path.join(self.left_dir, n) for n in self.names],
                [os.path.join(self.right_dir, n) for n in self.names])


def open_dataset(dataroot: str, compiled: bool = False) -> EurocDataset:
    """Open a stereo sequence directory in any supported layout."""
    return EurocDataset(dataroot, compiled)


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


def read_tum_trajectory(path: str):
    """Returns (times (N,), poses (N, 4, 4) float64)."""
    rows = np.loadtxt(path).reshape(-1, 8)
    q_wxyz = np.concatenate([rows[:, 7:8], rows[:, 4:7]], 1)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :3] = se3.rot_from_quat(torch.from_numpy(q_wxyz)).numpy()
    poses[:, :3, 3] = rows[:, 1:4]
    return rows[:, 0], poses
