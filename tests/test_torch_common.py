"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs on the CPU as its own tests run it (Pallas kernels in
interpret mode). Torch is capped to one thread because the tier-1 suite
runs several xdist workers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def np_tree(tree):
    """Pytree (dicts/lists of arrays) → the same structure of writable
    numpy arrays."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return np.array(tree)


def to_jax_cfg(obj):
    """A port config dataclass → the equal JAX-package config dataclass."""
    from rspl_slam_tpu import config as jcfg

    if dataclasses.is_dataclass(obj):
        cls = getattr(jcfg, type(obj).__name__)
        return cls(**{f.name: to_jax_cfg(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


def small_system_cfg(width=320, height=240, layers=2, max_keypoints=400):
    """Port SystemConfig at a small size: EuRoC intrinsics scaled to the
    image, lines off, ``layers`` GNN layers."""
    from rspl_slam_tpu_torch import config as tcfg

    s = width / 752.0
    cam = tcfg.CameraConfig(image_width=width, image_height=height,
                            fx=435.2046959714599 * s, fy=435.2046959714599 * s,
                            cx=367.4517211914062 * s, cy=252.2008514404297 * s,
                            bf=47.90639384423901 * s)
    cfg = tcfg.SystemConfig(camera=cam, use_lines=False)
    return dataclasses.replace(
        cfg,
        superpoint=dataclasses.replace(cfg.superpoint, max_keypoints=max_keypoints),
        superglue=dataclasses.replace(cfg.superglue, image_width=width,
                                      image_height=height, num_gnn_layers=layers))


def rendered_sequence(cfg, n, seed=1, step=0.05):
    """``n`` rendered stereo pairs of a blob scene along a forward
    trajectory, with the ground-truth world poses."""
    from rspl_slam_tpu_torch.evaluation import synthetic

    scene = synthetic.make_scene(num_points=600, num_lines=0, seed=seed,
                                 extent=(6.0, 4.0, 6.0), on_line_frac=0.0)
    traj = synthetic.make_trajectory(n, step=step)
    frames = [synthetic.render_images(scene, cfg.camera, traj[i], seed=i)
              for i in range(n)]
    return frames, traj


def matcher_weights(cfg):
    """(SuperPoint, SuperGlue) numpy weights shared by both packages: a
    seeded random SuperPoint and the descriptor-matcher SuperGlue."""
    from rspl_slam_tpu_torch.models import superglue, superpoint

    return (superpoint.init_params(0),
            superglue.descriptor_matcher_params(cfg.superglue, 0, 2000.0, 1980.0))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips where torch sees none (decided at run
    time, never at import, so every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")
