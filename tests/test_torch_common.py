"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs on the CPU as its own tests run it (Pallas kernels in
interpret mode). Torch is capped to one thread because the tier-1 suite
runs several xdist workers.
"""

from __future__ import annotations

import dataclasses
import json

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


def rendered_sequence(cfg, n, seed=1, step=0.05, num_lines=0):
    """``n`` rendered stereo pairs of a blob scene (with ``num_lines`` dark
    segments) along a forward trajectory, with the ground-truth world
    poses."""
    from rspl_slam_tpu_torch.evaluation import synthetic

    scene = synthetic.make_scene(num_points=600, num_lines=num_lines, seed=seed,
                                 extent=(6.0, 4.0, 6.0), on_line_frac=0.0)
    traj = synthetic.make_trajectory(n, step=step)
    frames = [synthetic.render_images(scene, cfg.camera, traj[i], seed=i)
              for i in range(n)]
    return frames, traj


def segment_set_distance(a, b):
    """For each segment [x1, y1, x2, y2] of ``a``, the max endpoint distance
    to its nearest segment of ``b``, endpoints in either order (inf when
    ``b`` is empty)."""
    if len(b) == 0:
        return np.full(len(a), np.inf)
    same = np.abs(a[:, None] - b[None]).max(-1)
    flip = np.abs(a[:, None] - b[None][..., [2, 3, 0, 1]]).max(-1)
    return np.minimum(same, flip).min(1)


def edge_weights():
    """The hand-set RCF edge weights at width 0.125: the full-width
    weights' logits (stage 1 keeps its 8 difference channels) at a CPU
    test's cost."""
    from rspl_slam_tpu_torch.models import rcf

    return rcf.edge_detector_params(width_mult=0.125)


def report(test: str, **measured):
    """Print what a parity test measured as one JSON line; ``pytest -s``
    shows them (PERF.md records the worst deviations)."""
    print(json.dumps({"measured": test, **measured}))


def matcher_weights(cfg):
    """(SuperPoint, SuperGlue) numpy weights shared by both packages: a
    seeded random SuperPoint and the descriptor-matcher SuperGlue."""
    from rspl_slam_tpu_torch.models import superglue, superpoint

    return (superpoint.init_params(0),
            superglue.descriptor_matcher_params(cfg.superglue, 0, 2000.0, 1980.0))


def frontend_pair(cfg, rcf_params=None):
    """(JAX, port) eager frontends on the same config and weights, both f32,
    the port's on the CPU."""
    import jax.numpy as jnp

    from rspl_slam_tpu.frontend.frontends import NeuralFrontend as JFE
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend as TFE

    sp, sg = matcher_weights(cfg)
    jfe = JFE(to_jax_cfg(cfg), sp_params=sp, sg_params=sg, rcf_params=rcf_params,
              compute_dtype=jnp.float32)
    tfe = TFE(cfg, sp_params=sp, sg_params=sg, rcf_params=rcf_params,
              compute_dtype=torch.float32, device="cpu")
    return jfe, tfe


def lines_cfg(at_detection_scale=True, **keyframe):
    """``small_system_cfg`` with lines on, RCF at detection scale or not,
    and keyframe policy overrides."""
    cfg = small_system_cfg()
    return dataclasses.replace(
        cfg, use_lines=True,
        line_detector=dataclasses.replace(cfg.line_detector,
                                          rcf_at_detection_scale=at_detection_scale),
        keyframe=dataclasses.replace(cfg.keyframe, **keyframe))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips where torch sees none (decided at run
    time, never at import, so every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")
