"""rspl_slam_tpu_torch — the PyTorch/CUDA port of rspl_slam_tpu.

The stereo point SLAM main path (SuperPoint + SuperGlue frontend, fused
PnP-RANSAC + pose-only LM tracking, keyframe insertion with multi-view
triangulation) written in PyTorch, with the three kernels the JAX package
wrote in Pallas for the TPU rewritten by hand in CUDA C++ for Hopper
(``csrc/``): the fused 3×3 conv stem, the SuperGlue GNN layer and the
log-domain Sinkhorn.

The package imports neither ``jax`` nor anything of ``rspl_slam_tpu``; the
numpy-only modules it needs from there are copied. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from rspl_slam_tpu_torch.config import (  # noqa: F401
    CameraConfig,
    KeyframeConfig,
    LineDetectorConfig,
    OptimizationConfig,
    PipelineConfig,
    SuperGlueConfig,
    SuperPointConfig,
    SystemConfig,
    load_system_config,
)
from rspl_slam_tpu_torch.evaluation.ate import (  # noqa: F401
    absolute_trajectory_error,
    align_umeyama,
)
