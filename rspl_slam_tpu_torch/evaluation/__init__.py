from rspl_slam_tpu_torch.evaluation.ate import absolute_trajectory_error, align_umeyama  # noqa: F401
