"""Scaling past one sequence and one process: the mesh, multi-process
setup over ``torch.distributed``, batched and landmark-sharded BA, and
multi-sequence mapping (port of ``rspl_slam_tpu/parallel``)."""
