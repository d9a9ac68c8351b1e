"""K3 wrapper: all Sinkhorn iterations in one launch of ``csrc/sinkhorn.cu``
(port of ops/sinkhorn_pallas.py). The coupling matrix is built in plain
torch (ops/sinkhorn.build_problem), as the TPU wrapper builds it in XLA.
CUDA tensors launch the kernel or raise; CPU tensors take the plain
sweeps."""

from __future__ import annotations

import torch

from rspl_slam_tpu_torch.ops import cuda_build
from rspl_slam_tpu_torch.ops.sinkhorn import build_problem, sinkhorn_iterations_plain

__all__ = ["sinkhorn_iterations", "log_optimal_transport_masked"]

launches = 0


def sinkhorn_iterations(Z0, log_mu, log_nu, iters: int):
    """Z0 (B, M1, N1), log_mu (B, M1), log_nu (B, N1) f32 → Z0 + u + v."""
    global launches
    if Z0.device.type == "cpu":
        return sinkhorn_iterations_plain(Z0, log_mu, log_nu, iters)
    B, M1, N1 = Z0.shape
    cuda_build.require_cuda(Z0, "Z0", torch.float32)
    cuda_build.require_cuda(log_mu, "log_mu", torch.float32, (B, M1))
    cuda_build.require_cuda(log_nu, "log_nu", torch.float32, (B, N1))
    out = torch.empty_like(Z0)
    cuda_build.launch("sinkhorn", "sinkhorn_launch", Z0, log_mu, log_nu, out,
                      B, M1, N1, int(iters), cuda_build.stream_of(Z0))
    launches += 1
    return out


def log_optimal_transport_masked(scores, mask0, mask1, bin_score,
                                 iters: int = 100):
    """Same contract as ops/sinkhorn.log_optimal_transport_masked, with the
    iterations in K3 on the card."""
    Z0, log_mu, log_nu, norm = build_problem(scores, mask0, mask1, bin_score)
    return sinkhorn_iterations(Z0, log_mu, log_nu, iters) - norm[:, None, None]
