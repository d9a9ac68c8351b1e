"""K3 wrapper: all Sinkhorn iterations in one launch of ``csrc/sinkhorn.cu``
(port of ops/sinkhorn_pallas.py). The coupling matrix is built in plain
torch (ops/sinkhorn.build_problem), as the TPU wrapper builds it in XLA.
CUDA tensors launch the kernel or raise; CPU tensors take the plain
sweeps.

The kernel runs one thread-block cluster per batch element, Z0 split in
row bands over the cluster's shared memory; :func:`cluster_plan` sizes it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rspl_slam_tpu_torch.ops import cuda_build
from rspl_slam_tpu_torch.ops.sinkhorn import build_problem, sinkhorn_iterations_plain

__all__ = ["ClusterPlan", "cluster_plan", "sinkhorn_iterations",
           "log_optimal_transport_masked"]

launches = 0

PORTABLE_CLUSTER = 8  # the largest cluster every Hopper launch may take
MAX_CLUSTER = 16  # with cudaFuncAttributeNonPortableClusterSizeAllowed


class ClusterPlan(NamedTuple):
    cluster: int  # CTAs per batch element
    rows: int  # rows of Z0 per CTA (the last bands may hold fewer, or none)
    smem: int  # dynamic shared memory per CTA, bytes


def cluster_plan(M1: int, N1: int) -> ClusterPlan:
    """The cluster that holds a (M1, N1) Z0 in shared memory: the portable
    size 8 where its bands fit, else 16; per CTA a band of ⌈M1/C⌉ rows plus
    v, u, log_mu and two parities of column partials (the layout of
    csrc/sinkhorn.cu). Raises ValueError where no cluster holds it."""
    for c in (PORTABLE_CLUSTER, MAX_CLUSTER):
        rows = -(-M1 // c)
        floats = rows * N1 + N1 + 2 * rows + 4 * N1
        if 4 * floats <= cuda_build.SMEM_LIMIT:
            return ClusterPlan(c, rows, 4 * floats)
    raise ValueError(
        f"sinkhorn kernel: Z0 of {M1}×{N1} does not fit a cluster of "
        f"{MAX_CLUSTER} CTAs with {cuda_build.SMEM_LIMIT} B of shared memory each")


def sinkhorn_iterations(Z0, log_mu, log_nu, iters: int):
    """Z0 (B, M1, N1), log_mu (B, M1), log_nu (B, N1) f32 → Z0 + u + v."""
    global launches
    if Z0.device.type == "cpu":
        return sinkhorn_iterations_plain(Z0, log_mu, log_nu, iters)
    B, M1, N1 = Z0.shape
    plan = cluster_plan(M1, N1)
    cuda_build.require_cuda(Z0, "Z0", torch.float32)
    cuda_build.require_cuda(log_mu, "log_mu", torch.float32, (B, M1))
    cuda_build.require_cuda(log_nu, "log_nu", torch.float32, (B, N1))
    out = torch.empty_like(Z0)
    cuda_build.launch("sinkhorn", "sinkhorn_launch", Z0, log_mu, log_nu, out,
                      B, M1, N1, int(iters), *plan, cuda_build.stream_of(Z0))
    with cuda_build.count_lock:
        launches += 1
    return out


def log_optimal_transport_masked(scores, mask0, mask1, bin_score,
                                 iters: int = 100):
    """Same contract as ops/sinkhorn.log_optimal_transport_masked, with the
    iterations in K3 on the card."""
    Z0, log_mu, log_nu, norm = build_problem(scores, mask0, mask1, bin_score)
    return sinkhorn_iterations(Z0, log_mu, log_nu, iters) - norm[:, None, None]
