"""K3 wrapper: all Sinkhorn iterations in one launch of ``csrc/sinkhorn.cu``
(port of ops/sinkhorn_pallas.py). The coupling matrix is built in plain
torch (ops/sinkhorn.build_problem), as the TPU wrapper builds it in XLA.
CUDA tensors launch the kernel or raise; CPU tensors take the plain
sweeps.

Two kernels, chosen by shape (:func:`sinkhorn_route`): where a cluster of
8 or 16 CTAs holds Z0 in shared memory, one thread-block cluster per batch
element, Z0 split in row bands (:func:`cluster_plan` sizes it); past that
(M1 = N1 ≥ 921, SuperGlue at ``max_keypoints`` 1024 or 2048; any B), one
cooperative launch of persistent clusters, each CTA holding a band of Z0
in shared memory for all iterations (:func:`grid_plan` sizes it; rows
past what shared memory holds stay in device memory), one barrier over the
grid per iteration. Either way one launch per call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from rspl_slam_tpu_torch.ops import cuda_build
from rspl_slam_tpu_torch.ops.sinkhorn import build_problem, sinkhorn_iterations_plain

__all__ = ["ClusterPlan", "GridPlan", "cluster_plan", "global_clusters", "grid_plan",
           "sinkhorn_route", "sinkhorn_iterations", "log_optimal_transport_masked"]

launches = 0  # calls run by the cluster kernel
global_launches = 0  # calls run by the global-memory kernel

GLOBAL_CLUSTER = 8  # CTAs per cluster of the global-memory kernel
MAX_GROUP_CLUSTERS = 16  # clusters per group, at most (merged in registers at once)

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


class GridPlan(NamedTuple):
    groups: int  # groups of clusters; group g takes batch elements g, g + groups, …
    clusters_per_group: int  # clusters of GLOBAL_CLUSTER CTAs in each group
    rows: int  # rows of the batch element per CTA (the last bands may hold fewer, or none)
    resident: int  # rows of a band held in shared memory; the rest stay in device memory
    smem: int  # dynamic shared memory per CTA, bytes


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def grid_plan(B: int, M1: int, N1: int, clusters: int) -> GridPlan:
    """The global-memory kernel's plan for B (M1, N1) problems over
    ``clusters`` co-resident clusters of :data:`GLOBAL_CLUSTER` CTAs: one
    group of clusters per batch element (min(B, clusters) groups, the
    clusters split evenly up to :data:`MAX_GROUP_CLUSTERS` each, the
    remainder idle; a group of one H100's 15 clusters of 8 CTAs spans
    120 of its 132 SMs), each CTA a band of
    ⌈M1 / CTAs per group⌉ rows, as many of them resident in shared memory
    as fit beside v, the band partials, u and log_mu (the layout of
    csrc/sinkhorn.cu: every row of N1 padded to a multiple of 4 floats).
    Raises ValueError where v and the partials alone exceed a CTA's shared
    memory (N1 past ~19,300)."""
    groups = min(B, clusters)
    cpg = min(clusters // groups, MAX_GROUP_CLUSTERS)
    rows = -(-M1 // (cpg * GLOBAL_CLUSTER))
    n1p = _pad4(N1)  # the resident rows' stride: 16-byte rows for float4 loads
    fixed = 3 * n1p + 2 * _pad4(rows)
    room = cuda_build.SMEM_LIMIT // 4 - fixed
    if room < 0:
        raise ValueError(
            f"sinkhorn global kernel: N1 = {N1} leaves no shared memory for Z0 "
            f"({cuda_build.SMEM_LIMIT} B per CTA)")
    resident = min(rows, room // n1p)
    return GridPlan(groups, cpg, rows, resident, 4 * (resident * n1p + fixed))


def global_clusters(device) -> int:
    """How many clusters of the global-memory kernel ``device`` holds at
    once (the CUDA runtime's occupancy query, once per device)."""
    idx = torch.device(device).index
    return _clusters_on(torch.cuda.current_device() if idx is None else idx)


@functools.lru_cache(maxsize=None)
def _clusters_on(idx: int) -> int:
    n = torch.zeros(1, dtype=torch.int32)
    with torch.cuda.device(idx):
        cuda_build.launch("sinkhorn", "sinkhorn_global_clusters", n)
    return int(n)


def sinkhorn_route(M1: int, N1: int) -> str:
    """The kernel for a (M1, N1) Z0: "cluster" where :func:`cluster_plan`
    finds a cluster that holds it, else "global"."""
    try:
        cluster_plan(M1, N1)
    except ValueError:
        return "global"
    return "cluster"


def sinkhorn_iterations(Z0, log_mu, log_nu, iters: int):
    """Z0 (B, M1, N1), log_mu (B, M1), log_nu (B, N1) f32 → Z0 + u + v,
    by :func:`sinkhorn_route`'s kernel."""
    if Z0.device.type == "cpu":
        return sinkhorn_iterations_plain(Z0, log_mu, log_nu, iters)
    M1, N1 = Z0.shape[1:]
    if sinkhorn_route(M1, N1) == "cluster":
        return _launch_cluster(Z0, log_mu, log_nu, iters)
    return _launch_global(Z0, log_mu, log_nu, iters)


def _check_args(Z0, log_mu, log_nu):
    cuda_build.refuse_grad("sinkhorn_iterations", Z0, log_mu, log_nu)
    B, M1, N1 = Z0.shape
    cuda_build.require_cuda(Z0, "Z0", torch.float32)
    cuda_build.require_cuda(log_mu, "log_mu", torch.float32, (B, M1))
    cuda_build.require_cuda(log_nu, "log_nu", torch.float32, (B, N1))
    return B, M1, N1


def _launch_cluster(Z0, log_mu, log_nu, iters: int):
    """The cluster kernel (the card checks run both kernels on one plan);
    raises where no cluster holds Z0."""
    global launches
    B, M1, N1 = _check_args(Z0, log_mu, log_nu)
    plan = cluster_plan(M1, N1)
    out = torch.empty_like(Z0)
    cuda_build.launch("sinkhorn", "sinkhorn_launch", Z0, log_mu, log_nu, out,
                      B, M1, N1, int(iters), *plan, cuda_build.stream_of(Z0))
    with cuda_build.count_lock:
        launches += 1
    return out


def _launch_global(Z0, log_mu, log_nu, iters: int):
    """The global-memory kernel, for any B and (M1, N1) :func:`grid_plan`
    takes."""
    global global_launches
    B, M1, N1 = _check_args(Z0, log_mu, log_nu)
    plan = grid_plan(B, M1, N1, global_clusters(Z0.device))
    out = torch.empty_like(Z0)
    gpart = torch.empty((plan.groups, 2, plan.clusters_per_group, 2, N1),
                        dtype=torch.float32, device=Z0.device)
    bar = torch.zeros(plan.groups, dtype=torch.int32, device=Z0.device)
    cuda_build.launch("sinkhorn", "sinkhorn_global_launch", Z0, log_mu, log_nu, out, gpart,
                      bar, B, M1, N1, int(iters), *plan, cuda_build.stream_of(Z0))
    with cuda_build.count_lock:
        global_launches += 1
    return out


def log_optimal_transport_masked(scores, mask0, mask1, bin_score,
                                 iters: int = 100):
    """Same contract as ops/sinkhorn.log_optimal_transport_masked, with the
    iterations in K3 on the card."""
    Z0, log_mu, log_nu, norm = build_problem(scores, mask0, mask1, bin_score)
    return sinkhorn_iterations(Z0, log_mu, log_nu, iters) - norm[:, None, None]
