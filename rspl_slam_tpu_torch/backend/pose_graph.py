"""Global pose-graph optimization over keyframe poses (port of
backend/pose_graph.py).

The JAX package's numeric contract: relative-pose constraints between
covisible keyframes (plus odometry and measured loop closures) as flat
arrays padded to a power-of-two capacity; the residual
r = log(Z⁻¹ · exp(ξi)Tcw_i · (exp(ξj)Tcw_j)⁻¹) ∈ ℝ⁶ in f32; its 6×6
Jacobian blocks at ξ = 0; a dense 6F×6F Levenberg-Marquardt solve with
λ0 = 1e-4, ×0.5 on accept and ×4 on reject, the relative damping floor,
fixed poses masked out of the update, and accept/reject on the true cost.

Where the design differs from the JAX package: JAX takes the Jacobian
blocks by ``jax.jacfwd`` under ``jax.vmap``; the port evaluates their
closed form, Ji = Jr⁻¹(r)·Ad(Tcw_j·Tcw_i⁻¹) and Jj = −Jr⁻¹(r) (Jr⁻¹ of
SE(3) through Barfoot's Q, in f64, rounded once), a few dozen batched
ops that import nothing (torch's forward-mode AD runs Python
decompositions, whose first use imports hundreds of modules:
``tests/torch_pose_graph_probe.py``). The normal equations are not
assembled with one-hot contractions. Each H block and each gradient
row is a fixed-order segment sum (``local_ba._segment_sum``: the rows of
each segment gathered, summed in f64, rounded once), laid out on the host
once per problem (:class:`PoseGraphPlan`, built where the constraints are
built), and the blocks land in H by an index copy over distinct indices.
So a solve repeats bit for bit on the card as on the CPU; no atomics. The
LM loop makes no host synchronization: accept and reject are
``torch.where``, and ``linalg.solve_spd`` gives NaN where the Cholesky
factorization fails, which no accept test passes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rspl_slam_tpu_torch.backend.local_ba import _rows_by_segment, _segment_sum
from rspl_slam_tpu_torch.geometry import linalg as glin
from rspl_slam_tpu_torch.geometry import se3

__all__ = ["PoseGraphProblem", "PoseGraphResult", "PoseGraphPlan", "pose_graph_plan",
           "relative_constraints_from_covisibility", "optimize_pose_graph"]


class PoseGraphPlan(NamedTuple):
    """The segment sums of a problem's normal equations, fixed per problem.
    The block terms are stacked as [Hii; Hjj; Hij; Hijᵀ] (4C rows), the
    gradient terms as [Jiᵀwr; Jjᵀwr] (2C rows)."""

    blocks: torch.Tensor  # (U,) flat f·F + g index of each H block with terms, ascending
    h_rows: torch.Tensor  # (U, M) the block-term rows of each, padded with 4C
    g_rows: torch.Tensor  # (F, M) the gradient-term rows of each pose, padded with 2C


class PoseGraphProblem(NamedTuple):
    Tcw: torch.Tensor  # (F, 4, 4) camera-from-world poses
    fixed: torch.Tensor  # (F,) bool: anchors excluded from the update
    c_i: torch.Tensor  # (C,) int64 constraint endpoint i
    c_j: torch.Tensor  # (C,) int64 constraint endpoint j
    c_Z: torch.Tensor  # (C, 4, 4) measured relative pose Tcw_i·Twc_j
    c_w: torch.Tensor  # (C,) constraint weight
    c_valid: torch.Tensor  # (C,) bool
    plan: PoseGraphPlan  # built with the constraints (pose_graph_plan)


class PoseGraphResult(NamedTuple):
    Tcw: torch.Tensor
    cost: torch.Tensor
    iters: int
    initial_cost: torch.Tensor  # the cost at the incoming poses


def pose_graph_plan(c_i, c_j, c_valid, F: int, device) -> PoseGraphPlan:
    """The :class:`PoseGraphPlan` of host constraint arrays, on ``device``."""
    ci, cj = np.asarray(c_i, np.int64), np.asarray(c_j, np.int64)
    valid = np.asarray(c_valid, bool)
    seg = np.concatenate([ci * F + ci, cj * F + cj, ci * F + cj, cj * F + ci])
    keep = np.tile(valid, 4)
    blocks = np.unique(seg[keep])
    rank = np.where(keep, np.searchsorted(blocks, seg), 0)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return PoseGraphPlan(blocks=t(blocks), h_rows=t(_rows_by_segment(rank, keep, len(blocks))),
                         g_rows=t(_rows_by_segment(np.concatenate([ci, cj]),
                                                   np.tile(valid, 2), F)))


def relative_constraints_from_covisibility(
    kf_pose: np.ndarray, covis: np.ndarray, n_kf: int,
    min_weight: int = 10, capacity: int | None = None,
    odometry: bool = True, loops=None, max_weight: float = 25.0,
    device="cuda",
) -> PoseGraphProblem:
    """The pose graph of a map, built on the host as the JAX package builds
    it and placed on ``device`` (f32): one constraint per covisible pair
    with weight ≥ ``min_weight`` (clamped to ``max_weight``), odometry
    constraints between consecutive keyframes, and the measured ``loops``
    (objects with ``i, j, Z, weight``; Z = Tcw_i·Twc_j), which supersede
    the estimate-derived edge on the same pair. ``kf_pose`` is Twc. The
    capacity is the next power of two (≥ 16) of the constraint count."""
    loop_pairs = {(min(lc.i, lc.j), max(lc.i, lc.j)) for lc in (loops or [])}
    pairs = []
    weights = []
    for a in range(n_kf):
        for b in range(a + 1, n_kf):
            w = covis[a, b]
            if w >= min_weight and (a, b) not in loop_pairs:
                pairs.append((a, b))
                weights.append(min(float(w), max_weight))
    if odometry:
        have = set(pairs)
        for a in range(n_kf - 1):
            if (a, a + 1) not in have:
                pairs.append((a, a + 1))
                weights.append(float(min_weight))
    C = len(pairs)
    n_loops = len(loops) if loops else 0
    cap = capacity or max(16, 1 << int(C + n_loops - 1).bit_length())
    c_i = np.zeros(cap, np.int64)
    c_j = np.zeros(cap, np.int64)
    c_Z = np.tile(np.eye(4), (cap, 1, 1))
    c_w = np.zeros(cap)
    c_valid = np.zeros(cap, bool)
    for k, ((a, b), w) in enumerate(zip(pairs[:cap], weights[:cap])):
        c_i[k] = a
        c_j[k] = b
        c_Z[k] = np.linalg.inv(kf_pose[a]) @ kf_pose[b]  # Tcw_i · Twc_j
        c_w[k] = w
        c_valid[k] = True
    if loops:
        for k, lc in enumerate(loops[: max(0, cap - C)]):
            c_i[C + k] = lc.i
            c_j[C + k] = lc.j
            c_Z[C + k] = lc.Z  # measured, not from the estimates
            c_w[C + k] = lc.weight
            c_valid[C + k] = True
    Tcw = np.stack([np.linalg.inv(kf_pose[f]) for f in range(n_kf)])
    device = torch.device(device)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    b = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return PoseGraphProblem(
        Tcw=f(Tcw), fixed=b(np.arange(n_kf) == 0), c_i=b(c_i), c_j=b(c_j), c_Z=f(c_Z),
        c_w=f(c_w), c_valid=b(c_valid), plan=pose_graph_plan(c_i, c_j, c_valid, n_kf, device))


def _residuals(Tcw, prob: PoseGraphProblem):
    """r at ξ = 0 for every constraint, batched (exp(0) is the identity)."""
    Ti, Tj = Tcw[prob.c_i], Tcw[prob.c_j]
    return se3.log_se3(se3.inverse(prob.c_Z) @ (Ti @ se3.inverse(Tj)))


def _jr_inv(r):
    """The inverse right Jacobian of SE(3) at r = [ω, v] (..., 6) →
    (..., 6, 6): Jl(−r)⁻¹ = [[Jl⁻¹, 0], [−Jl⁻¹·Q·Jl⁻¹, Jl⁻¹]] with Jl of
    SO(3) at −ω and Barfoot's Q(−v, −ω), its coefficients by their Taylor
    series below θ = 0.01."""
    w, v = -r[..., :3], -r[..., 3:]
    th2 = (w * w).sum(-1)
    small = th2 < 1e-4
    th = torch.sqrt(torch.where(small, 1.0, th2))
    s, c = torch.sin(th), torch.cos(th)
    c1 = torch.where(small, 1 / 6 - th2 / 120, (th - s) / th ** 3)
    c2 = torch.where(small, 1 / 24 - th2 / 720, (th2 + 2 * c - 2) / (2 * th ** 4))
    c3 = torch.where(small, 1 / 120 - th2 / 2520, (2 * th - 3 * s + th * c) / (2 * th ** 5))
    W, P = se3.hat(w), se3.hat(v)
    WP, PW = W @ P, P @ W
    WPW = WP @ W
    Q = (0.5 * P + c1[..., None, None] * (WP + PW + WPW)
         + c2[..., None, None] * (W @ WP + PW @ W - 3 * WPW)
         + c3[..., None, None] * (WPW @ W + W @ WPW))
    A = glin.inv3(se3._V(w))
    return torch.cat([torch.cat([A, torch.zeros_like(A)], -1),
                      torch.cat([-(A @ Q @ A), A], -1)], -2)


def _adjoint(T):
    """Ad(T) of (..., 4, 4) poses in the [ω, v] order: [[R, 0], [t^·R, R]]."""
    R = T[..., :3, :3]
    return torch.cat([torch.cat([R, torch.zeros_like(R)], -1),
                      torch.cat([se3.hat(T[..., :3, 3]) @ R, R], -1)], -2)


def _constraint_terms(Tcw, prob: PoseGraphProblem):
    """Per-constraint residuals r (C, 6) and Jacobian blocks Ji, Jj
    (C, 6, 6) at ξ = 0. With A = Tcw_i·Tcw_j⁻¹, exp(ξi)·A·exp(−ξj) =
    A·exp(Ad(A⁻¹)ξi)·exp(−ξj), so to first order r moves by
    Jr⁻¹(r)·(Ad(A⁻¹)ξi − ξj). The blocks are formed in f64 and rounded
    once to the poses' dtype."""
    r = _residuals(Tcw, prob)
    f64 = torch.float64
    D = _jr_inv(r.to(f64))
    Ti, Tj = Tcw[prob.c_i].to(f64), Tcw[prob.c_j].to(f64)
    Ji = D @ _adjoint(Tj @ se3.inverse(Ti))
    return r, Ji.to(Tcw.dtype), (-D).to(Tcw.dtype)


@torch.no_grad()
def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20,
                        lam0: float = 1e-4) -> PoseGraphResult:
    """LM on the pose graph, on the device of ``prob``'s tensors, queued
    without a host synchronization. Fixed poses are masked out of the
    update."""
    plan = prob.plan
    F = prob.Tcw.shape[0]
    dtype, dev = prob.Tcw.dtype, prob.Tcw.device
    w = torch.where(prob.c_valid, prob.c_w.to(dtype), 0.0)
    mfree = (~prob.fixed).to(dtype)
    free6 = mfree.repeat_interleave(6) > 0
    m2 = mfree[:, None, None, None] * mfree[None, None, :, None]

    def cost_fn(Tcw):
        r = _residuals(Tcw, prob)
        return (w * (r * r).sum(-1)).sum()

    def build(Tcw):
        r, Ji, Jj = _constraint_terms(Tcw, prob)
        wr = w[:, None] * r
        g = _segment_sum(plan.g_rows, torch.cat([
            torch.einsum("cab,ca->cb", Ji, wr), torch.einsum("cab,ca->cb", Jj, wr)]))
        wJi, wJj = w[:, None, None] * Ji, w[:, None, None] * Jj
        Hij = Ji.mT @ wJj
        blocks = _segment_sum(plan.h_rows, torch.cat([Ji.mT @ wJi, Jj.mT @ wJj, Hij,
                                                      Hij.mT]))
        H = torch.zeros((F * F, 6, 6), dtype=dtype, device=dev).index_copy(0, plan.blocks,
                                                                           blocks)
        return H.view(F, F, 6, 6).permute(0, 2, 1, 3), g

    Tcw = prob.Tcw
    lam = torch.full((), lam0, dtype=dtype, device=dev)
    cost = cost0 = cost_fn(Tcw)
    for _ in range(iters):
        H, g = build(Tcw)
        Hd = (H * m2).reshape(6 * F, 6 * F)
        diag = torch.diagonal(Hd)
        # relative damping floor: an isolated free pose keeps a PD block
        floor = 1e-6 * diag.max().clamp_min(1e-12) + 1e-12
        A = Hd + torch.diag(torch.where(free6, lam * diag + floor, 1.0))
        b = (g * mfree[:, None]).reshape(6 * F)
        dx = -glin.solve_spd(A, b).reshape(F, 6) * mfree[:, None]
        Tnew = se3.exp_se3(dx) @ Tcw
        new_cost = cost_fn(Tnew)
        accept = new_cost < cost
        Tcw = torch.where(accept, Tnew, Tcw)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    return PoseGraphResult(Tcw=Tcw, cost=cost, iters=iters, initial_cost=cost0)
