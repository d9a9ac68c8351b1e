"""Time, or profile, the pose graph's first solve in a fresh process, with
the closed-form Jacobian blocks the port uses or with forward-mode AD of
the residual over its 12 tangent directions (how the port first computed
them), and print one JSON line.

    python tests/torch_pose_graph_probe.py [--jacobians closed-form|forward-ad] \
        [--profile] [--device cuda]

The graph has the size of ``chip_smoke.py``'s loop map: 58 keyframes on a
3 m circle, drifted by 1 cm / 0.01 rad (σ) per step, covisibility between
each keyframe and its next five, and one measured loop (0, 57) from the
true poses. Without ``--profile`` the first and second solve are timed
(wall clock to a device synchronization) and the torch modules imported
during the first are counted; with it, the first solve runs inside
torch.profiler, started on a warm-up op so that its own set-up is not
timed, and the operators with the most self CPU time are listed. Both
start from a device that has run one Cholesky solve, as a SLAM process
has after its first local-BA window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def forward_ad_terms(Tcw, prob):
    """Residuals and Jacobian blocks by forward-mode AD: one evaluation of
    the residual on dual tensors carrying the 12 tangent directions."""
    import torch
    from torch.autograd import forward_ad as fwAD

    from rspl_slam_tpu_torch.geometry import se3

    Ti, Tj, Z = Tcw[prob.c_i], Tcw[prob.c_j], prob.c_Z
    C = Ti.shape[0]
    basis = torch.eye(12, dtype=Tcw.dtype, device=Tcw.device)[:, None].expand(12, C, 12)
    with fwAD.dual_level():
        xi = fwAD.make_dual(torch.zeros_like(basis), basis.contiguous())
        Ti_ = se3.exp_se3(xi[..., :6]) @ Ti
        Tj_ = se3.exp_se3(xi[..., 6:]) @ Tj
        r, r_t = fwAD.unpack_dual(se3.log_se3(se3.inverse(Z) @ (Ti_ @ se3.inverse(Tj_))))
    J = r_t.permute(1, 2, 0)
    return r[0], J[..., :6], J[..., 6:]


def circle_graph(F: int = 58, seed: int = 0):
    """(drifted Twc poses, covisibility, loops) of the probe's graph."""
    from rspl_slam_tpu_torch.backend.loop_closure import LoopConstraint
    from rspl_slam_tpu_torch.evaluation.synthetic import _exp_se3

    rng = np.random.default_rng(seed)
    gt = np.zeros((F, 4, 4))
    for k in range(F):
        yaw = 2 * np.pi * k / F
        c, s = np.cos(yaw), np.sin(yaw)
        gt[k] = np.eye(4)
        gt[k, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        gt[k, :3, 3] = [3 * (1 - c), 0, 3 * s]
    est = gt.copy()
    for k in range(1, F):
        step = np.linalg.inv(gt[k - 1]) @ gt[k]
        est[k] = est[k - 1] @ step @ _exp_se3(rng.normal(0, 0.01, 6))
    covis = np.zeros((F, F))
    for a in range(F):
        covis[a, a + 1: a + 6] = 30
    loop = LoopConstraint(i=0, j=F - 1, Z=np.linalg.inv(gt[0]) @ gt[F - 1], weight=100.0,
                          n_inliers=100, similarity=1.0)
    return est, covis, [loop]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jacobians", choices=("closed-form", "forward-ad"), default="closed-form")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    from rspl_slam_tpu_torch.backend import pose_graph
    from rspl_slam_tpu_torch.geometry import linalg as glin

    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if args.jacobians == "forward-ad":
        pose_graph._constraint_terms = forward_ad_terms
    glin.solve_spd(torch.eye(60, device=dev) * 2, torch.ones(60, device=dev))
    sync()
    est, covis, loops = circle_graph()
    prob = pose_graph.relative_constraints_from_covisibility(est, covis, len(est), loops=loops,
                                                             device=dev)
    sync()
    out = {"jacobians": args.jacobians, "device": str(dev), "keyframes": len(est),
           "constraints": int(prob.c_valid.sum())}
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            (torch.ones(4, device=dev) * 2).sum().item()
            t0 = time.perf_counter()
            res = pose_graph.optimize_pose_graph(prob)
            sync()
            out["first_ms_in_profiler"] = 1e3 * (time.perf_counter() - t0)
        ka = prof.key_averages()
        out["launches"] = sum(e.count for e in ka
                              if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
        out["top_self_cpu_ms"] = [[e.key, round(e.self_cpu_time_total / 1e3, 2), e.count]
                                  for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:12]]
    else:
        before = set(sys.modules)
        t0 = time.perf_counter()
        res = pose_graph.optimize_pose_graph(prob)
        sync()
        out["first_ms"] = 1e3 * (time.perf_counter() - t0)
        out["modules_imported_by_first_solve"] = len(set(sys.modules) - before)
        t0 = time.perf_counter()
        pose_graph.optimize_pose_graph(prob)
        sync()
        out["second_ms"] = 1e3 * (time.perf_counter() - t0)
    out["cost"] = [float(res.initial_cost), float(res.cost)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
