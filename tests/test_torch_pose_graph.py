"""The port's pose graph (``backend/pose_graph.py``) against the JAX
package's: the graph built from a map, residuals and Jacobian blocks
(JAX's ``jacfwd``, the port's closed form), the LM solve, and
``run_pose_graph`` on a SLAM map with injected drift.

Tolerances: both solve in f32. Residuals agree to 1e-5 and Jacobian
blocks to 1e-4 relative (JAX's forward-mode autodiff in f32 against the
port's closed form in f64); solved poses to 1e-4 m (f32 LM on the same normal
equations, summed in f64 by the port where JAX sums in f32).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pose_graph import _drifted, _gt_circle
from test_torch_common import report

import rspl_slam_tpu.backend.pose_graph as jpg
import rspl_slam_tpu_torch.backend.pose_graph as tpg
from rspl_slam_tpu.backend.loop_closure import LoopConstraint as JLoop
from rspl_slam_tpu_torch.backend.loop_closure import LoopConstraint
from rspl_slam_tpu_torch.backend.map_store import MapStore as TMapStore


def _graph(F=12, seed=1):
    """A drifted chain on a circular arc with covisibility between every
    second keyframe and one measured loop (0, F−1) from the true poses."""
    gt = _gt_circle(F)
    est = _drifted(gt, seed=seed)
    covis = np.zeros((F, F))
    for a in range(F - 2):
        covis[a, a + 2] = 12 + a
    loop = LoopConstraint(i=0, j=F - 1, Z=np.linalg.inv(gt[0]) @ gt[F - 1], weight=50.0,
                          n_inliers=50, similarity=0.95)
    return gt, est, covis, loop


def _both(est, covis, loops):
    F = len(est)
    jp = jpg.relative_constraints_from_covisibility(est, covis, F, loops=loops)
    tp = tpg.relative_constraints_from_covisibility(est, covis, F, loops=loops, device="cpu")
    return jp, tp


def test_constraints_from_covisibility_equal_jax():
    """Pairs, measured relatives, weights (clamped at 25), odometry edges,
    the loop (superseding the same pair's estimate edge) and the padded
    power-of-two capacity: array for array as JAX builds them (f32)."""
    _, est, covis, loop = _graph()
    covis[0, 11] = 40  # the loop's own pair: the measured loop replaces it
    covis[3, 9] = 5  # under min_weight
    for loops in ([], [loop]):
        jp, tp = _both(est, covis, loops)
        for k in ("Tcw", "fixed", "c_i", "c_j", "c_Z", "c_w", "c_valid"):
            a = np.asarray(getattr(jp, k))
            b = getattr(tp, k).numpy()
            assert a.shape == b.shape, k
            np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=k)
        assert tp.plan is not None


def test_residuals_and_jacobians_equal_jax():
    """Per-constraint residuals and 6×6 blocks at ξ = 0, on a graph built
    from the estimates (every estimate edge at the identity, where
    ``log_so3`` takes its small-angle branch) and on a perturbed one (every
    residual away from zero): JAX's ``jacfwd`` blocks within 1e-4 of their
    largest entry, all finite."""
    _, est, covis, loop = _graph()
    jp, tp = _both(est, covis, [loop])
    rng = np.random.default_rng(0)
    pert = np.stack([_se3_exp(rng.normal(0, 0.05, 6)) for _ in range(len(est))])
    worst = {}
    for name, Tcw in (("consistent", np.asarray(jp.Tcw)),
                      ("perturbed", np.einsum("fij,fjk->fik", pert, np.asarray(jp.Tcw)))):
        jprob = jp._replace(Tcw=jnp.asarray(Tcw, jnp.float32))
        rj, Jij, Jjj = (np.asarray(x) for x in jax.jit(jpg._constraint_terms)(jprob.Tcw,
                                                                              jprob))
        tprob = tp._replace(Tcw=torch.tensor(Tcw, dtype=torch.float32))
        rt, Jit, Jjt = (x.numpy() for x in tpg._constraint_terms(tprob.Tcw, tprob))
        assert np.isfinite(rt).all() and np.isfinite(Jit).all() and np.isfinite(Jjt).all()
        scale = max(np.abs(Jij).max(), np.abs(Jjj).max())
        worst[name] = dict(r=float(np.abs(rt - rj).max()),
                           J_rel=float(max(np.abs(Jit - Jij).max(), np.abs(Jjt - Jjj).max())
                                       / scale))
        np.testing.assert_allclose(rt, rj, atol=1e-5)
        np.testing.assert_allclose(Jit, Jij, atol=1e-4 * scale)
        np.testing.assert_allclose(Jjt, Jjj, atol=1e-4 * scale)
        np.testing.assert_allclose(
            tpg._residuals(tprob.Tcw, tprob).numpy(), rt, atol=1e-6)
    report("pose_graph_terms", **worst)


def _se3_exp(xi):
    """numpy SE(3) exponential (a small test perturbation)."""
    from rspl_slam_tpu_torch.evaluation.synthetic import _exp_se3

    return _exp_se3(xi)


def test_optimize_pose_graph_matches_jax():
    """LM on the drifted chain with its loop: the same final cost within
    1e-3 relative, poses within 1e-4 m of JAX's, the anchor bit for bit
    untouched, the cost never above the start."""
    gt, est, covis, loop = _graph()
    jp, tp = _both(est, covis, [loop])
    jr = jpg.optimize_pose_graph(jp, iters=20)
    tr = tpg.optimize_pose_graph(tp, iters=20)
    Tj, Tt = np.asarray(jr.Tcw), tr.Tcw.numpy()
    err_gt = max(np.linalg.norm(np.linalg.inv(T)[:3, 3] - g[:3, 3]) for T, g in zip(Tt, gt))
    report("pose_graph_solve", cost=[float(tr.cost), float(jr.cost)],
           pose_max_diff=float(np.abs(Tt - Tj).max()), err_gt_m=float(err_gt))
    np.testing.assert_array_equal(Tt[0], tp.Tcw[0].numpy())
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    assert float(tr.cost) <= float(tr.initial_cost)


def test_optimize_pose_graph_isolated_pose_stays_finite():
    """A free pose without any constraint (a zero diagonal block): the
    relative damping floor keeps the system positive definite, as in the
    JAX package; nothing goes non-finite and that pose does not move."""
    gt, est, covis, loop = _graph(F=8)
    est = np.concatenate([est, est[-1:] @ _se3_exp(np.full(6, 0.1))[None]])
    tp = tpg.relative_constraints_from_covisibility(est, np.zeros((9, 9)), 9, loops=[loop],
                                                    odometry=False, device="cpu")
    tr = tpg.optimize_pose_graph(tp)
    assert np.isfinite(tr.Tcw.numpy()).all()
    np.testing.assert_allclose(tr.Tcw[8].numpy(), tp.Tcw[8].numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def oracle_map(tmp_path_factory):
    """The map of the 60-frame oracle sequence of
    ``tests/test_loop_closure.py`` (JAX package, BA off), saved."""
    from test_slam import run_sequence

    jslam, _ = run_sequence(n_frames=60, enable_ba=False)
    path = str(tmp_path_factory.mktemp("oracle") / "map.npz")
    jslam.save_map(path)
    return path, jslam.cfg, jslam.frontend.scene


def _oracle_map_pair(oracle_map):
    """A JAX system and a port system, each resumed from the oracle map."""
    from test_torch_common import to_jax_cfg

    from rspl_slam_tpu.frontend.frontends import OracleFrontend as JOracle
    from rspl_slam_tpu.slam import SLAMSystem as JSLAM
    from rspl_slam_tpu_torch.config import PipelineConfig, SuperPointConfig, SystemConfig
    from rspl_slam_tpu_torch.frontend.frontends import OracleFrontend
    from rspl_slam_tpu_torch.slam import SLAMSystem

    path, _, scene = oracle_map
    cfg = SystemConfig(superpoint=SuperPointConfig(max_keypoints=256),
                       pipeline=PipelineConfig(ba_max_points=512, ba_max_lines=16),
                       use_lines=False)
    jslam = JSLAM(to_jax_cfg(cfg), JOracle(to_jax_cfg(cfg), scene), enable_ba=False)
    tslam = SLAMSystem(cfg, OracleFrontend(cfg, scene, device="cpu"), enable_ba=False)
    for slam in (jslam, tslam):
        slam.resume_from_map(path)
    assert isinstance(tslam.map, TMapStore)
    return jslam, tslam


def test_run_pose_graph_corrects_injected_drift_as_jax(oracle_map):
    """``run_pose_graph`` on the oracle map with growing drift injected
    into the stored keyframe poses and a loop between the first and last
    keyframe measured from the true poses: the port's corrected keyframe
    poses within 1e-4 m (rotation 1e-5) of JAX's, the last keyframe's drift
    halved at least (JAX's own gate), the same cost to 1e-3."""
    from test_loop_closure import _rot

    jslam, tslam = _oracle_map_pair(oracle_map)
    n = jslam.map.n_kf
    assert n >= 5
    gt_pose = jslam.map.kf_pose[:n].copy()
    drifted = gt_pose.copy()
    for k in range(n):
        d = np.eye(4)
        d[:3, :3] = _rot([0, 1, 0], 0.004 * k)
        d[:3, 3] = [0.02 * k, 0.01 * k, -0.015 * k]
        drifted[k] = d @ gt_pose[k]
    Z = np.linalg.inv(gt_pose[0]) @ gt_pose[n - 1]
    for slam, lc in ((jslam, JLoop), (tslam, LoopConstraint)):
        slam.map.apply_pose_corrections(drifted.copy())
        slam.loop_constraints.append(lc(i=0, j=n - 1, Z=Z, weight=50.0, n_inliers=50,
                                        similarity=0.95))
    err_before = np.linalg.norm(tslam.map.kf_pose[n - 1][:3, 3] - gt_pose[n - 1][:3, 3])
    cj = jslam.run_pose_graph(min_weight=10, iters=25)
    ct = tslam.run_pose_graph(min_weight=10, iters=25)
    Pj, Pt = jslam.map.kf_pose[:n], tslam.map.kf_pose[:n]
    err_after = np.linalg.norm(Pt[n - 1][:3, 3] - gt_pose[n - 1][:3, 3])
    report("run_pose_graph", keyframes=n, cost=[ct, cj],
           pos_max_diff_m=float(np.abs(Pt[:, :3, 3] - Pj[:, :3, 3]).max()),
           drift_before_m=float(err_before), drift_after_m=float(err_after))
    np.testing.assert_allclose(ct, cj, rtol=1e-3)
    np.testing.assert_allclose(Pt[:, :3, 3], Pj[:, :3, 3], atol=1e-4)
    np.testing.assert_allclose(Pt[:, :3, :3], Pj[:, :3, :3], atol=1e-5)
    assert err_after < 0.5 * err_before
    np.testing.assert_allclose(tslam._last_Twc, Pt[n - 1])
    good = tslam.map.pt_status[: tslam.map.n_pt] == 2
    np.testing.assert_allclose(tslam.map.pt_pos[: tslam.map.n_pt][good],
                               jslam.map.pt_pos[: jslam.map.n_pt][good], atol=1e-3)
    solve = tslam.pose_graph_solves[-1]
    assert solve["cost"] == ct and solve["cost"] <= solve["initial_cost"]
    assert "pose_graph" in tslam.timings


def test_run_pose_graph_without_loops_is_skipped(oracle_map):
    """Without a measured loop both packages skip the solve (None) and
    leave the map as it was; a map under 3 keyframes is skipped too."""
    jslam, tslam = _oracle_map_pair(oracle_map)
    before = tslam.map.kf_pose.copy()
    assert jslam.run_pose_graph() is None and tslam.run_pose_graph() is None
    np.testing.assert_array_equal(tslam.map.kf_pose, before)
    small = copy.copy(tslam.map)
    small.n_kf = 2
    tslam.map = small
    tslam.loop_constraints.append(LoopConstraint(0, 1, np.eye(4), 1.0, 1, 1.0))
    assert tslam.run_pose_graph() is None
