"""The port's local BA against the JAX package on the CPU: the Cholesky
solve's failure mode, the new linear algebra, residuals and triangulation,
the line Jacobians, one Schur step, the full 10 → gate → 5 schedule on the
JAX package's own test windows and on its captured divergence window, and
the SLAM slice with BA on (sync and async)."""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_local_ba as jba
import torch
from test_torch_common import (edge_weights, frontend_pair, lines_cfg, rendered_sequence,
                               report, to_jax_cfg)

from rspl_slam_tpu.backend import local_ba as jlb
from rspl_slam_tpu.backend import residuals as jres
from rspl_slam_tpu.geometry import linalg as jlin
from rspl_slam_tpu.geometry import plucker as jplk
from rspl_slam_tpu.geometry import triangulation as jtri
from rspl_slam_tpu.slam import SLAMSystem as JSLAM
from rspl_slam_tpu_torch.backend import local_ba as tlb
from rspl_slam_tpu_torch.backend import residuals as tres
from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
from rspl_slam_tpu_torch.config import SystemConfig
from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error
from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend as TFE
from rspl_slam_tpu_torch.geometry import linalg as tlin
from rspl_slam_tpu_torch.geometry import triangulation as ttri
from rspl_slam_tpu_torch.slam import INIT_POSE, SLAMSystem

K = CameraIntrinsics(*jba.K)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ba_divergence_case.npz")
DELTAS = tuple(float(np.sqrt(np.float32(c))) for c in (50.0, 75.0, 50.0, 75.0))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np_problem(prob):
    return jlb.BAProblem(*[np.asarray(a) for a in prob])


def _random_lines(rng, n):
    """Plücker lines through points 3-9 m in front of the camera."""
    p = rng.uniform([-2, -1.5, 3], [2, 1.5, 9], (n, 3))
    q = p + rng.standard_normal((n, 3))
    return np.concatenate([np.cross(p, q), q - p], -1).astype(np.float32)


def _random_poses(rng, n):
    xi = np.concatenate([rng.normal(0, 0.05, (n, 3)), rng.normal(0, 0.2, (n, 3))], -1)
    from rspl_slam_tpu_torch.geometry import se3

    return se3.exp_se3(torch.from_numpy(xi.astype(np.float32))).numpy()


def test_solve_spd_is_nan_where_jax_is_nan():
    """A batch of SPD and indefinite systems: the port's solve is NaN on
    exactly the systems where JAX's NaN-filled Cholesky makes it NaN (the
    indefinite ones), and agrees elsewhere to rel 1e-5 (f32)."""
    rng = np.random.default_rng(0)
    M = rng.standard_normal((6, 5, 5))
    A = (M @ M.transpose(0, 2, 1) + 0.5 * np.eye(5)).astype(np.float32)
    A[1] = np.diag([1.0, -2.0, 3.0, 4.0, 5.0])
    A[4, :3, :3] = [[1, 2, 0], [2, 1, 0], [0, 0, 1]]  # ROADMAP.md §3's solve_spd input
    A[4, 3:, :] = 0
    A[4, :, 3:] = 0
    A[4, 3, 3] = A[4, 4, 4] = 1
    b = rng.standard_normal((6, 5)).astype(np.float32)
    got = tlin.solve_spd(_t(A), _t(b)).numpy()
    ref = np.asarray(jlin.solve_spd(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref[[1, 4]]).all() and np.isfinite(ref[[0, 2, 3, 5]]).all()
    ok = [0, 2, 3, 5]
    assert _rel(got[ok], ref[ok]) < 1e-5
    # the matrix form of b too
    got_m = tlin.solve_spd(_t(A), _t(b[..., None])).numpy()
    assert np.isnan(got_m[[1, 4]]).all() and np.isfinite(got_m[ok]).all()


def test_inv4_spd_matches_jax():
    """Block inverses of SPD 4×4s (rel 1e-5, f32)."""
    rng = np.random.default_rng(1)
    M = rng.standard_normal((64, 4, 4))
    A = (M @ M.transpose(0, 2, 1) + 0.1 * np.eye(4)).astype(np.float32)
    got = tlin.inv4_spd(_t(A)).numpy()
    ref = np.asarray(jlin.inv4_spd(jnp.asarray(A)))
    assert _rel(got, ref) < 1e-5
    np.testing.assert_allclose(got @ A, np.broadcast_to(np.eye(4), A.shape), atol=1e-3)


def test_point_landmark_jacobian_matches_jax():
    """∂r/∂Xw over a pose and 100 points, mono and stereo rows (rel 1e-6)."""
    rng = np.random.default_rng(2)
    T = _random_poses(rng, 1)[0]
    X = rng.uniform([-3, -2, 3], [3, 2, 9], (100, 3)).astype(np.float32)
    st = rng.uniform(size=100) < 0.5
    got = tres.point_landmark_jacobian(K, _t(T), _t(X), _t(st)).numpy()
    ref = np.asarray(jres.point_landmark_jacobian(jba.K, jnp.asarray(T), jnp.asarray(X),
                                                  jnp.asarray(st)))
    assert _rel(got, ref) < 1e-6
    assert (got[~st, 2] == 0).all()


def test_line_residual_matches_jax():
    """Left and right endpoint distances of 200 lines in 8 poses, mono rows
    zeroed (abs ≤ 1e-4 · max |r|: f32, another association order)."""
    rng = np.random.default_rng(3)
    T = _random_poses(rng, 8)
    L = _random_lines(rng, 200).reshape(8, 25, 6)
    eps = rng.uniform(0, 700, (8, 25, 2, 2)).astype(np.float32)
    eps_r = (eps - rng.uniform(5, 30, (8, 25, 1, 1))).astype(np.float32)
    st = rng.uniform(size=(8, 25)) < 0.5
    got = tres.line_residual(K, _t(T), _t(L), _t(eps), _t(eps_r), _t(st)).numpy()
    ref = np.stack([np.asarray(jres.line_residual(jba.K, jnp.asarray(T[i]), jnp.asarray(L[i]),
                                                  jnp.asarray(eps[i]), jnp.asarray(eps_r[i]),
                                                  jnp.asarray(st[i]))) for i in range(8)])
    assert _rel(got, ref) < 1e-4
    assert (got[~st][:, 2:] == 0).all() and np.abs(got[st][:, 2:]).max() > 1


def test_triangulate_line_endpoints_matches_jax():
    """Endpoint refresh of 16 lines from ≤ 32 supporting points each, one
    line with a single point (not ok): abs 1e-4 m on the ok lines."""
    rng = np.random.default_rng(4)
    L = _random_lines(rng, 16)
    pts = rng.uniform(-5, 5, (16, 32, 3)).astype(np.float32)
    n = rng.integers(2, 33, 16)
    n[5] = 1
    mask = np.arange(32)[None] < n[:, None]
    eps, ok = ttri.triangulate_line_endpoints(_t(L), _t(pts), _t(mask))
    eps_j, ok_j = jax.vmap(jtri.triangulate_line_endpoints)(
        jnp.asarray(L), jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    assert not ok[5]
    np.testing.assert_allclose(eps.numpy()[ok.numpy()], np.asarray(eps_j)[np.asarray(ok_j)],
                               atol=1e-4)


def _jax_f32(prob):
    f = jnp.float32
    return prob.Tcw.astype(f), prob.points.astype(f), prob.lines.astype(f)


@pytest.mark.parametrize("seed", [0, 1])
def test_line_terms_match_jax_jacfwd(seed):
    """The analytic line Jacobians against JAX's ``jacfwd`` of the residual
    through the orthonormal chart, on ``build_problem``'s windows (perturbed
    poses and lines, 40 mono + stereo constraints): r, Jp and Jl each to
    ≤ 1e-5 of their largest entry (f32; entries reach ~600)."""
    prob, *_ = jba.build_problem(seed, noise_px=0.3)
    pt = tlb.upload_problem(_np_problem(prob), "cpu")
    Tcw, _, lines = _jax_f32(prob)
    rj, Jpj, Jlj = jax.jit(lambda *a: jlb._line_terms(jba.K, *a))(Tcw, lines, prob)
    rt, Jpt, Jlt = tlb._line_terms(K, pt.Tcw, pt.lines, pt)
    errs = [_rel(rt, rj), _rel(Jpt, Jpj), _rel(Jlt, Jlj)]
    report("line_terms", seed=seed, rel_r_Jp_Jl=errs)
    assert max(errs) < 1e-5


def test_build_and_solve_step_matches_jax():
    """One Schur-reduced LM step (Huber on, λ = 1e-4) on the noisy window
    with 10% outliers: dp, dx, dl to ≤ 1e-3 of their largest entry
    (measured 1.7e-4: the 30×30 Schur complement subtracts sums of ~1e6 in
    f32 in another order) and the cost to rel 1e-6."""
    prob, *_ = jba.build_problem(1, noise_px=0.3, outlier_frac=0.1)
    pt = tlb.upload_problem(_np_problem(prob), "cpu")
    Tcw, points, lines = _jax_f32(prob)
    out_j = jax.jit(lambda *a: jlb._build_and_solve(jba.K, *a, True, DELTAS, jnp.float32(1e-4)))(
        Tcw, points, lines, prob, prob.p_valid, prob.l_valid)
    out_t = tlb._build_and_solve(K, pt.Tcw, pt.points, pt.lines, pt, pt.p_valid, pt.l_valid,
                                 True, DELTAS, torch.tensor(1e-4))
    errs = [_rel(a, b) for a, b in zip(out_t, out_j)]
    report("build_and_solve", rel_dp_dx_dl_cost=errs)
    assert max(errs[:3]) < 1e-3 and errs[3] < 1e-6


def _block_diag_reference(blocks):
    F = len(blocks)
    S = np.zeros((F * 6, F * 6), np.float32)
    for f in range(F):
        S[6 * f: 6 * f + 6, 6 * f: 6 * f + 6] = blocks[f]
    return S


def test_block_diagonal_places_each_block_on_the_diagonal():
    """``S.at[arange(F), :, arange(F), :].add`` of the JAX package, as the
    port builds it: block f at rows and columns 6f..6f+5, zeros elsewhere."""
    blocks = np.random.default_rng(5).standard_normal((4, 6, 6)).astype(np.float32)
    got = tlb._block_diagonal(_t(blocks)).reshape(24, 24).numpy()
    np.testing.assert_array_equal(got, _block_diag_reference(blocks))
    S = jnp.zeros((4, 6, 4, 6)).at[jnp.arange(4), :, jnp.arange(4), :].add(blocks)
    np.testing.assert_array_equal(got, np.asarray(S).reshape(24, 24))


CASES = {
    "clean": dict(seed=0),
    "noisy_outliers": dict(seed=1, noise_px=0.3, outlier_frac=0.1),
    "fixed_pose": dict(seed=2, noise_px=0.2),
    "points_only": dict(seed=3, with_lines=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimize_local_map_matches_jax(case):
    """The full schedule on ``tests/test_local_ba.py``'s windows (5 poses,
    64 points, 8 lines): poses to 1e-4 (rotation) / 2e-4 m, points to 2e-3
    m, lines equal up to Plücker scale to 1e-3, identical inlier flags,
    cost to rel 1e-3 + 1e-6 abs; the fixed pose does not move, the
    outliers are flagged as JAX flags them."""
    prob, Tcw_gt, pts_gt, lines_gt, bad = jba.build_problem(**CASES[case])
    if case == "points_only":
        prob = prob._replace(l_valid=jnp.zeros(jba.CL, bool))
    rj = jlb.fetch_result(jlb.optimize_local_map(jba.K, prob))
    rt = tlb.fetch_result(tlb.optimize_local_map(K, tlb.upload_problem(_np_problem(prob),
                                                                         "cpu")))
    dT = np.abs(rt.Tcw - rj.Tcw)
    a = np.asarray(jplk.normalize(jnp.asarray(rt.lines)))
    b = np.asarray(jplk.normalize(jnp.asarray(rj.lines)))
    dL = np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))
    report("optimize_local_map", case=case, rot=float(dT[:, :3, :3].max()),
           trans=float(dT[:, :3, 3].max()), points=float(np.abs(rt.points - rj.points).max()),
           lines=float(dL.max()), cost=[float(rt.cost), float(rj.cost)])
    assert dT[:, :3, :3].max() < 1e-4 and dT[:, :3, 3].max() < 2e-4
    assert np.abs(rt.points - rj.points).max() < 2e-3
    assert dL.max() < 1e-3
    np.testing.assert_array_equal(rt.p_inlier, rj.p_inlier)
    np.testing.assert_array_equal(rt.l_inlier, rj.l_inlier)
    assert abs(float(rt.cost) - float(rj.cost)) <= 1e-3 * abs(float(rj.cost)) + 1e-6
    np.testing.assert_array_equal(rt.Tcw[0], np.asarray(prob.Tcw, np.float32)[0])
    if len(bad):
        assert rt.p_inlier[bad].sum() <= 2


def test_divergence_fixture_matches_jax():
    """The captured f32 divergence window (10 poses, 1536 point slots, 703
    constraints): finite, and JAX's own assertions (cost < 2000, > 600
    inliers); against JAX, cost to rel 1e-3 and inlier flags differing on
    at most 2 of 703 constraints. Poses to 3e-2 m and points to 0.2 m only:
    the window is ill-conditioned (a landmark ~6 cm in front of a camera),
    and each f32 solution lies ~1 cm (poses) and ~7 cm (points) from the
    f64 optimum of the same schedule (measured: port 8.7e-3 / 7.2e-2 m,
    JAX 1.0e-2 / 7.1e-2 m; port and JAX 1.0e-2 m apart)."""
    d = dict(np.load(FIXTURE))
    rj = jlb.fetch_result(jlb.optimize_local_map(jba.K, jlb.BAProblem(**d)))
    rt = tlb.fetch_result(tlb.optimize_local_map(K, tlb.upload_problem(jlb.BAProblem(**d),
                                                                         "cpu")))
    report("divergence_fixture", cost=[float(rt.cost), float(rj.cost)],
           inliers=[int(rt.p_inlier.sum()), int(rj.p_inlier.sum())],
           trans=float(np.abs(rt.Tcw - rj.Tcw)[:, :3, 3].max()),
           points=float(np.abs(rt.points - rj.points).max()))
    assert np.isfinite(rt.Tcw).all() and np.isfinite(rt.points).all()
    assert np.isfinite(float(rt.cost)) and float(rt.cost) < 2000.0
    assert int(rt.p_inlier.sum()) > 600
    assert abs(float(rt.cost) - float(rj.cost)) <= 1e-3 * float(rj.cost)
    assert (rt.p_inlier != rj.p_inlier).sum() <= 2
    assert np.abs(rt.Tcw - rj.Tcw)[:, :3, 3].max() < 3e-2
    assert np.abs(rt.points - rj.points).max() < 0.2


def test_full_size_window_matches_jax():
    """``evaluation.synthetic.make_ba_window`` at the default capacities
    (F = 10, P = 1536, L = 128, Cp = 6144, Cl = 512; 4 views each, 0.3 px,
    5% outliers), the window ``chip_smoke.py`` times on the card: finite;
    inlier flags differ on ≤ 1% of the rows; poses within 2e-3 m of JAX's;
    both within 1 cm of the ground truth. The final costs only within 25%:
    the 5 quadratic iterations restart at λ = 1e-4 next to landmarks the
    gate left nearly unconstrained (a line parallel to the motion, a point
    down to one mono view), so which steps are accepted turns on f32 sums
    (measured: port 2057 / JAX 1822 / port in f64 1893)."""
    from rspl_slam_tpu_torch.config import CameraConfig
    from rspl_slam_tpu_torch.evaluation import synthetic

    cam = CameraConfig()
    prob, gt = synthetic.make_ba_window(cam, seed=0)
    assert len(prob["p_pose"]) == 6144 and len(prob["l_pose"]) == 512
    rj = jlb.fetch_result(jlb.optimize_local_map(jba.K, jlb.BAProblem(**prob)))
    rt = tlb.fetch_result(tlb.optimize_local_map(K, tlb.upload_problem(jlb.BAProblem(**prob),
                                                                         "cpu")))
    flips = int((rt.p_inlier != rj.p_inlier).sum() + (rt.l_inlier != rj.l_inlier).sum())
    report("full_size_window", cost=[float(rt.cost), float(rj.cost)], inlier_flips=flips,
           trans=float(np.abs(rt.Tcw - rj.Tcw)[:, :3, 3].max()),
           gt_trans=[float(np.abs(r.Tcw - gt["Tcw"])[:, :3, 3].max()) for r in (rt, rj)])
    assert np.isfinite(rt.Tcw).all() and np.isfinite(rt.points).all()
    assert flips <= 0.01 * (6144 + 512)
    assert np.abs(rt.Tcw - rj.Tcw)[:, :3, 3].max() < 2e-3
    for r in (rt, rj):
        assert np.abs(r.Tcw - gt["Tcw"])[:, :3, 3].max() < 0.01
    assert abs(float(rt.cost) - float(rj.cost)) <= 0.25 * float(rj.cost)


def test_segment_sums_follow_the_window_plan():
    """The fixed-order segment sums: ``upload_problem``'s plan lists each
    segment's valid rows in ascending order (the W tensors' flat index
    landmark·F + pose included); a sum over it equals an f64 scatter of the
    valid rows rounded to f32 (rel 1e-6), leaves invalid rows out, and a
    problem built without ``upload_problem`` solves to the same bits."""
    from rspl_slam_tpu_torch.config import CameraConfig
    from rspl_slam_tpu_torch.evaluation import synthetic

    prob, _ = synthetic.make_ba_window(CameraConfig(), frames=5, points=64, lines=8, seed=1)
    p = tlb.BAProblem(**prob)
    pt = tlb.upload_problem(p, "cpu")
    F, P = len(prob["Tcw"]), len(prob["points"])
    valid = prob["p_valid"]
    for table, idx, n in ((pt.plan.p_pose, prob["p_pose"], F),
                          (pt.plan.p_point, prob["p_point"], P),
                          (pt.plan.p_cross, prob["p_point"] * F + prob["p_pose"], P * F)):
        rows = table.numpy()
        for s_ in range(n):
            got = rows[s_][rows[s_] < len(idx)]
            np.testing.assert_array_equal(got, np.nonzero(valid & (idx == s_))[0])
        terms = np.random.default_rng(0).standard_normal((len(idx), 6, 3)).astype(np.float32)
        ref = np.zeros((n, 6, 3))
        np.add.at(ref, idx[valid], terms[valid].astype(np.float64))
        got = tlb._segment_sum(table, torch.from_numpy(terms)).numpy()
        np.testing.assert_allclose(got, ref.astype(np.float32), rtol=1e-6, atol=1e-6)
    args = dict(iters1=3, iters2=2)
    a = tlb.fetch_result(tlb.optimize_local_map(K, pt, **args))
    b = tlb.fetch_result(tlb.optimize_local_map(K, pt._replace(plan=None), **args))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_cheirality_collapse_costs_more():
    """Throwing every point 100 m behind the cameras costs more than the
    sane state (the cheirality pricing), with the same numbers as JAX's
    ``_total_cost`` (rel 1e-5)."""
    prob, *_ = jba.build_problem(seed=2, noise_px=0.3, perturb=False)
    pt = tlb.upload_problem(_np_problem(prob), "cpu")
    shift = torch.tensor([0.0, 0.0, 100.0])
    sane, *_ = tlb._total_cost(K, pt.Tcw, pt.points, pt.lines, pt, pt.p_valid, pt.l_valid,
                               DELTAS, True)
    collapsed, *_ = tlb._total_cost(K, pt.Tcw, pt.points - shift, pt.lines, pt, pt.p_valid,
                                    pt.l_valid, DELTAS, True)
    assert float(collapsed) > float(sane)
    Tcw, points, lines = _jax_f32(prob)
    cost = jax.jit(lambda pts: jlb._total_cost(jba.K, Tcw, pts, lines, prob, prob.p_valid,
                                               prob.l_valid, DELTAS, True)[0])
    j_sane, j_coll = cost(points), cost(points - jnp.asarray([0.0, 0.0, 100.0]))
    assert _rel(sane, j_sane) < 1e-5 and _rel(collapsed, j_coll) < 1e-5


def test_result_round_trip_and_distributed_ba_raises():
    """``fetch_result`` unpacks its one packed copy field by field; an
    ``axis_name`` that is not a ``parallel.mesh.Mesh`` (an unknown axis
    name, or ``"data"`` with no process group behind it; distributed BA:
    ``tests/test_torch_parallel.py``) raises a ValueError that says what it
    takes."""
    prob, *_ = jba.build_problem(0)
    pt = tlb.upload_problem(_np_problem(prob), "cpu")
    assert pt.p_pose.dtype == torch.int64 and pt.p_valid.dtype == torch.bool
    np.testing.assert_array_equal(pt.p_point.numpy(), np.asarray(prob.p_point))
    r = tlb.BAResult(Tcw=pt.Tcw, points=pt.points, lines=pt.lines, p_inlier=pt.p_valid,
                     l_inlier=pt.l_stereo, cost=torch.tensor(3.5))
    h = tlb.fetch_result(r)
    np.testing.assert_array_equal(h.Tcw, pt.Tcw.numpy())
    np.testing.assert_array_equal(h.lines, pt.lines.numpy())
    np.testing.assert_array_equal(h.l_inlier, pt.l_stereo.numpy())
    assert float(h.cost) == 3.5
    with pytest.raises(ValueError, match=r"takes a rspl_slam_tpu_torch\.parallel\.mesh"
                                         r"\.Mesh.*got 'x'"):
        tlb.optimize_local_map(K, pt, axis_name="x")
    with pytest.raises(ValueError, match=r"multihost\.initialize\(\)\), got 'data'"):
        tlb.optimize_local_map(K, pt, axis_name="data")


def test_default_system_builds_with_ba():
    """``SLAMSystem(SystemConfig(), fe)`` with its defaults (BA on, async,
    lines on) builds on the CPU."""
    cfg = SystemConfig()
    slam = SLAMSystem(cfg, TFE(cfg, device="cpu"))
    assert slam.enable_ba and cfg.pipeline.async_ba and slam.enable_lines


@pytest.fixture(scope="module")
def ba_slice_inputs():
    """The BA slice's config, ground truth and each package's features of
    its 6 frames: extraction does not depend on the map, so both modes
    share it."""
    cfg = lines_cfg(at_detection_scale=False, max_num_match=400)
    frames, traj = rendered_sequence(cfg, 6, num_lines=12)
    jfe, tfe = frontend_pair(cfg, edge_weights())
    feats = [(jfe.extract_pair(*f), tfe.extract_pair(*f)) for f in frames]
    return cfg, traj, jfe, tfe, feats


def _capture_windows(slam, out):
    """Record every window the system gathers (problem, mapping)."""
    gather = slam.gather_ba_problem

    def wrapped(center_kf):
        prob, mapping = gather(center_kf)
        if prob is not None:
            out.append((prob, mapping))
        return prob, mapping

    slam.gather_ba_problem = wrapped


@pytest.mark.parametrize("async_ba", [True, False], ids=["async", "sync"])
def test_slam_slice_with_ba_matches_jax(async_ba, ba_slice_inputs, tmp_path):
    """The slice with BA on: 6 rendered 320×240 frames with 12 dark
    segments, 2 GNN layers, f32, the same weights in both packages, every
    tracked frame a keyframe, lines on with RCF at full size
    (``rcf_at_detection_scale=False``, the JAX path that reads its segments
    right), BA after every keyframe, in the JAX package's async or sync
    mode. The first window both gather is the same (poses 1e-6, points
    1e-5 m, every point constraint; line constraints within 5%, the two
    detectors' line sets differing by a line or two). After it the runs
    part: BA moves poses through lines, and the f32 LM takes another
    accept/reject path on some windows (measured on one such window: port
    and JAX 1.4e-3 m apart, the f64 solution 1e-5 m from JAX's). So the
    keyframe positions agree to 2.5 cm (measured 0.94 cm sync, 1.54 cm
    async), 90% of the mappoints to 3 cm, and the port's keyframe
    trajectory is no further from the ground truth than JAX's + 5 mm.
    ``save_trajectory`` flushes the last window."""
    cfg, traj, jfe, tfe, feats = ba_slice_inputs
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                                async_ba=async_ba))
    js = JSLAM(to_jax_cfg(cfg), jfe)
    ts = SLAMSystem(cfg, tfe)
    wins_j, wins_t = [], []
    _capture_windows(js, wins_j)
    _capture_windows(ts, wins_t)
    for i, (fj, ft) in enumerate(feats):
        rj = js.add_frame_features(i, 0.05 * i, copy.deepcopy(fj))
        rt = ts.add_frame_features(i, 0.05 * i, copy.deepcopy(ft))
        assert rt.is_keyframe == rj.is_keyframe
    assert (ts._pending_ba is not None) == async_ba
    path = str(tmp_path / "traj.txt")
    ts.save_trajectory(path)
    js.flush_ba()
    assert ts._pending_ba is None
    tm, jm = ts.map, js.map
    n = tm.n_kf
    assert n == jm.n_kf == 6 and len(wins_t) == len(wins_j) == 5
    assert len(ts.timings["local_ba"]) == 5
    assert ("ba_apply" in ts.timings) == async_ba
    rows = np.loadtxt(path).reshape(-1, 8)
    assert len(rows) == n and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[:, 1:4], tm.kf_pose[:n, :3, 3], atol=1e-6)
    # the first window: the same map, gathered the same way
    (pt, mt), (pj, mj) = wins_t[0], wins_j[0]
    for f in ("pose_fixed", "p_pose", "p_point", "p_stereo", "p_valid"):
        np.testing.assert_array_equal(getattr(pt, f), np.asarray(getattr(pj, f)))
    np.testing.assert_allclose(pt.Tcw, pj.Tcw, atol=1e-6)
    np.testing.assert_allclose(pt.points, pj.points, atol=1e-5)
    np.testing.assert_allclose(pt.p_meas, pj.p_meas, atol=1e-4)
    assert mt["ncl"] > 0 and abs(mt["ncl"] - mj["ncl"]) <= 0.05 * mj["ncl"]
    assert [w["ncl"] for w in ts.ba_windows] == [m["ncl"] for _, m in wins_t]
    # the runs, end to end
    dk = np.abs(tm.kf_pose[:n, :3, 3] - jm.kf_pose[:n, :3, 3]).max()
    good = (tm.pt_status[: tm.n_pt] == 2)
    assert abs(tm.n_pt - jm.n_pt) <= 0.01 * jm.n_pt
    m = min(tm.n_pt, jm.n_pt)
    both = good[:m] & (jm.pt_status[:m] == 2)
    dp = np.linalg.norm(tm.pt_pos[:m][both] - jm.pt_pos[:m][both], axis=-1)
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    ts_ = np.arange(len(feats)) * 0.05
    kf_t = tm.kf_frame_id[:n]

    def kf_ate(m_):
        return absolute_trajectory_error(ts_[kf_t], m_.kf_pose[:n, :3, 3], ts_,
                                         gt[:, :3, 3])["rmse"]

    ate_t, ate_j = kf_ate(tm), kf_ate(jm)
    report("slam_slice_with_ba", async_ba=async_ba, kf_position_max_diff_m=float(dk),
           mappoints=[int(tm.n_pt), int(jm.n_pt)],
           mappoint_diff_m_q50_q90=np.quantile(dp, [0.5, 0.9]).tolist(),
           kf_ate_m=[float(ate_t), float(ate_j)],
           line_constraints=[m_["ncl"] for _, m_ in wins_t])
    assert dk < 0.025
    assert np.quantile(dp, 0.9) < 0.03
    assert ate_t <= ate_j + 0.005
    assert np.isfinite(tm.kf_pose[:n]).all() and np.isfinite(tm.pt_pos[: tm.n_pt]).all()
