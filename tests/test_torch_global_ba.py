"""The port's full-map BA (``SLAMSystem.run_global_ba``) against the JAX
package's, on the oracle map of ``tests/test_global_ba.py`` (35 frames,
BA off, so the map keeps its raw noise), the same perturbation applied to
both packages' copies of the map.

Tolerances: the same power-of-two problem, solved by the same two-phase
f32 LM, whose accept decisions turn on f32 sums in another order: the
costs to 1e-2 relative, keyframe positions to 2 mm, and JAX's own gates
(reprojection RMS halved, under 1.5 px, the gauge keyframe untouched) in
both. Where f32 parts ways, the port's f64 solve of the same problem is
the arbiter: both f32 solutions within 2 mm of it.
"""

import copy

import numpy as np
import pytest
from test_global_ba import _build_map, _perturb, _reproj_rms, _reproj_rms_full
from test_torch_common import report

from rspl_slam_tpu_torch.backend import local_ba
from rspl_slam_tpu_torch.backend.map_store import MAX_OBS, MapStore
from rspl_slam_tpu_torch.config import PipelineConfig, SuperPointConfig, SystemConfig
from rspl_slam_tpu_torch.evaluation import synthetic
from rspl_slam_tpu_torch.frontend.frontends import OracleFrontend
from rspl_slam_tpu_torch.slam import SLAMSystem


def _cfg(**kw):
    return SystemConfig(superpoint=SuperPointConfig(max_keypoints=256),
                        pipeline=PipelineConfig(ba_max_points=512, ba_max_lines=16), **kw)


@pytest.fixture(scope="module")
def perturbed_pair(tmp_path_factory):
    """(JAX system, port system) on the same perturbed oracle map."""
    jslam = _build_map()
    _perturb(jslam)
    path = str(tmp_path_factory.mktemp("gba") / "map.npz")
    jslam.save_map(path)
    tslam = SLAMSystem(_cfg(use_lines=False),
                       OracleFrontend(_cfg(use_lines=False), jslam.frontend.scene, device="cpu"),
                       enable_ba=False)
    tslam.resume_from_map(path)
    return jslam, tslam


def test_global_ba_matches_jax(perturbed_pair):
    jslam, tslam = (copy.deepcopy(s) for s in perturbed_pair)
    n = jslam.map.n_kf
    assert n >= 4
    before = _reproj_rms(tslam)
    pose0 = tslam.map.kf_pose[0].copy()
    prob, mapping = tslam.global_ba_problem()
    f64 = local_ba.upload_problem(prob, "cpu")
    f64 = f64._replace(**{k: getattr(f64, k).double() for k in ("Tcw", "points", "lines",
                                                                "p_meas", "l_eps", "l_eps_r")})
    b = tslam.cfg.optimization.backend
    chi2 = dict(chi2_mono=b.mono_point, chi2_stereo=b.stereo_point,
                chi2_mono_line=b.mono_line, chi2_stereo_line=b.stereo_line)
    r64 = local_ba.fetch_result(local_ba.optimize_local_map(tslam.K, f64, **chi2))
    # the f32 solve run_global_ba makes, and its robust objective around it
    f32 = local_ba.upload_problem(prob, "cpu")
    r32 = local_ba.optimize_local_map(tslam.K, f32, **chi2)
    objective = [float(local_ba.robust_objective(tslam.K, f32, r, **chi2)) for r in (None, r32)]
    frames = mapping["frames"]
    cj, ct = jslam.run_global_ba(), tslam.run_global_ba()
    Pj, Pt = jslam.map.kf_pose[:n, :3, 3], tslam.map.kf_pose[:n, :3, 3]
    P64 = np.linalg.inv(r64.Tcw[: len(frames)])[:, :3, 3]
    after = _reproj_rms(tslam)
    report("global_ba", keyframes=n, constraints=int(mapping["ncp"]), cost=[ct, cj],
           cost_f64=float(r64.cost), pos_max_diff_m=float(np.abs(Pt - Pj).max()),
           pos_to_f64_m=[float(np.abs(Pt[frames] - P64).max()),
                         float(np.abs(Pj[frames] - P64).max())],
           reproj_rms_px=[before, after, _reproj_rms(jslam)], objective=objective)
    assert ct is not None and cj is not None
    np.testing.assert_allclose(ct, cj, rtol=1e-2)
    assert np.abs(Pt - Pj).max() < 2e-3
    assert np.abs(Pt[frames] - P64).max() < 2e-3 and np.abs(Pj[frames] - P64).max() < 2e-3
    assert after < 0.5 * before and after < 1.5, (before, after)
    np.testing.assert_allclose(tslam.map.kf_pose[0], pose0)
    assert ct == float(r32.cost) and objective[1] <= objective[0]
    assert "global_ba" in tslam.timings


def test_too_small_map_and_mesh():
    """A one-frame map gives None (as in the JAX package); a ``mesh=`` that
    is not the port's ``parallel.mesh.Mesh`` raises TypeError, whatever the
    map (the sharded solve itself: ``tests/test_torch_parallel.py``)."""
    cfg = _cfg(use_lines=False)
    scene = synthetic.make_scene(num_points=900, seed=2, num_lines=0, extent=(10.0, 6.0, 16.0))
    fe = OracleFrontend(cfg, scene, noise_px=0.6, seed=2, device="cpu")
    fe.poses = synthetic.make_trajectory(1, step=0.05, yaw_rate=0.003)
    slam = SLAMSystem(cfg, fe, enable_ba=False)
    slam.add_frame(0, 0.0, None, None)
    assert slam.run_global_ba() is None
    with pytest.raises(TypeError, match=r"parallel\.mesh\.Mesh, got object"):
        slam.run_global_ba(mesh=object())


def test_global_ba_uses_evicted_observations():
    """``tests/test_global_ba.py``'s long-loop map (20 keyframes, every one
    seeing all 60 landmarks, rings capped at MAX_OBS = 16) in the port: the
    global gather holds all 20 × 60 constraints, and ``run_global_ba``
    drives the full-table reprojection error below 0.2× and 0.5 px."""
    N_KF, N_PT = 20, 60
    cfg = SystemConfig(superpoint=SuperPointConfig(max_keypoints=64),
                       pipeline=PipelineConfig(max_map_keyframes=32, max_map_points=256,
                                               ba_max_points=256))
    slam = SLAMSystem(cfg, OracleFrontend(cfg, synthetic.make_scene(num_points=10, seed=0),
                                          device="cpu"), enable_ba=False)
    cam = cfg.camera
    m = MapStore(64, cfg.line_detector.max_lines, cfg.pipeline,
                 desc_dim=cfg.superglue.descriptor_dim)
    m.set_intrinsics(cam.fx, cam.fy, cam.cx, cam.cy)
    rng = np.random.default_rng(5)
    pts_w = rng.uniform([-2, -1.5, 5], [2, 1.5, 10], (N_PT, 3))
    pt_ids = m.new_mappoints_batch(pts_w, rng.standard_normal((N_PT, 256)).astype(np.float32))
    for k in range(N_KF):
        Twc = np.eye(4)
        Twc[0, 3] = 0.02 * k
        Xc = pts_w - Twc[:3, 3]
        meas = np.zeros((64, 3), np.float32)
        meas[:N_PT, 0] = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx
        meas[:N_PT, 1] = cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy
        meas[:N_PT, 2] = meas[:N_PT, 0] - cam.bf / Xc[:, 2]
        kf = m.add_keyframe(k, 0.05 * k, Twc, meas, np.arange(64) < N_PT,
                            np.zeros((64, 256), np.float16), np.ones(64, np.float16),
                            fixed=k == 0)
        m.add_point_obs_batch(pt_ids, kf, np.arange(N_PT))
        m.update_covisibility(kf)
    slam.map = m
    slam.initialized = True
    slam._ref_kf = m.n_kf - 1
    assert (m.pt_obs_n[pt_ids] == MAX_OBS).all()
    prob, mapping = slam.global_ba_problem()
    assert mapping["ncp"] == N_KF * N_PT
    assert set(np.unique(mapping["p_pose"])) == set(range(N_KF))
    for k in range(1, m.n_kf):
        m.kf_pose[k][:3, 3] += rng.standard_normal(3) * 0.01
    m.pt_pos[pt_ids] += rng.standard_normal((N_PT, 3)) * 0.02
    before = _reproj_rms_full(slam)
    assert slam.run_global_ba() is not None
    after = _reproj_rms_full(slam)
    report("global_ba_evicted", reproj_rms_px=[before, after])
    assert after < before * 0.2 and after < 0.5, (before, after)


def test_global_ba_with_lines_reduces_error():
    """``tests/test_global_ba.py``'s lines case in the port: a map with
    maplines, perturbed, refined with line terms: the reprojection error
    drops and the line constraints enter the problem."""
    cfg = _cfg(use_lines=True)
    scene = synthetic.make_scene(num_points=900, seed=2, num_lines=10, extent=(10.0, 6.0, 16.0))
    fe = OracleFrontend(cfg, scene, noise_px=0.6, seed=2, use_lines=True, device="cpu")
    fe.poses = synthetic.make_trajectory(35, step=0.05, yaw_rate=0.003)
    slam = SLAMSystem(cfg, fe, enable_ba=False)
    for i in range(35):
        slam.add_frame(i, i * 0.05, None, None)
    _perturb(slam, sigma_pose=0.005, sigma_pt=0.01, seed=3)
    before = _reproj_rms(slam)
    assert slam.global_ba_problem()[1]["ncl"] > 0
    assert slam.run_global_ba() is not None
    assert _reproj_rms(slam) < before
    assert np.isfinite(slam.map.kf_pose[: slam.map.n_kf]).all()
