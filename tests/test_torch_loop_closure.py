"""The port's loop closure and relocalization against the JAX package's.

``backend/loop_closure.py`` is host numpy in both packages, with the same
``np.random.default_rng(seed)`` RANSAC: on the same map arrays (a JAX map
store saved and loaded into the port's) both accept the same constraint,
bit for bit. Then the system paths on the CPU: the kidnapped-robot
scenario of ``tests/test_relocalization.py`` through both ``SLAMSystem``s
(oracle features, BA on), and the resume + relocalization scenario of
``tests/test_resume.py`` through the port.
"""

import numpy as np
import pytest
from test_loop_closure import _make_loop_map, _rot
from test_torch_common import report

import rspl_slam_tpu.backend.loop_closure as jlc
import rspl_slam_tpu_torch.backend.loop_closure as tlc
from rspl_slam_tpu.config import PipelineConfig as JPipe
from rspl_slam_tpu.config import SuperPointConfig as JSP
from rspl_slam_tpu.config import SystemConfig as JCfg
from rspl_slam_tpu.evaluation import synthetic as jsynth
from rspl_slam_tpu.frontend.frontends import FrameFeatures as JFF
from rspl_slam_tpu.frontend.frontends import OracleFrontend as JOracle
from rspl_slam_tpu.slam import SLAMSystem as JSLAM
from rspl_slam_tpu_torch.backend.map_store import MapStore as TMapStore
from rspl_slam_tpu_torch.config import PipelineConfig, SuperPointConfig, SystemConfig
from rspl_slam_tpu_torch.evaluation import synthetic
from rspl_slam_tpu_torch.frontend.frontends import FrameFeatures, OracleFrontend
from rspl_slam_tpu_torch.slam import INIT_POSE, SLAMSystem

K = 256


def _port_map(jmap, tmp_path):
    """The JAX map store's arrays in the port's map store (checkpoint)."""
    path = str(tmp_path / "map.npz")
    jmap.save(path)
    return TMapStore.load(path, PipelineConfig())


def _same_constraint(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.i, a.j, a.n_inliers) == (b.i, b.j, b.n_inliers)
    assert a.weight == b.weight and a.similarity == b.similarity
    np.testing.assert_array_equal(a.Z, b.Z)


def test_descriptor_matching_and_ransac_equal_jax():
    """``global_descriptor``, ``mutual_nn_matches`` and
    ``ransac_rigid_align`` (30% gross outliers) give JAX's arrays bit for
    bit."""
    rng = np.random.default_rng(3)
    d = rng.standard_normal((200, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    va = rng.random(200) < 0.8
    vb = rng.random(200) < 0.8
    db = d[rng.permutation(200)] + rng.standard_normal((200, 256)).astype(np.float32) * 0.05
    np.testing.assert_array_equal(tlc.global_descriptor(d, va), jlc.global_descriptor(d, va))
    np.testing.assert_array_equal(tlc.mutual_nn_matches(d, va, db, vb),
                                  jlc.mutual_nn_matches(d, va, db, vb))
    R = _rot([0.2, 1.0, -0.3], 0.4)
    src = rng.uniform(-2, 2, (120, 3))
    dst = src @ R.T + [0.5, -0.2, 1.1] + rng.standard_normal((120, 3)) * 0.005
    dst[rng.choice(120, 36, replace=False)] += rng.uniform(0.5, 3.0, (36, 3))
    for seed in range(3):
        Tt, mt = tlc.ransac_rigid_align(src, dst, inlier_dist=0.05, min_inliers=20, seed=seed)
        Tj, mj = jlc.ransac_rigid_align(src, dst, inlier_dist=0.05, min_inliers=20, seed=seed)
        np.testing.assert_array_equal(Tt, Tj)
        np.testing.assert_array_equal(mt, mj)


@pytest.mark.parametrize("drift", [False, True], ids=["consistent", "drifted"])
def test_detect_and_relocalize_equal_jax(drift, tmp_path):
    """``LoopDetector.detect`` on the revisit map of
    ``tests/test_loop_closure.py`` (the query's stored pose drifted or
    not), a query with no revisit, and ``relocalize`` of the revisit's raw
    features: the port's constraints equal JAX's bit for bit, and Z is the
    true relative pose despite the drift."""
    D = np.eye(4)
    D[:3, :3] = _rot([0, 1, 0], 0.05)
    D[:3, 3] = [0.4, 0.1, -0.2]
    jm, jdet, Twc_c, Twc_q = _make_loop_map(drift=D if drift else None)
    tm = _port_map(jm, tmp_path)
    tdet = tlc.LoopDetector(bf=jdet.bf, min_gap=jdet.min_gap, sim_thr=jdet.sim_thr,
                            min_inliers=jdet.min_inliers, inlier_dist=jdet.inlier_dist)
    q = jm.n_kf - 1
    jout, tout = jdet.detect(jm, q), tdet.detect(tm, q)
    _same_constraint(tout, jout)
    assert tout is not None and (tout.i, tout.j) == (0, q)
    Z_true = np.linalg.inv(Twc_c) @ Twc_q
    report(f"loop_detect_{'drifted' if drift else 'consistent'}",
           z_translation_err_m=float(np.abs(tout.Z[:3, 3] - Z_true[:3, 3]).max()),
           inliers=tout.n_inliers)
    np.testing.assert_allclose(tout.Z[:3, :3], Z_true[:3, :3], atol=5e-3)
    np.testing.assert_allclose(tout.Z[:3, 3], Z_true[:3, 3], atol=3e-2)
    _same_constraint(tdet.detect(tm, q - 1), jdet.detect(jm, q - 1))  # no revisit: None
    assert tdet.detect(tm, q - 1) is None
    args = (tm.kf_desc[q].astype(np.float32), tm.kf_kpt_valid[q], tm.kf_meas[q])
    rt = tdet.relocalize(tm, *args)
    rj = jdet.relocalize(jm, *args)
    assert rt is not None and rt[0] == rj[0] and rt[2] == rj[2]
    np.testing.assert_array_equal(rt[1], rj[1])


def _blackout(cls, desc_dim=256):
    return cls(xy=np.zeros((K, 2), np.float32), score=np.zeros(K, np.float32),
               desc=np.zeros((K, desc_dim), np.float32), valid=np.zeros(K, bool),
               meas=np.full((K, 3), -1.0, np.float32), depth=np.zeros(K, np.float32))


def _kidnap(pkg):
    """The kidnapped-robot run of ``tests/test_relocalization.py`` in one
    package: 50 frames of a yaw sweep, 5 blacked-out frames, then 6 frames
    back at an early pose. Returns (system, position errors after)."""
    if pkg == "port":
        cfg = SystemConfig(superpoint=SuperPointConfig(max_keypoints=K),
                           pipeline=PipelineConfig(ba_max_points=512, ba_max_lines=16))
        scene = synthetic.make_scene(num_points=1500, num_lines=0, extent=(40.0, 6.0, 14.0),
                                     seed=5)
        traj = synthetic.make_trajectory(50, step=0.02, yaw_rate=0.032)
        fe = OracleFrontend(cfg, scene, noise_px=0.3, seed=1, device="cpu")
        slam, ff = SLAMSystem(cfg, fe, enable_ba=True, enable_relocalization=True), FrameFeatures
    else:
        cfg = JCfg(superpoint=JSP(max_keypoints=K), pipeline=JPipe(ba_max_points=512,
                                                                   ba_max_lines=16))
        scene = jsynth.make_scene(num_points=1500, num_lines=0, extent=(40.0, 6.0, 14.0), seed=5)
        traj = jsynth.make_trajectory(50, step=0.02, yaw_rate=0.032)
        fe = JOracle(cfg, scene, noise_px=0.3, seed=1)
        slam, ff = JSLAM(cfg, fe, enable_ba=True, enable_relocalization=True), JFF
    idx = 0
    for i in range(50):
        slam.add_frame_features(idx, idx * 0.05, fe.observe(traj[i]))
        idx += 1
    for _ in range(5):
        slam.add_frame_features(idx, idx * 0.05, _blackout(ff))
        idx += 1
    errs = []
    for k in range(6):
        rec = slam.add_frame_features(idx, idx * 0.05, fe.observe(traj[4 + k]))
        idx += 1
        gt = INIT_POSE @ traj[4 + k]
        errs.append(float(np.linalg.norm(rec.Twc[:3, 3] - gt[:3, 3])))
    return slam, errs


def test_kidnap_relocalizes_as_jax():
    """Both packages relocalize the kidnapped camera the same number of
    times and track within 5 cm of the truth afterwards (JAX's own gate);
    the re-anchoring keyframes agree."""
    (ts, et), (js, ej) = _kidnap("port"), _kidnap("jax")
    report("kidnap", reloc=[ts.reloc_count, js.reloc_count], err_last_m=[et[-1], ej[-1]],
           err_min_m=[min(et), min(ej)])
    assert ts.reloc_count == js.reloc_count >= 1
    assert min(et) < 0.05 and et[-1] < 0.05, et
    assert min(ej) < 0.05 and ej[-1] < 0.05, ej
    assert ts.map.n_kf == js.map.n_kf
    assert "reloc" in ts.timings


def test_resume_from_moved_camera_relocalizes(tmp_path):
    """``tests/test_resume.py``'s scenario in the port: a map saved after a
    yaw sweep, a fresh system resumed from it with relocalization at once
    (``reloc_after=0``), woken up at an early pose: it re-anchors and
    tracks within 5 cm."""
    cfg = SystemConfig(superpoint=SuperPointConfig(max_keypoints=K),
                       pipeline=PipelineConfig(ba_max_points=512, ba_max_lines=16))
    scene = synthetic.make_scene(num_points=1500, num_lines=0, extent=(40.0, 6.0, 14.0), seed=5)
    traj = synthetic.make_trajectory(50, step=0.02, yaw_rate=0.032)
    fe = OracleFrontend(cfg, scene, noise_px=0.3, seed=1, device="cpu")
    slam = SLAMSystem(cfg, fe, enable_ba=True)
    for i in range(50):
        slam.add_frame_features(i, i * 0.05, fe.observe(traj[i]))
    ckpt = str(tmp_path / "map.npz")
    slam.save_map(ckpt)
    fresh = SLAMSystem(cfg, fe, enable_ba=True, enable_relocalization=True, reloc_after=0)
    fresh.loop_constraints.append("stale")
    fresh.loop_detector._gdesc.append(np.zeros(256, np.float32))
    fresh.resume_from_map(ckpt)
    assert fresh.loop_constraints == [] and fresh.loop_detector._gdesc == []
    errs = []
    for k in range(5):
        rec = fresh.add_frame_features(60 + k, 3.0 + k * 0.05, fe.observe(traj[4 + k]))
        gt = INIT_POSE @ traj[4 + k]
        errs.append(float(np.linalg.norm(rec.Twc[:3, 3] - gt[:3, 3])))
    report("resume_reloc", reloc=fresh.reloc_count, err_last_m=errs[-1])
    assert fresh.reloc_count >= 1
    assert errs[-1] < 0.05, errs
