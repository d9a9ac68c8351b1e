"""The port's ``MultiSequenceSLAM`` and the batched frontend calls against the
JAX package on the CPU.

JAX's three tests (``tests/test_multi_sequence.py``) with their bounds:
four oracle sequences with batched BA (ATE < 0.01 m), batched neural
extraction equal to serial ``extract_pair`` (xy, meas to 1e-4, the same
valid flags), sequences of different length. Beside them:
``extract_pairs_batched`` and ``match_batched`` against JAX's on the same
pairs and weights (the descriptor-matcher SuperGlue, 2 layers, 96×64,
K = 64, f32), at ``test_torch_slam.py::test_extract_pair_matches_jax``'s
tolerances (the same keypoints and stereo associations, uR and depth to
1e-3, descriptors to 1e-4; temporal matches equal); and two oracle
sequences through both packages' ``MultiSequenceSLAM``: the same
keyframes, their positions within 1e-3 m.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_common import matcher_weights, report, to_jax_cfg

from rspl_slam_tpu.frontend.frontends import NeuralFrontend as JFE
from rspl_slam_tpu.frontend.frontends import OracleFrontend as JOracle
from rspl_slam_tpu.parallel.multi_sequence import MultiSequenceSLAM as JMulti
from rspl_slam_tpu_torch.config import (CameraConfig, PipelineConfig, SuperPointConfig,
                                        SystemConfig)
from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error, synthetic
from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend, OracleFrontend
from rspl_slam_tpu_torch.parallel.multi_sequence import MultiSequenceSLAM
from rspl_slam_tpu_torch.slam import INIT_POSE


def _oracle_cfg():
    return SystemConfig(superpoint=SuperPointConfig(max_keypoints=256),
                        pipeline=PipelineConfig(ba_max_points=512, ba_max_lines=8),
                        use_lines=False)


def build_world(n_seq, n_frames, oracle=OracleFrontend, **fe_kw):
    """JAX's ``build_world``: per sequence a scene (seed 100 + s) and a
    trajectory whose yaw rate grows with s."""
    cfg = _oracle_cfg()
    fes, trajs = [], []
    for s in range(n_seq):
        scene = synthetic.make_scene(num_points=800, num_lines=0, seed=100 + s,
                                     extent=(10.0, 6.0, 16.0))
        traj = synthetic.make_trajectory(n_frames, step=0.05, yaw_rate=0.002 * (s + 1))
        c = cfg if oracle is OracleFrontend else to_jax_cfg(cfg)
        fe = oracle(c, scene, noise_px=0.3, seed=100 + s, **fe_kw)
        fe.poses = traj
        fes.append(fe)
        trajs.append(traj)
    return cfg, fes, trajs


def _small_cfg(matcher_layers=None):
    cam = CameraConfig(image_width=96, image_height=64, fx=80.0, fy=80.0, cx=48.0, cy=32.0,
                       bf=8.0)
    cfg = SystemConfig(superpoint=SuperPointConfig(max_keypoints=64, keypoint_threshold=1e-4),
                       camera=cam, use_lines=False)
    if matcher_layers:
        cfg = dataclasses.replace(cfg, superglue=dataclasses.replace(
            cfg.superglue, image_width=96, image_height=64, num_gnn_layers=matcher_layers))
    return cfg


def _pairs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(size=(64, 96)).astype(np.float32),
             rng.uniform(size=(64, 96)).astype(np.float32)) for _ in range(n)]


def test_four_sequences_batched_ba():
    n_seq, n_frames = 4, 30
    cfg, fes, trajs = build_world(n_seq, n_frames, device="cpu")
    msq = MultiSequenceSLAM(cfg, fes)
    for i in range(n_frames):
        msq.step([(i, i * 0.05, None, None)] * n_seq)
    assert msq.ba_solves and max(msq.ba_solves) >= 2  # windows solved together
    for s in range(n_seq):
        slam = msq.slams[s]
        est = np.stack([r.Twc for r in slam.records])
        ts = np.asarray([r.time for r in slam.records])
        gt = np.einsum("ij,njk->nik", INIT_POSE, trajs[s])
        res = absolute_trajectory_error(ts, est[:, :3, 3], ts, gt[:, :3, 3])
        assert res["rmse"] < 0.01, (s, res)
        assert slam.map.n_kf >= 2


def test_batched_neural_extraction_matches_serial():
    """``extract_pairs_batched`` gives what per-sequence ``extract_pair``
    calls give (cosine matcher)."""
    cfg = _small_cfg()
    fe0 = NeuralFrontend(cfg, matcher="cosine", seed=0, device="cpu")
    fe1 = NeuralFrontend(cfg, sp_params=fe0.sp, matcher="cosine", seed=0, device="cpu")
    pairs = _pairs(2)
    batched = fe0.extract_pairs_batched(pairs, [fe0, fe1])
    for s in range(2):
        serial = fe0.extract_pair(*pairs[s])
        np.testing.assert_allclose(batched[s].xy, serial.xy, atol=1e-4)
        np.testing.assert_allclose(batched[s].meas, serial.meas, atol=1e-4)
        assert (batched[s].valid == serial.valid).all()


def test_sequences_of_different_length():
    cfg, fes, _ = build_world(2, 20, device="cpu")
    msq = MultiSequenceSLAM(cfg, fes)
    for i in range(20):
        frames = [(i, i * 0.05, None, None), (i, i * 0.05, None, None) if i < 12 else None]
        recs = msq.step(frames)
        if i >= 12:
            assert recs[1] is None
    assert len(msq.slams[0].records) == 20
    assert len(msq.slams[1].records) == 12


def test_batched_frontend_calls_match_jax():
    """The same three pairs and weights through both packages' batched
    extraction and batched temporal matching (SuperGlue, f32)."""
    cfg = _small_cfg(matcher_layers=2)
    sp, sg = matcher_weights(cfg)
    jfes = [JFE(to_jax_cfg(cfg), sp_params=sp, sg_params=sg, compute_dtype=jnp.float32)]
    jfes += [JFE(to_jax_cfg(cfg), sp_params=jfes[0].sp_params, sg_params=sg,
                 compute_dtype=jnp.float32) for _ in range(2)]
    tfes = [NeuralFrontend(cfg, sp_params=sp, sg_params=sg, compute_dtype=torch.float32,
                           device="cpu")]
    tfes += [NeuralFrontend(cfg, sp_params=tfes[0].sp, sg_params=sg,
                            compute_dtype=torch.float32, device="cpu") for _ in range(2)]
    pairs = _pairs(3, seed=1)
    fj = jfes[0].extract_pairs_batched(pairs, jfes)
    ft = tfes[0].extract_pairs_batched(pairs, tfes)
    stereo = 0
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a.valid, b.valid)
        np.testing.assert_array_equal(a.xy, b.xy)
        np.testing.assert_array_equal(a.meas[:, 2] > 0, b.meas[:, 2] > 0)
        np.testing.assert_allclose(a.meas[:, 2], b.meas[:, 2], atol=1e-3)
        np.testing.assert_allclose(a.depth, b.depth, atol=1e-3)
        np.testing.assert_allclose(a.desc, b.desc, atol=1e-4)
        stereo += int((a.depth > 0).sum())
    # temporal problems: each frame against the next sequence's frame
    pj = [(fj[k], fj[(k + 1) % 3]) for k in range(3)]
    pt = [(ft[k], ft[(k + 1) % 3]) for k in range(3)]
    mj, mt = jfes[0].match_batched(pj), tfes[0].match_batched(pt)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a, np.asarray(b))
    report("extract_pairs_batched", stereo_matches=stereo,
           temporal_matches=[int((m >= 0).sum()) for m in mt])
    assert stereo > 0 and sum(int((m >= 0).sum()) for m in mt) > 0


def test_two_oracle_sequences_match_jax():
    """Two oracle sequences (batched BA) through both packages: the same
    keyframes, their positions within 1e-3 m."""
    n_frames = 20
    cfg, tfes, _ = build_world(2, n_frames, device="cpu")
    _, jfes, _ = build_world(2, n_frames, oracle=JOracle)
    tm, jm = MultiSequenceSLAM(cfg, tfes), JMulti(to_jax_cfg(cfg), jfes)
    for i in range(n_frames):
        frames = [(i, i * 0.05, None, None)] * 2
        for rt, rj in zip(tm.step(frames), jm.step(frames)):
            assert rt.is_keyframe == rj.is_keyframe
    worst = 0.0
    for ts, js in zip(tm.slams, jm.slams):
        n = ts.map.n_kf
        assert n == js.map.n_kf >= 2
        worst = max(worst, float(np.abs(ts.map.kf_pose[:n, :3, 3]
                                        - js.map.kf_pose[:n, :3, 3]).max()))
    report("multi_sequence_oracle", keyframes=[s.map.n_kf for s in tm.slams],
           kf_pos_max_diff_m=worst, ba_solves=tm.ba_solves)
    assert tm.ba_solves and worst < 1e-3
