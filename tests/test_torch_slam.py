"""The port's frontend and SLAM slice (points, and points + lines) against
the JAX package, plus the port's ground rules: no JAX import, the card as
default device; and the global layer's options run."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_common import (edge_weights, frontend_pair, lines_cfg, rendered_sequence,
                               report, segment_set_distance, small_system_cfg, to_jax_cfg)

from rspl_slam_tpu.slam import SLAMSystem as JSLAM
from rspl_slam_tpu.slam import _members_to_lists as j_members_to_lists
from rspl_slam_tpu_torch.config import SystemConfig
from rspl_slam_tpu_torch.datasets import write_tum_trajectory
from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend as TFE
from rspl_slam_tpu_torch.slam import SLAMSystem, _members_to_lists

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rspl_slam_tpu_torch")


def test_extract_pair_matches_jax():
    """One rendered 320×240 pair through both eager frontends (f32, the
    descriptor-matcher SuperGlue with 2 layers): the same keypoints, the
    same stereo associations, uR and depth to 1e-3."""
    cfg = small_system_cfg()
    frames, _ = rendered_sequence(cfg, 1)
    jfe, tfe = frontend_pair(cfg)
    fj = jfe.extract_pair(*frames[0])
    ft = tfe.extract_pair(*frames[0])
    np.testing.assert_array_equal(ft.valid, fj.valid)
    np.testing.assert_array_equal(ft.xy, fj.xy)
    np.testing.assert_array_equal(ft.meas[:, 2] > 0, fj.meas[:, 2] > 0)
    assert (ft.depth > 0).sum() > 100
    np.testing.assert_allclose(ft.meas[:, 2], fj.meas[:, 2], atol=1e-3)
    np.testing.assert_allclose(ft.depth, fj.depth, atol=1e-3)
    np.testing.assert_allclose(ft.desc, fj.desc, atol=1e-4)


def test_slam_slice_matches_jax(tmp_path):
    """The whole slice: 6 rendered frames at 320×240, K = 400, 2 GNN
    layers, same weights in both packages (f32). Both initialize and track;
    the keyframes agree and their positions match within 1 mm (f32 solvers
    in another summation order, and RANSAC draws from different random
    streams that converge to the same pose). A keyframe gate of 400
    matches makes every tracked frame a keyframe, so insertion and multi-view
    triangulation run on every step."""
    cfg = small_system_cfg()
    cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(cfg.keyframe,
                                                                max_num_match=400))
    frames, _ = rendered_sequence(cfg, 6)
    jfe, tfe = frontend_pair(cfg)
    js = JSLAM(to_jax_cfg(cfg), jfe, enable_ba=False)
    ts = SLAMSystem(cfg, tfe, enable_ba=False)
    for i, (il, ir) in enumerate(frames):
        rj = js.add_frame(i, 0.05 * i, il, ir)
        rt = ts.add_frame(i, 0.05 * i, il, ir)
        assert rt.is_keyframe == rj.is_keyframe
        assert abs(rt.num_inliers - rj.num_inliers) <= 2
    assert ts.initialized and js.initialized
    assert min(r.num_inliers for r in ts.records[1:]) > 20
    n = ts.map.n_kf
    assert n == js.map.n_kf >= 4
    assert (ts.map.pt_status[: ts.map.n_pt] == 2).sum() > 200
    np.testing.assert_allclose(ts.map.kf_pose[:n, :3, 3], js.map.kf_pose[:n, :3, 3],
                               atol=1e-3)
    np.testing.assert_array_equal(ts.map.pt_status[: ts.map.n_pt],
                                  js.map.pt_status[: js.map.n_pt])
    est = np.stack([r.Twc for r in ts.records])
    ref = np.stack([r.Twc for r in js.records])
    np.testing.assert_allclose(est[:, :3, 3], ref[:, :3, 3], atol=1e-3)
    assert np.isfinite(est).all()
    path = str(tmp_path / "traj.txt")
    ts.save_trajectory(path)
    rows = np.loadtxt(path).reshape(-1, 8)
    assert len(rows) == n and np.isfinite(rows).all()


def test_promote_last_frame_matches_jax():
    """The tracking fallback: promoting the previous frame to a keyframe
    re-optimizes its pose through the unfused PnP-RANSAC + LM path
    (``_pose_optimize``) and inserts it. Both packages insert the same
    keyframe at the same pose (1 mm; RANSAC draws differ, the LM optimum
    does not) with the same landmark bookkeeping."""
    cfg = small_system_cfg()
    frames, _ = rendered_sequence(cfg, 3)
    jfe, tfe = frontend_pair(cfg)
    js = JSLAM(to_jax_cfg(cfg), jfe, enable_ba=False)
    ts = SLAMSystem(cfg, tfe, enable_ba=False)
    for i, (il, ir) in enumerate(frames):
        js.add_frame(i, 0.05 * i, il, ir)
        ts.add_frame(i, 0.05 * i, il, ir)
    assert ts.map.n_kf == js.map.n_kf == 1
    js._promote_last_frame_to_keyframe()
    ts._promote_last_frame_to_keyframe()
    assert ts.map.n_kf == js.map.n_kf == 2
    assert ts.map.kf_frame_id[1] == js.map.kf_frame_id[1] == 2
    np.testing.assert_allclose(ts.map.kf_pose[1], js.map.kf_pose[1], atol=1e-3)
    assert ts.map.n_pt == js.map.n_pt
    np.testing.assert_array_equal(ts.map.kf_track[1], js.map.kf_track[1])
    assert "pose_opt" in ts.timings


def test_extract_pair_lines_unpack_the_one_copy():
    """The main path's line fields (RCF at ×0.5 on the pair, Hough on both
    eyes, segments riding the frame's one device→host copy) on a rendered
    320×240 pair, f32, the hand-set edge weights: the left lines are the
    merged detections of the frontend's own ``_extract_lines`` bit for bit,
    their keypoint membership is ``assign_points_to_lines``', and some have
    a stereo match. (The JAX package's fused eager graph packs segments as
    [coords; valid] but reads rows of 5 — ROADMAP.md §3 — so the segments
    are held against its ``_extract_lines`` in tests/test_torch_lines.py.)"""
    from rspl_slam_tpu_torch.ops import lines as tl

    cfg = lines_cfg()
    (pair,), _ = rendered_sequence(cfg, 1, num_lines=12)
    _, tfe = frontend_pair(cfg, edge_weights())
    ff = tfe.extract_pair(*pair)
    segs, valid = tfe._extract_lines(torch.from_numpy(np.stack(pair)))
    ref = tfe._host_merge(segs[0][valid[0]].numpy() * 2)
    n = int(ff.line_valid.sum())
    assert n == min(len(ref), cfg.line_detector.max_lines) > 20
    assert ff.line_valid[:n].all() and not ff.line_valid[n:].any()
    np.testing.assert_array_equal(ff.lines[:n], ref[:n].astype(np.float32))
    np.testing.assert_array_equal(
        ff.line_members[:n], tl.assign_points_to_lines(ff.lines[:n], ff.xy, ff.valid))
    assert ff.line_members[:n].any(1).sum() > 5 and ff.line_has_right.sum() > 5
    assert set(tfe.timings) == {"rcf_hough", "lines_host"}


def test_attach_lines_matches_jax():
    """Padding, keypoint assignment and stereo line matching of given
    segments equal JAX's ``_attach_lines`` exactly."""
    from rspl_slam_tpu.frontend.frontends import FrameFeatures as JFF
    from rspl_slam_tpu_torch.frontend.frontends import FrameFeatures as TFF

    jfe, tfe = frontend_pair(lines_cfg(), edge_weights())
    rng = np.random.default_rng(5)
    segs_l = rng.uniform(0, 300, (40, 4)).astype(np.float32)
    segs_r = segs_l - np.array([8, 0, 8, 0], np.float32)
    K = 400
    t = rng.uniform(0, 1, (K, 1))
    which = rng.integers(0, 40, K)
    xy = (segs_l[which, :2] * (1 - t) + segs_l[which, 2:] * t
          + rng.normal(0, 1.0, (K, 2))).astype(np.float32)
    perm = rng.permutation(K)
    xyR = np.empty_like(xy)
    xyR[perm] = xy - np.array([8, 0], np.float32)
    valid = rng.uniform(size=K) < 0.9
    validR = valid[np.argsort(perm)]
    i0 = np.where(rng.uniform(size=K) < 0.8, perm, -1)
    uR = np.where(i0 >= 0, xy[:, 0] - 8, -1.0).astype(np.float32)
    fj = JFF(xy=xy, valid=valid)
    jfe._attach_lines(fj, None, xyR, validR, i0, uR, segs_pair=(segs_l, segs_r))
    ft = tfe._attach_lines(TFF(xy=xy, valid=valid), xyR, validR, i0, uR, (segs_l, segs_r))
    for name in ("lines", "line_valid", "lines_right", "line_has_right", "line_members"):
        np.testing.assert_array_equal(getattr(ft, name), getattr(fj, name))
    assert ft.line_has_right.sum() > 10


def test_members_to_lists_matches_jax():
    m = np.random.default_rng(6).uniform(size=(20, 400)) < 0.1
    m[3] = True  # more members than a list holds
    np.testing.assert_array_equal(_members_to_lists(m), j_members_to_lists(m))


def test_default_config_runs_lines():
    """The default ``SystemConfig()`` (lines on) builds on the CPU."""
    fe = TFE(SystemConfig(), device="cpu")
    assert fe.use_lines and fe.rcf is not None
    assert SLAMSystem(SystemConfig(), fe, enable_ba=False).enable_lines


def test_slam_slice_with_lines_matches_jax():
    """The slice with lines on: 4 rendered frames at 320×240 with 12 dark
    segments, 2 GNN layers, f32, the same weights in both packages, every
    tracked frame a keyframe (gate of 400 matches). RCF runs at full size
    with the edge map max-pooled to ×0.5 (``rcf_at_detection_scale=False``)
    — the JAX package's eager path that reads its segments right
    (ROADMAP.md §3); the hand-set edge weights at width 0.125. The same
    keyframes, within 1 cm (a PnP inlier more or less than in JAX, which
    the point path alone decides, moves a pose by mm). Lines
    per keyframe within 2, at most 3 of them without a counterpart within
    4 px (a refined Hough line can move one bin, and the 60 px filter and
    the merge then keep or join it differently); mapline counts, and those
    with endpoints, within 5%; 90% of the fitted maplines have a
    counterpart within 1 cm (endpoints up to order)."""
    cfg = lines_cfg(at_detection_scale=False, max_num_match=400)
    frames, _ = rendered_sequence(cfg, 4, num_lines=12)
    jfe, tfe = frontend_pair(cfg, edge_weights())
    js = JSLAM(to_jax_cfg(cfg), jfe, enable_ba=False)
    ts = SLAMSystem(cfg, tfe, enable_ba=False)
    for i, (il, ir) in enumerate(frames):
        rj = js.add_frame(i, 0.05 * i, il, ir)
        rt = ts.add_frame(i, 0.05 * i, il, ir)
        assert rt.is_keyframe == rj.is_keyframe
    tm, jm = ts.map, js.map
    n = tm.n_kf
    assert n == jm.n_kf >= 4
    np.testing.assert_allclose(tm.kf_pose[:n, :3, 3], jm.kf_pose[:n, :3, 3], atol=1e-2)
    kf_lines = []
    for k in range(n):
        a = tm.kf_lines[k][tm.kf_line_valid[k]]
        b = jm.kf_lines[k][jm.kf_line_valid[k]]
        kf_lines.append([len(a), len(b), int((segment_set_distance(a, b) > 4).sum()),
                         int((segment_set_distance(b, a) > 4).sum())])
    has_t = tm.ln_has_endpoints[: tm.n_ln]
    has_j = jm.ln_has_endpoints[: jm.n_ln]
    et = tm.ln_endpoints[: tm.n_ln][has_t]
    ej = jm.ln_endpoints[: jm.n_ln][has_j]
    d = np.minimum(np.abs(et[:, None] - ej[None]).max((-1, -2)),
                   np.abs(et[:, None] - ej[None][:, :, ::-1]).max((-1, -2))).min(1)
    report("slam_slice_with_lines", keyframes=[int(n), int(jm.n_kf)],
           kf_position_max_diff_m=float(np.abs(tm.kf_pose[:n, :3, 3]
                                               - jm.kf_pose[:n, :3, 3]).max()),
           lines_port_jax_unmatched_4px=kf_lines, maplines=[int(tm.n_ln), int(jm.n_ln)],
           with_endpoints=[len(et), len(ej)],
           endpoint_diff_m_q50_q90_max=np.quantile(d, [0.5, 0.9, 1.0]).tolist(),
           share_within_1cm=float((d < 0.01).mean()))
    for n_t, n_j, far_t, far_j in kf_lines:
        assert n_t > 20 and abs(n_t - n_j) <= 2 and far_t <= 3 and far_j <= 3
    assert abs(tm.n_ln - jm.n_ln) <= 0.05 * jm.n_ln
    assert has_t.sum() > 20 and abs(int(has_t.sum()) - int(has_j.sum())) <= 0.05 * has_j.sum()
    assert (d < 0.01).mean() >= 0.9
    assert np.isfinite(tm.ln_plucker[: tm.n_ln][has_t]).all()
    np.testing.assert_array_equal(ts._ref_feats.line_tracks, tm.kf_line_track[n - 1])


def test_write_tum_trajectory(tmp_path):
    poses = np.tile(np.eye(4), (2, 1, 1))
    poses[1, :3, 3] = [1.0, 2.0, 3.0]
    path = str(tmp_path / "t.txt")
    write_tum_trajectory(path, [0.0, 0.5], poses)
    rows = np.loadtxt(path)
    np.testing.assert_allclose(rows[1], [0.5, 1, 2, 3, 0, 0, 0, 1])


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_imports_no_jax():
    """Importing every port module (and chip_smoke.py) in a fresh process
    leaves neither jax nor rspl_slam_tpu in sys.modules; an AST scan of the
    package finds no such import either."""
    code = ("import sys, importlib\n"
            f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'rspl_slam_tpu' or m.startswith('rspl_slam_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "rspl_slam_tpu"), (path, name)


def test_default_device_is_the_card(monkeypatch):
    """With no GPU the default device raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = small_system_cfg()
    with pytest.raises(RuntimeError, match="CUDA"):
        TFE(cfg)
    fe = TFE(cfg, device="cpu")
    assert fe.device.type == "cpu"
    assert SLAMSystem(cfg, fe, enable_ba=False).device.type == "cpu"


@pytest.mark.parametrize("what", ["match_outlier_rejection", "loop_closure"])
def test_global_configurations_run(what):
    """The global layer's options, which raised before they were ported,
    run on the CPU: 4 rendered frames through the port and the JAX package
    (every tracked frame a keyframe, BA off) with the epipolar filter (the
    port fed JAX's hypothesis draws; tracking takes the unfused route) or
    with loop closure on (relocalization follows it; the detector tests
    every keyframe and finds no loop in so short a run): the same
    keyframes, positions within 1 mm."""
    from test_torch_global import _JaxDraws

    cfg = small_system_cfg()
    cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(cfg.keyframe, max_num_match=400),
                              pipeline=dataclasses.replace(
                                  cfg.pipeline,
                                  match_outlier_rejection=what == "match_outlier_rejection"))
    frames, _ = rendered_sequence(cfg, 4)
    jfe, tfe = frontend_pair(cfg)
    kw = dict(enable_ba=False, enable_loop_closure=what == "loop_closure")
    js, ts = JSLAM(to_jax_cfg(cfg), jfe, **kw), SLAMSystem(cfg, tfe, **kw)
    if what == "match_outlier_rejection":
        tfe._orej_hypotheses = _JaxDraws()
    for i, f in enumerate(frames):
        assert ts.add_frame(i, 0.05 * i, *f).is_keyframe == js.add_frame(i, 0.05 * i, *f).is_keyframe
    n = js.map.n_kf
    assert ts.map.n_kf == n >= 3
    np.testing.assert_allclose(ts.map.kf_pose[:n, :3, 3], js.map.kf_pose[:n, :3, 3], atol=1e-3)
    assert ts.enable_relocalization == js.enable_relocalization == (what == "loop_closure")
    if what == "loop_closure":
        assert len(ts.timings["loop_detect"]) == len(js.timings["loop_detect"]) == n - 1
        assert ts.loop_constraints == js.loop_constraints == []
    else:  # the unfused route, as in the JAX package
        assert "match" in ts.timings and "track_fused" not in ts.timings
