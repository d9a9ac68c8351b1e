"""The port's lazy-right schedule against the JAX package on the CPU: the
left-only extraction, the stereo completion of a keyframe, one combined
frame step, a 6-frame lazy slice, and the deferred-download contract.

Setup: rendered 320×240 frames of a scene with 12 dark segments quantized
to 8 bits (the upload the production loop makes), K = 400,
2 GNN layers, f32, the descriptor-matcher SuperGlue and the hand-set edge
weights in both packages, ``lazy_right_extraction=True`` (lines on, RCF at
the detection scale: the route both packages' combined step takes)."""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_common import (edge_weights, frontend_pair, lines_cfg, matcher_weights,
                               rendered_sequence, report, segment_set_distance, to_jax_cfg)

from rspl_slam_tpu.frame_step import CombinedTracker as JCombined
from rspl_slam_tpu.slam import SLAMSystem as JSLAM
from rspl_slam_tpu_torch.frame_step import CombinedTracker
from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend as TFE
from rspl_slam_tpu_torch.slam import SLAMSystem

LINE_TOL = 2 * 2 * np.hypot(120, 160) / 256 + 1e-3  # one projection bin at ×0.5, full scale


def _lazy_cfg(**pipeline):
    cfg = lines_cfg(max_num_match=180)
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, lazy_right_extraction=True, **pipeline))


@pytest.fixture(scope="module")
def lazy():
    """Config, frames, ground truth and the (JAX, port) lazy frontends."""
    cfg = _lazy_cfg()
    frames, traj = rendered_sequence(cfg, 6, num_lines=12)
    frames = [tuple((np.clip(im, 0, 1) * 255).astype(np.uint8) for im in f) for f in frames]
    jfe, tfe = frontend_pair(cfg, edge_weights())
    assert jfe.lazy_right and tfe.lazy_right
    return cfg, frames, traj, jfe, tfe


@pytest.fixture(scope="module")
def initialized(lazy):
    """Both systems (BA off) after frame 0: the map initialized from the
    completed first frame."""
    cfg, frames, _, jfe, tfe = lazy
    js = JSLAM(to_jax_cfg(cfg), jfe, enable_ba=False)
    ts = SLAMSystem(cfg, tfe, enable_ba=False)
    js.add_frame(0, 0.0, *frames[0])
    ts.add_frame(0, 0.0, *frames[0])
    assert js.initialized and ts.initialized
    return js, ts


def test_left_only_extraction_matches_jax(lazy):
    """The left eye alone (JAX's ``lazy_extract_core``, which packs its
    segment rows right): the same keypoints and flags, score and
    descriptors to 1e-4, the same merged left segments within one
    projection bin; nothing comes down until a field is read, the right
    image waits on the host as 8-bit, and the frame is all-mono."""
    _, frames, _, jfe, tfe = lazy
    fj = jfe.extract_pair(*frames[1])
    ft = tfe.extract_pair(*frames[1])
    assert not ft.is_materialized and ft.stereo_ur() is None
    np.testing.assert_array_equal(ft.pending_right, frames[1][1])
    np.testing.assert_array_equal(ft.valid, fj.valid)
    assert ft.is_materialized
    np.testing.assert_array_equal(ft.xy, fj.xy)
    np.testing.assert_allclose(ft.score, fj.score, atol=1e-4)
    np.testing.assert_allclose(ft.desc, fj.desc, atol=1e-4)
    assert (ft.meas[:, 2] == -1).all() and (ft.depth == 0).all()
    n = int(ft.line_valid.sum())
    assert n == int(fj.line_valid.sum()) > 20
    worst = max(segment_set_distance(ft.lines[:n], fj.lines[:n]).max(),
                segment_set_distance(fj.lines[:n], ft.lines[:n]).max())
    report("left_only_extraction", lines=n, worst_px=float(worst))
    assert worst <= LINE_TOL
    assert not ft.line_has_right.any()


def test_complete_stereo_matches_jax(lazy):
    """A keyframe's right eye: uR and depth as JAX's ``complete_stereo``
    gives them (1e-3). Its right lines are held against the port's own
    eager extraction of the same pair (the same stereo-matched segments,
    1e-3) and against JAX's ``_extract_lines`` on the right image (each
    within one projection bin of a JAX segment): JAX's fused completion
    reads its right segments as rows of 5 where it packed [coords; valid]
    (ROADMAP.md §3). (Frame 2 of this sequence holds a near-tie that the
    two matchers' f32 sums break differently, one right keypoint claimed
    by two left ones; frame 4 has none.)"""
    cfg, frames, _, jfe, tfe = lazy
    fj = jfe.complete_stereo(jfe.extract_pair(*frames[4]))
    before = (tfe.stereo_completions, tfe.desc_downloads)
    ft = tfe.complete_stereo(tfe.extract_pair(*frames[4]))
    assert (tfe.stereo_completions, tfe.desc_downloads) == (before[0] + 1, before[1] + 1)
    assert ft.pending_right is None and fj.pending_right is None
    np.testing.assert_array_equal(ft.meas[:, 2] > 0, fj.meas[:, 2] > 0)
    assert (ft.depth > 0).sum() > 100
    np.testing.assert_allclose(ft.meas, fj.meas, atol=1e-3)
    np.testing.assert_allclose(ft.depth, fj.depth, atol=1e-3)
    sp, sg = matcher_weights(cfg)
    eager = TFE(cfg, sp_params=sp, sg_params=sg, rcf_params=edge_weights(),
                compute_dtype=torch.float32, lazy_right=False, device="cpu")
    fe_ = eager.extract_pair(*frames[4])
    np.testing.assert_allclose(ft.meas, fe_.meas, atol=1e-3)
    np.testing.assert_array_equal(ft.line_valid, fe_.line_valid)
    np.testing.assert_array_equal(ft.line_has_right, fe_.line_has_right)
    np.testing.assert_allclose(ft.lines_right, fe_.lines_right, atol=1e-3)
    has = ft.line_has_right
    assert has.sum() > 5
    assert tfe._rect_maps is None  # the rendered frames are rectified already
    (ref,) = jfe._extract_lines(frames[4][1][None].astype(np.float32) / 255.0)
    d = segment_set_distance(ft.lines_right[has], ref)
    report("complete_stereo", stereo=int((ft.depth > 0).sum()), right_lines=int(has.sum()),
           worst_px_to_jax_extract_lines=float(d.max()))
    assert d.max() <= LINE_TOL


def test_complete_stereo_twice_is_a_noop(lazy):
    """A second completion changes nothing and runs nothing."""
    _, frames, _, _, tfe = lazy
    ff = tfe.complete_stereo(tfe.extract_pair(*frames[3]))
    meas, lines_right = ff.meas.copy(), ff.lines_right.copy()
    n = tfe.stereo_completions
    assert tfe.complete_stereo(ff) is ff
    assert tfe.stereo_completions == n
    np.testing.assert_array_equal(ff.meas, meas)
    np.testing.assert_array_equal(ff.lines_right, lines_right)


def test_combined_step_matches_jax(lazy, initialized):
    """One combined frame step (left extraction → all-mono fused tracking,
    one copy down) against JAX's ``CombinedTracker.step``, both against
    the keyframe each package initialized from frame 0: the same matches,
    the pose within 1 mm (RANSAC draws from different random streams
    converge to the same LM optimum), inliers within 2; the small buffer
    brings the keypoint rows and lines, the descriptors stay on the device
    until read, and then are JAX's f16-rounded ones (values 1e-4 apart
    before the rounding can land one f16 step apart)."""
    cfg, frames, _, jfe, tfe = lazy
    js, ts = initialized
    tcfg = cfg.optimization.tracking
    ref_pos, ref_good = ts._ref_landmarks()
    fj, i0j, Tj, nj, _ = JCombined(jfe, js.K, tcfg.mono_point, tcfg.stereo_point).step(
        *frames[1], js._ref_feats, ref_pos, ref_good, js._last_Twc)
    ct = CombinedTracker(tfe, ts.K, tcfg.mono_point, tcfg.stereo_point)
    assert ct.supported()
    ft, i0t, Tt, nt, _ = ct.step(*frames[1], ts._ref_feats, ref_pos, ref_good,
                                 ts._last_Twc, seed=1)
    report("combined_step", matches=int((i0t >= 0).sum()), inliers=[nt, nj],
           pose_diff_m=float(np.abs(Tt[:3, 3] - Tj[:3, 3]).max()))
    np.testing.assert_array_equal(i0t, i0j)
    assert (i0t >= 0).sum() > 100 and abs(nt - nj) <= 2
    np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], atol=1e-3)
    np.testing.assert_array_equal(ft.xy, fj.xy)
    np.testing.assert_array_equal(ft.line_valid, fj.line_valid)
    assert ft._np["desc"] is None and not ft.is_materialized and ft.pending_right is not None
    n = tfe.desc_downloads
    np.testing.assert_allclose(ft.desc, fj.desc, rtol=2.0 ** -10, atol=1e-4)
    assert tfe.desc_downloads == n + 1
    np.testing.assert_array_equal(ft.desc, ft.desc.astype(np.float16).astype(np.float32))


def test_lazy_slice_matches_jax(lazy):
    """The lazy slice, 6 frames through both ``SLAMSystem``s (BA off): the
    same keyframe decisions (a mix of keyframes and tracked-only frames,
    which the combined step runs), keyframe and frame positions within
    1 mm, the same mappoint states; every keyframe was stereo-completed
    and brought its descriptors down once, no tracked-only frame did."""
    cfg, frames, _, jfe, tfe = lazy
    js = JSLAM(to_jax_cfg(cfg), jfe, enable_ba=False)
    ts = SLAMSystem(cfg, tfe, enable_ba=False)
    c0, d0 = tfe.stereo_completions, tfe.desc_downloads
    for i, f in enumerate(frames):
        rj = js.add_frame(i, 0.05 * i, *f)
        rt = ts.add_frame(i, 0.05 * i, *f)
        assert rt.is_keyframe == rj.is_keyframe
        assert abs(rt.num_inliers - rj.num_inliers) <= 2
    kf = [r.is_keyframe for r in ts.records]
    n = ts.map.n_kf
    assert n == js.map.n_kf and 2 <= n < len(frames)
    assert len(ts.timings["frame_combined"]) == len(frames) - 1
    assert tfe.stereo_completions - c0 == n == tfe.desc_downloads - d0
    est = np.stack([r.Twc for r in ts.records])
    ref = np.stack([r.Twc for r in js.records])
    report("lazy_slice", keyframes=kf, inliers=[r.num_inliers for r in ts.records],
           kf_position_max_diff_m=float(np.abs(ts.map.kf_pose[:n, :3, 3]
                                               - js.map.kf_pose[:n, :3, 3]).max()),
           frame_position_max_diff_m=float(np.abs(est[:, :3, 3] - ref[:, :3, 3]).max()))
    np.testing.assert_allclose(ts.map.kf_pose[:n, :3, 3], js.map.kf_pose[:n, :3, 3], atol=1e-3)
    np.testing.assert_allclose(est[:, :3, 3], ref[:, :3, 3], atol=1e-3)
    np.testing.assert_array_equal(ts.map.pt_status[: ts.map.n_pt],
                                  js.map.pt_status[: js.map.n_pt])
    assert np.isfinite(est).all()


def test_only_keyframes_materialize(lazy):
    """The split path (``combined_frame_step=False``: every frame extracted
    by ``extract_pair``, tracked by the fused tracker): the frames that
    became keyframes were downloaded; no plain tracked frame was (the last
    frame stays cached for the promote fallback and is left out)."""
    _, frames, _, _, tfe = lazy
    slam = SLAMSystem(_lazy_cfg(combined_frame_step=False), tfe, enable_ba=False)
    out = []
    for i, f in enumerate(frames):
        ff = tfe.extract_pair(*f)
        out.append((slam.add_frame_features(i, 0.05 * i, ff), ff))
        assert not slam.wants_images()
    assert slam.initialized and "frame_combined" not in slam.timings
    kf = {i for i, (r, _) in enumerate(out) if r.is_keyframe}
    assert kf and all(out[i][1].is_materialized for i in kf)
    plain = [i for i in range(1, len(frames) - 1) if i not in kf]
    assert plain
    assert not any(out[i][1].is_materialized for i in plain)
