"""Every shipped camera configuration through the port and the JAX package
on the CPU: EuRoC, OIVIO (radtan), UMA (fisheye), RealSense and ZED2i.

Raw frames are made as ``chip_smoke.py``'s ``configs`` phase makes them:
``chip_smoke.config_scene`` renders the rectified view, and
``chip_smoke.raw_frames`` samples it where each raw pixel of the camera
looks, so both frontends rectify with the file's own maps. Each
configuration runs at about a quarter of its size, rounded so that it keeps
its own RCF route (×0.5 where H and W are multiples of 8; ZED2i's 135 rows
take the full-size route, as its 540 do), with its own keypoint budget,
keyframe and χ² settings, 2 GNN layers and f32.
"""

import dataclasses
import os

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import (edge_weights, frontend_pair, report, segment_set_distance,
                               to_jax_cfg)

from rspl_slam_tpu import camera as jcam
from rspl_slam_tpu import config as jcfg
from rspl_slam_tpu.frontend.frontends import _downsample_max, _downsample_mean
from rspl_slam_tpu.models import rcf as jrcf
from rspl_slam_tpu.ops import lines as jl
from rspl_slam_tpu.slam import SLAMSystem as JSLAM
from rspl_slam_tpu_torch import camera as tcam
from rspl_slam_tpu_torch.config import load_system_config
from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend as TFE
from rspl_slam_tpu_torch.ops import lines as tl
from rspl_slam_tpu_torch.slam import SLAMSystem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = {"euroc": "configs/euroc.yaml", "oivio": "configs/oivio.yaml",
         "uma": "configs/uma_bumblebee_indoor.yaml", "realsense": "configs/realsense.yaml",
         "zed2i": "configs/zed2i.yaml"}
# (width, height) at about a quarter of each size: the camera scaled by ¼,
# then cropped or padded to the size that keeps the configuration's RCF route
SMALL = {"oivio": (320, 176), "uma": (256, 192), "realsense": (216, 120), "zed2i": (240, 135)}


def _config(name):
    path = os.path.join(ROOT, FILES[name])
    return load_system_config(path, path)


def _small_config(name, layers=2):
    """The configuration at its SMALL size: its camera scaled by ¼ (with its
    distortion model and rectification) and cropped, its algorithm section
    as the file has it, ``layers`` GNN layers."""
    cfg = _config(name)
    W, H = SMALL[name]
    cam = dataclasses.replace(chip_smoke.scale_camera(cfg.camera, 0.25), image_width=W,
                              image_height=H)
    return dataclasses.replace(cfg, camera=cam, superglue=dataclasses.replace(
        cfg.superglue, image_width=W, image_height=H, num_gnn_layers=layers))


def _raw_sequence(cfg, n, closer=1.0):
    frames, traj, _ = chip_smoke.config_scene(cfg.camera, n, closer=closer)
    return chip_smoke.raw_frames(cfg.camera, frames), traj


@pytest.mark.parametrize("name", list(FILES))
def test_rectify_maps_match_jax(name):
    """``build_rectify_maps`` of every shipped file, both eyes, at full
    size: bit-equal to the JAX package's (radtan, fisheye and the identity
    rectifications)."""
    path = os.path.join(ROOT, FILES[name])
    cj, ct = jcfg.load_camera_config(path), load_system_config(path, path).camera
    for side in ("left", "right"):
        got, ref = tcam.build_rectify_maps(ct, side), jcam.build_rectify_maps(cj, side)
        assert got.shape == (ct.image_height, ct.image_width, 2)
        np.testing.assert_array_equal(got, ref)


def test_raw_frames_rectify_back_to_the_render():
    """The test frames' scaffolding: the raw frame of UMA's fisheye camera,
    rectified with the file's maps, is the render again up to the two
    bilinear resamplings (the inner region, where no border clamps)."""
    cfg = _small_config("uma")
    frames, _, _ = chip_smoke.config_scene(cfg.camera, 1)
    raw = chip_smoke.raw_frames(cfg.camera, frames)
    H, W = frames[0][0].shape
    for eye, side in enumerate(("left", "right")):
        maps = torch.from_numpy(tcam.build_rectify_maps(cfg.camera, side))
        back = tcam.remap_bilinear(torch.from_numpy(raw[0][eye]).float() / 255.0, maps).numpy()
        d = np.abs(back - frames[0][eye])[H // 8:-H // 8, W // 8:-W // 8]
        assert np.median(d) < 0.02 and np.percentile(d, 99) < 0.15
        assert np.abs(maps.numpy() - np.stack(np.meshgrid(np.arange(W), np.arange(H)),
                                              -1)).max() > 10  # the fisheye moves pixels


@pytest.mark.parametrize("name", list(SMALL))
def test_extract_pair_matches_jax(name):
    """One raw pair of each configuration through both eager frontends
    (f32, 2 layers, the configuration's K, rectified with its maps): the
    same keypoints, stereo associations, uR and depth to 1e-3 and
    descriptors to 1e-4 (test_torch_slam.py's tolerances). Lines on the
    rectified pair, each package's RCF on the configuration's own route
    (the JAX package's steps of ``_extract_lines``; its eager path misreads
    its packed segments, ROADMAP.md §3) and its detector: the same number
    of segments per eye, each within one projection bin of the detection
    map of a segment of the other. The merge is held apart
    (tests/test_torch_lines.py): it turns on thresholds, and segments that
    differ by 2e-5 px can merge on one side and not on the other (UMA's
    right eye: 62 merged segments against 64), so only its sizes are
    reported."""
    cfg = dataclasses.replace(_small_config(name), use_lines=True)
    raw, _ = _raw_sequence(cfg, 1)
    jfe, tfe = frontend_pair(cfg, rcf_params=edge_weights())
    fj = jfe.extract_pair(*raw[0])
    ft = tfe.extract_pair(*raw[0])
    assert ft.valid.sum() > 50
    np.testing.assert_array_equal(ft.valid, fj.valid)
    np.testing.assert_array_equal(ft.xy, fj.xy)
    np.testing.assert_array_equal(ft.meas[:, 2] > 0, fj.meas[:, 2] > 0)
    assert (ft.depth > 0).sum() > 20
    np.testing.assert_allclose(ft.meas[:, 2], fj.meas[:, 2], atol=1e-3)
    np.testing.assert_allclose(ft.depth, fj.depth, atol=1e-3)
    np.testing.assert_allclose(ft.desc, fj.desc, atol=1e-4)

    rect = tfe._upload(np.stack(raw[0]), slice(0, 2))
    ld = cfg.line_detector
    ds = ld.downsample
    imgs = jnp.asarray(rect.numpy())
    H, W = imgs.shape[1:]
    if ld.rcf_at_detection_scale and H % (4 * ds) == 0 and W % (4 * ds) == 0:
        edges = jrcf.edge_map(jfe.rcf_params, _downsample_mean(imgs, ds), jfe.compute_dtype)
    else:
        edges = _downsample_max(jrcf.edge_map(jfe.rcf_params, imgs, jfe.compute_dtype), ds)
    segs, valid = tfe._extract_lines(rect)
    assert tuple(segs.shape[:1]) == (2,) and edges.shape == (2, H // ds, W // ds)
    tol = 2 * np.hypot(H // ds, W // ds) / 256 + 1e-3
    worst, merged = 0.0, []
    for b in range(2):
        js, jv, _ = jl.detect_line_segments(edges[b], min_length=float(ld.length_threshold),
                                            inlier_dist=float(ld.distance_threshold),
                                            max_segments=ld.max_lines)
        ref = np.asarray(js)[np.asarray(jv)]
        got = segs[b][valid[b]].numpy()
        assert len(got) == len(ref) > 20
        worst = max(worst, segment_set_distance(got, ref).max(initial=0.0),
                    segment_set_distance(ref, got).max(initial=0.0))
        merged.append([len(tfe._host_merge(got * ds)), len(jfe._host_merge(ref * ds))])
    report("configs_extract_pair", config=name, keypoints=int(ft.valid.sum()),
           stereo=int((ft.depth > 0).sum()), detections=int(valid.sum()),
           merged_port_jax=merged, worst_line_bins=worst / (tol - 1e-3))
    assert worst <= tol


@pytest.mark.parametrize("name", list(SMALL))
def test_slam_slice_matches_jax(name):
    """Six raw frames of each configuration through both SLAM systems
    (points, BA off, as test_torch_slam.py's slice; the file's χ² and
    keyframe settings, but for a keyframe gate of K matches, which makes
    every tracked frame a keyframe, so insertion and multi-view
    triangulation run on every step): both initialize and track, every
    frame is or is not a keyframe in both, inliers within 2, keyframe and
    frame positions within 1 mm. The scene comes twice as close as in the full-size run
    (``closer=2``), so that a quarter of the short-baseline cameras'
    disparities (RealSense, ZED2i: 5 cm) still initializes."""
    cfg = _small_config(name)
    cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(
        cfg.keyframe, max_num_match=cfg.superpoint.max_keypoints))
    raw, _ = _raw_sequence(cfg, 6, closer=2.0)
    jfe, tfe = frontend_pair(cfg)
    js = JSLAM(to_jax_cfg(cfg), jfe, enable_ba=False)
    ts = SLAMSystem(cfg, tfe, enable_ba=False)
    for i, (il, ir) in enumerate(raw):
        rj = js.add_frame(i, 0.05 * i, il, ir)
        rt = ts.add_frame(i, 0.05 * i, il, ir)
        assert rt.is_keyframe == rj.is_keyframe
        assert abs(rt.num_inliers - rj.num_inliers) <= 2
    assert ts.initialized and js.initialized
    assert min(r.num_inliers for r in ts.records[1:]) > 20
    n = ts.map.n_kf
    assert n == js.map.n_kf >= 4
    np.testing.assert_allclose(ts.map.kf_pose[:n, :3, 3], js.map.kf_pose[:n, :3, 3],
                               atol=1e-3)
    est = np.stack([r.Twc for r in ts.records])
    ref = np.stack([r.Twc for r in js.records])
    np.testing.assert_allclose(est[:, :3, 3], ref[:, :3, 3], atol=1e-3)
    report("configs_slam_slice", config=name, keyframes=int(n),
           inliers=[int(r.num_inliers) for r in ts.records],
           max_position_diff_m=float(np.abs(est[:, :3, 3] - ref[:, :3, 3]).max()))


@pytest.mark.parametrize("name", list(FILES))
def test_hough_detector_matches_jax_on_each_detection_map(name):
    """``detect_line_segments`` on the detection map of each shipped
    configuration at full size (the frontend's own RCF route on the first
    rendered left image of ``config_scene``, the hand-set edge weights): the
    same number of valid segments as the JAX function, each within one
    projection bin (2·hypot(H, W) / 256) of a segment of the other, either
    way. The port computes XLA's FMAs, reciprocals and summation order;
    what remains is XLA's own atan2, sin and cos, an ulp from torch's on
    some peaks (ROADMAP.md §3), 1.5e-5 bins at most on these maps."""
    cfg = _config(name)
    frames, _, _ = chip_smoke.config_scene(cfg.camera, 1)
    tfe = TFE(cfg, rcf_params=edge_weights(), compute_dtype=torch.float32, device="cpu")
    edge = tfe._edge_maps(torch.from_numpy(frames[0][0][None]))[0].numpy()
    ld = cfg.line_detector
    kw = dict(min_length=float(ld.length_threshold), inlier_dist=float(ld.distance_threshold),
              max_segments=ld.max_lines)
    js, jv, _ = (np.asarray(a) for a in jl.detect_line_segments(jnp.asarray(edge), **kw))
    ts, tv, _ = (a.numpy() for a in tl.detect_line_segments(torch.from_numpy(edge), **kw))
    bin_px = 2 * np.hypot(*edge.shape) / 256
    d_t = segment_set_distance(ts[tv], js[jv])
    d_j = segment_set_distance(js[jv], ts[tv])
    beyond = max(int((d_t > bin_px + 1e-3).sum()), int((d_j > bin_px + 1e-3).sum()))
    report("configs_hough", config=name, detection_map=list(edge.shape),
           segments=int(tv.sum()), beyond_one_bin=beyond,
           worst_in_bins=float(max(d_t.max(initial=0), d_j.max(initial=0)) / bin_px))
    assert tv.sum() == jv.sum() > 20
    assert beyond == 0
