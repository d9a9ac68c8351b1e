"""The repo's real photograph (tests/fixtures/real_photo.jpg, a baseline
4:2:0 RGB JPEG) through the port: decoded by the port's own reader
(``png.read_gray``, equal to PIL's ``convert("L")``: tests/test_torch_native.py),
then the same arrays into both packages at f32 on the CPU, the cosine
matcher and ``plane_cam()`` (376×240) of the JAX package's
``tests/test_real_image.py``, whose gates each package must pass.

Tolerances. SuperPoint on the photo: the same keypoint set, scores within
1e-5 and descriptors within 1e-4 (``test_torch_models``'s extraction
parity). The plane pair: the same valid keypoints, depths within 1e-3 m
(``test_torch_slam``'s frontend parity). The 8-frame sequence (BA on, as
the JAX case runs it): the packages' poses part where their RANSAC
streams differ, so each must pass JAX's gates (initialized, ≥ 5 tracked
frames, ATE < 0.2 m) and their positions lie within ``SLAM_POS_TOL`` of
each other.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import report, to_jax_cfg

from rspl_slam_tpu.config import SuperPointConfig as JSPC
from rspl_slam_tpu.evaluation import absolute_trajectory_error as j_ate
from rspl_slam_tpu.frontend.frontends import NeuralFrontend as JFE
from rspl_slam_tpu.models import superpoint as jsp
from rspl_slam_tpu.slam import SLAMSystem as JSLAM
from rspl_slam_tpu_torch import cli as tcli
from rspl_slam_tpu_torch import png
from rspl_slam_tpu_torch.config import CameraConfig, SuperPointConfig, SystemConfig
from rspl_slam_tpu_torch.datasets import write_tum_trajectory
from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error as t_ate
from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend as TFE
from rspl_slam_tpu_torch.models import superpoint as tsp
from rspl_slam_tpu_torch.models import weights
from rspl_slam_tpu_torch.slam import INIT_POSE
from rspl_slam_tpu_torch.slam import SLAMSystem as TSLAM

PHOTO = os.path.join(os.path.dirname(__file__), "fixtures", "real_photo.jpg")
SP = dict(max_keypoints=300, keypoint_threshold=1e-4)
SLAM_POS_TOL = 1e-3  # m, between the two packages' poses (8.6e-5 measured, CPU run)


def load_photo() -> np.ndarray:
    """The photo through the port's reader: (600, 512) float32 in [0, 1]."""
    return png.read_gray(PHOTO).astype(np.float32) / 255.0


def crop(photo: np.ndarray, oy: float, ox: float, H: int, W: int) -> np.ndarray:
    """Sub-pixel bilinear crop (JAX's ``test_real_image.crop``): a
    fronto-parallel plane seen by a translating camera."""
    ys = np.arange(H, dtype=np.float64) + oy
    xs = np.arange(W, dtype=np.float64) + ox
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    y0 = np.clip(y0, 0, photo.shape[0] - 2)
    x0 = np.clip(x0, 0, photo.shape[1] - 2)
    p00, p01 = photo[np.ix_(y0, x0)], photo[np.ix_(y0, x0 + 1)]
    p10, p11 = photo[np.ix_(y0 + 1, x0)], photo[np.ix_(y0 + 1, x0 + 1)]
    return ((1 - fy) * (1 - fx) * p00 + (1 - fy) * fx * p01
            + fy * (1 - fx) * p10 + fy * fx * p11).astype(np.float32)


def plane_cam() -> CameraConfig:
    """JAX's: bf/Z = 16 px at Z = 3 m, a multiple of the 8-px cell."""
    return CameraConfig(image_width=376, image_height=240, fx=300.0, fy=300.0, cx=188.0,
                        cy=120.0, bf=48.0, depth_upper_thr=20.0)


def _sp_params():
    return jax.tree_util.tree_map(np.array, jsp.init_params(jax.random.PRNGKey(0)))


def _frontends(cfg):
    """(JAX, port) frontends on ``cfg``: cosine matcher, eager, f32, the
    same SuperPoint weights."""
    sp = _sp_params()
    jfe = JFE(to_jax_cfg(cfg), sp_params=sp, matcher="cosine", lazy_right=False,
              compute_dtype=jnp.float32)
    tfe = TFE(cfg, sp_params=sp, matcher="cosine", lazy_right=False,
              compute_dtype=torch.float32, device="cpu")
    return jfe, tfe


def _plane_cfg():
    return SystemConfig(superpoint=SuperPointConfig(**SP), camera=plane_cam(), use_lines=False)


def test_keypoints_on_real_photo():
    """SuperPoint on the whole photo (600 × 512) in both packages: JAX's
    gates on each (≥ 200 keypoints, in bounds, spread, unit descriptors)
    and the same keypoints, scores and descriptors."""
    photo = load_photo()
    params = _sp_params()
    fj = jsp.extract(params, jnp.asarray(photo[None]), JSPC(**SP), jnp.float32)
    ft = tsp.extract(weights.superpoint_from_numpy(params, "cpu"), torch.from_numpy(photo[None]),
                     SuperPointConfig(**SP), torch.float32)
    vj, vt = np.asarray(fj.valid[0]), ft.valid[0].numpy()
    xj, xt = np.asarray(fj.xy[0])[vj], ft.xy[0].numpy()[vt]
    for v, xy, desc in ((vj, xj, np.asarray(fj.desc[0])[vj]), (vt, xt, ft.desc[0].numpy()[vt])):
        assert v.sum() >= 200, int(v.sum())
        assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 512).all()
        assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 600).all()
        assert xy[:, 0].std() > 60 and xy[:, 1].std() > 60
        np.testing.assert_allclose(np.linalg.norm(desc, axis=1), 1.0, atol=1e-3)
    kj = {tuple(p): i for i, p in enumerate(xj)}
    kt = {tuple(p): i for i, p in enumerate(xt)}
    assert kj.keys() == kt.keys()
    ij, it = [kj[k] for k in kj], [kt[k] for k in kj]
    sj, st = np.asarray(fj.score[0])[vj][ij], ft.score[0].numpy()[vt][it]
    report("real_photo_keypoints", n=len(kj), score_max_diff=float(np.abs(sj - st).max()))
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ft.desc[0].numpy()[vt][it], np.asarray(fj.desc[0])[vj][ij],
                               rtol=0, atol=1e-4)


def test_stereo_pair_recovers_plane_depth():
    """A real-texture stereo pair of a plane at Z = 3 m: in both packages
    ≥ 60 depths with their median within 0.3 m of 3 m (JAX's gate); the
    same valid keypoints and stereo depths within 1e-3 m."""
    cfg = _plane_cfg()
    Z = 3.0
    disp = cfg.camera.bf / Z
    photo = load_photo()
    left = crop(photo, 120.0, 70.0, 240, 376)
    right = crop(photo, 120.0, 70.0 + disp, 240, 376)
    jfe, tfe = _frontends(cfg)
    fj = jfe.extract_pair(left, right)
    ft = tfe.extract_pair(left, right)
    for ff in (fj, ft):
        d = ff.depth[ff.depth > 0]
        assert len(d) >= 60, len(d)
        assert abs(float(np.median(d)) - Z) < 0.3, float(np.median(d))
    np.testing.assert_array_equal(ft.valid, fj.valid)
    np.testing.assert_array_equal(ft.depth > 0, fj.depth > 0)
    report("real_photo_plane_depth", median_port=float(np.median(ft.depth[ft.depth > 0])),
           median_jax=float(np.median(fj.depth[fj.depth > 0])),
           depth_max_diff=float(np.abs(ft.depth - fj.depth).max()))
    np.testing.assert_allclose(ft.depth, fj.depth, rtol=0, atol=1e-3)


def test_slam_tracks_real_texture_sequence():
    """``SLAMSystem`` (BA on, the default) over 8 real-texture frames with
    known translation, in both packages: each initializes, tracks ≥ 5
    frames with > 20 inliers and has ATE < 0.2 m (JAX's gates); their
    positions lie within ``SLAM_POS_TOL``."""
    cfg = _plane_cfg()
    cam = cfg.camera
    Z = 3.0
    disp = cam.bf / Z
    photo = load_photo()
    N = 8
    dx_m, dy_m = np.linspace(0, 0.28, N), np.linspace(0, 0.12, N)
    traj = np.tile(np.eye(4), (N, 1, 1))
    traj[:, 0, 3], traj[:, 1, 3] = dx_m, dy_m
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    jfe, tfe = _frontends(cfg)
    systems = {"jax": JSLAM(to_jax_cfg(cfg), jfe), "port": TSLAM(cfg, tfe)}
    for i in range(N):
        ox = 60.0 + cam.fx * dx_m[i] / Z
        oy = 100.0 + cam.fy * dy_m[i] / Z
        left = crop(photo, oy, ox, 240, 376)
        right = crop(photo, oy, ox + disp, 240, 376)
        for slam in systems.values():
            slam.add_frame(i, i * 0.05, left, right)
    est, ate = {}, {}
    for name, slam in systems.items():
        assert slam.initialized, f"{name}: init failed on real texture"
        inliers = [r.num_inliers for r in slam.records[1:]]
        assert sum(1 for n in inliers if n > 20) >= 5, (name, inliers)
        est[name] = np.stack([r.Twc for r in slam.records])
        ts = np.asarray([r.time for r in slam.records])
        fn = j_ate if name == "jax" else t_ate
        ate[name] = fn(ts, est[name][:, :3, 3], ts, gt[:, :3, 3])["rmse"]
        assert ate[name] < 0.2, (name, ate[name])
    dist = float(np.abs(est["port"][:, :3, 3] - est["jax"][:, :3, 3]).max())
    report("real_photo_slam", ate_port=ate["port"], ate_jax=ate["jax"], position_max_diff_m=dist)
    assert dist < SLAM_POS_TOL, dist


def _photo_tree(tmp_path):
    """JAX's one-command case on disk: 10 stereo crops along 0.6 m of x as
    an EuRoC-layout tree (``png.write_png``), the ground truth and a config
    with the plane camera. Returns (sequence dir, gt file, config file)."""
    cam = plane_cam()
    Z = 3.0
    disp = cam.bf / Z
    photo = load_photo()
    d = tmp_path / "seq"
    N = 10
    dx_m = np.linspace(0, 0.6, N)
    times = 1400000000 * 10**9 + np.arange(N, dtype=np.int64) * 50000000
    gt = np.tile(np.eye(4), (N, 1, 1))
    gt[:, 0, 3] = dx_m
    for i in range(N):
        ox = 40.0 + cam.fx * dx_m[i] / Z
        for sub, oxe in (("cam0", ox), ("cam1", ox + disp)):
            img = crop(photo, 100.0, oxe, 240, 376)
            png.write_png(str(d / sub / "data" / f"{int(times[i])}.png"),
                          (img * 255).astype(np.uint8))
    gt_file = str(tmp_path / "gt.tum")
    write_tum_trajectory(gt_file, times * 1e-9, np.einsum("ij,njk->nik", INIT_POSE, gt))
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(
        "superpoint:\n  max_keypoints: 300\n  keypoint_threshold: 0.0001\n"
        "keyframe:\n  max_distance: 0.15\n"
        f"image_width: {cam.image_width}\nimage_height: {cam.image_height}\n"
        f"bf: {cam.bf}\ndepth_upper_thr: 20.0\n"
        "LEFT.P:\n"
        f"  data: [{cam.fx}, 0, {cam.cx}, 0, 0, {cam.fy}, {cam.cy}, 0, 0, 0, 1, 0]\n")
    return d, gt_file, str(cfg_file)


def _run_args(d, cfg_file, *extra):
    return ["run", "--dataroot", str(d), "--config", cfg_file, "--camera-config", cfg_file,
            "--matcher", "cosine", "--no-lines", "--device", "cpu", *extra]


def test_one_command_yields_ate(tmp_path, capsys):
    """JAX's one-command case through the port's CLI on the CPU: a
    real-image EuRoC-layout tree, then ``run --dataroot ... --gt ...`` with
    the native prefetcher (the default) and with ``--no-native``. Each
    prints ATE with n ≥ 3 and rmse < 0.3 m (JAX's gate); with no
    rectification maps both routes read the same 8-bit frames, so the two
    trajectories are equal."""
    d, gt_file, cfg_file = _photo_tree(tmp_path)
    res, trajs = {}, {}
    for route, extra in (("native", []), ("no_native", ["--no-native"])):
        traj = str(tmp_path / f"est_{route}.tum")
        capsys.readouterr()
        tcli.main(_run_args(d, cfg_file, "--traj-path", traj, "--gt", gt_file, *extra))
        out = capsys.readouterr().out
        assert ("using native prefetcher" in out.splitlines()) == (route == "native"), out
        line = [ln for ln in out.splitlines() if ln.startswith("ATE:")][0]
        res[route] = json.loads(line[4:])
        with open(traj) as f:
            trajs[route] = f.read()
    with capsys.disabled():
        report("real_photo_cli", **{k: v["rmse"] for k, v in res.items()})
    for r in res.values():
        assert r["n"] >= 3, r
        assert r["rmse"] < 0.3, r
    assert trajs["native"] == trajs["no_native"]


def test_broken_frame_raises_in_run(tmp_path):
    """A truncated frame in the tree: ``run`` with the native prefetcher
    raises IOError naming the frame (the decode thread's failure reaches
    the caller; the runner does not wait for frames that never come)."""
    d, _, cfg_file = _photo_tree(tmp_path)
    bad = sorted((d / "cam1" / "data").iterdir())[4]
    bad.write_bytes(bad.read_bytes()[:100])
    with pytest.raises(IOError, match="frame 4"):
        tcli.main(_run_args(d, cfg_file, "--traj-path", str(tmp_path / "est.tum")))
