"""The port's frontend and SLAM slice against the JAX package, plus the
port's ground rules: no JAX import, the card as default device, unported
configurations raise."""

import ast
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import matcher_weights, rendered_sequence, small_system_cfg, to_jax_cfg

from rspl_slam_tpu.frontend.frontends import NeuralFrontend as JFE
from rspl_slam_tpu.slam import SLAMSystem as JSLAM
from rspl_slam_tpu_torch.datasets import write_tum_trajectory
from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend as TFE
from rspl_slam_tpu_torch.slam import SLAMSystem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rspl_slam_tpu_torch")


def _frontends(cfg):
    sp, sg = matcher_weights(cfg)
    jfe = JFE(to_jax_cfg(cfg), sp_params=sp, sg_params=sg, compute_dtype=jnp.float32)
    tfe = TFE(cfg, sp_params=sp, sg_params=sg, compute_dtype=torch.float32, device="cpu")
    return jfe, tfe


def test_extract_pair_matches_jax():
    """One rendered 320×240 pair through both eager frontends (f32, the
    descriptor-matcher SuperGlue with 2 layers): the same keypoints, the
    same stereo associations, uR and depth to 1e-3."""
    cfg = small_system_cfg()
    frames, _ = rendered_sequence(cfg, 1)
    jfe, tfe = _frontends(cfg)
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
    jfe, tfe = _frontends(cfg)
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
    jfe, tfe = _frontends(cfg)
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


@pytest.mark.parametrize("what", ["use_lines", "enable_ba", "lazy_right",
                                  "match_outlier_rejection", "loop_closure"])
def test_unported_configurations_raise(what):
    cfg = small_system_cfg()
    fe = TFE(cfg, device="cpu")
    pipe = cfg.pipeline
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "use_lines":
            TFE(dataclasses.replace(cfg, use_lines=True), device="cpu")
        elif what == "enable_ba":
            SLAMSystem(cfg, fe)
        elif what == "lazy_right":
            TFE(dataclasses.replace(cfg, pipeline=dataclasses.replace(
                pipe, lazy_right_extraction=True)), device="cpu")
        elif what == "match_outlier_rejection":
            SLAMSystem(dataclasses.replace(cfg, pipeline=dataclasses.replace(
                pipe, match_outlier_rejection=True)), fe, enable_ba=False)
        else:
            SLAMSystem(cfg, fe, enable_ba=False, enable_loop_closure=True)
