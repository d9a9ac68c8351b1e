"""Parity of the port's geometry, camera and tracking solvers with the JAX
package on the same numpy inputs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (one torch thread)

from rspl_slam_tpu import camera as jcam
from rspl_slam_tpu import config as jcfg
from rspl_slam_tpu.backend import pnp as jpnp
from rspl_slam_tpu.backend import pose_solver as jps
from rspl_slam_tpu.backend.residuals import CameraIntrinsics as JK
from rspl_slam_tpu.geometry import linalg as jlin
from rspl_slam_tpu.geometry import se3 as jse3
from rspl_slam_tpu.geometry import triangulation as jtri
from rspl_slam_tpu_torch import camera as tcam
from rspl_slam_tpu_torch import config as tcfg
from rspl_slam_tpu_torch.backend import pnp as tpnp
from rspl_slam_tpu_torch.backend import pose_solver as tps
from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics as TK
from rspl_slam_tpu_torch.geometry import linalg as tlin
from rspl_slam_tpu_torch.geometry import se3 as tse3
from rspl_slam_tpu_torch.geometry import triangulation as ttri

ATOL = 1e-5  # f32 closed forms evaluated in another order


def _j(fn, *a):
    return np.asarray(fn(*[jnp.asarray(x) for x in a]))


def _t(fn, *a):
    return fn(*[torch.from_numpy(np.array(x)) for x in a]).numpy()


def _random_poses(rng, n):
    xi = np.concatenate([rng.normal(0, 0.8, (n, 3)), rng.normal(0, 2.0, (n, 3))], 1)
    return np.asarray(jse3.exp_se3(jnp.asarray(xi, jnp.float32)))


@pytest.mark.parametrize("name", ["exp_so3", "exp_se3", "log_so3", "log_se3",
                                  "inverse", "quat_from_rot", "rot_from_quat"])
def test_se3_matches_jax(name):
    rng = np.random.default_rng(0)
    T = _random_poses(rng, 64)
    xi = np.concatenate([rng.normal(0, 0.8, (64, 3)), rng.normal(0, 2, (64, 3))],
                        1).astype(np.float32)
    xi[:4] *= 1e-7  # the small-angle branches
    arg = {"exp_so3": xi[:, :3], "exp_se3": xi, "log_so3": T[:, :3, :3],
           "log_se3": T, "inverse": T, "quat_from_rot": T[:, :3, :3],
           "rot_from_quat": rng.normal(size=(64, 4)).astype(np.float32)}[name]
    np.testing.assert_allclose(_t(getattr(tse3, name), arg),
                               _j(getattr(jse3, name), arg), atol=ATOL)


def test_linalg_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(32, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32)
    S = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    M = rng.normal(size=(16, 6, 6)).astype(np.float32)
    spd = M @ M.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    g = rng.normal(size=(16, 6)).astype(np.float32)
    np.testing.assert_allclose(_t(tlin.inv3, A), _j(jlin.inv3, A), atol=ATOL)
    np.testing.assert_allclose(_t(tlin.solve3, A, b), _j(jlin.solve3, A, b), atol=ATOL)
    np.testing.assert_allclose(_t(tlin.eigvalsh3, S), _j(jlin.eigvalsh3, S),
                               atol=ATOL * np.abs(_j(jlin.eigvalsh3, S)).max())
    np.testing.assert_allclose(_t(tlin.solve_spd, spd, g), _j(jlin.solve_spd, spd, g),
                               atol=ATOL)


def test_triangulation_matches_jax():
    """Batched port vs the vmapped JAX function: identical acceptance, and
    points within 1e-5 of their distance (f32 solves of a 3×3 normal system
    whose rays span ~10-40°; narrower rays amplify f32 rounding by the
    system's condition number in both packages alike)."""
    rng = np.random.default_rng(2)
    n, m = 64, 6
    X = rng.uniform([-2, -2, 3], [2, 2, 6], (n, 3))
    Twc = np.tile(np.eye(4), (n, m, 1, 1))
    Twc[..., :3, 3] = rng.normal(0, 1.0, (n, m, 3))
    Twc[:8, :, :3, 3] *= 1e-3  # no parallax → rejected
    Xc = X[:, None] - Twc[..., :3, 3]
    uvn = (Xc[..., :2] / Xc[..., 2:] + rng.normal(0, 1e-3, (n, m, 2))).astype(np.float32)
    mask = rng.random((n, m)) < 0.8
    mask[:, :2] = True
    Twc = Twc.astype(np.float32)
    pj, okj = jax.vmap(jtri.triangulate_point_multiview)(
        jnp.asarray(Twc), jnp.asarray(uvn), jnp.asarray(mask))
    pt, okt = ttri.triangulate_point_multiview(
        torch.from_numpy(Twc), torch.from_numpy(uvn), torch.from_numpy(mask))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    assert ok.sum() > 40
    pj = np.asarray(pj)[ok]
    err = np.linalg.norm(pt.numpy()[ok] - pj, axis=-1)
    assert (err <= ATOL * np.linalg.norm(pj, axis=-1)).all(), err.max()


def test_remap_and_rectify_maps_match_jax():
    """Bilinear remap with the JAX border clamp (maps reaching outside the
    image) and the copied rectification-map builder."""
    rng = np.random.default_rng(3)
    img = rng.random((2, 30, 40)).astype(np.float32)
    maps = np.stack(np.meshgrid(np.arange(40.0), np.arange(30.0)), -1)[None].repeat(2, 0)
    maps = (maps + rng.normal(0, 3.0, maps.shape)).astype(np.float32)
    ref = np.asarray(jax.vmap(jcam.remap_bilinear)(jnp.asarray(img), jnp.asarray(maps)))
    out = tcam.remap_bilinear(torch.from_numpy(img), torch.from_numpy(maps)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    yaml = os.path.join(os.path.dirname(__file__), "..", "configs", "euroc.yaml")
    cj = jcfg.load_camera_config(yaml)
    ct = tcfg.load_camera_config(yaml)
    for side in ("left", "right"):
        np.testing.assert_array_equal(tcam.build_rectify_maps(ct, side),
                                      jcam.build_rectify_maps(cj, side))


def _tracking_problem(seed=0, n=120, outlier_frac=0.3):
    """A camera 0.1 m / ~3° off its prior, 30% gross outliers."""
    rng = np.random.default_rng(seed)
    cam = tcfg.CameraConfig()
    K = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    Twc_true = np.asarray(jse3.exp_se3(jnp.asarray([0.03, -0.04, 0.02, 0.1, -0.05, 0.08])),
                          np.float64)
    Xc = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 9, n)], -1)
    Xw = Xc @ Twc_true[:3, :3].T + Twc_true[:3, 3]
    u = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx
    v = cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy
    uv = np.stack([u, v], -1) + rng.normal(0, 0.5, (n, 2))
    out = rng.random(n) < outlier_frac
    uv[out] = rng.uniform([0, 0], [cam.image_width, cam.image_height], (out.sum(), 2))
    ur = u - cam.bf / Xc[:, 2] + rng.normal(0, 0.5, n)
    stereo = rng.random(n) < 0.5
    meas = np.stack([uv[:, 0], uv[:, 1], np.where(stereo, ur, 0.0)], -1)
    valid = np.ones(n, bool)
    valid[-10:] = False
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return K, Twc_true, f(np.eye(4)), f(Xw), f(uv), f(meas), stereo, valid, ~out


def test_gn_refine_matches_jax():
    """Same start, same weights: translation within 1e-4."""
    K, _, Twc0, Xw, uv, _, _, valid, inl = _tracking_problem()
    w = (valid & inl).astype(np.float32)
    Tj = np.asarray(jpnp._gn_refine(JK(*K), jse3.inverse(jnp.asarray(Twc0)),
                                    jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(w), 5))
    Tt = tpnp._gn_refine(TK(*K), tse3.inverse(torch.from_numpy(Twc0)), torch.from_numpy(Xw),
                         torch.from_numpy(uv), torch.from_numpy(w), 5).numpy()
    np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], atol=1e-4)
    np.testing.assert_allclose(Tt[:3, :3], Tj[:3, :3], atol=1e-4)


def test_optimize_pose_matches_jax():
    """4 rounds × 10 LM iterations from the same initial pose, with
    outliers to gate: translation within 1e-4, same inlier set."""
    K, Twc_true, Twc0, Xw, _, meas, stereo, valid, _ = _tracking_problem(1)
    rj = jps.optimize_pose(JK(*K), jnp.asarray(Twc0), jnp.asarray(Xw), jnp.asarray(meas),
                           jnp.asarray(stereo), jnp.asarray(valid))
    t = torch.from_numpy
    rt = tps.optimize_pose(TK(*K), t(Twc0), t(Xw), t(meas), t(stereo), t(valid))
    Tj = np.linalg.inv(np.asarray(rj.Tcw, np.float64))
    Tt = np.linalg.inv(rt.Tcw.numpy().astype(np.float64))
    np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], atol=1e-4)
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert np.linalg.norm(Tt[:3, 3] - Twc_true[:3, 3]) < 0.01


def test_pnp_ransac_outcome_matches_jax():
    """The two RANSACs draw different subsets (jax.random vs a torch
    Generator), so they are held by outcome: both recover the pose within
    2 cm and 0.01 rad, and their inlier sets agree on ≥ 95% of slots."""
    K, Twc_true, Twc0, Xw, uv, _, _, valid, _ = _tracking_problem(2)
    rj = jpnp.pnp_ransac(JK(*K), jnp.asarray(Twc0), jnp.asarray(Xw), jnp.asarray(uv),
                         jnp.asarray(valid), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    t = torch.from_numpy
    rt = tpnp.pnp_ransac(TK(*K), t(Twc0), t(Xw), t(uv), t(valid), gen)
    assert bool(rj.ok) and bool(rt.ok)
    for Tcw in (np.asarray(rj.Tcw, np.float64), rt.Tcw.numpy().astype(np.float64)):
        Twc = np.linalg.inv(Tcw)
        assert np.linalg.norm(Twc[:3, 3] - Twc_true[:3, 3]) < 0.02
        dR = Twc[:3, :3].T @ Twc_true[:3, :3]
        assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 0.01
    agree = (rt.inlier.numpy() == np.asarray(rj.inlier)).mean()
    assert agree >= 0.95, agree
