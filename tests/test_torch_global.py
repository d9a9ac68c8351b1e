"""The rest of the port's global layer against the JAX package:
local-map tracking (``track_local_map``), the epipolar match filter
(``match_outlier_rejection``, fed JAX's own hypothesis draws) in
``ops.matching`` and through ``NeuralFrontend``, and the routing both
packages derive from these options.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_epipolar import two_view_matches
from test_local_map_tracking import DroppyOracle as JDroppy
from test_torch_common import (frontend_pair, rendered_sequence, report, small_system_cfg,
                               to_jax_cfg)

from rspl_slam_tpu.config import KeyframeConfig as JKf
from rspl_slam_tpu.config import PipelineConfig as JPipe
from rspl_slam_tpu.config import SuperPointConfig as JSP
from rspl_slam_tpu.config import SystemConfig as JCfg
from rspl_slam_tpu.evaluation import synthetic as jsynth
from rspl_slam_tpu.frame_step import CombinedTracker as JCombined
from rspl_slam_tpu.ops.matching import fundamental_ransac_inliers as j_frans
from rspl_slam_tpu.slam import SLAMSystem as JSLAM
from rspl_slam_tpu_torch.config import KeyframeConfig, PipelineConfig, SuperPointConfig, SystemConfig
from rspl_slam_tpu_torch.evaluation import synthetic
from rspl_slam_tpu_torch.frame_step import CombinedTracker
from rspl_slam_tpu_torch.frontend.frontends import OracleFrontend
from rspl_slam_tpu_torch.ops.matching import fundamental_ransac_inliers, sample_hypotheses
from rspl_slam_tpu_torch.slam import SLAMSystem


# ---------------------------------------------------------- local-map tracking
class Droppy(OracleFrontend):
    """The port's oracle frontend losing ``drop_frac`` of its true matches,
    on the same numpy stream as ``tests/test_local_map_tracking.py``'s."""

    def __init__(self, *a, drop_frac=0.3, **kw):
        super().__init__(*a, **kw)
        self.drop_frac = drop_frac
        self._drop_rng = np.random.default_rng(99)

    def match(self, fA, fB):
        i0 = super().match(fA, fB)
        drop = (i0 >= 0) & (self._drop_rng.random(len(i0)) < self.drop_frac)
        return np.where(drop, -1, i0)


def _droppy_run(pkg, n_frames=30, seed=0):
    """``tests/test_local_map_tracking.py``'s run (BA on) in one package,
    recording each keyframe's recovered (keypoint, landmark) pairs."""
    kw = dict(superpoint=SuperPointConfig(max_keypoints=256),
              pipeline=PipelineConfig(ba_max_points=768, ba_max_lines=16,
                                      track_local_map=True),
              keyframe=KeyframeConfig(max_num_match=120), use_lines=False)
    if pkg == "port":
        cfg = SystemConfig(**kw)
        scene = synthetic.make_scene(num_points=800, seed=seed, extent=(10.0, 6.0, 16.0))
        fe = Droppy(cfg, scene, noise_px=0.4, outlier_frac=0.05, seed=seed, device="cpu")
        slam = SLAMSystem(cfg, fe)
        traj = synthetic.make_trajectory(n_frames, step=0.05, yaw_rate=0.003)
    else:
        cfg = JCfg(superpoint=JSP(max_keypoints=256),
                   pipeline=JPipe(ba_max_points=768, ba_max_lines=16, track_local_map=True),
                   keyframe=JKf(max_num_match=120), use_lines=False)
        scene = jsynth.make_scene(num_points=800, seed=seed, extent=(10.0, 6.0, 16.0))
        fe = JDroppy(cfg, scene, noise_px=0.4, outlier_frac=0.05, seed=seed)
        slam = JSLAM(cfg, fe)
        traj = jsynth.make_trajectory(n_frames, step=0.05, yaw_rate=0.003)
    fe.poses = traj
    recovered = []
    assoc = slam._associate_local_map

    def recording(kf, matched_pts):
        out = assoc(kf, matched_pts)
        recovered.append((kf, sorted((int(k), int(p)) for p, k in out)))
        return out

    slam._associate_local_map = recording
    for i in range(n_frames):
        slam.add_frame(i, i * 0.05, None, None)
    slam.flush_ba()
    return slam, recovered


def test_track_local_map_recovers_as_jax():
    """The DroppyOracle scenario (30% of true matches dropped, BA on):
    the same keyframes, the same re-associations proposed at each of them
    (≥ 98% of the (keyframe, keypoint, landmark) triples shared: BA's f32
    sums and PnP's random streams differ between the packages, so a
    borderline projection may fall either side of a gate), landmarks and
    observation counts within 1%."""
    (ts, tr), (js, jr) = _droppy_run("port"), _droppy_run("jax")
    tset = {(kf, k, p) for kf, pairs in tr for k, p in pairs}
    jset = {(kf, k, p) for kf, pairs in jr for k, p in pairs}
    shared = len(tset & jset) / max(len(tset | jset), 1)
    report("track_local_map", keyframes=[ts.map.n_kf, js.map.n_kf],
           proposals=[len(tset), len(jset)], shared=shared, n_pt=[ts.map.n_pt, js.map.n_pt])
    assert [k for k, _ in tr] == [k for k, _ in jr] and ts.map.n_kf == js.map.n_kf
    assert len(jset) > 0 and shared >= 0.98
    assert abs(ts.map.n_pt - js.map.n_pt) <= 0.01 * js.map.n_pt
    obs_t = ts.map.pt_obs_n[: ts.map.n_pt].sum()
    obs_j = js.map.pt_obs_n[: js.map.n_pt].sum()
    assert abs(obs_t - obs_j) <= 0.01 * obs_j


# ------------------------------------------------------------ epipolar filter
def _jax_hypotheses(key, matched, iters=128):
    """The (iters, 8) indices JAX's ``fundamental_ransac_inliers`` draws
    from ``key``: Gumbel-top-8 over the matched rows per split key."""
    K = matched.shape[0]
    logits = jnp.where(jnp.asarray(matched), 0.0, -1e9)
    keys = jax.random.split(key, iters)
    idx = jax.vmap(lambda k: jax.lax.top_k(logits + jax.random.gumbel(k, (K,)), 8)[1])(keys)
    return torch.tensor(np.array(idx), dtype=torch.int64)


@pytest.mark.parametrize("seed,n_bad,drop", [(0, 30, 0), (3, 24, 7), (1, 0, 3)])
def test_fundamental_ransac_matches_jax(seed, n_bad, drop):
    """Planted two-view matches (``tests/test_epipolar.py``; ``n_bad``
    scrambled, every ``drop``-th row unmatched): fed the hypotheses JAX
    draws, the port keeps exactly JAX's inliers; with its own generator it
    passes ``tests/test_epipolar.py``'s gates (< 15% of the scrambles kept,
    > 90% of the epipolar-consistent rows) and keeps no unmatched row."""
    p0, p1, bad = two_view_matches(n_bad=n_bad, seed=seed)
    matched = np.ones(len(p0), bool)
    if drop:
        matched[::drop] = False
    key = jax.random.PRNGKey(seed)
    okj = np.asarray(j_frans(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(matched), key))
    args = (torch.tensor(p0), torch.tensor(p1), torch.tensor(matched))
    okt = fundamental_ransac_inliers(*args, hypotheses=_jax_hypotheses(key, matched)).numpy()
    own = fundamental_ransac_inliers(*args, torch.Generator().manual_seed(seed)).numpy()
    good = np.setdiff1d(np.arange(len(p0)), bad)
    report(f"fundamental_ransac_{seed}", kept=[int(okt.sum()), int(okj.sum()), int(own.sum())],
           differ=int((okt != okj).sum()))
    np.testing.assert_array_equal(okt, okj)
    if n_bad:
        assert own[bad].mean() < 0.15
    assert own[good][matched[good]].mean() > 0.9
    assert not own[~matched].any()


def test_fundamental_ransac_underconstrained_and_hypotheses():
    """Fewer than 8 matches pass through unchanged; the port's draws are 8
    distinct matched rows per hypothesis."""
    p0, p1, _ = two_view_matches(n=8, n_bad=0)
    matched = np.zeros(8, bool)
    matched[:5] = True
    ok = fundamental_ransac_inliers(torch.tensor(p0), torch.tensor(p1), torch.tensor(matched),
                                    torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(ok.numpy(), matched)
    m = torch.zeros(50, dtype=torch.bool)
    m[::3] = True
    h = sample_hypotheses(m, torch.Generator().manual_seed(0))
    assert h.shape == (128, 8) and bool(m[h].all())
    assert all(len(set(row.tolist())) == 8 for row in h)


class _JaxDraws:
    """Replays the JAX frontend's key sequence (``PRNGKey(seed + 7)``, one
    split per match) as the port frontend's hypothesis source."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed + 7)

    def __call__(self, matched):
        self.key, k = jax.random.split(self.key)
        return _jax_hypotheses(k, matched.numpy())


def _orej_cfg(**pipe):
    cfg = small_system_cfg()
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, match_outlier_rejection=True, **pipe))


def test_frontend_with_epipolar_filter_matches_jax():
    """``NeuralFrontend`` with ``match_outlier_rejection`` on two rendered
    320×240 frames (f32, 2 layers), the port fed JAX's draws: the stereo
    association of ``extract_pair`` (the filtered left↔right match) and the
    temporal ``match`` equal JAX's; the filter removed matches the plain
    matcher keeps."""
    cfg = _orej_cfg()
    frames, _ = rendered_sequence(cfg, 4)
    jfe, tfe = frontend_pair(cfg)
    tfe._orej_hypotheses = _JaxDraws()
    fj = [jfe.extract_pair(*frames[i]) for i in (0, 3)]
    ft = [tfe.extract_pair(*frames[i]) for i in (0, 3)]
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a.meas[:, 2] > 0, b.meas[:, 2] > 0)
        np.testing.assert_allclose(a.meas[:, 2], b.meas[:, 2], atol=1e-3)
    it, ij = tfe.match(ft[1], ft[0]), jfe.match(fj[1], fj[0])
    tfe._orej = False  # the same matcher without the filter
    ip = tfe.match(ft[1], ft[0])
    tfe._orej = True
    report("frontend_epipolar", temporal=[int((it >= 0).sum()), int((ij >= 0).sum())],
           plain=int((ip >= 0).sum()), stereo=int((ft[0].meas[:, 2] > 0).sum()))
    np.testing.assert_array_equal(it, ij)
    assert (it >= 0).sum() > 50 and (it >= 0).sum() < (ip >= 0).sum()


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_epipolar_routing_matches_jax(lazy):
    """With the filter on, both packages turn fused tracking off and the
    lazy schedule's combined frame step reports itself unsupported; with it
    off, both keep them on."""
    for orej in (False, True):
        cfg = small_system_cfg()
        cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, match_outlier_rejection=orej, lazy_right_extraction=lazy))
        jfe, tfe = frontend_pair(cfg)
        js, ts = JSLAM(to_jax_cfg(cfg), jfe, enable_ba=False), SLAMSystem(cfg, tfe,
                                                                           enable_ba=False)
        assert ts._fused_enabled == js._fused_enabled == (not orej)
        if lazy:
            jc = JCombined(jfe, js.K, 50.0, 75.0).supported(None)
            tc = CombinedTracker(tfe, ts.K, 50.0, 75.0).supported()
            assert tc == jc == (not orej)

