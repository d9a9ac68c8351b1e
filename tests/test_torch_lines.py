"""The port's line pipeline against the JAX package's: the Hough detector,
the host merge / filter / assign / match steps, and the frontend's line
extraction, on the same numpy inputs.

The detector computes what XLA's CPU backend computes (its FMAs, its
reciprocals of constants, its order of summation), but atan2, sin and cos
are XLA's own and can differ from torch's by an ulp, so a refined line could
put an inlier pixel into the neighbouring projection bin. Its outputs are
held as sets: the same number of valid segments, each with a counterpart
on the other side whose endpoints (in either order) lie within one
projection bin, 2·hypot(H, W) / num_bins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_rcf_lines import _noisy_edge_map
from test_torch_common import (edge_weights, matcher_weights, rendered_sequence, report,
                               segment_set_distance, small_system_cfg, to_jax_cfg)

from rspl_slam_tpu.frontend.frontends import NeuralFrontend as JFE
from rspl_slam_tpu.ops import lines as jl
from rspl_slam_tpu.training import rcf_train
from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend as TFE
from rspl_slam_tpu_torch.ops import lines as tl


def _assert_same_segments(a, b, tol):
    """Returns the worst endpoint distance, for the report."""
    assert len(a) == len(b)
    worst = max(segment_set_distance(a, b).max(initial=0.0),
                segment_set_distance(b, a).max(initial=0.0))
    assert worst <= tol
    return float(worst)


def _noisy_map(seed):
    rng = np.random.default_rng(seed)
    _, gt, _ = rcf_train.render_edge_scene(rng, 240, 320, n_rects=2, noise=0.0)
    return _noisy_edge_map(gt, rng, n_blobs=10).astype(np.float32)


def _tie_map(seed, H=120, W=188):
    """30% of the pixels and two long lines at exactly 1.0: more tied
    edge pixels than the top-E budget, and tied Hough peaks."""
    rng = np.random.default_rng(seed)
    e = np.zeros((H, W), np.float32)
    e[rng.uniform(size=(H, W)) < 0.3] = 1.0
    e[30, 10:150] = 1.0
    e[10:100, 60] = 1.0
    return e


# the noisy maps of test_rcf_lines.py under two detector settings, and tie maps
CASES = [("noisy", 0, dict(max_segments=48, min_length=25.0, edge_threshold=0.3)),
         ("noisy", 1, dict(max_segments=128, inlier_dist=1.414213562)),
         ("ties", 0, dict(max_segments=128)),
         ("ties", 1, dict(max_segments=128))]


@pytest.mark.parametrize("kind,seed,kw", CASES)
def test_detect_line_segments_matches_jax(kind, seed, kw):
    edge = _noisy_map(seed) if kind == "noisy" else _tie_map(seed)
    js, jv, _ = (np.asarray(a) for a in jl.detect_line_segments(jnp.asarray(edge), **kw))
    ts, tv, tlen = tl.detect_line_segments(torch.from_numpy(edge), **kw)
    ts, tv = ts.numpy(), tv.numpy()
    assert tv.sum() > 10
    bin_px = 2 * np.hypot(*edge.shape) / 256
    worst = _assert_same_segments(ts[tv], js[jv], bin_px + 1e-3)
    moved = int((segment_set_distance(ts[tv], js[jv]) > 1e-3).sum())
    report("detect_line_segments", case=f"{kind}-{seed}", segments=int(tv.sum()),
           moved=moved, worst_in_bins=worst / bin_px)
    assert (np.diff(tlen.numpy()[tv]) <= 0).all()  # longest first


def test_detect_batches_the_pair():
    """Two maps in one call give each map's own result, bit for bit."""
    e = np.stack([_tie_map(0), _tie_map(1)])
    both = tl.detect_line_segments(torch.from_numpy(e), max_segments=64)
    for b in range(2):
        one = tl.detect_line_segments(torch.from_numpy(e[b]), max_segments=64)
        for x, y in zip(both, one):
            assert torch.equal(x[b], y)


def _random_segments(rng, n):
    """Clusters of near-collinear segments plus loose ones, in pixels."""
    base = rng.uniform(0, 300, (n // 3, 4))
    near = np.repeat(base, 2, 0) + rng.normal(0, 2.0, (2 * (n // 3), 4))
    shifted = near + np.repeat(rng.uniform(-20, 20, (len(near), 1)), 4, 1)
    return np.concatenate([base, shifted, rng.uniform(0, 300, (n - 3 * (n // 3), 4))])


@pytest.mark.parametrize("seed", range(4))
def test_merge_and_filter_match_jax(seed):
    """``merge_lines``'s numpy body (``force_numpy=True``) equals JAX's
    exactly, and the two-pass filter around it; the default C++ merge
    (``native.merge_lines``) gives the same shape within 1e-9 (libm's
    atan/cos/hypot against numpy's may differ in the last bit). The
    row-wise pair merge, on every neighbouring pair: JAX's row-wise merge
    exactly, and its scalar ``merge_two_lines`` to 1e-12."""
    rng = np.random.default_rng(seed)
    segs = _random_segments(rng, 40 + 20 * seed).astype(np.float32)
    for thr in (30.0, 60.0):
        np.testing.assert_array_equal(tl.filter_short_lines(segs, thr),
                                      jl.filter_short_lines(segs, thr))
    for args in ((0.1, 15.0, 30.0), (0.12, 6.0, 25.0)):
        ref = jl.merge_lines(segs, *args, force_numpy=True)
        np.testing.assert_array_equal(tl.merge_lines(segs, *args, force_numpy=True), ref)
        got = tl.merge_lines(segs, *args)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    a, b = segs[:-1].astype(np.float64), segs[1:].astype(np.float64)
    on = np.ones(len(a), bool)
    pairs = tl._merge_two_lines_vec(a, b, on)
    np.testing.assert_array_equal(pairs, jl._merge_two_lines_vec(a, b, on))
    np.testing.assert_allclose(pairs, [jl.merge_two_lines(x, y) for x, y in zip(a, b)],
                               rtol=1e-12, atol=1e-9)
    assert len(tl.merge_lines(segs[:0])) == 0 and tl.merge_lines(segs[:1]).shape == (1, 4)


@pytest.mark.parametrize("seed", range(3))
def test_assign_and_match_match_jax(seed):
    """Point-on-line membership and vote matching equal JAX's exactly."""
    rng = np.random.default_rng(seed)
    segs0 = rng.uniform(0, 200, (30, 4)).astype(np.float32)
    segs1 = segs0 + rng.normal(0, 1.0, segs0.shape).astype(np.float32)
    t = rng.uniform(0, 1, (300, 1))
    which = rng.integers(0, 30, 300)
    xy0 = (segs0[which, :2] * (1 - t) + segs0[which, 2:] * t
           + rng.normal(0, 2.0, (300, 2))).astype(np.float32)
    valid = rng.uniform(size=300) < 0.9
    perm = rng.permutation(300)
    xy1 = np.empty_like(xy0)
    xy1[perm] = xy0 + rng.normal(0, 0.5, xy0.shape).astype(np.float32)
    m0 = tl.assign_points_to_lines(segs0, xy0, valid)
    np.testing.assert_array_equal(m0, jl.assign_points_to_lines(segs0, xy0, valid))
    m1 = tl.assign_points_to_lines(segs1, xy1, valid[np.argsort(perm)])
    matches = np.where(rng.uniform(size=300) < 0.8, perm, -1)
    got = tl.match_lines(m0, m1, matches)
    np.testing.assert_array_equal(got, jl.match_lines(m0, m1, matches))
    assert (got >= 0).sum() > 5


@pytest.mark.parametrize("at_detection_scale", [True, False])
def test_extract_lines_matches_jax(at_detection_scale):
    """The frontend's line extraction on a rendered 320×240 pair (f32, the
    hand-set edge weights), RCF at ×0.5 on the downsampled image (the main
    path) or at full size with the edge map max-pooled down: after the
    merge, the same segments per eye, within one projection bin of the
    ×0.5 map scaled back to full size (3.1 px)."""
    import dataclasses

    cfg = small_system_cfg()
    cfg = dataclasses.replace(cfg, use_lines=True, line_detector=dataclasses.replace(
        cfg.line_detector, rcf_at_detection_scale=at_detection_scale))
    (pair,), _ = rendered_sequence(cfg, 1, num_lines=12)
    sp, sg = matcher_weights(cfg)
    rp = edge_weights()
    jfe = JFE(to_jax_cfg(cfg), sp_params=sp, sg_params=sg, rcf_params=rp,
              compute_dtype=jnp.float32)
    tfe = TFE(cfg, sp_params=sp, sg_params=sg, rcf_params=rp, compute_dtype=torch.float32,
              device="cpu")
    imgs = np.stack(pair)
    ref = jfe._extract_lines(imgs)
    segs, valid = tfe._extract_lines(torch.from_numpy(imgs))
    tol = 2 * 2 * np.hypot(120, 160) / 256 + 1e-3
    worst = []
    for b in range(2):
        got = tfe._host_merge(segs[b][valid[b]].numpy() * 2)
        assert len(got) > 20
        worst.append(_assert_same_segments(got, ref[b], tol))
    report("extract_lines", at_detection_scale=at_detection_scale, worst_px=max(worst))
