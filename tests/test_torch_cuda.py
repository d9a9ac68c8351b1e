"""The port's CUDA kernels against their plain PyTorch versions, and the
paths that run them, on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one. The file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch
from test_torch_common import cuda_device, matcher_weights, rendered_sequence, small_system_cfg  # noqa: F401

from rspl_slam_tpu_torch.ops import attention_cuda, conv_stem_cuda, sinkhorn, sinkhorn_cuda

pytestmark = pytest.mark.cuda


# ragged 16×16 tiles in both directions, and RCF's ×0.5 side-mode shape
@pytest.mark.parametrize("H,W", [(36, 50), (30, 44), (240, 376)])
def test_conv_stem_kernel_matches_plain(cuda_device, H, W):  # noqa: F811
    """K1 (weights packed once) vs its plain version (HWIO weights): one
    bf16 rounding of near-equal f32 sums; the side score in f32 to rtol
    1e-4."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((2, H, W, 64), generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randn((3, 3, 64, 64), generator=g, device=cuda_device) * 0.06
    b = torch.randn((64,), generator=g, device=cuda_device) * 0.1
    sw = torch.randn((64,), generator=g, device=cuda_device)
    wp = conv_stem_cuda.pack_weights(w)
    got = conv_stem_cuda.conv3x3_relu_pool(x, wp, b)
    got_s, side = conv_stem_cuda.conv3x3_relu_pool(x, wp, b, sw)
    ref, side_ref = conv_stem_cuda.conv3x3_relu_pool_plain(x, w, b, sw)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
    assert torch.equal(got, got_s)
    torch.testing.assert_close(side, side_ref, rtol=1e-4, atol=1e-4)


# the lazy schedule's B = 1: SuperPoint conv1b of one eye at 752×480, and
# RCF's stage 1 of one eye at ×0.5
@pytest.mark.parametrize("H,W", [(480, 752), (240, 376)])
def test_conv_stem_kernel_one_image_matches_plain(cuda_device, H, W):  # noqa: F811
    """K1 at B = 1 against its plain version, both modes, at the bounds of
    the B = 2 test."""
    g = torch.Generator(device=cuda_device).manual_seed(H)
    x = torch.rand((1, H, W, 64), generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randn((3, 3, 64, 64), generator=g, device=cuda_device) * 0.06
    b = torch.randn((64,), generator=g, device=cuda_device) * 0.1
    sw = torch.randn((64,), generator=g, device=cuda_device)
    wp = conv_stem_cuda.pack_weights(w)
    got = conv_stem_cuda.conv3x3_relu_pool(x, wp, b)
    got_s, side = conv_stem_cuda.conv3x3_relu_pool(x, wp, b, sw)
    ref, side_ref = conv_stem_cuda.conv3x3_relu_pool_plain(x, w, b, sw)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
    assert torch.equal(got, got_s)
    torch.testing.assert_close(side, side_ref, rtol=1e-4, atol=1e-4)


def _layer(rng, C=256):
    def lin(cin, cout):
        return {"w": (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(cout)).astype(np.float32)}

    m0, m1 = lin(2 * C, 2 * C), lin(2 * C, C)
    m0["bn_scale"] = (1 + 0.2 * rng.standard_normal(2 * C)).astype(np.float32)
    m0["bn_shift"] = (0.1 * rng.standard_normal(2 * C)).astype(np.float32)
    return {**{n: lin(C, C) for n in ("q", "k", "v", "merge")}, "mlp": [m0, m1]}


@pytest.mark.parametrize("cross", [False, True])
def test_superglue_layer_kernel_matches_plain(cuda_device, cross):  # noqa: F811
    """K2 vs its plain version at f32 (summation order only), with a
    partially masked source set and K not a multiple of the tiles."""
    layer = attention_cuda.pack_layer(_layer(np.random.default_rng(1)), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((2, 70, 256), generator=g, device=cuda_device)
    masks = torch.arange(70, device=cuda_device)[None] < torch.tensor(
        [[70], [53]], device=cuda_device)
    got = attention_cuda.superglue_layer(x, masks, layer, cross)
    ref = attention_cuda.superglue_layer_plain(x, masks, layer, cross)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)


# the main path's K = 400 (331 valid keys), ragged K and OIVIO's K = 600
@pytest.mark.parametrize("K,valid", [(400, 331), (48, 40), (301, 250), (600, 577)])
@pytest.mark.parametrize("cross", [False, True])
def test_superglue_layer_bf16_kernel_matches_plain(cuda_device, K, valid, cross):  # noqa: F811
    """K2's tensor-core mode vs its plain version at bf16: |k - p| <=
    2^-8|p| + 4e-3, since an intermediate can round to the other side of a
    bf16 boundary after another f32 summation order."""
    layer = attention_cuda.pack_layer(_layer(np.random.default_rng(2)), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K)
    x = torch.randn((2, K, 256), generator=g, device=cuda_device)
    masks = torch.arange(K, device=cuda_device)[None] < torch.tensor(
        [[K], [valid]], device=cuda_device)
    got = attention_cuda.superglue_layer(x, masks, layer, cross, compute_dtype=torch.bfloat16)
    ref = attention_cuda.superglue_layer_plain(x, masks, layer, cross,
                                               compute_dtype=torch.bfloat16)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=2 ** -8, atol=4e-3)


def test_superglue_layer_bf16_refuses_what_it_does_not_take(cuda_device):  # noqa: F811
    """Shapes, types and scratch the bf16 kernel cannot take raise."""
    layer = attention_cuda.pack_layer(_layer(np.random.default_rng(0)), cuda_device)
    bf16 = torch.bfloat16

    def run(x, n2=2, **kw):
        m = torch.ones((n2, x.shape[1]), dtype=torch.bool, device=cuda_device)
        return attention_cuda.superglue_layer(x, m, layer, True, **kw)

    x = torch.zeros((2, 8, 256), device=cuda_device)
    with pytest.raises(ValueError):  # 8 heads
        run(x, compute_dtype=bf16, num_heads=8)
    with pytest.raises(ValueError):  # C = 128
        run(torch.zeros((2, 8, 128), device=cuda_device), compute_dtype=bf16)
    with pytest.raises(ValueError):  # an odd number of sets
        run(torch.zeros((3, 8, 256), device=cuda_device), n2=3, compute_dtype=bf16)
    with pytest.raises(ValueError, match="exceeds"):  # beyond the shared memory
        k = attention_cuda.MAX_K_BF16 + 16
        run(torch.zeros((2, k, 256), device=cuda_device), compute_dtype=bf16)
    with pytest.raises(ValueError):  # x in bf16 (the residual stream is f32)
        run(x.to(bf16), compute_dtype=bf16)
    with pytest.raises(ValueError):  # float16 is no mode of the kernel
        run(x, compute_dtype=torch.float16)
    with pytest.raises(ValueError):  # an f32 mode scratch at bf16
        masks = torch.ones((2, 8), dtype=torch.bool, device=cuda_device)
        run(x, compute_dtype=bf16,
            scratch=attention_cuda.layer_scratch(x, masks, torch.float32))


def test_sinkhorn_kernel_matches_plain(cuda_device):  # noqa: F811
    """K3 vs the plain sweeps: max error < 1e-3 on valid rows, columns and
    dustbins (fast exponentials and another summation order)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    S = torch.randn((2, 50, 61), generator=g, device=cuda_device) * 3
    m0 = torch.arange(50, device=cuda_device)[None] < torch.tensor([[50], [31]], device=cuda_device)
    m1 = torch.arange(61, device=cuda_device)[None] < torch.tensor([[44], [61]], device=cuda_device)
    Z0, mu, nu, _ = sinkhorn.build_problem(S, m0, m1, 1.0)
    got = sinkhorn_cuda.sinkhorn_iterations(Z0, mu, nu, 100)
    ref = sinkhorn.sinkhorn_iterations_plain(Z0, mu, nu, 100)
    one = torch.ones((2, 1), dtype=torch.bool, device=cuda_device)
    sel = torch.cat([m0, one], 1)[:, :, None] & torch.cat([m1, one], 1)[:, None, :]
    assert torch.isfinite(got).all()
    assert (got - ref).abs()[sel].max() < 1e-3


@pytest.mark.parametrize("B,M,N", [(1, 400, 400), (1, 600, 600), (2, 70, 61), (1, 4, 9)],
                         ids=["superglue", "oivio", "batch2", "rows-below-cluster"])
def test_sinkhorn_cluster_kernel_shapes(cuda_device, B, M, N):  # noqa: F811
    """K3's cluster at the shipped sizes (K = 400, OIVIO's 600), two
    clusters at once, and M1 = 5 rows over a cluster of 8 (empty bands):
    max error < 1e-3 on valid rows, columns and dustbins."""
    g = torch.Generator(device=cuda_device).manual_seed(M)
    S = torch.randn((B, M, N), generator=g, device=cuda_device) * 3
    v0 = torch.tensor([[M - M // 7]] * B, device=cuda_device)
    v1 = torch.tensor([[N]] * B, device=cuda_device)
    v0[-1] = M
    v1[0] = N - N // 5
    m0 = torch.arange(M, device=cuda_device)[None] < v0
    m1 = torch.arange(N, device=cuda_device)[None] < v1
    Z0, mu, nu, _ = sinkhorn.build_problem(S, m0, m1, 1.0)
    got = sinkhorn_cuda.sinkhorn_iterations(Z0, mu, nu, 100)
    ref = sinkhorn.sinkhorn_iterations_plain(Z0, mu, nu, 100)
    one = torch.ones((B, 1), dtype=torch.bool, device=cuda_device)
    sel = torch.cat([m0, one], 1)[:, :, None] & torch.cat([m1, one], 1)[:, None, :]
    assert torch.isfinite(got).all()
    assert (got - ref).abs()[sel].max() < 1e-3


def test_kernels_refuse_what_they_do_not_take(cuda_device):  # noqa: F811
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    x = torch.zeros((1, 8, 8, 64), device=cuda_device)  # f32, not bf16
    w = torch.zeros((3, 3, 64, 64), device=cuda_device)
    with pytest.raises(ValueError):
        conv_stem_cuda.conv3x3_relu_pool(x, conv_stem_cuda.pack_weights(w),
                                         torch.zeros(64, device=cuda_device))
    with pytest.raises(ValueError):  # HWIO weights: K1 takes them packed
        conv_stem_cuda.conv3x3_relu_pool(x.to(torch.bfloat16), w,
                                         torch.zeros(64, device=cuda_device))
    Z0 = torch.zeros((1, 1401, 1401), device=cuda_device)  # beyond a cluster of 16
    with pytest.raises(ValueError, match="does not fit a cluster"):
        sinkhorn_cuda.sinkhorn_iterations(Z0, torch.zeros((1, 1401), device=cuda_device),
                                          torch.zeros((1, 1401), device=cuda_device), 10)
    layer = attention_cuda.pack_layer(_layer(np.random.default_rng(0), 256), cuda_device)
    with pytest.raises(ValueError):
        attention_cuda.superglue_layer(torch.zeros((2, 5, 256), device=cuda_device),
                                       torch.ones((2, 5), dtype=torch.bool,
                                                  device=cuda_device), layer, False,
                                       num_heads=8)


def test_slam_slice_runs_on_the_card(cuda_device):  # noqa: F811
    """The slice on the card at 320×240 with 2 GNN layers: it initializes,
    tracks through all three kernels, and the promote-last-frame fallback
    (the unfused PnP + LM path) inserts a keyframe with a finite pose."""
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.slam import SLAMSystem

    cfg = small_system_cfg()
    frames, _ = rendered_sequence(cfg, 3)
    sp, sg = matcher_weights(cfg)
    slam = SLAMSystem(cfg, NeuralFrontend(cfg, sp_params=sp, sg_params=sg,
                                          device=cuda_device), enable_ba=False)
    before = (conv_stem_cuda.launches, attention_cuda.launches, sinkhorn_cuda.launches)
    recs = [slam.add_frame(i, 0.05 * i, *f) for i, f in enumerate(frames)]
    after = (conv_stem_cuda.launches, attention_cuda.launches, sinkhorn_cuda.launches)
    assert slam.initialized and min(r.num_inliers for r in recs[1:]) > 20
    assert after[0] - before[0] == 3 and after[1] - before[1] == 2 * 3 + 2 * 2
    assert after[2] - before[2] == 3 + 2
    slam._promote_last_frame_to_keyframe()
    assert slam.map.n_kf == 2 and np.isfinite(slam.map.kf_pose[:2]).all()


def test_rcf_k1_recipe_on_the_card_matches_the_generic_recipe(cuda_device):  # noqa: F811
    """RCF at the main path's ×0.5 shape (2, 240, 376), bf16, the hand-set
    edge weights: the default recipe on the card (stage 1 through K1's side
    mode, one launch) against the generic conv recipe on the card, at the
    CPU test's bound for these weights: |Δ| < 0.08·(|generic| + 1) on the
    logits, 0.02 on the edge map."""
    from rspl_slam_tpu_torch.models import rcf
    from rspl_slam_tpu_torch.models.weights import rcf_from_numpy

    m = rcf_from_numpy(rcf.edge_detector_params(), cuda_device)
    (pair,), _ = rendered_sequence(small_system_cfg(752, 480), 1, num_lines=12)
    img = torch.from_numpy(np.stack(pair)).to(cuda_device)
    img = torch.nn.functional.avg_pool2d(img[:, None], 2)[:, 0]
    before = conv_stem_cuda.side_launches
    got = rcf.edge_logits(m, img)
    assert conv_stem_cuda.side_launches == before + 1
    ref = rcf.edge_logits(m, img, use_pallas_stem=False)
    assert conv_stem_cuda.side_launches == before + 1
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() / (ref.abs() + 1.0)).max() < 0.08
    assert (torch.sigmoid(got) - torch.sigmoid(ref)).abs().max() < 0.02
    assert 0.01 < float((torch.sigmoid(got) > 0.25).float().mean()) < 0.6


def test_rcf_stem_on_the_card_launches_k1_or_raises(cuda_device):  # noqa: F811
    """A CUDA tensor's default stage 1 is K1 wherever K1's own limits hold:
    a bf16 image with H ≡ 2 (mod 4) launches K1's side mode exactly once
    and agrees with the generic recipe at the bound above; f32 and an odd
    H raise without a launch."""
    from rspl_slam_tpu_torch.models import rcf
    from rspl_slam_tpu_torch.models.weights import rcf_from_numpy

    m = rcf_from_numpy(rcf.edge_detector_params(), cuda_device)
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 42, 70))
                           .astype(np.float32)).to(cuda_device)
    before = conv_stem_cuda.side_launches
    got = rcf.edge_logits(m, img)
    assert conv_stem_cuda.side_launches == before + 1
    ref = rcf.edge_logits(m, img, use_pallas_stem=False)
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() / (ref.abs() + 1.0)).max() < 0.08
    with pytest.raises(ValueError):
        rcf.edge_logits(m, img, torch.float32)
    with pytest.raises(ValueError):
        rcf.edge_logits(m, img[:, :41])
    assert conv_stem_cuda.side_launches == before + 1


def _tie_map(seed, H=240, W=376):
    rng = np.random.default_rng(seed)
    e = np.zeros((H, W), np.float32)
    e[rng.uniform(size=(H, W)) < 0.05] = 1.0
    e[60, 20:300] = 1.0
    e[20:200, 120] = 1.0
    return e


def test_line_detector_on_the_card_matches_the_cpu(cuda_device):  # noqa: F811
    """The Hough detector on the card against the same code on the CPU, on
    the pair batched as the main path batches it: the same number of
    segments, each within one projection bin (sums in another order can
    move a refined line's inlier one bin)."""
    from rspl_slam_tpu_torch.ops import lines

    e = np.stack([_tie_map(0), _tie_map(1)])
    kw = dict(max_segments=128, min_length=10.0, inlier_dist=1.414213562)
    ref = lines.detect_line_segments(torch.from_numpy(e), **kw)
    got = lines.detect_line_segments(torch.from_numpy(e).to(cuda_device), **kw)
    tol = 2 * np.hypot(240, 376) / 256 + 1e-3
    for b in range(2):
        a = got[0][b][got[1][b]].cpu().numpy()
        r = ref[0][b][ref[1][b]].numpy()
        assert len(a) == len(r) > 10
        for x, y in ((a, r), (r, a)):
            d = np.minimum(np.abs(x[:, None] - y[None]).max(-1),
                           np.abs(x[:, None] - y[None][..., [2, 3, 0, 1]]).max(-1)).min(1)
            assert d.max() <= tol


def test_slam_slice_with_lines_runs_on_the_card(cuda_device):  # noqa: F811
    """The slice with lines on the card at 320×240 (2 GNN layers): K1's
    side mode launches once per frame, every frame carries lines, and the
    map gains maplines."""
    import dataclasses

    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.models import rcf
    from rspl_slam_tpu_torch.slam import SLAMSystem

    cfg = small_system_cfg()
    cfg = dataclasses.replace(cfg, use_lines=True, keyframe=dataclasses.replace(
        cfg.keyframe, max_num_match=400))
    frames, _ = rendered_sequence(cfg, 4, num_lines=12)
    sp, sg = matcher_weights(cfg)
    slam = SLAMSystem(cfg, NeuralFrontend(cfg, sp_params=sp, sg_params=sg,
                                          rcf_params=rcf.edge_detector_params(),
                                          device=cuda_device), enable_ba=False)
    before = conv_stem_cuda.side_launches
    for i, f in enumerate(frames):
        slam.add_frame(i, 0.05 * i, *f)
        assert slam._last_feats.line_valid.sum() > 10
    assert conv_stem_cuda.side_launches - before == len(frames)
    assert slam.initialized and slam.map.n_ln > 0
    assert slam.map.ln_has_endpoints[: slam.map.n_ln].any()


def _ba_windows():
    """The captured f32 divergence window, and a small synthetic window
    (5 poses, 64 points, 8 lines, 4 views each: the shape of the JAX
    package's ``tests/test_local_ba.py`` windows)."""
    import os

    from rspl_slam_tpu_torch.config import CameraConfig
    from rspl_slam_tpu_torch.evaluation import synthetic

    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "ba_divergence_case.npz")
    small, _ = synthetic.make_ba_window(CameraConfig(), frames=5, points=64, lines=8, seed=1)
    return {"fixture": dict(np.load(fixture)), "small": small}


def _intrinsics():
    from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
    from rspl_slam_tpu_torch.config import CameraConfig

    cam = CameraConfig()
    return CameraIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)


@pytest.mark.parametrize("window", ["fixture", "small"])
def test_local_ba_on_the_card_matches_the_cpu(cuda_device, window):  # noqa: F811
    """``optimize_local_map`` on the card against the same function on CPU
    tensors: finite; inlier flags differ on ≤ 1% of the rows; poses ≤ 3e-2 m
    apart (the fixture is ill-conditioned: each f32 solution lies ~1 cm from
    the f64 one); costs within 25% (the 5 restarted quadratic iterations
    accept steps by f32 sums, tests/test_torch_ba.py); the fixture meets
    the JAX package's own assertions (cost < 2000, > 600 inliers)."""
    from rspl_slam_tpu_torch.backend import local_ba

    prob = local_ba.BAProblem(**_ba_windows()[window])
    K = _intrinsics()
    cpu = local_ba.fetch_result(local_ba.optimize_local_map(K, local_ba.upload_problem(prob, "cpu")))
    gpu = local_ba.fetch_result(local_ba.optimize_local_map(
        K, local_ba.upload_problem(prob, cuda_device)))
    rows = len(gpu.p_inlier) + len(gpu.l_inlier)
    assert np.isfinite(gpu.Tcw).all() and np.isfinite(gpu.points).all()
    assert np.isfinite(gpu.lines).all() and np.isfinite(float(gpu.cost))
    flips = (gpu.p_inlier != cpu.p_inlier).sum() + (gpu.l_inlier != cpu.l_inlier).sum()
    assert flips <= max(2, 0.01 * rows)
    assert np.abs(gpu.Tcw - cpu.Tcw)[:, :3, 3].max() < 3e-2
    assert abs(float(gpu.cost) - float(cpu.cost)) <= 0.25 * float(cpu.cost) + 1e-3
    if window == "fixture":
        assert float(gpu.cost) < 2000.0 and int(gpu.p_inlier.sum()) > 600


def test_local_ba_on_the_card_makes_no_host_sync(cuda_device):  # noqa: F811
    """The upload and the whole 10 → gate → 5 schedule at the default
    capacities run under ``torch.cuda.set_sync_debug_mode("error")``: no
    operation waits for the device; only ``fetch_result``'s one copy does."""
    from rspl_slam_tpu_torch.backend import local_ba
    from rspl_slam_tpu_torch.config import CameraConfig
    from rspl_slam_tpu_torch.evaluation import synthetic

    prob, _ = synthetic.make_ba_window(CameraConfig(), seed=0)
    K = _intrinsics()
    local_ba.optimize_local_map(K, local_ba.upload_problem(local_ba.BAProblem(**prob),
                                                           cuda_device), iters1=1, iters2=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = local_ba.optimize_local_map(K, local_ba.upload_problem(local_ba.BAProblem(**prob),
                                                                     cuda_device))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out = local_ba.fetch_result(res)
    assert np.isfinite(out.Tcw).all() and out.p_inlier.sum() > 0.9 * len(out.p_inlier)


def test_solve_spd_on_the_card_is_nan_where_not_spd(cuda_device):  # noqa: F811
    """A batch of SPD and indefinite systems on the card: NaN exactly on the
    indefinite ones, the CPU's answer (rel 1e-4) elsewhere."""
    from rspl_slam_tpu_torch.geometry import linalg

    rng = np.random.default_rng(0)
    M = rng.standard_normal((4, 6, 6))
    A = (M @ M.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    A[2] = np.diag([1.0, 2.0, -3.0, 4.0, 5.0, 6.0])
    b = rng.standard_normal((4, 6)).astype(np.float32)
    got = linalg.solve_spd(torch.from_numpy(A).to(cuda_device),
                           torch.from_numpy(b).to(cuda_device)).cpu().numpy()
    ref = linalg.solve_spd(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert np.isnan(got[2]).all() and np.isfinite(got[[0, 1, 3]]).all()
    np.testing.assert_allclose(got[[0, 1, 3]], ref[[0, 1, 3]], rtol=1e-4, atol=1e-5)


def test_async_ba_on_the_card_matches_the_cpu_order(cuda_device):  # noqa: F811
    """Async BA of one window on a map built on the CPU: on the card the
    solve is issued on the side stream and the map is untouched until
    ``flush_ba``, which waits for the event, applies the result and records
    ``ba_device``; the CPU system solves at dispatch and applies at the
    flush. Both leave the same map: keyframe poses within 1e-3 m, 99% of
    the mappoints within 1 cm, the same observations apart from ≤ 2."""
    import copy
    import dataclasses

    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.slam import SLAMSystem

    cfg = small_system_cfg()
    cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(cfg.keyframe, max_num_match=400))
    frames, _ = rendered_sequence(cfg, 4)
    sp, sg = matcher_weights(cfg)

    def system(device, **kw):
        return SLAMSystem(cfg, NeuralFrontend(cfg, sp_params=sp, sg_params=sg,
                                              compute_dtype=torch.float32, device=device), **kw)

    base = system("cpu", enable_ba=False)
    for i, f in enumerate(frames):
        base.add_frame(i, 0.05 * i, *f)
    n = base.map.n_kf
    assert n >= 3
    runs = {}
    for device in ("cpu", cuda_device):
        s = system(device)
        s.map = copy.deepcopy(base.map)
        s._dispatch_local_ba(n - 1)
        assert s._pending_ba is not None
        np.testing.assert_array_equal(s.map.kf_pose, base.map.kf_pose)
        s.flush_ba()
        assert s._pending_ba is None and "ba_apply" in s.timings
        runs[str(device)] = s
    g, c = runs[str(cuda_device)].map, runs["cpu"].map
    assert "ba_device" in runs[str(cuda_device)].timings
    assert not np.allclose(c.kf_pose[:n], base.map.kf_pose[:n])
    np.testing.assert_allclose(g.kf_pose[:n], c.kf_pose[:n], atol=1e-3)
    good = c.pt_status[: c.n_pt] == 2
    d = np.linalg.norm(g.pt_pos[: c.n_pt][good] - c.pt_pos[: c.n_pt][good], axis=-1)
    assert np.quantile(d, 0.99) < 0.01
    assert np.abs(g.pt_obs_n[: c.n_pt] - c.pt_obs_n[: c.n_pt]).sum() <= 2


def test_local_ba_on_the_card_repeats_bit_for_bit(cuda_device):  # noqa: F811
    """``optimize_local_map`` twice on the same full-capacity window
    (``make_ba_window``, seed 0): every output equal bit for bit (fixed-order
    segment sums, no atomics)."""
    from rspl_slam_tpu_torch.backend import local_ba
    from rspl_slam_tpu_torch.config import CameraConfig
    from rspl_slam_tpu_torch.evaluation import synthetic

    prob = local_ba.BAProblem(**synthetic.make_ba_window(CameraConfig(), seed=0)[0])
    K = _intrinsics()
    a, b = (local_ba.fetch_result(local_ba.optimize_local_map(
        K, local_ba.upload_problem(prob, cuda_device))) for _ in range(2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _lazy_system(cuda_device, n_frames):  # noqa: F811
    """A lazy-right system on the card (lines, async BA, 320×240, 2 GNN
    layers, bf16) and its rendered 8-bit frames."""
    import dataclasses

    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.models import rcf
    from rspl_slam_tpu_torch.slam import SLAMSystem

    cfg = small_system_cfg()
    cfg = dataclasses.replace(
        cfg, use_lines=True,
        pipeline=dataclasses.replace(cfg.pipeline, lazy_right_extraction=True),
        keyframe=dataclasses.replace(cfg.keyframe, max_num_match=180))
    frames, _ = rendered_sequence(cfg, n_frames, num_lines=12)
    frames = [tuple((np.clip(im, 0, 1) * 255).astype(np.uint8) for im in f) for f in frames]
    sp, sg = matcher_weights(cfg)
    fe = NeuralFrontend(cfg, sp_params=sp, sg_params=sg, rcf_params=rcf.edge_detector_params(),
                        device=cuda_device)
    return cfg, frames, lambda: SLAMSystem(cfg, fe)


def test_lazy_slice_runs_on_the_card(cuda_device):  # noqa: F811
    """The lazy slice on the card (6 frames): it initializes and tracks
    through the combined step; one stereo completion per initialization
    attempt and per keyframe, each bringing the frame's descriptors down
    once; K1 and its side mode launch once per frame and once per
    completion, K3 once per match (the tracked frames' temporal matches and
    the completions' stereo matches), K2 once per GNN layer of each."""
    cfg, frames, system = _lazy_system(cuda_device, 6)
    slam = system()
    fe = slam.frontend
    before = (conv_stem_cuda.launches, conv_stem_cuda.side_launches, attention_cuda.launches,
              sinkhorn_cuda.launches, fe.stereo_completions, fe.desc_downloads)
    recs = [slam.add_frame(i, 0.05 * i, *f) for i, f in enumerate(frames)]
    slam.flush_ba()
    k1, k1s, k2, k3, done, down = (a - b for a, b in zip(
        (conv_stem_cuda.launches, conv_stem_cuda.side_launches, attention_cuda.launches,
         sinkhorn_cuda.launches, fe.stereo_completions, fe.desc_downloads), before))
    init = next(i for i, r in enumerate(recs) if r.is_keyframe) + 1
    assert slam.initialized and min(r.num_inliers for r in recs[init:]) > 20
    assert "frame_combined" in slam.timings and slam.map.n_kf >= 2
    assert done == init + slam.map.n_kf - 1 == down
    assert k1 == k1s == len(frames) + done
    matches = len(frames) - init + done
    assert k3 == matches and k2 == cfg.superglue.num_gnn_layers * matches
    assert np.isfinite(np.stack([r.Twc for r in recs])).all()


def test_runner_on_the_card_matches_serial_calls(cuda_device):  # noqa: F811
    """The PipelinedRunner on the card (the extract thread on its own
    stream, each frame's event waited on by the tracking thread) makes the
    serial loop's keyframe decisions and inlier counts."""
    from rspl_slam_tpu_torch.datasets import StereoFrame
    from rspl_slam_tpu_torch.pipeline import PipelinedRunner

    _, frames, system = _lazy_system(cuda_device, 8)
    serial = system()
    recs_s = [serial.add_frame(i, 0.05 * i, *f) for i, f in enumerate(frames)]

    class Frames:
        def __len__(self):
            return len(frames)

        def __getitem__(self, i):
            return StereoFrame(i, 0.05 * i, *frames[i])

    piped = system()
    recs_p = PipelinedRunner(piped, Frames()).run()
    piped.flush_ba()
    serial.flush_ba()
    assert [r.is_keyframe for r in recs_p] == [r.is_keyframe for r in recs_s]
    assert [r.num_inliers for r in recs_p] == [r.num_inliers for r in recs_s]
    assert sum(r.is_keyframe for r in recs_s) >= 2
    np.testing.assert_allclose(np.stack([r.Twc for r in recs_p]),
                               np.stack([r.Twc for r in recs_s]), atol=1e-5)


@pytest.mark.parametrize("bpp", [1, 3])
def test_png_unfilter_compiled_matches_numpy(cuda_device, bpp):  # noqa: F811
    """The PNG reader's compiled row unfilter (host code of
    ``csrc/png_unfilter.cu``, built with nvcc like the kernels) equals the
    numpy one bit for bit on every filter and a per-row mix; the dataset
    path of a card run uses it."""
    from rspl_slam_tpu_torch import png

    rng = np.random.default_rng(bpp)
    img = rng.integers(0, 256, (31, 47 * bpp), dtype=np.uint8)
    cand = png._filtered(img, bpp)
    for choice in [np.full(31, f) for f in range(5)] + [np.arange(31) % 5]:
        raw = np.concatenate([choice.astype(np.uint8)[:, None],
                              cand[choice, np.arange(31)]], 1).tobytes()
        got = png.unfilter_compiled(raw, 31, 47 * bpp, bpp)
        np.testing.assert_array_equal(got, png.unfilter_numpy(raw, 31, 47 * bpp, bpp))
        np.testing.assert_array_equal(got, img)
    with pytest.raises(RuntimeError, match="invalid PNG filter type"):
        png.unfilter_compiled(b"\x07" + bytes(47 * bpp), 1, 47 * bpp, bpp)
