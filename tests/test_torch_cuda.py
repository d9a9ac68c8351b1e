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


# SuperGlue with M != N: 400 keypoints over 300 and 300 over 400, and a
# ragged pair below one query tile
@pytest.mark.parametrize("M,N", [(400, 300), (300, 400), (24, 17)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_superglue_layer_two_set_kernel_matches_plain(cuda_device, M, N, bf16):  # noqa: F811
    """K2's two-set variant against its plain version, a set over another
    (partly masked) source and over itself, at the stacked kernel's
    tolerances (f32: rtol, atol 1e-3; bf16: 2^-8|p| + 4e-3)."""
    dt = torch.bfloat16 if bf16 else torch.float32
    layer = attention_cuda.pack_layer(_layer(np.random.default_rng(3)), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(M + N)
    x = torch.randn((2, M, 256), generator=g, device=cuda_device)
    src = torch.randn((2, N, 256), generator=g, device=cuda_device)
    m_src = torch.arange(N, device=cuda_device)[None] < torch.tensor(
        [[N], [N - N // 4]], device=cuda_device)
    m_x = torch.arange(M, device=cuda_device)[None] < torch.tensor([[M - 3], [M]],
                                                                   device=cuda_device)
    tol = dict(rtol=2 ** -8, atol=4e-3) if bf16 else dict(rtol=1e-3, atol=1e-3)
    for s, m in ((src, m_src), (x, m_x)):
        got = attention_cuda.superglue_layer_two_set(x, s, m, layer, compute_dtype=dt)
        ref = attention_cuda.superglue_layer_two_set_plain(x, s, m, layer, compute_dtype=dt)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, **tol)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_two_set_layers_on_equal_sets_are_the_stacked_kernel(cuda_device, bf16):  # noqa: F811
    """On sets of one size the two-set kernels run the stacked kernels'
    arithmetic row for row: a set over itself equals the stacked self
    layer, a set over the other the stacked cross layer, bit for bit."""
    dt = torch.bfloat16 if bf16 else torch.float32
    layer = attention_cuda.pack_layer(_layer(np.random.default_rng(4)), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((2, 70, 256), generator=g, device=cuda_device)
    masks = torch.arange(70, device=cuda_device)[None] < torch.tensor(
        [[70], [53]], device=cuda_device)
    for cross in (False, True):
        stacked = attention_cuda.superglue_layer(x, masks, layer, cross, compute_dtype=dt)
        for s in (0, 1):
            o = 1 - s if cross else s
            got = attention_cuda.superglue_layer_two_set(
                x[s:s + 1].contiguous(), x[o:o + 1].contiguous(), masks[o:o + 1], layer,
                compute_dtype=dt)
            assert torch.equal(got, stacked[s:s + 1])


# past the f32 mode's old 3308-key ceiling and at a ragged K: stacked (M ==
# N, self and cross) and two-set, a source past the old ceiling either way
@pytest.mark.parametrize("M,N", [(3309, 3309), (4096, 4096), (1100, 1100), (800, 4096),
                                 (4096, 3309)])
def test_superglue_layer_f32_takes_any_k(cuda_device, M, N):  # noqa: F811
    """K2's f32 mode (3xTF32 on the tensor cores, K and V streamed in 64-key
    chunks) against its plain version, with masked keys, at the f32 kernel
    line's rtol, atol 1e-5 (f32 accuracy: one TF32 product alone would miss
    it); a second run equal bit for bit."""
    layer = attention_cuda.pack_layer(_layer(np.random.default_rng(9)), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(M + 7 * N)
    tol = dict(rtol=1e-5, atol=1e-5)
    if M == N:
        x = torch.randn((2, M, 256), generator=g, device=cuda_device)
        masks = torch.arange(M, device=cuda_device)[None] < torch.tensor(
            [[M], [M - M // 6]], device=cuda_device)
        for cross in (False, True):
            got = attention_cuda.superglue_layer(x, masks, layer, cross)
            assert torch.equal(attention_cuda.superglue_layer(x, masks, layer, cross), got)
            ref = attention_cuda.superglue_layer_plain(x, masks, layer, cross)
            torch.testing.assert_close(got, ref, **tol)
    else:
        x = torch.randn((1, M, 256), generator=g, device=cuda_device)
        src = torch.randn((1, N, 256), generator=g, device=cuda_device)
        m_src = torch.arange(N, device=cuda_device)[None] < N - N // 5
        got = attention_cuda.superglue_layer_two_set(x, src, m_src, layer)
        assert torch.equal(attention_cuda.superglue_layer_two_set(x, src, m_src, layer), got)
        ref = attention_cuda.superglue_layer_two_set_plain(x, src, m_src, layer)
        torch.testing.assert_close(got, ref, **tol)


def test_superglue_layer_two_set_refuses_what_it_does_not_take(cuda_device):  # noqa: F811
    """Shapes, types and sources the two-set kernels cannot take raise."""
    layer = attention_cuda.pack_layer(_layer(np.random.default_rng(0)), cuda_device)
    x = torch.zeros((1, 24, 256), device=cuda_device)

    def run(src, dt=torch.bfloat16, **kw):
        m = torch.ones(src.shape[:2], dtype=torch.bool, device=cuda_device)
        return attention_cuda.superglue_layer_two_set(x, src, m, layer, compute_dtype=dt, **kw)

    with pytest.raises(ValueError, match="exceeds"):  # a source beyond the shared memory
        src = torch.zeros((1, attention_cuda.MAX_K_BF16 + 16, 256), device=cuda_device)
        m = torch.ones(src.shape[:2], dtype=torch.bool, device=cuda_device)
        attention_cuda._launch_two_set(x, src, m, layer, 4, torch.bfloat16, None, False)
    with pytest.raises(ValueError):  # a source of another batch
        run(torch.zeros((2, 17, 256), device=cuda_device))
    with pytest.raises(ValueError):  # a source of another width
        run(torch.zeros((1, 17, 128), device=cuda_device))
    with pytest.raises(ValueError):  # a bf16 source (the residual stream is f32)
        run(torch.zeros((1, 17, 256), device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # 8 heads
        run(torch.zeros((1, 17, 256), device=cuda_device), num_heads=8)
    with pytest.raises(ValueError):  # float16 is no mode of the kernels
        run(torch.zeros((1, 17, 256), device=cuda_device), dt=torch.float16)


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
        attention_cuda._launch_layer(torch.zeros((2, k, 256), device=cuda_device),
                                     torch.ones((2, k), dtype=torch.bool, device=cuda_device),
                                     layer, True, 4, bf16, None, False)
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


@pytest.mark.parametrize("B,M,N", [(1, 400, 400), (1, 600, 600), (2, 70, 61), (1, 4, 9),
                                   (1, 400, 300), (1, 300, 400)],
                         ids=["superglue", "oivio", "batch2", "rows-below-cluster",
                              "unequal-400-300", "unequal-300-400"])
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
        sinkhorn_cuda._launch_cluster(Z0, torch.zeros((1, 1401), device=cuda_device),
                                      torch.zeros((1, 1401), device=cuda_device), 10)
    with pytest.raises(ValueError):  # the global-memory kernel takes f32 only
        sinkhorn_cuda.sinkhorn_iterations(Z0.double(), torch.zeros((1, 1401), device=cuda_device),
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


def _drifted_graph(F=24, seed=1):
    """A circular chain with accumulating drift, odometry and covisibility
    edges and one loop measured from the true poses."""
    from rspl_slam_tpu_torch.backend.loop_closure import LoopConstraint
    from rspl_slam_tpu_torch.evaluation.synthetic import _exp_se3

    rng = np.random.default_rng(seed)
    gt = []
    for f in range(F):
        a = np.pi * f / F
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        T[:3, 3] = [5 * np.cos(a), 5 * np.sin(a), 0]
        gt.append(T)
    est = [gt[0]]
    for f in range(1, F):
        est.append(est[-1] @ np.linalg.inv(gt[f - 1]) @ gt[f]
                   @ _exp_se3(np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.05, 3)])))
    covis = np.zeros((F, F))
    for a in range(F - 2):
        covis[a, a + 2] = 15
    loop = LoopConstraint(0, F - 1, np.linalg.inv(gt[0]) @ gt[F - 1], 50.0, 50, 0.95)
    return np.stack(est), covis, [loop]


def test_pose_graph_on_the_card_matches_the_cpu_and_repeats(cuda_device):  # noqa: F811
    """The pose-graph LM on the card against the same solve on CPU tensors
    (f32: poses within 1e-4, costs within 1e-4 relative), twice on the card
    with the same bits (fixed-order segment sums, no atomics), and no host
    synchronization inside the solve."""
    from rspl_slam_tpu_torch.backend import pose_graph

    est, covis, loops = _drifted_graph()
    F = len(est)
    cpu = pose_graph.optimize_pose_graph(pose_graph.relative_constraints_from_covisibility(
        est, covis, F, loops=loops, device="cpu"))
    runs = []
    for _ in range(2):
        prob = pose_graph.relative_constraints_from_covisibility(est, covis, F, loops=loops,
                                                                 device=cuda_device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = pose_graph.optimize_pose_graph(prob)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs.append((res.Tcw.cpu(), res.cost.cpu()))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    torch.testing.assert_close(runs[0][0], cpu.Tcw, rtol=0, atol=1e-4)
    torch.testing.assert_close(runs[0][1], cpu.cost, rtol=1e-4, atol=1e-7)
    assert float(runs[0][1]) < float(cpu.initial_cost)


def test_epipolar_filter_on_the_card_rejects_planted_outliers(cuda_device):  # noqa: F811
    """``fundamental_ransac_inliers`` on CUDA tensors (hypotheses from a
    generator on the card): 30 scrambled matches of 120 between two views
    of a known relative pose; < 15% of the scrambles kept, > 90% of the
    rest, nothing unmatched kept."""
    from rspl_slam_tpu_torch.ops.matching import fundamental_ransac_inliers

    rng = np.random.default_rng(0)
    X = rng.uniform([-3, -2, 3], [3, 2, 9], (120, 3))
    a = 0.1
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])

    def project(Xc):
        return np.stack([400 * Xc[:, 0] / Xc[:, 2] + 320, 400 * Xc[:, 1] / Xc[:, 2] + 240], -1)

    p0 = project(X) + rng.standard_normal((120, 2)) * 0.3
    p1 = project(X @ R.T + [0.4, 0.05, 0.1]) + rng.standard_normal((120, 2)) * 0.3
    bad = np.arange(90, 120)
    p1[bad] = p1[rng.permutation(bad)] + rng.uniform(20, 80, (30, 2))
    matched = np.ones(120, bool)
    matched[::11] = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    t = lambda x: torch.as_tensor(x, device=cuda_device)  # noqa: E731
    ok = fundamental_ransac_inliers(t(p0.astype(np.float32)), t(p1.astype(np.float32)),
                                    t(matched), g).cpu().numpy()
    good = np.setdiff1d(np.nonzero(matched)[0], bad)
    assert ok[bad].mean() < 0.15 and ok[good].mean() > 0.9 and not ok[~matched].any()


def test_global_ba_on_the_card_matches_the_cpu(cuda_device):  # noqa: F811
    """``run_global_ba``'s problem (an oracle map, BA off, perturbed) solved
    on the card and on CPU tensors: costs within 1e-3 relative, poses within
    1e-3 m, the same bits on a second card solve."""
    from rspl_slam_tpu_torch.backend import local_ba
    from rspl_slam_tpu_torch.config import PipelineConfig, SuperPointConfig, SystemConfig
    from rspl_slam_tpu_torch.evaluation import synthetic
    from rspl_slam_tpu_torch.frontend.frontends import OracleFrontend
    from rspl_slam_tpu_torch.slam import SLAMSystem

    cfg = SystemConfig(superpoint=SuperPointConfig(max_keypoints=256),
                       pipeline=PipelineConfig(ba_max_points=512, ba_max_lines=16),
                       use_lines=False)
    scene = synthetic.make_scene(num_points=900, seed=2, num_lines=0, extent=(10.0, 6.0, 16.0))
    fe = OracleFrontend(cfg, scene, noise_px=0.6, seed=2, device="cpu")
    fe.poses = synthetic.make_trajectory(35, step=0.05, yaw_rate=0.003)
    slam = SLAMSystem(cfg, fe, enable_ba=False)
    for i in range(35):
        slam.add_frame(i, i * 0.05, None, None)
    rng = np.random.default_rng(0)
    m = slam.map
    for k in range(1, m.n_kf):
        m.kf_pose[k][:3, 3] += rng.standard_normal(3) * 0.01
    prob, _ = slam.global_ba_problem()
    cpu = local_ba.fetch_result(local_ba.optimize_local_map(
        slam.K, local_ba.upload_problem(prob, "cpu")))
    card = [local_ba.fetch_result(local_ba.optimize_local_map(
        slam.K, local_ba.upload_problem(prob, cuda_device))) for _ in range(2)]
    assert np.array_equal(card[0].Tcw, card[1].Tcw) and card[0].cost == card[1].cost
    assert abs(float(card[0].cost) - float(cpu.cost)) <= 1e-3 * float(cpu.cost)
    assert np.abs(card[0].Tcw - cpu.Tcw)[:, :3, 3].max() < 1e-3


def test_neural_relocalization_on_the_card_matches_the_cpu(cuda_device, tmp_path):  # noqa: F811
    """Relocalization's re-anchoring route with the neural frontend, as
    ``SLAMSystem._track`` runs it, on the card and on the CPU from the same
    saved map and the same host features of one frame (320×240, 2 GNN
    layers, f32):
    the keyframe database query, the verified keyframe's stored features,
    the re-match through K2 and K3, the PnP + LM pose solve. The same
    keyframe, ≥ 95% of the matches equal, poses within 1e-3 m, more than
    20 inliers; K2 (its f32 mode) and K3 launched on the card only."""
    from rspl_slam_tpu_torch.frontend.frontends import FrameFeatures, NeuralFrontend
    from rspl_slam_tpu_torch.slam import SLAMSystem

    cfg = small_system_cfg()
    frames, _ = rendered_sequence(cfg, 6)
    sp, sg = matcher_weights(cfg)

    def system(dev):
        return SLAMSystem(cfg, NeuralFrontend(cfg, sp_params=sp, sg_params=sg,
                                              compute_dtype=torch.float32, device=dev),
                          enable_ba=False, enable_relocalization=True)

    mapper = system("cpu")
    for i, f in enumerate(frames):
        mapper.add_frame(i, 0.05 * i, *f)
    path = str(tmp_path / "map.npz")
    mapper.save_map(path)
    f = mapper.frontend.extract_pair(*frames[1])
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", cuda_device)):
        # the frame's host fields alone: each frontend caches its own device copies
        feats = FrameFeatures(xy=f.xy, score=f.score, desc=f.desc, valid=f.valid, meas=f.meas,
                              depth=f.depth)
        slam = system(dev)
        slam.resume_from_map(path)
        before = (attention_cuda.f32_launches, sinkhorn_cuda.launches)
        r = slam.loop_detector.relocalize(slam.map, feats.desc, feats.valid, feats.meas)
        assert r is not None
        c, Twc_r, _ = r
        slam._ref_kf = int(c)
        slam._ref_feats = slam._features_from_keyframe(int(c))
        slam._last_Twc = np.asarray(Twc_r)
        i0 = slam.frontend.match(feats, slam._ref_feats)
        Twc, n_inl, _ = slam._pose_optimize(feats, i0)
        out[name] = (int(c), i0, np.asarray(Twc), n_inl,
                     (attention_cuda.f32_launches - before[0],
                      sinkhorn_cuda.launches - before[1]))
    (c0, i0, T0, n0, l0), (c1, i1, T1, n1, l1) = out["cpu"], out["card"]
    assert c0 == c1 and (i0 == i1).mean() >= 0.95
    assert n0 > 20 and n1 > 20
    assert np.abs(T1[:3, 3] - T0[:3, 3]).max() < 1e-3
    assert l0 == (0, 0) and min(l1) > 0


# ----------------------------------------------------------------- training


def test_kernel_wrappers_refuse_grad(cuda_device):  # noqa: F811
    """The kernels have no backward: each wrapper raises on CUDA inputs that
    require grad while grad mode is on (an output without ``grad_fn`` would
    drop the gradient silently), and runs the same call under no_grad."""
    from rspl_slam_tpu_torch.ops import sinkhorn as plain_sinkhorn

    g = torch.Generator().manual_seed(0)
    w = (0.05 * torch.randn(3, 3, 64, 64, generator=g)).to(cuda_device)
    x = torch.rand(1, 16, 16, 64, generator=g).to(cuda_device, torch.bfloat16)
    b = torch.zeros(64, device=cuda_device, requires_grad=True)
    images = torch.rand(1, 16, 16, generator=g).to(cuda_device)
    w1a = torch.randn(3, 3, 1, 64, generator=g).to(cuda_device).requires_grad_()
    layer = attention_cuda.pack_layer(_layer(np.random.default_rng(0)), cuda_device)
    layer["bm"].requires_grad_()
    xs = torch.randn(2, 16, 256, generator=g).to(cuda_device)
    masks = torch.ones(2, 16, dtype=torch.bool, device=cuda_device)
    sim = torch.randn(1, 16, 16, generator=g).to(cuda_device)
    Z0, mu, nu, _ = plain_sinkhorn.build_problem(sim, masks[:1], masks[:1],
                                                 torch.tensor(1.0, device=cuda_device))
    calls = {"conv3x3_relu_pool": lambda: conv_stem_cuda.conv3x3_relu_pool(
                 x, conv_stem_cuda.pack_weights(w), b),
             "conv1a": lambda: conv_stem_cuda.conv1a(images, w1a, b, torch.bfloat16),
             "superglue_layer": lambda: attention_cuda.superglue_layer(xs, masks, layer, False),
             "sinkhorn_iterations": lambda: sinkhorn_cuda.sinkhorn_iterations(
                 Z0.requires_grad_(), mu, nu, 10)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("model", ["superpoint", "rcf", "superglue"])
def test_training_step_on_the_card_matches_the_cpu(cuda_device, model):  # noqa: F811
    """One training step on the card against the CPU from the same
    parameters and batch (TF32 off, as inside the trainers): the loss
    within 1e-5 relative and each leaf's gradient within 1e-3 of that
    leaf's largest |g| on the CPU (the key bias of an attention layer,
    whose exact gradient is 0, under 1e-6 of the largest |g| of all
    leaves). 1e-3, not the 1e-4 the CPU holds against JAX: cuDNN picks its
    own f32 algorithms and summation orders for the weight gradients
    (measured on an H100: 1.9e-4 and 4.3e-4 in two runs on SuperPoint's
    conv1a, a c_in = 1 kernel summed over every pixel; 1.2e-5 RCF, 8.9e-5
    SuperGlue). Then
    ``train(steps=1)`` on the card: its loss is that loss, and it moves
    every element by at most lr, up to the parameter's own f32 spacing
    (Adam's first step is lr·g/(|g| + eps)). The trainers leave the TF32
    switches as they found them. Parameters after a step are not compared
    element by element: an element whose gradient is rounding noise may
    land 2·lr apart."""
    from rspl_slam_tpu_torch.config import CameraConfig, SuperGlueConfig
    from rspl_slam_tpu_torch.models import rcf, superglue, superpoint
    from rspl_slam_tpu_torch.models.weights import flatten_pytree, to_tensor_tree, tree_leaves
    from rspl_slam_tpu_torch.training import rcf_train, superglue_train, superpoint_train
    from rspl_slam_tpu_torch.training.loop import no_tf32

    cam = CameraConfig(image_width=96, image_height=64, fx=80.0, fy=80.0, cx=48.0, cy=32.0,
                       bf=8.0)
    sg_cfg = SuperGlueConfig(image_width=160, image_height=120, num_gnn_layers=2,
                             sinkhorn_iterations=10)
    if model == "superpoint":
        params, lr = superpoint.init_params(0), 1e-3
        batch = lambda d: superpoint_train.make_batch(cam, 2, 0, d)  # noqa: E731
        loss = lambda p, b: superpoint_train.loss_fn(p, *b)  # noqa: E731
        train = lambda d: superpoint_train.train(  # noqa: E731
            cam, steps=1, batch=2, params=params, verbose=False, device=d, stats=stats)
    elif model == "rcf":
        params, lr = rcf.init_params(0, 0.125), 3e-4
        batch = lambda d: rcf_train.make_batch(48, 64, 2, 0, d)  # noqa: E731
        loss = lambda p, b: rcf_train.loss_fn(p, *b)  # noqa: E731
        train = lambda d: rcf_train.train(  # noqa: E731
            steps=1, batch=2, hw=(48, 64), params=params, verbose=False, device=d, stats=stats)
    else:
        params, lr = superglue.init_params(sg_cfg, 0), 1e-3
        batch = lambda d: superglue_train.make_batch(  # noqa: E731
            np.random.default_rng(0), 2, 16, sg_cfg, d)
        loss = lambda p, b: superglue_train.loss_fn(p, b, sg_cfg)  # noqa: E731
        train = lambda d: superglue_train.train(  # noqa: E731
            sg_cfg, steps=1, batch=2, K=16, params=params, verbose=False, device=d, stats=stats)
    names = list(flatten_pytree(params))
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        tree = to_tensor_tree(params, dev, requires_grad=True)
        with no_tf32():
            ell = loss(tree, batch(dev))
            ell.backward()
        out[dev.type] = (float(ell.detach()), {
            k: np.zeros(v.shape, np.float32) if v.grad is None else v.grad.cpu().numpy()
            for k, v in zip(names, tree_leaves(tree))})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    scale = max(float(np.abs(g).max()) for g in gc.values())
    worst = 0.0
    for k in names:
        top = float(np.abs(gc[k]).max())
        err = float(np.abs(gg[k] - gc[k]).max())
        if k.endswith("/k/b"):
            assert max(top, float(np.abs(gg[k]).max())) <= 1e-6 * scale, k
        elif top == 0.0:
            assert err == 0.0, k
        else:
            worst = max(worst, err / top)
            assert err <= 1e-3 * top, (k, err / top)
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    print({"measured": f"card_step_{model}", "loss_rel": abs(lg - lc) / abs(lc),
           "grad_worst_rel_to_leaf_max": worst})

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        stats = {}
        res = train(cuda_device)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    trained = flatten_pytree(res if model == "superpoint" else res[0])
    hist = stats.get("loss") or res[1]
    assert abs(hist[0] - lg) <= 1e-5 * abs(lg), (hist[0], lg)
    p0 = flatten_pytree(params)
    for k in names:
        step = np.abs(trained[k] - p0[k])
        assert (step <= lr * (1 + 1e-6) + np.spacing(np.abs(p0[k]) + lr)).all(), k


def test_superpoint_training_repeats_bit_for_bit_on_the_card(cuda_device):  # noqa: F811
    """Two ``superpoint_train.train`` runs from one seed on the card give the
    same loss history and the same trained leaves, bit for bit: the steps
    run under ``loop.deterministic`` (without it cuDNN's backward
    convolutions and ``gather``'s backward add with atomics, and the
    chip_smoke recipe's recall after 120 steps ranged from 0.13 to 0.40)."""
    from rspl_slam_tpu_torch.config import CameraConfig
    from rspl_slam_tpu_torch.models import superpoint
    from rspl_slam_tpu_torch.models.weights import flatten_pytree
    from rspl_slam_tpu_torch.training import superpoint_train

    cam = CameraConfig(image_width=160, image_height=120, fx=120.0, fy=120.0, cx=80.0,
                       cy=60.0, bf=12.0)
    runs = []
    for _ in range(2):
        stats = {}
        trained = superpoint_train.train(cam, steps=10, batch=2, lr=1e-3, seed=0,
                                         params=superpoint.init_params(0), verbose=False,
                                         device=cuda_device, stats=stats)
        runs.append((stats["loss"], flatten_pytree(trained)))
    (h0, t0), (h1, t1) = runs
    assert h0 == h1
    for k in t0:
        np.testing.assert_array_equal(t0[k], t1[k], err_msg=k)


@pytest.mark.parametrize("K", [16, 64])
def test_matching_accuracy_on_the_card_matches_the_plain_version(cuda_device, K):  # noqa: F811
    """``matching_accuracy`` through K2 (f32 mode) and K3 at the training
    sizes (K = 16 and 64: Sinkhorn's 17×17 and 65×65 problems, 2B = 4 sets)
    equals the plain version's (``plain_accuracy``, the same forward without
    the kernels) after a short overfit on the card; the log plans agree
    within 1e-3."""
    from rspl_slam_tpu_torch.config import SuperGlueConfig
    from rspl_slam_tpu_torch.models import superglue
    from rspl_slam_tpu_torch.models.weights import superglue_from_numpy
    from rspl_slam_tpu_torch.training import superglue_train

    cfg = SuperGlueConfig(image_width=160, image_height=120, num_gnn_layers=2,
                          sinkhorn_iterations=10)
    fixed = superglue_train.make_batch(np.random.default_rng(0), 2, K, cfg, cuda_device)
    params, hist = superglue_train.train(cfg, steps=60, batch=2, K=K, verbose=False,
                                         batch_fn=lambda *a: fixed, device=cuda_device)
    assert hist[-1] < hist[0]
    before = (attention_cuda.f32_launches, sinkhorn_cuda.launches)
    acc = superglue_train.matching_accuracy(params, fixed, cfg)
    assert (attention_cuda.f32_launches - before[0], sinkhorn_cuda.launches - before[1]) == (
        2, 1)
    assert acc == superglue_train.plain_accuracy(params, fixed, cfg)
    assert acc > 0.5, acc
    with torch.no_grad():
        z = superglue.match_pair(superglue_from_numpy(params, cfg, cuda_device), *fixed[:8],
                                 cfg, compute_dtype=torch.float32).log_plan
        ref = superglue_train.log_plan(
            superglue_train.to_tensor_tree(params, cuda_device), *fixed[:8], cfg)
    assert float((z - ref).abs().max()) < 1e-3


@pytest.mark.parametrize("K,route", [(752, "resident"), (752, "streamed"), (400, "streamed"),
                                     (768, None), (1024, None), (1100, None), (2048, None),
                                     (4096, None)])
def test_superglue_layer_streamed_matches_plain(cuda_device, K, route):  # noqa: F811
    """K2's streamed bf16 kernel (K and V through a ring of 128-key chunks,
    two passes, logits and probabilities in registers) past the resident
    kernel's 752 (ragged at 1100), both kernels at 752 and the streamed one
    at 400, against the plain version, self and cross, with masked keys:
    |k - p| <= 2^-8|p| + 4e-3, the bf16 kernel line's tolerance."""
    layer = attention_cuda.pack_layer(_layer(np.random.default_rng(6)), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K)
    x = torch.randn((2, K, 256), generator=g, device=cuda_device)
    masks = torch.arange(K, device=cuda_device)[None] < torch.tensor(
        [[K], [K - K // 6]], device=cuda_device)
    for cross in (False, True):
        got = (attention_cuda.superglue_layer(x, masks, layer, cross,
                                              compute_dtype=torch.bfloat16) if route is None
               else attention_cuda._launch_layer(x, masks, layer, cross, 4, torch.bfloat16,
                                                 None, route == "streamed"))
        ref = attention_cuda.superglue_layer_plain(x, masks, layer, cross,
                                                   compute_dtype=torch.bfloat16)
        assert ((got - ref).abs() <= 2.0 ** -8 * ref.abs() + 4e-3).all()


@pytest.mark.parametrize("B,M,N", [(1, 920, 920), (1, 1024, 1024), (1, 2048, 2048),
                                   (1, 1024, 1200), (4, 1024, 1024), (1, 4096, 4096)])
def test_sinkhorn_global_kernel_matches_plain(cuda_device, B, M, N):  # noqa: F811
    """K3's global-memory kernel on plans no cluster holds, against the
    plain sweeps: max error < 1e-3 on valid rows, columns and dustbins; at
    B = 4 one group of clusters per batch element, at 4096² most of each
    band in device memory (``grid_plan``'s overflow rows). A plan run twice
    is equal bit for bit."""
    assert sinkhorn_cuda.sinkhorn_route(M + 1, N + 1) == "global"
    g = torch.Generator(device=cuda_device).manual_seed(M + N + B)
    S = torch.randn((B, M, N), generator=g, device=cuda_device) * 3
    m0 = (torch.arange(M, device=cuda_device)[None] < M - M // 11).expand(B, M)
    m1 = (torch.arange(N, device=cuda_device)[None] < N - N // 13).expand(B, N)
    Z0, mu, nu, _ = sinkhorn.build_problem(S, m0, m1, 1.0)
    got = sinkhorn_cuda.sinkhorn_iterations(Z0, mu, nu, 100)
    assert torch.equal(sinkhorn_cuda.sinkhorn_iterations(Z0, mu, nu, 100), got)
    ref = sinkhorn.sinkhorn_iterations_plain(Z0, mu, nu, 100)
    one = torch.ones((B, 1), dtype=torch.bool, device=cuda_device)
    sel = torch.cat([m0, one], 1)[:, :, None] & torch.cat([m1, one], 1)[:, None, :]
    assert torch.isfinite(got).all()
    assert (got - ref).abs()[sel].max() < 1e-3


@pytest.mark.parametrize("M,N", [(800, 1024), (1024, 800)])
def test_superglue_layer_two_set_streamed_matches_plain(cuda_device, M, N):  # noqa: F811
    """K2's two-set variant with a source past the resident ceiling (800
    queries over 1024 keys: the streamed kernel) and the reverse (1024 over
    800), against the plain version within the bf16 kernel line's
    tolerance, with a masked source."""
    layer = attention_cuda.pack_layer(_layer(np.random.default_rng(8)), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(M * N)
    x = torch.randn((1, M, 256), generator=g, device=cuda_device)
    src = torch.randn((1, N, 256), generator=g, device=cuda_device)
    m_src = torch.arange(N, device=cuda_device)[None] < N - N // 5
    before = attention_cuda.streamed_launches
    got = attention_cuda.superglue_layer_two_set(x, src, m_src, layer,
                                                 compute_dtype=torch.bfloat16)
    assert attention_cuda.streamed_launches - before == int(N > attention_cuda.MAX_K_BF16)
    ref = attention_cuda.superglue_layer_two_set_plain(x, src, m_src, layer,
                                                       compute_dtype=torch.bfloat16)
    assert ((got - ref).abs() <= 2.0 ** -8 * ref.abs() + 4e-3).all()


@pytest.mark.parametrize("K", [1024, 2048])
def test_match_pair_takes_any_keypoint_budget(cuda_device, K):  # noqa: F811
    """``match_pair`` at bf16 with K keypoints per set, past both resident
    kernels: 18 streamed K2 launches and one global-memory K3 launch, a
    finite log plan of shape (1, K+1, K+1), equal bit for bit when the
    match runs again."""
    from rspl_slam_tpu_torch.config import SuperGlueConfig
    from rspl_slam_tpu_torch.models import superglue
    from rspl_slam_tpu_torch.models.weights import superglue_from_numpy

    cfg = SuperGlueConfig()
    sg = superglue_from_numpy(superglue.init_params(cfg, 0), cfg, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K)

    def side():
        xy = torch.rand((1, K, 2), generator=g, device=cuda_device) * torch.tensor(
            [cfg.image_width, cfg.image_height], device=cuda_device)
        desc = torch.nn.functional.normalize(
            torch.randn((1, K, 256), generator=g, device=cuda_device), dim=-1)
        return (xy, torch.rand((1, K), generator=g, device=cuda_device), desc,
                torch.arange(K, device=cuda_device)[None] < K - 17)

    sides = side() + side()
    before = (attention_cuda.streamed_launches, sinkhorn_cuda.global_launches)
    res = superglue.match_pair(sg, *sides, cfg, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert attention_cuda.streamed_launches - before[0] == cfg.num_gnn_layers
    assert sinkhorn_cuda.global_launches - before[1] == 1
    assert tuple(res.log_plan.shape) == (1, K + 1, K + 1)
    assert torch.isfinite(res.log_plan).all()
    again = superglue.match_pair(sg, *sides, cfg, compute_dtype=torch.bfloat16)
    assert torch.equal(again.log_plan, res.log_plan)


def test_loader_threads_decode_every_image_kind_to_its_pinned_hash(cuda_device):  # noqa: F811
    """On the card's machine, where PIL is absent: ``NativeStereoLoader``'s
    decode threads read every readable fixture of ``tests/fixtures/
    image_kinds`` (progressive, arithmetic-coded, lossless, CMYK, YCCK,
    RGB, 4:1:1 JPEG; netpbm P1-P6, PFM; TIFF with libtiff's JPEG, CCITT and
    YCbCr codecs among them, BMP and the headerless DIB; GIF; WebP
    lossless, lossy, with alpha, animated; QOI, Sun raster, PCX, SGI, TGA,
    ICO, CUR, DDS with BC1, BC6H and BC7 blocks) to the PIL sha256 its
    manifest pins, and refuse the kinds PIL refuses, and those the port
    does not read yet, with ``NotImplementedError``."""
    import hashlib
    import json
    import os

    from rspl_slam_tpu_torch import native

    root = os.path.join(os.path.dirname(__file__), "fixtures", "image_kinds")
    with open(os.path.join(root, "manifest.json")) as f:
        files = json.load(f)["files"]
    for name, entry in sorted(files.items()):
        path = os.path.join(root, name)
        if entry.get("refused"):
            with native.NativeStereoLoader([path], [path], 48, 64, threads=2) as loader:
                with pytest.raises(NotImplementedError):
                    next(loader)
            continue
        with open(path, "rb") as f:
            H, W = native.image_size(f.read())
        with native.NativeStereoLoader([path] * 3, [path] * 3, H, W, threads=3) as loader:
            for _, left, right in loader:
                for img in (left, right):
                    u8 = np.round(img * 255).astype(np.uint8)
                    assert hashlib.sha256(u8.tobytes()).hexdigest() == entry["sha256"], name
