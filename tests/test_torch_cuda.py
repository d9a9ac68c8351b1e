"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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


@pytest.mark.parametrize("H,W", [(36, 50), (30, 44)])  # ragged 16×16 tiles
def test_conv_stem_kernel_matches_plain(cuda_device, H, W):  # noqa: F811
    """K1 vs its plain version: one bf16 rounding of near-equal f32 sums;
    the side score in f32 to rtol 1e-4."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((2, H, W, 64), generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randn((3, 3, 64, 64), generator=g, device=cuda_device) * 0.06
    b = torch.randn((64,), generator=g, device=cuda_device) * 0.1
    sw = torch.randn((64,), generator=g, device=cuda_device)
    got = conv_stem_cuda.conv3x3_relu_pool(x, w, b)
    got_s, side = conv_stem_cuda.conv3x3_relu_pool(x, w, b, sw)
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


def test_kernels_refuse_what_they_do_not_take(cuda_device):  # noqa: F811
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    x = torch.zeros((1, 8, 8, 64), device=cuda_device)  # f32, not bf16
    w = torch.zeros((3, 3, 64, 64), device=cuda_device)
    with pytest.raises(ValueError):
        conv_stem_cuda.conv3x3_relu_pool(x, w, torch.zeros(64, device=cuda_device))
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
