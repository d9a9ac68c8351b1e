"""Parity of the port's three kernels with the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that version against the JAX functions (XLA, and the Pallas
kernels in interpret mode). tests/test_torch_cuda.py holds the CUDA
kernels against the same plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import np_tree

from rspl_slam_tpu.config import SuperGlueConfig
from rspl_slam_tpu.models import superglue as jsg
from rspl_slam_tpu.models import superpoint as jsp
from rspl_slam_tpu.models.superglue import _apply_mlp, _attention
from rspl_slam_tpu.ops.attention_pallas import attention_layer_fused
from rspl_slam_tpu.ops.conv_stem_pallas import superpoint_stem as jax_stem
from rspl_slam_tpu.ops.sinkhorn import log_optimal_transport_masked as jax_ot
from rspl_slam_tpu.ops.sinkhorn_pallas import log_optimal_transport_masked_pallas
from rspl_slam_tpu_torch.ops import attention_cuda, conv_stem_cuda, sinkhorn, sinkhorn_cuda


def _stem_params():
    p = np_tree(jsp.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for n in ("conv1a", "conv1b"):  # non-zero biases exercise the bias path
        p[n]["b"] = (0.05 * rng.standard_normal(p[n]["b"].shape)).astype(np.float32)
    return p


def _port_stem(p, imgs, dtype):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = conv_stem_cuda.superpoint_stem(t(p["conv1a"]["w"]), t(p["conv1a"]["b"]),
                                         t(p["conv1b"]["w"]), t(p["conv1b"]["b"]),
                                         t(imgs), dtype)
    return out.float().numpy()


def _jax_stage1(p, imgs, dtype):
    from rspl_slam_tpu.models.superpoint import _conv, _pool2

    x = jnp.asarray(imgs)[..., None]
    x = jax.nn.relu(_conv(x, p["conv1a"], dtype))
    x = jax.nn.relu(_conv(x, p["conv1b"], dtype))
    return np.asarray(_pool2(x), np.float32)


def _rel(ref, out, floor=1e-3):
    return np.abs(ref - out) / (np.abs(ref) + floor)


@pytest.mark.parametrize("H,W", [(32, 64), (40, 64)])  # 40: ragged row tile
def test_stem_f32_matches_xla(H, W):
    """f32: same arithmetic up to summation order → rel < 1e-4. The floor
    of the relative error is 1e-2 (activations are O(0.5)): a 576-term f32
    sum that cancels to ~1e-3 keeps an absolute error of a few 1e-7 from
    the order of its terms, whatever the size of the result."""
    p = _stem_params()
    imgs = np.random.default_rng(0).random((2, H, W)).astype(np.float32)
    ref = _jax_stage1(p, imgs, jnp.float32)
    out = _port_stem(p, imgs, torch.float32)
    assert out.shape == ref.shape
    assert _rel(ref, out, floor=1e-2).max() < 1e-4


@pytest.mark.parametrize("H,W", [(32, 64), (40, 64)])
def test_stem_bf16_matches_xla_and_pallas(H, W):
    """bf16: both round activations to bf16 at different points (XLA adds
    the conv1a bias in f32 then casts; order of sums differs) → rel < 0.05,
    the JAX package's own stem tolerance."""
    p = _stem_params()
    imgs = np.random.default_rng(0).random((2, H, W)).astype(np.float32)
    out = _port_stem(p, imgs, torch.bfloat16)
    ref = _jax_stage1(p, imgs, jnp.bfloat16)
    pal = np.asarray(jax_stem(p, jnp.asarray(imgs), interpret=True), np.float32)
    assert out.shape == ref.shape == pal.shape
    assert _rel(ref, out).max() < 0.05
    assert _rel(pal, out).max() < 0.05


def test_stem_side_mode_matches_rcf_pallas():
    """K1's side-output mode in RCF's stage-1 recipe vs the interpreted
    Pallas stem of models/rcf.py. RCF activations are O(100-1000) and
    intermediates round to bf16, so compare on the activation scale: worst
    deviation ≤ 5% and mean ≤ 1% of the mean magnitude (the JAX package's
    test_rcf_stem_matches_xla tolerance)."""
    from rspl_slam_tpu.models import rcf as R

    params = np_tree(R.init_params(jax.random.PRNGKey(3)))
    imgs = np.random.default_rng(2).random((2, 32, 64)).astype(np.float32)
    x_ref, (s_ref,) = R._stem_pallas(params, jnp.asarray(imgs * 255.0), jnp.bfloat16,
                                     interpret=True)
    x_ref = np.asarray(x_ref, np.float32)
    s_ref = np.asarray(s_ref, np.float32)

    ws = params["conv1_score"]["w"][0, 0, :, 0]

    def side_w(i):
        return torch.from_numpy(params[f"conv1_{i + 1}_down"]["w"][0, 0] @ ws)

    bias = params["conv1_score"]["b"].astype(np.float32) + sum(
        params[f"conv1_{i + 1}_down"]["b"] @ ws for i in range(2))
    t = torch.from_numpy
    w11 = params["conv1_1"]["w"].sum(axis=2, keepdims=True)
    x11 = conv_stem_cuda.conv1a(t(imgs * 255.0), t(w11), t(params["conv1_1"]["b"]),
                                torch.bfloat16)
    s1a = torch.einsum("bhwc,c->bhw", x11.float(), side_w(0).to(torch.bfloat16).float())
    x12, s1b = conv_stem_cuda.conv3x3_relu_pool(x11, t(params["conv1_2"]["w"]),
                                                t(params["conv1_2"]["b"]), side_w(1))
    x = x12.float().numpy()
    s1 = (s1a + s1b).numpy() + bias
    assert x.shape == x_ref.shape and s1.shape == s_ref.shape == (2, 32, 64)
    scale = np.abs(x_ref).mean()
    d = np.abs(x - x_ref)
    assert d.max() < 0.05 * scale and d.mean() < 0.01 * scale, (d.max(), scale)
    sscale = np.abs(s_ref).mean() + 1e-3
    assert np.abs(s1 - s_ref).max() < 0.05 * sscale


def _layer_params():
    cfg = SuperGlueConfig(num_gnn_layers=2)
    params = np_tree(jsg.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(7)
    for layer in params["gnn"]:  # non-trivial folded BN and biases
        m0 = layer["mlp"][0]
        m0["bn_scale"] = (1.0 + 0.2 * rng.standard_normal(m0["bn_scale"].shape)).astype(np.float32)
        m0["bn_shift"] = (0.1 * rng.standard_normal(m0["bn_shift"].shape)).astype(np.float32)
        for n in ("q", "k", "v", "merge"):
            layer[n]["b"] = (0.1 * rng.standard_normal(layer[n]["b"].shape)).astype(np.float32)
    return params


@pytest.mark.parametrize("cross", [False, True])
def test_superglue_layer_matches_jax(cross):
    """Plain stacked layer vs ``_attention`` + ``_apply_mlp`` at f32 and vs
    the interpreted Pallas layer, per set: f32 everywhere, only summation
    order differs → atol 2e-4 / rtol 1e-4."""
    params = _layer_params()
    layer = params["gnn"][1 if cross else 0]
    rng = np.random.default_rng(1)
    K, C = 48, 256
    xs = [rng.standard_normal((K, C)).astype(np.float32) for _ in range(2)]
    masks = [np.arange(K) < 40, np.arange(K) < 45]
    out = attention_cuda.superglue_layer(
        torch.from_numpy(np.stack(xs)), torch.from_numpy(np.stack(masks)),
        attention_cuda.pack_layer(layer, "cpu"), cross).numpy()
    for s in range(2):
        src = 1 - s if cross else s
        x, sx, sm = jnp.asarray(xs[s]), jnp.asarray(xs[src]), jnp.asarray(masks[src])
        msg = _attention(layer, x[None], sx[None], sm[None], 4, jnp.float32)
        ref = (x[None] + _apply_mlp(layer["mlp"], jnp.concatenate([x[None], msg], -1),
                                    jnp.float32))[0]
        np.testing.assert_allclose(out[s], np.asarray(ref), atol=2e-4, rtol=1e-4)
        fused = attention_layer_fused(x, sx, sm, layer, interpret=True)
        np.testing.assert_allclose(out[s], np.asarray(fused), atol=2e-4, rtol=1e-4)


def test_sinkhorn_matches_xla_and_pallas():
    """Plain sweeps (through the K3 wrapper's CPU path) vs the XLA and the
    interpreted Pallas Sinkhorn: max error < 1e-4 on valid rows, columns
    and dustbins (masked slots carry −1e9 in all three)."""
    rng = np.random.default_rng(0)
    B, M, N = 2, 24, 40
    S = rng.standard_normal((B, M, N)).astype(np.float32)
    m0 = np.arange(M)[None] < np.array([[M], [17]])
    m1 = np.arange(N)[None] < np.array([[33], [N]])
    Zx = np.asarray(jax_ot(jnp.asarray(S), jnp.asarray(m0), jnp.asarray(m1),
                           jnp.asarray(0.7), 50))
    Zp = np.asarray(log_optimal_transport_masked_pallas(
        jnp.asarray(S), jnp.asarray(m0), jnp.asarray(m1), jnp.asarray(0.7), 50,
        interpret=True))
    t = torch.from_numpy
    Zt = sinkhorn_cuda.log_optimal_transport_masked(t(S), t(m0), t(m1), 0.7, 50).numpy()
    Zq = sinkhorn.log_optimal_transport_masked(t(S), t(m0), t(m1), 0.7, 50).numpy()
    sel = (np.concatenate([m0, np.ones((B, 1), bool)], 1)[:, :, None]
           & np.concatenate([m1, np.ones((B, 1), bool)], 1)[:, None, :])
    for ref in (Zx, Zp):
        assert np.abs(ref - Zt)[sel].max() < 1e-4
    np.testing.assert_array_equal(Zt, Zq)
