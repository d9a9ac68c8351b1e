"""Parity of the port's SuperPoint and SuperGlue with the JAX package, with
the same weights carried across through the weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import np_tree

from rspl_slam_tpu.config import SuperGlueConfig as JSGC
from rspl_slam_tpu.config import SuperPointConfig as JSPC
from rspl_slam_tpu.models import superglue as jsg
from rspl_slam_tpu.models import superpoint as jsp
from rspl_slam_tpu.models.weights import save_npz_pytree
from rspl_slam_tpu_torch.config import SuperGlueConfig, SuperPointConfig
from rspl_slam_tpu_torch.models import superglue as tsg
from rspl_slam_tpu_torch.models import superpoint as tsp
from rspl_slam_tpu_torch.models import weights


def test_superpoint_extract_matches_jax():
    """64×96 at f32. Keypoints are compared as SETS (lax.top_k and
    torch.topk may order ties differently); scores to 1e-5 and descriptors
    to 1e-4 at matched keypoints."""
    params = np_tree(jsp.init_params(jax.random.PRNGKey(0)))
    imgs = np.random.default_rng(0).random((2, 64, 96)).astype(np.float32)
    kw = dict(max_keypoints=60, keypoint_threshold=0.005)
    fj = jsp.extract(params, jnp.asarray(imgs), JSPC(**kw), jnp.float32)
    sp = weights.superpoint_from_numpy(params, "cpu")
    ft = tsp.extract(sp, torch.from_numpy(imgs), SuperPointConfig(**kw), torch.float32)
    for b in range(2):
        vj = np.asarray(fj.valid[b])
        vt = ft.valid[b].numpy()
        assert vj.sum() == vt.sum() > 20
        kj = {tuple(p): i for i, p in enumerate(np.asarray(fj.xy[b])[vj])}
        kt = {tuple(p): i for i, p in enumerate(ft.xy[b].numpy()[vt])}
        assert kj.keys() == kt.keys()
        ij = [kj[k] for k in kj]
        it = [kt[k] for k in kj]
        np.testing.assert_allclose(ft.score[b].numpy()[vt][it],
                                   np.asarray(fj.score[b])[vj][ij], atol=1e-5)
        np.testing.assert_allclose(ft.desc[b].numpy()[vt][it],
                                   np.asarray(fj.desc[b])[vj][ij], atol=1e-4)


def _match_inputs(K=64, C=256, seed=0):
    rng = np.random.default_rng(seed)
    d0 = rng.standard_normal((1, K, C)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    perm = rng.permutation(K)
    d1 = d0[:, perm] + 0.05 * rng.standard_normal((1, K, C)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    xy0 = rng.uniform([0, 0], [752, 480], (1, K, 2)).astype(np.float32)
    xy1 = (xy0[:, perm] + rng.normal(0, 2, (1, K, 2))).astype(np.float32)
    s0 = rng.random((1, K)).astype(np.float32)
    s1 = s0[:, perm]
    m0 = np.arange(K)[None] < K - 5
    m1 = np.arange(K)[None] < K - 9
    return xy0, s0, d0, m0, xy1, s1, d1.astype(np.float32), m1


def _match_params():
    """2-layer SuperGlue weights for the matcher parity tests: random, with
    the residual updates scaled down and a near-identity final projection
    so that the descriptors still decide and the decode has matches to
    agree on."""
    cfg = JSGC(num_gnn_layers=2)
    params = np_tree(jsg.init_params(jax.random.PRNGKey(1), cfg))
    rng = np.random.default_rng(4)
    for layer in params["gnn"]:
        layer["mlp"][1]["w"] *= 0.05
    params["kenc"][-1]["w"] *= 0.05
    params["final_proj"]["w"] = (12.0 * np.eye(256) + 0.05 * rng.standard_normal(
        (256, 256))).astype(np.float32)
    params["bin_score"] = np.asarray(3.0, np.float32)
    return cfg, params


def _valid_plan(Z, args):
    """The log plan on valid rows and columns (dustbins dropped)."""
    return np.asarray(Z)[:, :-1, :-1][:, args[3][0]][:, :, args[7][0]]


def test_match_pair_matches_jax():
    """2 GNN layers, 20 Sinkhorn iterations, f32 on both sides: equal
    indices0 (and a log plan within 1e-3)."""
    cfg, params = _match_params()
    args = _match_inputs()
    rj = jsg.match_pair(params, *[jnp.asarray(a) for a in args], cfg, jnp.float32,
                        sinkhorn_iters=20)
    tcfg = SuperGlueConfig(num_gnn_layers=2)
    sg = weights.superglue_from_numpy(params, tcfg, "cpu")
    rt = tsg.match_pair(sg, *[torch.from_numpy(a) for a in args], tcfg, sinkhorn_iters=20)
    i0 = rt.indices0.numpy()
    np.testing.assert_array_equal(i0, np.asarray(rj.indices0))
    assert (i0 >= 0).sum() > 10
    np.testing.assert_allclose(_valid_plan(rt.log_plan.numpy(), args),
                               _valid_plan(rj.log_plan, args), atol=1e-3)


def test_match_pair_bf16_matches_jax():
    """The JAX package's default compute_dtype: both sides at bf16, same
    inputs and weights as the f32 test. Equal indices0 and a log plan
    within 3e-3: both round the same operands to bf16 and sum in f32, so
    only an intermediate that rounds to the other side of a bf16 boundary
    after another f32 summation order separates them (1.2e-3 measured on
    the CPU). A port that ignores the dtype and stays f32 reads 1.2e-2."""
    cfg, params = _match_params()
    args = _match_inputs()
    rj = jsg.match_pair(params, *[jnp.asarray(a) for a in args], cfg, jnp.bfloat16,
                        sinkhorn_iters=20)
    tcfg = SuperGlueConfig(num_gnn_layers=2)
    sg = weights.superglue_from_numpy(params, tcfg, "cpu")
    rt = tsg.match_pair(sg, *[torch.from_numpy(a) for a in args], tcfg, sinkhorn_iters=20,
                        compute_dtype=torch.bfloat16)
    i0 = rt.indices0.numpy()
    np.testing.assert_array_equal(i0, np.asarray(rj.indices0))
    assert (i0 >= 0).sum() > 10
    np.testing.assert_allclose(_valid_plan(rt.log_plan.numpy(), args),
                               _valid_plan(rj.log_plan, args), atol=3e-3)


def test_frontend_matches_at_its_compute_dtype(monkeypatch):
    """NeuralFrontend.match_indices (which the fused tracker calls too)
    hands the frontend's compute_dtype to match_pair: at bf16 it returns
    exactly match_pair's bf16 indices."""
    from test_torch_common import small_system_cfg

    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend

    cfg = small_system_cfg(width=752, height=480)
    _, params = _match_params()
    fe = NeuralFrontend(cfg, sg_params=params, compute_dtype=torch.bfloat16, device="cpu")
    args = [torch.from_numpy(a) for a in _match_inputs()]
    seen = []
    match_pair = tsg.match_pair

    def spy(*a, **kw):
        seen.append(kw.get("compute_dtype"))
        return match_pair(*a, **kw)

    monkeypatch.setattr(tsg, "match_pair", spy)
    got = fe.match_indices(*args)
    assert seen == [torch.bfloat16]
    ref = match_pair(fe.sg, *args, cfg.superglue, compute_dtype=torch.bfloat16).indices0
    assert torch.equal(got, ref) and (ref >= 0).sum() > 10


def test_descriptor_matcher_weights_keep_descriptors():
    """The end-to-end check's SuperGlue weights: the GNN leaves the
    descriptors unchanged and the similarity is sharpness·cos."""
    cfg = SuperGlueConfig(num_gnn_layers=2)
    p = tsg.descriptor_matcher_params(cfg, 0, 2000.0, 1980.0)
    sg = tsg.SuperGlue(p, cfg, "cpu")
    xy0, s0, d0, m0, *_ = _match_inputs(K=16)
    x = torch.from_numpy(np.concatenate([d0, d0], 0))
    enc = torch.cat([torch.from_numpy(np.concatenate([xy0, xy0], 0)),
                     torch.from_numpy(np.concatenate([s0, s0], 0))[..., None]], -1)
    assert torch.equal(tsg._apply_mlp(sg.kenc, enc), torch.zeros_like(x))
    from rspl_slam_tpu_torch.ops import attention_cuda

    m = torch.ones(2, 16, dtype=torch.bool)
    for li, layer in enumerate(sg.gnn):
        assert torch.allclose(attention_cuda.superglue_layer(x, m, layer, li % 2 == 1), x)
    md = x @ sg.final_w
    sim = (md[0] @ md[1].T) / 16.0
    torch.testing.assert_close(sim, 2000.0 * (x[0] @ x[1].T), rtol=1e-5, atol=1e-3)


def test_weight_bridge_npz_roundtrip(tmp_path):
    """An .npz pytree written by the JAX package loads in the port with
    numpy alone and builds the same modules."""
    params = jsp.init_params(jax.random.PRNGKey(2))
    path = str(tmp_path / "sp.npz")
    save_npz_pytree(path, params)
    loaded = weights.load_npz_pytree(path)
    for name in params:
        np.testing.assert_array_equal(loaded[name]["w"], np.asarray(params[name]["w"]))
    sp = weights.superpoint_from_numpy(loaded, "cpu")
    np.testing.assert_array_equal(sp.conv1b_hwio.numpy(), np.asarray(params["conv1b"]["w"]))
    np.testing.assert_array_equal(sp.convDb_w.numpy(), np.asarray(params["convDb"]["w"])[0, 0])
    cfg = JSGC(num_gnn_layers=2)
    sgp = jsg.init_params(jax.random.PRNGKey(3), cfg)
    save_npz_pytree(str(tmp_path / "sg.npz"), sgp)
    sg = weights.superglue_from_numpy(weights.load_npz_pytree(str(tmp_path / "sg.npz")),
                                      SuperGlueConfig(num_gnn_layers=2), "cpu")
    wqkv = np.concatenate([np.asarray(sgp["gnn"][1][n]["w"]) for n in "qkv"], 1)
    np.testing.assert_array_equal(sg.gnn[1]["wqkv"].numpy(), wqkv)
    # a public-layout .pth (OIHW convs) loads through the same entry point
    torch.save({f"{n}.{k}": torch.from_numpy(
        np.ascontiguousarray(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))) if k == "weight"
        else np.array(p["b"])) for n, p in params.items() for k in ("weight", "bias")},
        str(tmp_path / "sp.pth"))
    from_pth = weights.load_params(str(tmp_path / "sp.pth"), "superpoint")
    for name in params:
        np.testing.assert_array_equal(from_pth[name]["w"], np.asarray(params[name]["w"]))


def test_unported_matcher_shapes_raise():
    """The shapes that raised before the two-set matcher and the pixel-space
    NMS were ported now run: sets of 8 against 9 give a (1, 9, 10) plan,
    and ``nms_radius`` 2 extracts (tests/test_torch_unequal.py holds both
    against the JAX package)."""
    cfg = SuperGlueConfig(num_gnn_layers=2)
    sg = tsg.SuperGlue(tsg.init_params(cfg), cfg, "cpu")
    a = [torch.zeros(1, 8, 2), torch.zeros(1, 8), torch.zeros(1, 8, 256),
         torch.ones(1, 8, dtype=torch.bool)]
    b = [torch.zeros(1, 9, 2), torch.zeros(1, 9), torch.zeros(1, 9, 256),
         torch.ones(1, 9, dtype=torch.bool)]
    res = tsg.match_pair(sg, *a, *b, sinkhorn_iters=5)
    assert res.log_plan.shape == (1, 9, 10) and torch.isfinite(res.log_plan).all()
    assert res.indices0.shape == (1, 8) and res.indices1.shape == (1, 9)
    sp = tsp.SuperPoint(tsp.init_params(0))
    f = tsp.extract(sp, torch.zeros(1, 16, 16), SuperPointConfig(nms_radius=2, max_keypoints=32))
    assert f.xy.shape == (1, 32, 2) and f.desc.shape == (1, 32, 256)
