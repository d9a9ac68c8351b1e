"""The port's ``.pth`` loaders and ``.npz`` pytree IO against the JAX
package's.

Random state dicts in the public checkpoint layouts (key names, OIHW and
Conv1d shapes, BatchNorm running statistics; the builders are copies of
``tests/test_weight_loading.py``'s) are saved with ``torch.save`` and read
by both packages' ``load_torch_weights``: every array must be equal
(``assert_array_equal``, tolerance 0).
"""

import jax
import numpy as np
import pytest
import torch

from rspl_slam_tpu.config import SuperGlueConfig as JSGC
from rspl_slam_tpu.models import rcf as jrcf
from rspl_slam_tpu.models import superglue as jsg
from rspl_slam_tpu.models import superpoint as jsp
from rspl_slam_tpu.models import weights as jweights
from rspl_slam_tpu_torch.config import SuperGlueConfig
from rspl_slam_tpu_torch.models import rcf, superglue, superpoint, weights

SG = dict(descriptor_dim=64, keypoint_encoder=(32,), num_gnn_layers=4, num_heads=4,
          sinkhorn_iterations=30, image_width=160, image_height=120)


def _t(rng, *shape, scale=0.3):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _superpoint_sd(rng):
    sd = {}
    for name, cin, cout, k in superpoint.LAYERS:
        sd[f"{name}.weight"] = _t(rng, cout, cin, k, k)
        sd[f"{name}.bias"] = _t(rng, cout, scale=0.05)
    return sd


def _bn_sd(sd, prefix, rng, ch):
    sd[f"{prefix}.weight"] = _t(rng, ch, scale=0.2) + 1.0
    sd[f"{prefix}.bias"] = _t(rng, ch, scale=0.1)
    sd[f"{prefix}.running_mean"] = _t(rng, ch, scale=0.2)
    sd[f"{prefix}.running_var"] = torch.from_numpy(rng.uniform(0.5, 2.0, ch).astype(np.float32))
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(1000)


def _conv1d_sd(sd, prefix, rng, cin, cout):
    sd[f"{prefix}.weight"] = _t(rng, cout, cin, 1, scale=1.0 / np.sqrt(cin))
    sd[f"{prefix}.bias"] = _t(rng, cout, scale=0.05)


def _superglue_sd(rng, cfg):
    d = cfg.descriptor_dim
    sd = {}
    chans = [3, *cfg.keypoint_encoder, d]
    seq = 0
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        _conv1d_sd(sd, f"kenc.encoder.{seq}", rng, cin, cout)
        seq += 1
        if i < len(chans) - 2:
            _bn_sd(sd, f"kenc.encoder.{seq}", rng, cout)
            seq += 2
    for li in range(cfg.num_gnn_layers):
        base = f"gnn.layers.{li}"
        for p in range(3):
            _conv1d_sd(sd, f"{base}.attn.proj.{p}", rng, d, d)
        _conv1d_sd(sd, f"{base}.attn.merge", rng, d, d)
        _conv1d_sd(sd, f"{base}.mlp.0", rng, 2 * d, 2 * d)
        _bn_sd(sd, f"{base}.mlp.1", rng, 2 * d)
        _conv1d_sd(sd, f"{base}.mlp.3", rng, 2 * d, d)
    _conv1d_sd(sd, "final_proj", rng, d, d)
    sd["bin_score"] = torch.tensor(0.8)
    return sd


def _rcf_sd(rng):
    sd = {}
    for si, (_, convs) in enumerate(rcf.STAGES, start=1):
        for i, (cin, cout) in enumerate(convs):
            sd[f"conv{si}_{i + 1}.weight"] = _t(rng, cout, cin, 3, 3, scale=0.05)
            sd[f"conv{si}_{i + 1}.bias"] = _t(rng, cout, scale=0.02)
            sd[f"conv{si}_{i + 1}_down.weight"] = _t(rng, rcf.SIDE_CH, cout, 1, 1, scale=0.05)
            sd[f"conv{si}_{i + 1}_down.bias"] = _t(rng, rcf.SIDE_CH, scale=0.02)
        sd[f"score_dsn{si}.weight"] = _t(rng, 1, rcf.SIDE_CH, 1, 1, scale=0.1)
        sd[f"score_dsn{si}.bias"] = _t(rng, 1, scale=0.02)
    sd["score_final.weight"] = _t(rng, 1, 5, 1, 1, scale=0.3)
    sd["score_final.bias"] = _t(rng, 1, scale=0.02)
    return sd


def assert_trees_equal(port, ref):
    """Same structure, every leaf equal (tolerance 0)."""
    a, b = weights.flatten_pytree(port), jweights.flatten_pytree(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("model", ["superpoint", "superglue", "rcf", "rcf_module_nested"])
def test_loader_matches_jax(model, tmp_path):
    """Each port loader equals the JAX loader array for array; RCF also
    from a DataParallel-style checkpoint (``module.`` keys nested under
    ``state_dict``), which both loaders unwrap."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / f"{model}.pth")
    if model == "superpoint":
        torch.save(_superpoint_sd(rng), path)
        port, ref = superpoint.load_torch_weights(path), jsp.load_torch_weights(path)
    elif model == "superglue":
        torch.save(_superglue_sd(rng, SuperGlueConfig(**SG)), path)
        port = superglue.load_torch_weights(path, SuperGlueConfig(**SG))
        ref = jsg.load_torch_weights(path, JSGC(**SG))
    else:
        sd = _rcf_sd(rng)
        if model == "rcf_module_nested":
            sd = {"epoch": 3, "state_dict": {f"module.{k}": v for k, v in sd.items()}}
        torch.save(sd, path)
        port, ref = rcf.load_torch_weights(path), jrcf.load_torch_weights(path)
    assert_trees_equal(port, ref)


def test_superglue_head_permutation_matters(tmp_path):
    """The head-layout permutation is applied: the loaded q/k/v output and
    merge input channels differ from a plain transpose of the checkpoint
    (so a loader that skipped it would fail the parity test above), and
    the permuted layer's matcher output changes when it is undone."""
    cfg = SuperGlueConfig(**SG)
    sd = _superglue_sd(np.random.default_rng(1), cfg)
    path = str(tmp_path / "sg.pth")
    torch.save(sd, path)
    params = superglue.load_torch_weights(path, cfg)
    plain_q = sd["gnn.layers.0.attn.proj.0.weight"].numpy()[..., 0].T
    plain_merge = sd["gnn.layers.0.attn.merge.weight"].numpy()[..., 0].T
    assert not np.array_equal(params["gnn"][0]["q"]["w"], plain_q)
    assert not np.array_equal(params["gnn"][0]["merge"]["w"], plain_merge)
    d, h = cfg.descriptor_dim, cfg.num_heads
    perm = np.arange(d).reshape(d // h, h).T.ravel()
    np.testing.assert_array_equal(params["gnn"][0]["q"]["w"], plain_q[:, perm])

    sgm = weights.superglue_from_numpy(params, cfg, "cpu")
    bad = weights.to_numpy_tree(params)
    bad["gnn"][0]["q"] = {"w": plain_q, "b": sd["gnn.layers.0.attn.proj.0.bias"].numpy()}
    sgm_bad = weights.superglue_from_numpy(bad, cfg, "cpu")
    rng = np.random.default_rng(2)
    M = 16
    xy = torch.from_numpy(rng.uniform(0, 100, (1, M, 2)).astype(np.float32))
    sc = torch.from_numpy(rng.random((1, M)).astype(np.float32))
    de = torch.nn.functional.normalize(torch.randn(1, M, d, generator=torch.Generator()
                                                   .manual_seed(3)), dim=-1)
    mask = torch.ones(1, M, dtype=torch.bool)
    z = [superglue.match_pair(m, xy, sc, de, mask, xy, sc, de, mask, cfg,
                              compute_dtype=torch.float32).log_plan for m in (sgm, sgm_bad)]
    assert float((z[0] - z[1]).abs().max()) > 1e-3


def test_npz_pytree_roundtrip_both_packages(tmp_path):
    """A pytree saved by either package loads in the other unchanged; the
    port's flatten equals the JAX one key for key."""
    params = jsg.init_params(jax.random.PRNGKey(0), JSGC(**SG))
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jweights.save_npz_pytree(a, params)
    n = weights.save_npz_pytree(b, weights.to_numpy_tree(params))
    assert n == len(jweights.flatten_pytree(params))
    assert_trees_equal(weights.load_npz_pytree(a), params)
    assert_trees_equal(jweights.load_npz_pytree(b), params)


@pytest.mark.parametrize("ext", [".npz", ".pth"])
def test_load_params_dispatch(ext, tmp_path):
    """``load_params`` reads either format for each model name."""
    sd = _superpoint_sd(np.random.default_rng(5))
    pth = str(tmp_path / "sp.pth")
    torch.save(sd, pth)
    direct = superpoint.load_torch_weights(pth)
    path = pth
    if ext == ".npz":
        path = str(tmp_path / "sp.npz")
        weights.save_npz_pytree(path, direct)
    assert_trees_equal(weights.load_params(path, "superpoint"), direct)


# trained trees across the packages: a few CPU steps of each package's
# trainer at a small size, written by its own writer, read by the other
# package's loader, and run through both packages' inference at f32
TRAIN_CAM = dict(image_width=96, image_height=64, fx=80.0, fy=80.0, cx=48.0, cy=32.0, bf=8.0)


def _frame(h=120, w=160):
    """One rendered 160×120 frame (blobs) both packages extract from."""
    from rspl_slam_tpu_torch.config import CameraConfig
    from rspl_slam_tpu_torch.evaluation import synthetic

    cam = CameraConfig(image_width=w, image_height=h, fx=120.0, fy=120.0, cx=80.0, cy=60.0,
                       bf=12.0)
    scene = synthetic.make_scene(num_points=150, num_lines=0, seed=3, extent=(4.0, 3.0, 4.0))
    return synthetic.render_images(scene, cam, np.eye(4), seed=3)[0]


def _assert_same_keypoints(jax_params, port_params):
    import jax.numpy as jnp

    from rspl_slam_tpu.config import SuperPointConfig as JSPC
    from rspl_slam_tpu_torch.config import SuperPointConfig

    img = _frame()
    fj = jsp.extract(jax_params, jnp.asarray(img[None]),
                     JSPC(max_keypoints=64, keypoint_threshold=1e-4), jnp.float32)
    ft = superpoint.extract(weights.superpoint_from_numpy(port_params, "cpu"),
                            torch.as_tensor(img[None]),
                            SuperPointConfig(max_keypoints=64, keypoint_threshold=1e-4),
                            torch.float32)
    np.testing.assert_array_equal(np.asarray(fj.valid), ft.valid.numpy())
    assert ft.valid.sum() > 10
    np.testing.assert_allclose(np.asarray(fj.xy), ft.xy.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(fj.desc), ft.desc.numpy(), atol=1e-4)


def test_port_trained_superpoint_loads_into_jax(tmp_path):
    """The port's trained SuperPoint, written as ``pretrain`` writes it
    (``save_npz_pytree``), loads through the JAX package's
    ``superpoint_train.load_params`` and gives the port's keypoints through
    JAX's ``extract`` (f32; positions within 1e-4 px)."""
    from rspl_slam_tpu.training import superpoint_train as JT
    from rspl_slam_tpu_torch.config import CameraConfig
    from rspl_slam_tpu_torch.training import superpoint_train as T

    trained = T.train(CameraConfig(**TRAIN_CAM), steps=2, batch=1, seed=0,
                      params=superpoint.init_params(0), verbose=False, device="cpu")
    path = str(tmp_path / "sp.npz")
    weights.save_npz_pytree(path, trained)
    loaded = JT.load_params(path)
    assert_trees_equal(weights.to_numpy_tree(loaded), trained)
    _assert_same_keypoints(loaded, weights.load_params(path, "superpoint"))


@pytest.mark.parametrize("model", ["superpoint", "superglue"])
def test_jax_trained_tree_loads_into_port(model, tmp_path):
    """A JAX-trained tree written by the JAX CLI's writer
    (``save_npz_pytree``) loads through the port's ``load_params`` and runs
    the port's inference as it runs JAX's (f32: SuperPoint keypoints within
    1e-4 px; SuperGlue log plans within 1e-4)."""
    path = str(tmp_path / f"{model}.npz")
    if model == "superpoint":
        from rspl_slam_tpu.config import CameraConfig as JCam
        from rspl_slam_tpu.training import superpoint_train as JT

        trained = JT.train(JCam(**TRAIN_CAM), steps=2, batch=1, seed=0, verbose=False)
        jweights.save_npz_pytree(path, trained)
        loaded = weights.load_params(path, "superpoint")
        assert_trees_equal(loaded, weights.to_numpy_tree(trained))
        _assert_same_keypoints(trained, loaded)
        return
    import jax.numpy as jnp

    from rspl_slam_tpu.training import superglue_train as JG
    from rspl_slam_tpu_torch.config import SuperGlueConfig
    from rspl_slam_tpu_torch.training import superglue_train as G

    cfg = dict(image_width=160, image_height=120, num_gnn_layers=2, sinkhorn_iterations=10)
    trained, _ = JG.train(JSGC(**cfg), steps=3, batch=2, K=16, verbose=False)
    jweights.save_npz_pytree(path, trained)
    loaded = weights.load_params(path, "superglue")
    assert_trees_equal(loaded, weights.to_numpy_tree(trained))
    batch = G.make_batch_numpy(np.random.default_rng(4), 2, 16, SuperGlueConfig(**cfg))
    zj = jsg.match_pair(trained, *map(jnp.asarray, batch[:8]), JSGC(**cfg),
                        jnp.float32).log_plan
    tb = G.make_batch(np.random.default_rng(4), 2, 16, SuperGlueConfig(**cfg), "cpu")
    zt = superglue.match_pair(weights.superglue_from_numpy(loaded, SuperGlueConfig(**cfg),
                                                           "cpu"), *tb[:8],
                              compute_dtype=torch.float32).log_plan
    np.testing.assert_allclose(np.asarray(zj), zt.numpy(), atol=1e-4)
