"""Parity with the JAX package of what the port runs for sets of unequal
size and for SuperPoint's pixel-space NMS: SuperGlue's two-set path
(``match_pair`` with M != N, one GNN layer of one set over another, the
training forward), ``dense_heads``, the pixel-space NMS and top-K,
``extract`` at ``nms_radius`` outside 3..8 and ``match_distance``. Inputs
are made with numpy from a seed and weights cross through the ``.npz``
bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import np_tree
from test_torch_models import _match_params

from rspl_slam_tpu.config import SuperGlueConfig as JSGC
from rspl_slam_tpu.config import SuperPointConfig as JSPC
from rspl_slam_tpu.models import superglue as jsg
from rspl_slam_tpu.models import superpoint as jsp
from rspl_slam_tpu.models.weights import save_npz_pytree
from rspl_slam_tpu.ops import keypoints as jkp
from rspl_slam_tpu.ops import matching as jmatch
from rspl_slam_tpu.training import superglue_train as jsgt
from rspl_slam_tpu_torch.config import SuperGlueConfig, SuperPointConfig
from rspl_slam_tpu_torch.models import superglue as tsg
from rspl_slam_tpu_torch.models import superpoint as tsp
from rspl_slam_tpu_torch.models import weights
from rspl_slam_tpu_torch.ops import attention_cuda
from rspl_slam_tpu_torch.ops import keypoints as tkp
from rspl_slam_tpu_torch.ops import matching as tmatch
from rspl_slam_tpu_torch.training import superglue_train as tsgt

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _unequal_inputs(M=24, N=17, C=256, seed=0):
    """Set 0 of M keypoints, set 1 of N: N - 3 of them noisy copies of
    set-0 keypoints (shuffled), 3 distractors; a few padded slots in each."""
    rng = np.random.default_rng(seed)

    def unit(a):
        return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)

    d0 = unit(rng.standard_normal((1, M, C)))
    xy0 = rng.uniform([0, 0], [752, 480], (1, M, 2)).astype(np.float32)
    n_shared = min(M, N) - 3
    src = rng.permutation(M)[:n_shared]
    d1 = unit(rng.standard_normal((1, N, C)))
    xy1 = rng.uniform([0, 0], [752, 480], (1, N, 2)).astype(np.float32)
    slots = rng.permutation(N)[:n_shared]
    d1[:, slots] = unit(d0[:, src] + 0.05 * rng.standard_normal((1, n_shared, C)))
    xy1[:, slots] = xy0[:, src] + rng.normal(0, 2, (1, n_shared, 2)).astype(np.float32)
    s0 = rng.random((1, M)).astype(np.float32)
    s1 = rng.random((1, N)).astype(np.float32)
    m0 = np.arange(M)[None] < M - 2
    m1 = np.arange(N)[None] < N - 1
    return xy0, s0, d0, m0, xy1, s1, d1, m1


def _valid_plan(Z, args):
    return np.asarray(Z, np.float32)[:, :-1, :-1][:, args[3][0]][:, :, args[7][0]]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,N", [(24, 17), (17, 24)])
def test_match_pair_unequal_matches_jax(M, N, dtype):
    """``match_pair`` with M != N (2 GNN layers, 20 Sinkhorn iterations)
    against the JAX package's unstacked path: equal indices0 and indices1,
    and a log plan within 1e-4 at f32 (summation order; 3.8e-6 measured on
    the CPU) or 3e-3 at bf16 (an intermediate rounding to the other side
    of a bf16 boundary, as in the equal-size bf16 test; 1.3e-3 measured)."""
    jdt, tdt = DTYPES[dtype]
    cfg, params = _match_params()
    args = _unequal_inputs(M, N)
    rj = jsg.match_pair(params, *[jnp.asarray(a) for a in args], cfg, jdt, sinkhorn_iters=20)
    tcfg = SuperGlueConfig(num_gnn_layers=2)
    sg = weights.superglue_from_numpy(params, tcfg, "cpu")
    rt = tsg.match_pair(sg, *[torch.from_numpy(a) for a in args], tcfg, sinkhorn_iters=20,
                        compute_dtype=tdt)
    assert rt.log_plan.shape == (1, M + 1, N + 1)
    i0 = rt.indices0.numpy()
    np.testing.assert_array_equal(i0, np.asarray(rj.indices0))
    np.testing.assert_array_equal(rt.indices1.numpy(), np.asarray(rj.indices1))
    assert (i0 >= 0).sum() >= 8
    np.testing.assert_allclose(_valid_plan(rt.log_plan.numpy(), args),
                               _valid_plan(rj.log_plan, args),
                               atol=1e-4 if dtype == "f32" else 3e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_set_layer_matches_jax(dtype):
    """One GNN layer of a set of 24 over a source of 17 (5 masked): the
    port's two-set plain layer against JAX's ``_attention`` plus the
    caller's residual MLP (models/superglue.py:316-334), random weights.
    Tolerance 2e-5 at f32 (summation order), and at bf16 |t - j| <=
    2^-8|j| + 4e-3, the K2 kernel checks' bound for one bf16 intermediate
    on the other side of a rounding boundary."""
    jdt, tdt = DTYPES[dtype]
    _, params = _match_params()
    layer = params["gnn"][0]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 24, 256)).astype(np.float32)
    src = rng.standard_normal((2, 17, 256)).astype(np.float32)
    mask = np.arange(17)[None] < np.array([[17], [12]])
    msg = jsg._attention(layer, jnp.asarray(x), jnp.asarray(src), jnp.asarray(mask), 4, jdt)
    ref = np.asarray(jnp.asarray(x) + jsg._apply_mlp(
        layer["mlp"], jnp.concatenate([jnp.asarray(x), msg], -1), jdt))
    sg = weights.superglue_from_numpy(params, SuperGlueConfig(num_gnn_layers=2), "cpu")
    got = attention_cuda.superglue_layer_two_set(
        torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(mask), sg.gnn[0],
        compute_dtype=tdt).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=4e-3)


@pytest.mark.parametrize("cross", [False, True])
def test_two_set_layer_on_equal_sets_is_the_stacked_layer(cross):
    """On sets of one size, the two-set plain layer of each set over its
    source (itself, or the other set) gives the stacked plain layer's
    halves: the two paths compute one function (f32, 1e-5: the q/k/v
    products run as other matmuls)."""
    rng = np.random.default_rng(3)
    _, params = _match_params()
    sg = weights.superglue_from_numpy(params, SuperGlueConfig(num_gnn_layers=2), "cpu")
    x = torch.from_numpy(rng.standard_normal((2, 20, 256)).astype(np.float32))
    masks = torch.arange(20)[None] < torch.tensor([[20], [14]])
    stacked = attention_cuda.superglue_layer_plain(x, masks, sg.gnn[1], cross)
    for s in (0, 1):
        o = 1 - s if cross else s
        got = attention_cuda.superglue_layer_two_set_plain(x[s:s + 1], x[o:o + 1],
                                                           masks[o:o + 1], sg.gnn[1])
        torch.testing.assert_close(got, stacked[s:s + 1], rtol=0, atol=1e-5)


def test_training_forward_unequal_matches_jax():
    """The training forward (``log_plan``, plain f32 with autograd) at M =
    24 against N = 17: the log plan within 1e-3 of JAX's f32
    ``match_pair`` and the loss within 1e-4 of JAX's ``loss_fn`` (M > N,
    where JAX's dustbin column M clamps to the port's N); the loss
    backpropagates to every GNN weight."""
    _, params = _match_params()
    cfg = JSGC(num_gnn_layers=2, sinkhorn_iterations=20)
    args = _unequal_inputs(24, 17)
    gt0 = np.full((1, 24), 17, np.int32)
    gt0[0, :5] = [3, 0, 9, 11, 2]
    gt0[~args[3]] = -1
    rj = jsg.match_pair(params, *[jnp.asarray(a) for a in args], cfg, jnp.float32)
    lj = float(jsgt.loss_fn(params, tuple(jnp.asarray(a) for a in (*args, gt0)), cfg))
    tcfg = SuperGlueConfig(num_gnn_layers=2, sinkhorn_iterations=20)
    tree = weights.to_tensor_tree(params, "cpu", requires_grad=True)
    targs = [torch.from_numpy(a) for a in args]
    Z = tsgt.log_plan(tree, *targs, tcfg)
    np.testing.assert_allclose(_valid_plan(Z.detach().numpy(), args),
                               _valid_plan(rj.log_plan, args), atol=1e-3)
    loss = tsgt.loss_fn(tree, (*targs, torch.from_numpy(gt0)), tcfg)
    assert abs(float(loss.detach()) - lj) < 1e-4
    loss.backward()
    for layer in tree["gnn"]:
        for n in ("q", "k", "v", "merge"):
            assert layer[n]["w"].grad is not None and torch.isfinite(layer[n]["w"].grad).all()
        assert float(layer["mlp"][0]["w"].grad.abs().sum()) > 0


def _sp_params(tmp_path):
    """Random SuperPoint weights through the ``.npz`` bridge: the JAX
    tree, and the port's module built from the file."""
    params = np_tree(jsp.init_params(jax.random.PRNGKey(0)))
    path = str(tmp_path / "sp.npz")
    save_npz_pytree(path, params)
    return params, weights.superpoint_from_numpy(weights.load_npz_pytree(path), "cpu")


def test_dense_heads_matches_jax(tmp_path):
    """Full-resolution scores and the descriptor map at f32 on a 64×96
    pair: within 1e-6 and 1e-5 (f32 convolutions summed in another
    order)."""
    params, sp = _sp_params(tmp_path)
    imgs = np.random.default_rng(1).random((2, 64, 96)).astype(np.float32)
    sj, dj = jsp.dense_heads(params, jnp.asarray(imgs), jnp.float32)
    st, dt = tsp.dense_heads(sp, torch.from_numpy(imgs), torch.float32)
    assert st.shape == (2, 64, 96) and dt.shape == (2, 256, 8, 12)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("radius", [2, 10])
def test_pixel_nms_and_top_k_match_jax(radius):
    """``simple_nms`` and ``top_k_keypoints`` on the same (2, 48, 64)
    score map: equal maps and equal keypoints (scores are distinct, so no
    tie can order them differently)."""
    rng = np.random.default_rng(radius)
    scores = rng.random((2, 48, 64)).astype(np.float32) ** 4
    nj = np.asarray(jkp.simple_nms(jnp.asarray(scores), radius))
    nt = tkp.simple_nms(torch.from_numpy(scores), radius)
    np.testing.assert_array_equal(nt.numpy(), nj)
    xy, sc, valid = tkp.top_k_keypoints(nt, 40, 0.01, 4)
    for b in range(2):
        xj, sj, vj = jkp.top_k_keypoints(jnp.asarray(nj[b]), 40, 0.01, 4)
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(vj))
        np.testing.assert_array_equal(xy[b].numpy(), np.asarray(xj))
        np.testing.assert_array_equal(sc[b].numpy(), np.asarray(sj))
        assert 0 < valid[b].sum() < 40 if radius == 10 else valid[b].all()


@pytest.mark.parametrize("radius", [2, 10])
def test_extract_pixel_path_matches_jax(tmp_path, radius):
    """``extract`` at ``nms_radius`` 2 and 10 (the pixel-space path) on a
    64×96 pair at f32: the same keypoints as sets (torch.topk and
    lax.top_k may order ties differently), scores within 1e-5 and
    descriptors within 1e-4 at matched keypoints, as the cell path's
    test."""
    params, sp = _sp_params(tmp_path)
    imgs = np.random.default_rng(0).random((2, 64, 96)).astype(np.float32)
    kw = dict(max_keypoints=60, keypoint_threshold=0.005, nms_radius=radius)
    fj = jsp.extract(params, jnp.asarray(imgs), JSPC(**kw), jnp.float32)
    ft = tsp.extract(sp, torch.from_numpy(imgs), SuperPointConfig(**kw), torch.float32)
    for b in range(2):
        vj = np.asarray(fj.valid[b])
        vt = ft.valid[b].numpy()
        assert vj.sum() == vt.sum() > 5
        kj = {tuple(p): i for i, p in enumerate(np.asarray(fj.xy[b])[vj])}
        kt = {tuple(p): i for i, p in enumerate(ft.xy[b].numpy()[vt])}
        assert kj.keys() == kt.keys()
        ij = [kj[k] for k in kj]
        it = [kt[k] for k in kj]
        np.testing.assert_allclose(ft.score[b].numpy()[vt][it],
                                   np.asarray(fj.score[b])[vj][ij], atol=1e-5)
        np.testing.assert_allclose(ft.desc[b].numpy()[vt][it],
                                   np.asarray(fj.desc[b])[vj][ij], atol=1e-4)


def test_match_distance_matches_jax():
    """DMatch distance of mutual scores: equal to JAX's in f32."""
    rng = np.random.default_rng(5)
    a, b = rng.random((2, 3, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        tmatch.match_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jmatch.match_distance(jnp.asarray(a), jnp.asarray(b))))


def test_merge_two_lines_matches_jax():
    """The scalar segment merge on random pairs, and pairs past the π wrap
    and with a vertical segment: within 1e-12 of JAX's (float64 host math,
    numpy's ufuncs against ``math``)."""
    from rspl_slam_tpu.ops import lines as jlines
    from rspl_slam_tpu_torch.ops import lines as tlines

    rng = np.random.default_rng(9)
    pairs = list(rng.uniform(0, 300, (40, 2, 4)))
    pairs += [(np.array([0.0, 0.0, 100.0, 2.0]), np.array([0.0, 5.0, 100.0, 3.0])),
              (np.array([10.0, 0.0, 10.0, 80.0]), np.array([12.0, 5.0, 13.0, 90.0]))]
    for a, b in pairs:
        np.testing.assert_allclose(tlines.merge_two_lines(a, b),
                                   jlines.merge_two_lines(a, b), rtol=0, atol=1e-12)


# JAX names whose port counterpart has another name or place: the Pallas
# modules became the CUDA wrappers (ops/*_cuda.py), and JAX's jit-keyed
# matcher factories, its traceable lazy-extraction core and its sharding
# helpers became methods and the Mesh idiom (parallel/mesh.py's notes)
COUNTERPARTS = {
    ("ops/attention_pallas.py", "attention_layer_fused"): "ops.attention_cuda.superglue_layer",
    ("ops/conv_stem_pallas.py", "conv3x3_nhcw"): "ops.conv_stem_cuda.conv3x3_relu_pool",
    ("ops/conv_stem_pallas.py", "conv1a_nhcw"): "ops.conv_stem_cuda.conv1a",
    ("ops/conv_stem_pallas.py", "conv3x3_cin1_nhcw"): "ops.conv_stem_cuda.conv1a",
    ("ops/conv_stem_pallas.py", "superpoint_stem"): "ops.conv_stem_cuda.superpoint_stem",
    ("ops/sinkhorn_pallas.py", "log_optimal_transport_masked_pallas"):
        "ops.sinkhorn_cuda.log_optimal_transport_masked",
    ("frontend/frontends.py", "make_superglue_match_fn"):
        "frontend.frontends.NeuralFrontend.match_indices",
    ("frontend/frontends.py", "make_cosine_match_fn"):
        "frontend.frontends.NeuralFrontend.match_indices",
    ("frontend/frontends.py", "lazy_extract_core"): "frontend.frontends.NeuralFrontend.lazy_extract",
    ("parallel/mesh.py", "data_sharding"): "parallel.mesh.Mesh.data_slice",
    ("parallel/mesh.py", "replicated"): "parallel.mesh.Mesh",
}


def test_every_public_jax_name_has_a_port_counterpart():
    """Every public top-level function and class of the JAX package has one
    of the same name in the port's module of the same path, or the
    counterpart that ``COUNTERPARTS`` names, and that counterpart exists."""
    import ast
    import importlib
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    jax_pkg, port = root / "rspl_slam_tpu", root / "rspl_slam_tpu_torch"

    def names(path):
        tree = ast.parse(path.read_text())
        return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and not n.name.startswith("_")}

    missing = []
    for f in sorted(jax_pkg.rglob("*.py")):
        rel = f.relative_to(jax_pkg).as_posix()
        twin = port / rel
        have = names(twin) if twin.exists() else set()
        for name in sorted(names(f) - have):
            target = COUNTERPARTS.get((rel, name))
            if target is None:
                missing.append(f"{rel}:{name}")
                continue
            parts = target.split(".")
            for i in range(len(parts), 0, -1):  # the longest importable module prefix
                try:
                    obj = importlib.import_module("rspl_slam_tpu_torch." + ".".join(parts[:i]))
                except ModuleNotFoundError:
                    continue
                for attr in parts[i:]:
                    obj = getattr(obj, attr)
                break
            else:
                missing.append(f"{rel}:{name} -> {target}")
    assert not missing, missing
