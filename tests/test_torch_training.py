"""The port's trainers (``rspl_slam_tpu_torch/training/``) against the JAX
package's (``rspl_slam_tpu/training/``), on the CPU, f32 on both sides.

The same numpy inputs and seeds go to both; JAX's parameters cross over
as numpy (``np_tree``). Sizes: a 96×64 camera for SuperPoint,
``width_mult=0.125`` at 48×64 for RCF, and 2 GNN layers / 10 Sinkhorn
iterations / K = 16 for SuperGlue. Tolerances:

- data (``make_batch``, ``render_edge_scene``, ``detector_labels``): equal
  bit for bit;
- losses: 1e-5 relative;
- gradients: each leaf within 1e-4 of that leaf's largest |g|. The key
  projection's bias of every attention layer has an exact gradient of 0
  (it adds q·b_k to every logit of a query row, which the softmax
  ignores), so both packages give rounding noise there: those leaves are
  held under 1e-6 of the largest |g| of all leaves instead;
- 5-step ``train`` from the same parameters: the loss history within 1e-4
  relative (JAX's SuperPoint ``train`` returns no history; its printed
  losses, 4 decimals, stand in: their rounding is under 1e-5 relative),
  and ≥ 99% of each leaf's elements within 1e-6 (Adam's first step is
  about lr·sign(g), so an element whose gradient is rounding noise may
  land 2·lr apart). SuperPoint's trajectory is more sensitive than that
  to f32 rounding itself: there the bound is 2× the distance between the
  port's own f32 and f64 runs (see the test);
- SuperGlue decoding (``matching_accuracy``): equal.

``pytest -s`` prints each parity test's measured deviation as one
``{"measured": ...}`` line. The JAX file's two ``slow`` cases are ported
as ``slow`` too.
"""

import re

import jax
import numpy as np
import pytest
import torch
from test_torch_common import np_tree, report

from rspl_slam_tpu.config import CameraConfig as JCam
from rspl_slam_tpu.config import SuperGlueConfig as JSGC
from rspl_slam_tpu.config import SuperPointConfig as JSPC
from rspl_slam_tpu.models import rcf as jrcf
from rspl_slam_tpu.models import superglue as jsg
from rspl_slam_tpu.models import superpoint as jsp
from rspl_slam_tpu.training import rcf_train as JR
from rspl_slam_tpu.training import superglue_train as JG
from rspl_slam_tpu.training import superpoint_train as JT
from rspl_slam_tpu_torch.config import CameraConfig, SuperGlueConfig, SuperPointConfig
from rspl_slam_tpu_torch.models import superpoint
from rspl_slam_tpu_torch.models.weights import flatten_pytree, to_tensor_tree, tree_leaves
from rspl_slam_tpu_torch.training import rcf_train as R
from rspl_slam_tpu_torch.training import superglue_train as G
from rspl_slam_tpu_torch.training import superpoint_train as T

CPU = torch.device("cpu")
CAM = dict(image_width=96, image_height=64, fx=80.0, fy=80.0, cx=48.0, cy=32.0, bf=8.0)
SG = dict(image_width=160, image_height=120, num_gnn_layers=2, sinkhorn_iterations=10)
RCF_HW, RCF_WIDTH = (48, 64), 0.125
MODELS = ["superpoint", "rcf", "superglue"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest |g|
ZERO_GRAD_TOL = 1e-6  # of the largest |g| of all leaves, where the exact gradient is 0
HIST_RTOL = 1e-4
PARAM_ATOL, PARAM_SHARE = 1e-6, 0.99


def _case(model):
    """(JAX parameters, JAX loss of the parameters, port loss of a tensor
    pytree) on one batch made from the same seed in both packages."""
    if model == "superpoint":
        jp = jsp.init_params(jax.random.PRNGKey(0))
        jb = JT.make_batch(JCam(**CAM), 2, seed=0)
        tb = T.make_batch(CameraConfig(**CAM), 2, 0, CPU)
        return jp, lambda p: JT.loss_fn(p, *jb), lambda p: T.loss_fn(p, *tb)
    if model == "rcf":
        jp = jrcf.init_params(jax.random.PRNGKey(0), width_mult=RCF_WIDTH)
        jb = JR.make_batch(*RCF_HW, 2, 0)
        tb = R.make_batch(*RCF_HW, 2, 0, CPU)
        return jp, lambda p: JR.loss_fn(p, *jb), lambda p: R.loss_fn(p, *tb)
    jc, tc = JSGC(**SG), SuperGlueConfig(**SG)
    jp = jsg.init_params(jax.random.PRNGKey(0), jc)
    jb = JG.make_batch(np.random.default_rng(0), 2, 16, jc)
    tb = G.make_batch(np.random.default_rng(0), 2, 16, tc, CPU)
    return jp, lambda p: JG.loss_fn(p, jb, jc), lambda p: G.loss_fn(p, tb, tc)


@pytest.fixture(scope="module")
def loss_and_grads():
    """Per model: (JAX loss, port loss, JAX gradients, port gradients), the
    gradients as flat {leaf path: array} (a leaf the loss does not reach
    has no port gradient: zeros)."""
    cache = {}

    def get(model):
        if model not in cache:
            jp, jloss, tloss = _case(model)
            lj, gj = jax.jit(jax.value_and_grad(jloss))(jp)
            tree = to_tensor_tree(np_tree(jp), CPU, requires_grad=True)
            lt = tloss(tree)
            lt.backward()
            names = list(flatten_pytree(np_tree(jp)))
            gt = {k: np.zeros(v.shape, np.float32) if v.grad is None else v.grad.numpy()
                  for k, v in zip(names, tree_leaves(tree))}
            cache[model] = (float(lj), float(lt.detach()), flatten_pytree(np_tree(gj)), gt)
        return cache[model]

    return get


def _zero_gradient_leaf(name):
    return re.fullmatch(r"gnn/\d+/k/b", name) is not None


# ---------------------------------------------------------------- data


def test_detector_labels_cell_case():
    xy = np.array([[13.0, 21.0], [100.0, 3.0]])
    lab = T.detector_labels(xy, np.ones(2, bool), 64, 128)
    # (13, 21): cell (2, 1), offset (y%8=5, x%8=5) → 45
    assert lab[2, 1] == 8 * 5 + 5
    assert lab[0, 12] == 8 * 3 + 4
    assert (lab == 64).sum() == 64 // 8 * (128 // 8) - 2
    np.testing.assert_array_equal(lab, JT.detector_labels(xy, np.ones(2, bool), 64, 128))


def test_superpoint_make_batch_equals_jax():
    jb = JT.make_batch(JCam(**CAM), 3, seed=4)
    tb = T.make_batch_numpy(CameraConfig(**CAM), 3, 4)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert (tb[4] >= 0).sum() > 0  # some left cells have a right correspondence
    for a, b in zip(tb, T.make_batch(CameraConfig(**CAM), 3, 4, CPU)):
        np.testing.assert_array_equal(a, b.numpy())


def test_rcf_render_and_make_batch_equal_jax():
    for a, b in zip(JR.render_edge_scene(np.random.default_rng(7), 60, 80),
                    R.render_edge_scene(np.random.default_rng(7), 60, 80)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(JR.make_batch(*RCF_HW, 3, 5), R.make_batch_numpy(*RCF_HW, 3, 5)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("kw", [{}, dict(cluster=0.1, score_lo=0.02, score_hi=0.1)],
                         ids=["default", "clustered"])
def test_superglue_make_batch_equals_jax(kw):
    jb = JG.make_batch(np.random.default_rng(3), 3, 24, JSGC(**SG), **kw)
    tb = G.make_batch_numpy(np.random.default_rng(3), 3, 24, SuperGlueConfig(**SG), **kw)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(a), b)


# ------------------------------------------------- losses and gradients


@pytest.mark.parametrize("model", MODELS)
def test_loss_matches_jax(model, loss_and_grads):
    lj, lt, _, _ = loss_and_grads(model)
    rel = abs(lt - lj) / abs(lj)
    report(f"training_loss_{model}", jax=lj, port=lt, rel=rel)
    assert np.isfinite(lt) and rel < LOSS_RTOL


@pytest.mark.parametrize("model", MODELS)
def test_gradients_match_jax(model, loss_and_grads):
    _, _, gj, gt = loss_and_grads(model)
    scale = max(float(np.abs(g).max()) for g in gj.values())
    worst, zero = 0.0, 0.0
    for name, g in gj.items():
        assert gt[name].shape == g.shape, name
        if _zero_gradient_leaf(name):
            zero = max(zero, float(np.abs(g).max()), float(np.abs(gt[name]).max()))
            continue
        top = float(np.abs(g).max())
        err = float(np.abs(gt[name] - g).max())
        if top == 0.0:
            assert err == 0.0, name
            continue
        worst = max(worst, err / top)
        assert err <= GRAD_TOL * top, (name, err, top)
    report(f"training_grads_{model}", worst_rel_to_leaf_max=worst,
           zero_leaves_rel=zero / scale)
    assert zero <= ZERO_GRAD_TOL * scale


def _jax_superpoint_history(params, capsys):
    capsys.readouterr()
    trained = JT.train(JCam(**CAM), steps=5, batch=2, lr=1e-3, seed=0, params=params,
                       log_every=1, verbose=True)
    out = capsys.readouterr().out
    return trained, [float(x) for x in re.findall(r"step \d+: loss (\S+)", out)]


def _port_f64_run(model, params, steps=5):
    """The port's ``train`` recipe for ``model`` with every leaf and batch
    in f64: (loss history, flat leaves). The yardstick of how far f32
    rounding alone moves the trajectory."""
    if model == "superpoint":
        batches = (T.make_batch(CameraConfig(**CAM), 2, s, CPU) for s in range(steps))
        loss = lambda p, b: T.loss_fn(p, *b)  # noqa: E731
        lr = 1e-3
    elif model == "rcf":
        batches = (R.make_batch(*RCF_HW, 2, s, CPU) for s in range(steps))
        loss = lambda p, b: R.loss_fn(p, *b)  # noqa: E731
        lr = 3e-4
    else:
        rng = np.random.default_rng(0)
        batches = (G.make_batch(rng, 2, 16, SuperGlueConfig(**SG), CPU) for _ in range(steps))
        loss = lambda p, b: G.loss_fn(p, b, SuperGlueConfig(**SG))  # noqa: E731
        lr = 1e-3
    names = list(flatten_pytree(params))
    tree = to_tensor_tree(params, CPU)
    leaves = [t.double().requires_grad_() for t in tree_leaves(tree)]
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, list):
            return [rebuild(v) for v in node]
        return next(it)

    tree = rebuild(tree)
    opt = torch.optim.Adam(leaves, lr=lr)
    hist = []
    for b in batches:
        b = tuple(x.double() if x.is_floating_point() else x for x in b)
        ell = loss(tree, b)
        opt.zero_grad(set_to_none=True)
        ell.backward()
        opt.step()
        hist.append(float(ell.detach()))
    return hist, {k: v.detach().numpy() for k, v in zip(names, leaves)}


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


@pytest.mark.parametrize("model", MODELS)
def test_five_step_train_matches_jax(model, capsys):
    """5 steps from the same parameters. Strict where f32 rounding allows:
    the history within 1e-4 relative and ≥ 99% of each leaf's elements
    within 1e-6. Where the port's own f32 and f64 runs part further than
    that (SuperPoint at lr 1e-3: Adam takes ~lr steps on elements whose
    gradient sign is rounding noise, and the trajectory parts by ~1e-4 of
    the loss within 5 steps), the JAX run may part from the port's f32 run
    by at most 2× the port's own f32-to-f64 distance (history, and each
    leaf's RMS): two f32 runs each that far from f64. A leaf whose exact
    gradient is 0 stays within 5·lr·1e-2 of its start in both."""
    if model == "superpoint":
        jp = jsp.init_params(jax.random.PRNGKey(0))
        trained_j, hist_j = _jax_superpoint_history(jp, capsys)
        stats = {}
        trained_t = T.train(CameraConfig(**CAM), steps=5, batch=2, lr=1e-3, seed=0,
                            params=np_tree(jp), verbose=False, device=CPU, stats=stats)
        hist_t, lr = stats["loss"], 1e-3
    elif model == "rcf":
        jp = jrcf.init_params(jax.random.PRNGKey(0), width_mult=RCF_WIDTH)
        kw = dict(steps=5, batch=2, hw=RCF_HW, width_mult=RCF_WIDTH, seed=0, verbose=False)
        trained_j, hist_j = JR.train(params=jp, **kw)
        trained_t, hist_t = R.train(params=np_tree(jp), device=CPU, **kw)
        lr = 3e-4
    else:
        jp = jsg.init_params(jax.random.PRNGKey(0), JSGC(**SG))
        kw = dict(steps=5, batch=2, K=16, lr=1e-3, seed=0, verbose=False)
        trained_j, hist_j = JG.train(JSGC(**SG), params=jp, **kw)
        trained_t, hist_t = G.train(SuperGlueConfig(**SG), params=np_tree(jp), device=CPU,
                                    **kw)
        lr = 1e-3
    assert len(hist_j) == len(hist_t) == 5
    assert hist_t[-1] < hist_t[0]
    hist_rel = float(np.max(np.abs(np.subtract(hist_t, hist_j)) / np.abs(hist_j)))
    f0, fj, ft = (flatten_pytree(np_tree(t)) for t in (jp, trained_j, trained_t))
    assert fj.keys() == ft.keys()
    shares = {k: float((np.abs(ft[k] - fj[k]) <= PARAM_ATOL).mean())
              for k in fj if not _zero_gradient_leaf(k)}
    strict = hist_rel < HIST_RTOL and min(shares.values()) >= PARAM_SHARE
    line = dict(history_jax=hist_j, history_port=hist_t, history_rel=hist_rel,
                worst_leaf_share=min(shares.values()), strict=strict)
    for k in fj:
        if _zero_gradient_leaf(k):
            moved = max(float(np.abs(ft[k] - f0[k]).max()), float(np.abs(fj[k] - f0[k]).max()))
            assert moved <= 5 * lr * 1e-2, (k, moved)
    if not strict:
        hist64, f64 = _port_f64_run(model, np_tree(jp))
        hist_rel64 = float(np.max(np.abs(np.subtract(hist_t, hist64)) / np.abs(hist64)))
        ratios = {k: _rms(ft[k] - fj[k]) / max(_rms(ft[k] - f64[k]), 1e-30)
                  for k in shares if shares[k] < PARAM_SHARE}
        line.update(history_rel_f32_f64=hist_rel64, worst_rms_ratio=max(ratios.values(), default=0))
        assert hist_rel < max(HIST_RTOL, 2 * hist_rel64), (hist_rel, hist_rel64)
        assert max(ratios.values(), default=0) <= 2.0, ratios
    report(f"training_train5_{model}", **line)


# ------------------------------------------------ behaviour (JAX's cases)


def test_loss_decreases():
    cam = CameraConfig(**CAM)
    params = superpoint.init_params(0)
    batch = T.make_batch(cam, 2, 0, CPU)
    tree = to_tensor_tree(params, CPU)
    l0 = float(T.loss_fn(tree, *batch))
    trained = T.train(cam, steps=8, batch=2, lr=2e-3, seed=0, params=params, verbose=False,
                      device=CPU)
    l1 = float(T.loss_fn(to_tensor_tree(trained, CPU), *batch))
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0, (l0, l1)


def test_deterministic_sets_and_restores_the_switches():
    """``loop.deterministic`` turns on PyTorch's deterministic algorithms and
    cuDNN's, and gives back what it found, also when its body raises; the
    SuperPoint trainer runs inside it and leaves the switches as it found
    them."""
    from rspl_slam_tpu_torch.training.loop import deterministic

    def switches():
        return (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled(),
                torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)

    before = switches()
    torch.backends.cudnn.benchmark = True
    try:
        with pytest.raises(ValueError):
            with deterministic():
                assert switches() == (True, False, True, False)
                raise ValueError
        assert switches() == before[:3] + (True,)
    finally:
        torch.backends.cudnn.benchmark = before[3]
    T.train(CameraConfig(**CAM), steps=1, batch=1, params=superpoint.init_params(0),
            verbose=False, device=CPU)
    assert switches() == before


def test_params_roundtrip(tmp_path):
    params = superpoint.init_params(1)
    p = str(tmp_path / "sp.npz")
    T.save_params(params, p)
    for loaded in (T.load_params(p), JT.load_params(p)):
        assert loaded.keys() == params.keys()
        for name in params:
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(loaded[name][leaf]),
                                              params[name][leaf])


@pytest.fixture(scope="module")
def overfit():
    """The port's fixed-batch overfit (the JAX test's recipe): 60 Adam
    steps on one K = 16 batch."""
    cfg = SuperGlueConfig(**SG)
    fixed_np = G.make_batch_numpy(np.random.default_rng(0), 2, 16, cfg)
    fixed = G.make_batch(np.random.default_rng(0), 2, 16, cfg, CPU)
    params, hist = G.train(cfg, steps=60, batch=2, K=16, lr=1e-3, verbose=False,
                           batch_fn=lambda *a: fixed, device=CPU)
    return params, hist, fixed, fixed_np


def test_overfits_fixed_batch(overfit):
    params, hist, fixed, _ = overfit
    assert hist[-1] < hist[0] * 0.3, (hist[0], hist[-1])
    acc = G.matching_accuracy(params, fixed, SuperGlueConfig(**SG))
    assert acc > 0.9, acc


def test_matching_accuracy_matches_jax(overfit):
    params, _, fixed, fixed_np = overfit
    got = [G.matching_accuracy(params, fixed, SuperGlueConfig(**SG)),
           G.plain_accuracy(params, fixed, SuperGlueConfig(**SG))]
    ref = JG.matching_accuracy(params, tuple(fixed_np), JSGC(**SG))
    rnd = jsg.init_params(jax.random.PRNGKey(3), JSGC(**SG))
    got_rnd = G.matching_accuracy(np_tree(rnd), fixed, SuperGlueConfig(**SG))
    ref_rnd = JG.matching_accuracy(rnd, tuple(fixed_np), JSGC(**SG))
    report("training_matching_accuracy", port=got, jax=ref, random_port=got_rnd,
           random_jax=ref_rnd)
    assert got == [ref, ref] and ref > 0.9
    assert got_rnd == ref_rnd


def test_label_by_landmarks():
    lm0 = np.array([[10.0, 10], [50, 20], [90, 40], [130, 80]])
    lm1 = lm0 - [16.0, 0]  # "disparity" per landmark
    vis = np.array([True, True, True, False])  # landmark 3 not shared
    xy0 = np.array([[11.0, 9], [49, 21], [91, 39], [200, 200], [0, 0]])
    v0 = np.array([True, True, True, True, False])
    xy1 = np.array([[-6.0, 10], [75, 40], [114, 80]])
    v1 = np.ones(3, bool)
    gt0 = G.label_by_landmarks(xy0, v0, xy1, v1, lm0, lm1, vis, tol_px=5.0)
    np.testing.assert_array_equal(gt0, [0, 3, 1, 3, -1])
    np.testing.assert_array_equal(
        gt0, JG.label_by_landmarks(xy0, v0, xy1, v1, lm0, lm1, vis, tol_px=5.0))


def test_bank_batch_fn_stacks():
    cfg = SuperGlueConfig(**SG)
    b = G.make_batch_numpy(np.random.default_rng(0), 3, 16, cfg)
    bank = [tuple(a[i] for a in b) for i in range(3)]
    out = G.bank_batch_fn(bank, CPU)(np.random.default_rng(1), 2, 16, cfg)
    assert out[0].shape == (2, 16, 2) and out[0].dtype == torch.float32
    assert out[3].dtype == torch.bool
    assert out[-1].shape == (2, 16)
    ref = JG.bank_batch_fn(bank)(np.random.default_rng(1), 2, 16, JSGC(**SG))
    for a, c in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_ground_truth_batch_sanity():
    xy0, sc0, d0, v0, xy1, sc1, d1, v1, gt0 = G.make_batch_numpy(
        np.random.default_rng(3), 2, 24, SuperGlueConfig(**SG))
    K = 24
    m = (gt0 >= 0) & (gt0 < K)
    assert m.sum() > 0
    b, i = np.nonzero(m)
    sims = np.sum(d0[b, i] * d1[b, gt0[b, i]], -1)
    assert sims.mean() > 0.8, sims.mean()
    assert (gt0[~v0] == -1).all()


def _labels_by_position(problem):
    """{view-A keypoint position: its label as a view-B position, "dustbin"
    or "invalid"}: bf16 scores that differ in the last bit reorder the
    top-K rows between the packages, so rows compare by position."""
    xy0, _, _, _, xy1, _, _, _, gt0 = problem
    K = len(gt0)
    return {tuple(np.round(xy0[i], 2)): "dustbin" if g == K else "invalid" if g < 0
            else tuple(np.round(xy1[g], 2)) for i, g in enumerate(gt0)}


def test_shift_pair_bank_labels_are_exact():
    """Shifted crops give exact correspondence: matched keypoints' descriptors
    agree, invalid rows are −1, a healthy number of keypoints match, and the
    labels equal the JAX bank's (both extract at bf16) on ≥ 95% of rows,
    matched by keypoint position."""
    img = np.random.default_rng(0).uniform(size=(40, 50)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))  # (320, 400)
    sp_params = np_tree(jsp.init_params(jax.random.PRNGKey(1)))
    kw = dict(n_pairs=4, K=64, crop_hw=(160, 240), shift_range=16.0)
    bank = G.make_shift_pair_bank([img], sp_params, SuperPointConfig(
        max_keypoints=64, keypoint_threshold=1e-4), rng=np.random.default_rng(2),
        device=CPU, **kw)
    ref = JG.make_shift_pair_bank([img], sp_params, JSPC(
        max_keypoints=64, keypoint_threshold=1e-4), rng=np.random.default_rng(2), **kw)
    assert len(bank) == len(ref) == 4
    any_matches = same = rows = 0
    for got, want in zip(bank, ref):
        xy0, sc0, d0, v0, xy1, sc1, d1, v1, gt0 = got
        m = (gt0 >= 0) & (gt0 < 64)
        any_matches += int(m.sum())
        if m.sum() >= 2:
            sims = np.einsum("ij,ij->i", d0[m], d1[gt0[m]])
            assert sims.mean() > 0.9
        assert (gt0[~v0] == -1).all()
        mine, theirs = _labels_by_position(got), _labels_by_position(want)
        same += sum(theirs.get(k) == v for k, v in mine.items())
        rows += len(gt0)
    report("training_shift_bank", matches=any_matches, rows_equal_share=same / rows)
    assert any_matches >= 20, any_matches
    assert same >= 0.95 * rows, (same, rows)


# ------------------------------------------------------- JAX's slow cases


@pytest.mark.slow
def test_generalizes_to_heldout_problems():
    cfg = SuperGlueConfig(**SG)
    eval_batch = G.make_batch(np.random.default_rng(99), 4, 32, cfg, CPU)
    p0 = np_tree(jsg.init_params(jax.random.PRNGKey(0), JSGC(**SG)))
    acc0 = G.matching_accuracy(p0, eval_batch, cfg)
    params, hist = G.train(cfg, steps=300, batch=8, K=32, params=p0, verbose=False,
                           device=CPU)
    acc1 = G.matching_accuracy(params, eval_batch, cfg)
    assert hist[-1] < hist[0] * 0.5, (hist[0], hist[-1])
    assert acc1 > 0.9 and acc1 > acc0 + 0.5, (acc0, acc1)


@pytest.mark.slow
def test_trained_superpoint_localizes_better_than_random():
    from rspl_slam_tpu_torch.evaluation import synthetic
    from rspl_slam_tpu_torch.models.weights import superpoint_from_numpy

    cam = CameraConfig(image_width=160, image_height=120, fx=120.0, fy=120.0, cx=80.0,
                       cy=60.0, bf=12.0)
    cfg = SuperPointConfig(max_keypoints=100, keypoint_threshold=1e-4)

    def localization(params, seeds=(11, 12, 13)):
        sp = superpoint_from_numpy(params, CPU)
        recalls, errs = [], []
        for s in seeds:
            scene = synthetic.make_scene(num_points=120, num_lines=0, seed=s,
                                         extent=(4.0, 3.0, 4.0))
            il, _ = synthetic.render_images(scene, cam, np.eye(4), seed=s)
            obs = synthetic.observe_points(scene, cam, np.eye(4))
            gt = obs["uv_left"][obs["visible"]]
            f = superpoint.extract(sp, torch.as_tensor(il[None]), cfg, torch.float32)
            xy = f.xy[0][f.valid[0]].numpy()
            d = np.linalg.norm(gt[:, None] - xy[None], axis=-1).min(1)
            recalls.append(float((d < 2.0).mean()))
            errs.append(float(np.median(d)))
        return float(np.mean(recalls)), float(np.mean(errs))

    p0 = np_tree(jsp.init_params(jax.random.PRNGKey(0)))
    r0, e0 = localization(p0)
    tp = T.train(cam, steps=120, batch=2, lr=1e-3, seed=0, params=p0, verbose=False,
                 device=CPU)
    r1, e1 = localization(tp)
    assert r1 > r0 + 0.08, (r0, r1)
    assert e1 < e0, (e0, e1)
