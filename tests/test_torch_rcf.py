"""The port's RCF edge network against the JAX package's, on the same numpy
weights and images.

Tolerances: ``rel`` is |port − JAX| / (|JAX| + 1e-2), pointwise. f32:
rel < 1e-4 (another summation order). bf16: rel < 0.08, the JAX package's
own bound between its two stage-1 recipes (tests/test_pallas_kernels.py):
bf16 activations of O(100-1000) round on either side of a step after
another f32 summation order. The K1 recipe is held stage by stage against
JAX's K1 recipe (``_stem_pallas``, its Pallas kernel in interpret mode).
Each test prints what it measured (``pytest -s``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import edge_weights, np_tree, report

from rspl_slam_tpu.models import rcf as jrcf
from rspl_slam_tpu_torch.models import rcf
from rspl_slam_tpu_torch.models.weights import rcf_from_numpy

SHAPES = [(2, 32, 64), (1, 40, 72)]  # the second has odd sizes from stage 4 on


@functools.lru_cache(maxsize=None)
def _params(name):
    """The JAX package's seeded init (its logits stay far from 0, where a
    relative bound means something; made once) or the hand-set edge
    weights. Read only."""
    if name == "jax_init":
        return np_tree(jax.jit(jrcf.init_params)(jax.random.PRNGKey(1)))
    return rcf.edge_detector_params()


@functools.lru_cache(maxsize=None)
def _model(name):
    """The port's RCF on the CPU with :func:`_params`' weights (made once)."""
    return rcf_from_numpy(_params(name), "cpu")


def _images(shape):
    return np.random.default_rng(0).uniform(0.0, 1.0, shape).astype(np.float32)


def _rel(got, ref):
    return float((np.abs(got - ref) / (np.abs(ref) + 1e-2)).max())


@pytest.mark.parametrize("width_mult", [1.0, 0.25])
def test_init_params_layout_matches_jax(width_mult):
    """The port's numpy init has the JAX tree, shapes and dtypes."""
    tp = rcf.init_params(0, width_mult)
    jp = jax.eval_shape(lambda: jrcf.init_params(jax.random.PRNGKey(0), width_mult=width_mult))
    assert tp.keys() == jp.keys()
    for k in jp:
        for leaf in ("w", "b"):
            assert tp[k][leaf].shape == jp[k][leaf].shape, (k, leaf)
            assert tp[k][leaf].dtype == np.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pname", ["jax_init", "edge"])
@pytest.mark.parametrize("shape", SHAPES)
def test_edge_logits_matches_jax(shape, pname, dtype):
    """The generic conv recipe on both sides: f32 rel < 1e-4, bf16 rel <
    0.08."""
    p = _params(pname)
    img = _images(shape)
    ref = np.asarray(jrcf.edge_logits(p, jnp.asarray(img), getattr(jnp, dtype),
                                      use_pallas_stem=False))
    got = rcf.edge_logits(_model(pname), torch.from_numpy(img),
                          getattr(torch, dtype), use_pallas_stem=False).numpy()
    assert got.shape == shape and np.isfinite(got).all()
    rel = _rel(got, ref)
    report("edge_logits", shape=shape, params=pname, dtype=dtype, rel=rel)
    assert rel < (1e-4 if dtype == "float32" else 0.08)


@pytest.mark.parametrize("pname", ["jax_init", "edge"])
@pytest.mark.parametrize("shape", SHAPES[:1])  # stage 1 sees no odd size
def test_k1_stem_recipe_matches_jax(shape, pname):
    """The port's K1 recipe for stage 1 (conv1_1 as c_in = 1, conv1_2 +
    pool + side score through K1's side mode, plain on the CPU) against
    JAX's K1 recipe (``_stem_pallas``, Pallas interpreted) at bf16: the
    pooled trunk and the stage-1 score, each at rel < 0.08. With the seeded
    weights the whole K1-recipe logits also hold against JAX's generic
    recipe at rel < 0.08 (the edge weights' logits cross zero, where the
    1e-2 floor measures a bf16 step of a stage score, not the recipe)."""
    p = _params(pname)
    x255 = _images(shape) * np.float32(255.0)
    xj, (sj,) = jrcf._stem_pallas(p, jnp.asarray(x255), jnp.bfloat16, interpret=True)
    xt, st = rcf._stem_k1(_model(pname), torch.from_numpy(x255), torch.bfloat16)
    xj = np.asarray(xj.astype(jnp.float32))
    xt = xt.permute(0, 2, 3, 1).float().numpy()
    assert xt.shape == xj.shape and st.shape == shape
    rel_x, rel_s = _rel(xt, xj), _rel(st.numpy(), np.asarray(sj))
    measured = dict(rel_trunk=rel_x, rel_score=rel_s)
    if pname == "jax_init":
        img = _images(shape)
        ref = np.asarray(jrcf.edge_logits(p, jnp.asarray(img), jnp.bfloat16,
                                          use_pallas_stem=False))
        got = rcf.edge_logits(_model(pname), torch.from_numpy(img), torch.bfloat16,
                              use_pallas_stem=True).numpy()
        measured["rel_logits_vs_generic"] = _rel(got, ref)
    report("k1_stem_recipe", shape=shape, params=pname, **measured)
    assert max(measured.values()) < 0.08


def test_edge_detector_params_narrow_width_has_the_same_logits():
    """Width 0.125 (the CPU tests' edge weights) and full width: the same
    logits within f32 rounding."""
    img = torch.from_numpy(_images((1, 24, 40)))
    full = rcf.edge_logits(_model("edge"), img, torch.float32)
    narrow = rcf.edge_logits(rcf_from_numpy(edge_weights(), "cpu"), img, torch.float32)
    torch.testing.assert_close(narrow, full, rtol=1e-5, atol=1e-4)


def test_stem_recipe_default_is_the_generic_one_on_the_cpu():
    """``use_pallas_stem=None`` takes K1 only for CUDA tensors: on the CPU
    the default equals the generic recipe bit for bit."""
    m = _model("edge")
    img = torch.from_numpy(_images((1, 32, 64)))
    assert torch.equal(rcf.edge_logits(m, img), rcf.edge_logits(m, img, use_pallas_stem=False))


@pytest.mark.parametrize("src,dst", [((7, 11), (30, 47)), ((5, 9), (40, 72)), ((8, 8), (8, 8))])
def test_upsample_bilinear_matches_jax_resize(src, dst):
    """Half-pixel-centre bilinear upsampling, non-integer ratios included:
    |Δ| < 1e-5 on unit-scale values."""
    x = np.random.default_rng(1).standard_normal((2,) + src).astype(np.float32)
    ref = np.asarray(jrcf._upsample_bilinear(jnp.asarray(x)[..., None], *dst))[..., 0]
    got = rcf._upsample_bilinear(torch.from_numpy(x), *dst).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_pool2_matches_jax(stride):
    """2×2 max-pool with SAME −inf padding on odd sizes, exactly."""
    x = np.random.default_rng(2).standard_normal((2, 5, 7, 9)).astype(np.float32)
    ref = np.asarray(jrcf._pool2(jnp.asarray(x), stride))
    got = rcf._pool2(torch.from_numpy(x).permute(0, 3, 1, 2), stride).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_edge_detector_params_see_rendered_lines():
    """The hand-set weights (at width 0.125, the same logits) light up the
    edges of a rendered frame: a clear share of pixels over the detector's
    0.25, and a background (the median pixel) below it."""
    from test_torch_common import rendered_sequence, small_system_cfg

    cfg = small_system_cfg()
    il, _ = rendered_sequence(cfg, 1, num_lines=12)[0][0]
    img = torch.from_numpy(il)[None]
    e = rcf.edge_map(rcf_from_numpy(edge_weights(), "cpu"), img, torch.float32)
    share = float((e > 0.25).float().mean())
    assert 0.02 < share < 0.6, share
    assert float(e.median()) < 0.25
