"""Synthetic SuperGlue training (port of training/superglue_train.py).

Training problems are generated at the keypoint level, shaped like
SuperPoint's output: two keypoint sets with unit descriptors, a known
partial assignment (shared "landmarks" with descriptor noise and a rigid
2D shift + jitter between the views) and distractors on both sides
(:func:`make_batch`), or self-labelled pairs of real extractions
(:func:`make_shift_pair_bank`, :func:`label_by_landmarks`). The loss is
SuperGlue's: the negative log-likelihood of the ground-truth assignment
under the Sinkhorn plan, matched rows at Z[i, j(i)], unmatched ones at
their dustbin.

The forward (:func:`log_plan`) is ``match_pair`` in plain PyTorch over
the leaves: q/k/v concatenated per layer by ``torch.cat`` (no ``*_mma``
packing: ``attention_cuda.pack_layer`` copies the weights, which would cut
the graph), each layer through ``attention_cuda.superglue_layer_plain``
(M == N, stacked) or ``superglue_layer_two_set_plain`` (M != N, each set
over its source), and the Sinkhorn through
``ops/sinkhorn`` (``build_problem`` keeps ``bin_score`` in the graph).
Every JAX leaf is a trainable leaf here too; the last MLP layer's BN
leaves take no part in the forward, get no gradient and stay unchanged,
as under optax with their zero gradient. :func:`matching_accuracy` runs
the inference ``models/superglue.match_pair`` (K2 and K3 on the card).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rspl_slam_tpu_torch.config import SuperGlueConfig
from rspl_slam_tpu_torch.frontend.frontends import resolve_device
from rspl_slam_tpu_torch.models import superglue, superpoint
from rspl_slam_tpu_torch.models.superglue import _apply_mlp
from rspl_slam_tpu_torch.models.weights import (superglue_from_numpy, superpoint_from_numpy,
                                                to_tensor_tree)
from rspl_slam_tpu_torch.ops import sinkhorn
from rspl_slam_tpu_torch.ops.attention_cuda import (round_operand, superglue_layer_plain,
                                                    superglue_layer_two_set_plain)
from rspl_slam_tpu_torch.ops.matching import mutual_match_decode, normalize_keypoints
from rspl_slam_tpu_torch.training.loop import train_adam

__all__ = ["make_batch_numpy", "make_batch", "make_shift_pair_bank", "label_by_landmarks",
           "bank_batch_fn", "log_plan", "loss_fn", "matching_accuracy", "plain_accuracy",
           "train"]

DEFAULT_CFG = SuperGlueConfig(image_width=320, image_height=240, num_gnn_layers=4,
                              sinkhorn_iterations=20)


def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)


def make_batch_numpy(rng: np.random.Generator, batch: int, K: int, cfg: SuperGlueConfig,
                     desc_dim: int = 256, match_frac: float = 0.65,
                     desc_noise: float = 0.15, pos_noise: float = 1.0,
                     cluster: float = 0.0, score_lo: float = 0.2, score_hi: float = 1.0):
    """Random matching problems with ground truth, as numpy: (xy0, sc0, d0,
    v0, xy1, sc1, d1, v1, gt0); gt0 (B, K) int32 is the index in set 1
    matching keypoint i of set 0, K for the dustbin, −1 for padded slots.
    The JAX package's arrays for the same generator state.

    ``cluster`` > 0 compresses the descriptors around a shared direction
    per item, d ← unit(μ + cluster·d), as an untrained SuperPoint emits
    them; ``score_lo``/``score_hi`` bound the keypoint scores."""
    W, H = cfg.image_width, cfg.image_height
    B = batch

    def noisy(base, n_shape):
        """base + a noise vector of norm ``desc_noise``, re-normalized."""
        n = _unit(rng.standard_normal(n_shape).astype(np.float32))
        return _unit(base + desc_noise * n)

    xy0 = rng.uniform([8, 8], [W - 8, H - 8], (B, K, 2)).astype(np.float32)
    land = _unit(rng.standard_normal((B, K, desc_dim)).astype(np.float32))
    d0 = noisy(land, (B, K, desc_dim))
    n_valid = rng.integers(K // 2, K + 1, B)
    v0 = np.arange(K)[None] < n_valid[:, None]
    v1 = np.arange(K)[None] < n_valid[:, None]

    matched = (rng.random((B, K)) < match_frac) & v0
    # a rigid 2D shift between the views + per-point jitter
    shift = rng.uniform(-40, 40, (B, 1, 2))
    xy1_m = xy0 + shift + pos_noise * rng.standard_normal((B, K, 2))
    xy1 = rng.uniform([8, 8], [W - 8, H - 8], (B, K, 2)).astype(np.float32)
    d1 = _unit(rng.standard_normal((B, K, desc_dim)).astype(np.float32))

    gt0 = np.full((B, K), K, np.int32)  # default: dustbin
    perm = np.stack([rng.permutation(K) for _ in range(B)])
    for b in range(B):
        for i in range(K):
            if not matched[b, i]:
                continue
            j = perm[b, i]
            if not v1[b, j]:
                continue
            x, y = xy1_m[b, i]
            if not (0 <= x < W and 0 <= y < H):
                continue
            xy1[b, j] = [x, y]
            d1[b, j] = noisy(land[b, i], desc_dim)
            gt0[b, i] = j
    gt0[~v0] = -1
    if cluster > 0:
        mu = _unit(rng.standard_normal((B, 1, desc_dim)).astype(np.float32))
        d0 = _unit(mu + cluster * d0)
        d1 = _unit(mu + cluster * d1)
    sc0 = rng.uniform(score_lo, score_hi, (B, K)).astype(np.float32) * v0
    sc1 = rng.uniform(score_lo, score_hi, (B, K)).astype(np.float32) * v1
    return (xy0, sc0, d0.astype(np.float32), v0, xy1, sc1, d1.astype(np.float32), v1, gt0)


def _upload(arrays, dev):
    """A problem's arrays as tensors on ``dev``: masks bool, gt0 int64,
    the rest f32."""
    kinds = (torch.float32, torch.float32, torch.float32, torch.bool) * 2 + (torch.int64,)
    return tuple(torch.as_tensor(np.asarray(a)).to(dev, k) if not isinstance(a, torch.Tensor)
                 else a.to(dev, k) for a, k in zip(arrays, kinds))


def make_batch(rng: np.random.Generator, batch: int, K: int, cfg: SuperGlueConfig,
               device="cuda", **kw):
    """:func:`make_batch_numpy` as tensors on ``device``."""
    return _upload(make_batch_numpy(rng, batch, K, cfg, **kw), resolve_device(device))


def make_shift_pair_bank(images, sp_params, sp_cfg, n_pairs: int, K: int,
                         rng: np.random.Generator, crop_hw=(240, 376),
                         shift_range: float = 32.0, tol_px: float = 2.0,
                         extract_batch: int = 8, cell_aligned: int = 8, device="cuda"):
    """Matching problems from the real feature distribution: crops of
    ``images`` shifted by a known (dx, dy) give exact dense correspondence,
    so two SuperPoint extractions (``models/superpoint.extract`` at bf16:
    K1 on the card) of a shifted pair label themselves — keypoint i of
    view A matches the mutually nearest keypoint of view B within
    ``tol_px`` of its un-shifted position, else the dustbin. Shifts are
    multiples of ``cell_aligned`` px where it is set (an untrained
    SuperPoint snaps keypoints to the 8-px lattice).

    Returns n_pairs numpy problems shaped like :func:`make_batch_numpy`
    items without the batch axis; :func:`bank_batch_fn` stacks them."""
    dev = resolve_device(device)
    H, W = crop_hw

    def subcrop(img, oy, ox):
        ys = np.arange(H, dtype=np.float64) + oy
        xs = np.arange(W, dtype=np.float64) + ox
        y0 = np.clip(np.floor(ys).astype(int), 0, img.shape[0] - 2)
        x0 = np.clip(np.floor(xs).astype(int), 0, img.shape[1] - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        return ((1 - fy) * (1 - fx) * img[np.ix_(y0, x0)]
                + (1 - fy) * fx * img[np.ix_(y0, x0 + 1)]
                + fy * (1 - fx) * img[np.ix_(y0 + 1, x0)]
                + fy * fx * img[np.ix_(y0 + 1, x0 + 1)]).astype(np.float32)

    crops, shifts = [], []
    for _ in range(n_pairs):
        img = images[rng.integers(len(images))]
        my = img.shape[0] - H - 2 * shift_range - 2
        mx = img.shape[1] - W - 2 * shift_range - 2
        oy = shift_range + rng.uniform(0, max(my, 1))
        ox = shift_range + rng.uniform(0, max(mx, 1))
        if cell_aligned:
            q = int(shift_range) // cell_aligned
            sx, sy = cell_aligned * rng.integers(-q, q + 1, 2)
        else:
            sx, sy = rng.uniform(-shift_range, shift_range, 2)
        crops.append(subcrop(img, oy, ox))
        crops.append(subcrop(img, oy + sy, ox + sx))
        shifts.append((sx, sy))

    sp = superpoint_from_numpy(sp_params, dev)
    feats = []
    for i in range(0, len(crops), extract_batch):
        f = superpoint.extract(sp, torch.as_tensor(np.stack(crops[i:i + extract_batch])).to(dev),
                               sp_cfg)
        xy, sc, desc, valid = (t.cpu().numpy() for t in (f.xy, f.score, f.desc, f.valid))
        feats.extend(zip(xy, sc, desc.astype(np.float32), valid))

    bank = []
    for p in range(n_pairs):
        xy0, sc0, d0, v0 = feats[2 * p]
        xy1, sc1, d1, v1 = feats[2 * p + 1]
        sx, sy = shifts[p]
        Kc = min(K, len(xy0))
        # a view-A pixel (x, y) appears in view B at (x − sx, y − sy)
        pred = xy0 - [sx, sy]
        D = np.linalg.norm(pred[:, None, :] - xy1[None, :, :], axis=-1)
        D = np.where(v0[:, None] & v1[None, :], D, 1e9)
        j = D.argmin(1)
        i_back = D.argmin(0)
        gt0 = np.full(len(xy0), len(xy1), np.int32)  # dustbin
        ok = (D[np.arange(len(xy0)), j] < tol_px) & (i_back[j] == np.arange(len(xy0)))
        gt0[ok] = j[ok]
        gt0[~v0] = -1
        bank.append(tuple(a[:Kc] for a in (xy0, sc0, d0, v0))
                    + tuple(a[:Kc] for a in (xy1, sc1, d1, v1))
                    + (np.minimum(gt0[:Kc], Kc),))
    return bank


def label_by_landmarks(xy0, v0, xy1, v1, p0, p1, vis, tol_px: float = 5.0):
    """Ground-truth assignment between two detected keypoint sets through a
    shared landmark table: keypoint i of view 0 binds to the nearest
    landmark projection ``p0`` within ``tol_px``, likewise view 1 against
    ``p1``; two keypoints bound to the same visible landmark match (the
    closest claimant per landmark and view). Returns gt0 (K0,) int32: the
    index into view 1, K1 for the dustbin, −1 for invalid rows."""
    K1 = len(xy1)
    lm = np.nonzero(vis)[0]
    gt0 = np.full(len(xy0), K1, np.int32)
    gt0[~v0] = -1
    if len(lm) == 0:
        return gt0
    P0 = np.asarray(p0)[lm]
    P1 = np.asarray(p1)[lm]

    def bind(xy, valid, P):
        D = np.linalg.norm(xy[:, None, :] - P[None], axis=-1)
        j = D.argmin(1)
        d = D[np.arange(len(xy)), j]
        return np.where(valid & (d < tol_px), j, -1), d

    b0, d0 = bind(np.asarray(xy0), np.asarray(v0, bool), P0)
    b1, d1 = bind(np.asarray(xy1), np.asarray(v1, bool), P1)
    lm_to_k1 = np.full(len(lm), -1, np.int64)
    for j in np.argsort(d1):
        if b1[j] >= 0 and lm_to_k1[b1[j]] < 0:
            lm_to_k1[b1[j]] = j
    claimed0 = np.full(len(lm), False)
    for i in np.argsort(d0):
        if b0[i] < 0 or claimed0[b0[i]] or not v0[i]:
            continue
        claimed0[b0[i]] = True
        t = lm_to_k1[b0[i]]
        if t >= 0:
            gt0[i] = t
    return gt0


def bank_batch_fn(bank, device="cuda"):
    """A ``batch_fn(rng, batch, K, cfg)`` for :func:`train` that stacks a
    random subset of bank problems onto ``device``."""
    dev = resolve_device(device)

    def fn(rng, batch, K, cfg):
        idx = rng.choice(len(bank), size=batch, replace=len(bank) < batch)
        return _upload([np.stack(c) for c in zip(*(bank[i] for i in idx))], dev)

    return fn


def _layer(layer):
    """A layer's leaves as ``superglue_layer_plain`` takes them, built in
    the graph."""
    m0, m1 = layer["mlp"]
    return {"wqkv": torch.cat([layer[n]["w"] for n in "qkv"], 1),
            "bqkv": torch.cat([layer[n]["b"] for n in "qkv"], 0),
            "wm": layer["merge"]["w"], "bm": layer["merge"]["b"],
            "w1": m0["w"], "b1": m0["b"], "s1": m0["bn_scale"], "t1": m0["bn_shift"],
            "w2": m1["w"], "b2": m1["b"]}


def log_plan(params, xy0, sc0, d0, v0, xy1, sc1, d1, v1, cfg: SuperGlueConfig,
             compute_dtype=torch.float32):
    """The (B, M+1, N+1) log transport plan of ``match_pair`` in plain
    PyTorch, differentiable in the leaves of ``params`` (a tensor pytree in
    the JAX layout); ``compute_dtype`` rounds the matmul operands as
    ``match_pair`` does. Sets of equal size run stacked, others unstacked,
    as ``match_pair`` runs them."""
    B, M, _ = d0.shape
    r = functools.partial(round_operand, compute_dtype=compute_dtype)
    enc = [torch.cat([normalize_keypoints(xy, cfg.image_width, cfg.image_height),
                      sc[..., None]], -1) for xy, sc in ((xy0, sc0), (xy1, sc1))]
    fp = params["final_proj"]
    if d1.shape[1] == M:
        x = torch.cat([d0, d1], 0) + _apply_mlp(params["kenc"], torch.cat(enc, 0),
                                                compute_dtype)
        masks = torch.cat([v0, v1], 0)
        for li, layer in enumerate(params["gnn"]):
            x = superglue_layer_plain(x, masks, _layer(layer), cross=li % 2 == 1,
                                      num_heads=cfg.num_heads, compute_dtype=compute_dtype)
        md = r(r(x) @ r(fp["w"]) + fp["b"])
        md0, md1 = md[:B], md[B:]
    else:
        x0 = d0 + _apply_mlp(params["kenc"], enc[0], compute_dtype)
        x1 = d1 + _apply_mlp(params["kenc"], enc[1], compute_dtype)
        for li, layer in enumerate(params["gnn"]):
            lay = _layer(layer)
            src0, m0 = (x1, v1) if li % 2 else (x0, v0)
            src1, m1 = (x0, v0) if li % 2 else (x1, v1)
            x0, x1 = [superglue_layer_two_set_plain(x, src, m, lay, cfg.num_heads,
                                                    compute_dtype)
                      for x, src, m in ((x0, src0, m0), (x1, src1, m1))]
        md0, md1 = [r(r(x) @ r(fp["w"]) + fp["b"]) for x in (x0, x1)]
    sim = torch.einsum("bmc,bnc->bmn", md0, md1) / math.sqrt(cfg.descriptor_dim)
    return sinkhorn.log_optimal_transport_masked(sim, v0, v1, params["bin_score"],
                                                 cfg.sinkhorn_iterations)


def loss_fn(params, batch, cfg: SuperGlueConfig):
    """−mean log P(gt assignment) over valid rows (matched → Z[i, j],
    unmatched but valid → the dustbin column Z[i, N]), f32. gt0 (B, M)
    holds N or more for the dustbin. (JAX's ``loss_fn`` takes column M as
    the dustbin: the same where M == N, a keypoint's column where M < N.)"""
    *arrays, gt0 = batch
    Z = log_plan(params, *arrays, cfg)
    M, N = gt0.shape[1], Z.shape[2] - 1
    take = torch.where(gt0 >= 0, gt0.clamp(max=N), N)
    ll = Z[:, :M].gather(2, take[..., None])[..., 0]
    w = (gt0 >= 0).float()
    return -(ll * w).sum() / w.sum().clamp_min(1.0)


def _accuracy(idx0, gt0) -> float:
    """Share of the ground-truth matches (0 ≤ gt0 < K) that ``idx0`` decodes."""
    idx0 = np.asarray(idx0)
    gt = np.asarray(gt0)
    m = (gt >= 0) & (gt < gt.shape[1])
    return float((idx0[m] == gt[m]).mean()) if m.sum() else 0.0


def matching_accuracy(params, batch, cfg: SuperGlueConfig) -> float:
    """Share of the ground-truth matches recovered by the mutual-max decode
    of the inference ``match_pair`` at f32, as in JAX (K2's f32 mode and K3
    on the card), on the batch's device."""
    *arrays, gt0 = batch
    sg = superglue_from_numpy(params, cfg, arrays[0].device)
    res = superglue.match_pair(sg, *arrays, cfg, compute_dtype=torch.float32)
    return _accuracy(res.indices0.cpu(), gt0.cpu())


@torch.no_grad()
def plain_accuracy(params, batch, cfg: SuperGlueConfig) -> float:
    """:func:`matching_accuracy` through :func:`log_plan` (the plain
    versions of K2 and K3) on the batch's device."""
    *arrays, gt0 = batch
    Z = log_plan(to_tensor_tree(params, arrays[0].device), *arrays, cfg)
    idx0, _, _ = mutual_match_decode(Z, arrays[3], arrays[7], cfg.match_threshold)
    return _accuracy(idx0.cpu(), gt0.cpu())


def train(cfg: SuperGlueConfig | None = None, steps: int = 300, batch: int = 8, K: int = 64,
          lr: float = 1e-3, seed: int = 0, params=None, log_every: int = 25,
          verbose: bool = True, batch_fn=None, device="cuda", stats: dict | None = None):
    """Train SuperGlue on synthetic assignments; returns (trained numpy
    pytree, loss history). ``batch_fn(rng, batch, K, cfg)`` replaces the
    problem generator (its arrays go to ``device``); the default draws
    :func:`make_batch` from ``default_rng(seed)``."""
    cfg = cfg or DEFAULT_CFG
    dev = resolve_device(device)
    if params is None:
        params = superglue.init_params(cfg, seed)
    rng = np.random.default_rng(seed)
    batch_fn = batch_fn or make_batch_numpy
    return train_adam(params, lambda p, b: loss_fn(p, b, cfg),
                      lambda s: _upload(batch_fn(rng, batch, K, cfg), dev),
                      steps, lr, dev, log_every, verbose, stats)
