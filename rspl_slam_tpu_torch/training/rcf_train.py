"""Synthetic RCF edge-detection pretraining (port of training/rcf_train.py).

Scenes are a smooth low-frequency background plus filled rotated
rectangles of random intensity; labels are the pixels within ~1.2 px of a
rectangle outline; the loss is the RCF paper's class-balanced BCE on the
fused logit. ``width_mult < 1`` shrinks the VGG trunk (``models/rcf.
init_params``) for cheap pretraining and CPU tests.

The forward (:func:`edge_logits`) is JAX's f32 ``edge_logits`` (the
generic branch, ``models/rcf.py:214`` there) over the unfolded leaves:
each conv's 21-channel ``*_down`` branch folds into its stage's
``*_score`` weights inside the forward, so gradients reach both leaves.
The inference module (``models/rcf.RCF``) folds them once at construction
and runs stage 1 through K1, which has no backward, so training never goes
through it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rspl_slam_tpu_torch.frontend.frontends import resolve_device
from rspl_slam_tpu_torch.models import rcf
from rspl_slam_tpu_torch.models.rcf import STAGES, _pool2, _upsample_bilinear
from rspl_slam_tpu_torch.training.loop import train_adam
from rspl_slam_tpu_torch.training.superpoint_train import load_params, save_params

__all__ = ["render_edge_scene", "make_batch_numpy", "make_batch", "edge_logits",
           "loss_fn", "train", "save_params", "load_params"]


def _smooth_background(rng, H, W, cells=5):
    """Bilinear upsample of a random coarse grid — low-frequency shading."""
    coarse = rng.uniform(0.2, 0.8, (cells, cells)).astype(np.float32)
    ys = np.linspace(0, cells - 1, H)
    xs = np.linspace(0, cells - 1, W)
    y0 = np.clip(ys.astype(int), 0, cells - 2)
    x0 = np.clip(xs.astype(int), 0, cells - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    c00 = coarse[y0][:, x0]
    c01 = coarse[y0][:, x0 + 1]
    c10 = coarse[y0 + 1][:, x0]
    c11 = coarse[y0 + 1][:, x0 + 1]
    return (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
            + c10 * fy * (1 - fx) + c11 * fy * fx)


def render_edge_scene(rng: np.random.Generator, H: int, W: int,
                      n_rects: int = 3, noise: float = 0.02):
    """→ (image (H, W) float32 [0,1], gt_edge (H, W) bool, segments (S, 4)):
    ``segments`` are the rectangle outline pieces in image coordinates."""
    img = _smooth_background(rng, H, W)
    gt = np.zeros((H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W]
    segments = []
    for _ in range(n_rects):
        cx = rng.uniform(0.2 * W, 0.8 * W)
        cy = rng.uniform(0.2 * H, 0.8 * H)
        hw = rng.uniform(0.12 * W, 0.3 * W)
        hh = rng.uniform(0.12 * H, 0.3 * H)
        th = rng.uniform(0, np.pi)
        c, s = np.cos(th), np.sin(th)
        u = (xx - cx) * c + (yy - cy) * s  # the rectangle's local coordinates
        v = -(xx - cx) * s + (yy - cy) * c
        inside = (np.abs(u) < hw) & (np.abs(v) < hh)
        img = np.where(inside, np.clip(img + rng.uniform(-0.45, 0.45), 0, 1), img)
        # outline: a 1.2 px band around the rectangle's boundary
        band = ((np.abs(np.abs(u) - hw) < 1.2) & (np.abs(v) < hh)) | (
            (np.abs(np.abs(v) - hh) < 1.2) & (np.abs(u) < hw))
        gt |= band
        corners = np.array([
            [cx + hw * c - hh * (-s), cy + hw * s - hh * c],
            [cx + hw * c + hh * (-s), cy + hw * s + hh * c],
            [cx - hw * c + hh * (-s), cy - hw * s + hh * c],
            [cx - hw * c - hh * (-s), cy - hw * s - hh * c],
        ])
        for k in range(4):
            p0, p1 = corners[k], corners[(k + 1) % 4]
            segments.append([p0[0], p0[1], p1[0], p1[1]])
    img = np.clip(img + rng.standard_normal((H, W)) * noise, 0, 1)
    return img.astype(np.float32), gt, np.asarray(segments, np.float32)


def make_batch_numpy(H: int, W: int, batch: int, seed: int):
    """(images (B, H, W) f32, edge labels (B, H, W) bool): the JAX package's
    arrays for the seed."""
    rng = np.random.default_rng(seed)
    imgs, gts = [], []
    for _ in range(batch):
        img, gt, _ = render_edge_scene(rng, H, W)
        imgs.append(img)
        gts.append(gt)
    return np.stack(imgs), np.stack(gts)


def make_batch(H: int, W: int, batch: int, seed: int, device="cuda"):
    """:func:`make_batch_numpy` as tensors on ``device``."""
    dev = resolve_device(device)
    imgs, gts = make_batch_numpy(H, W, batch, seed)
    return torch.as_tensor(imgs).to(dev), torch.as_tensor(gts).to(dev)


def _conv(x, p, dilation: int = 1):
    """SAME conv of NCHW ``x`` with an HWIO leaf, f32, + bias."""
    pad = dilation * (p["w"].shape[0] // 2)
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=pad, dilation=dilation)


def edge_logits(params, images):
    """images (B, H, W) in [0, 1] → fused edge logits (B, H, W), f32 and
    differentiable in every leaf. Stage scores fold each conv's side
    branch per forward: score = Σ_i x_i · (W_down_i · w_score) + b_score +
    Σ_i b_down_i · w_score."""
    B, H, W = images.shape
    x = (images * 255.0)[:, None].expand(B, 3, H, W)
    side_scores = []
    for sname, convs in STAGES:
        dil = 2 if sname == "conv5" else 1
        ws = params[f"{sname}_score"]["w"][0, 0, :, 0]  # (SIDE,)
        score = params[f"{sname}_score"]["b"][:, None, None]
        for i in range(len(convs)):
            name = f"{sname}_{i + 1}"
            x = torch.relu(_conv(x, params[name], dil))
            down = params[f"{name}_down"]
            score = score + torch.einsum("bchw,c->bhw", x, down["w"][0, 0] @ ws)
            score = score + down["b"] @ ws
        side_scores.append(_upsample_bilinear(score, H, W))
        if sname != "conv5":
            x = _pool2(x, 1 if sname == "conv4" else 2)
    fuse = params["fuse"]
    return torch.stack(side_scores, -1) @ fuse["w"][0, 0, :, 0] + fuse["b"]


def loss_fn(params, imgs, gts):
    """Class-balanced sigmoid BCE on the fused logit: positives weighted by
    the negative pixel fraction, negatives by 1.1 × the positive one."""
    logits = edge_logits(params, imgs)
    y = gts.float()
    pos = y.sum()
    neg = y.numel() - pos
    alpha = neg / (pos + neg)
    beta = 1.1 * pos / (pos + neg)
    w = torch.where(y > 0, alpha, beta)
    bce = torch.relu(logits) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    return (w * bce).sum() / w.sum().clamp_min(1.0)


def train(steps: int = 200, batch: int = 2, hw=(96, 128), width_mult: float = 0.25,
          lr: float = 3e-4, seed: int = 0, params=None, log_every: int = 25,
          verbose: bool = True, device="cuda", stats: dict | None = None):
    """Train (a reduced-width) RCF on synthetic polygon scenes; step s trains
    on ``make_batch(H, W, batch, seed · 99991 + s)``, as in JAX. Returns
    (trained numpy pytree, loss history)."""
    H, W = hw
    dev = resolve_device(device)
    if params is None:
        params = rcf.init_params(seed, width_mult)
    return train_adam(params, lambda p, b: loss_fn(p, *b),
                      lambda s: make_batch(H, W, batch, seed * 99991 + s, dev),
                      steps, lr, dev, log_every, verbose, stats)
