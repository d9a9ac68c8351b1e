"""Self-supervised SuperPoint pretraining on the synthetic renderer (port of
training/superpoint_train.py).

The MagicPoint recipe adapted to the renderer, as in the JAX package:

- **Detector head**: 65-way cell classification. The renderer knows the
  exact subpixel location of every blob; each 8×8 cell's label is the
  position of the keypoint in it, or 64 (the "no keypoint" dustbin).
- **Descriptor head**: a contrastive hinge over stereo pairs with known
  correspondences: matching cells pulled together (margin ``mp``), the
  cell 7 further on pushed apart (margin ``mn``).

The forward is its own: f32 ``F.conv2d`` over the JAX-layout leaves (HWIO
weights), as ``_detector_loss`` there recomputes the encoder and heads
from the parameter leaves in XLA. The inference module
(``models/superpoint.SuperPoint``) caches cast weights and runs conv1b in
K1, which has no backward, so training never goes through it. Trained
weights load through ``models/weights.superpoint_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rspl_slam_tpu_torch.config import CameraConfig
from rspl_slam_tpu_torch.evaluation import synthetic
from rspl_slam_tpu_torch.frontend.frontends import resolve_device
from rspl_slam_tpu_torch.models import superpoint
from rspl_slam_tpu_torch.models.weights import to_numpy_tree
from rspl_slam_tpu_torch.training.loop import deterministic, train_adam

__all__ = ["detector_labels", "make_batch_numpy", "make_batch", "forward", "loss_fn",
           "train", "save_params", "load_params"]

DEFAULT_CAMERA = CameraConfig(image_width=320, image_height=240, fx=240.0, fy=240.0,
                              cx=160.0, cy=120.0, bf=24.0)


def detector_labels(xy: np.ndarray, valid: np.ndarray, H: int, W: int):
    """Keypoint pixel locations → (H/8, W/8) int labels in [0, 64]:
    8*(y%8)+(x%8) for the (at most one) keypoint in each cell, else 64."""
    Hc, Wc = H // 8, W // 8
    lab = np.full((Hc, Wc), 64, np.int32)
    for (x, y), v in zip(xy, valid):
        if not v:
            continue
        xi, yi = int(round(x)), int(round(y))
        if not (0 <= xi < W and 0 <= yi < H):
            continue
        lab[yi // 8, xi // 8] = 8 * (yi % 8) + (xi % 8)
    return lab


def make_batch_numpy(cam: CameraConfig, batch: int, seed: int):
    """Render ``batch`` stereo pairs of fresh random scenes with labels and
    left↔right cell correspondences: (imgs_l, imgs_r (B, H, W) f32,
    labs_l, labs_r (B, H/8, W/8) int32, corr (B, H/8·W/8) int32, −1 where a
    left cell has no landmark), the JAX package's arrays for the seed."""
    rng = np.random.default_rng(seed)
    H, W = cam.image_height, cam.image_width
    Hc, Wc = H // 8, W // 8
    imgs_l, imgs_r, labs_l, labs_r = [], [], [], []
    corr = np.full((batch, Hc * Wc), -1, np.int32)  # left cell → right cell
    for b in range(batch):
        scene = synthetic.make_scene(
            num_points=int(rng.integers(150, 300)), num_lines=int(rng.integers(0, 8)),
            seed=int(rng.integers(1 << 31)), extent=(6.0, 4.0, 6.0), on_line_frac=0.0)
        il, ir = synthetic.render_images(scene, cam, np.eye(4),
                                         seed=int(rng.integers(1 << 31)))
        obs = synthetic.observe_points(scene, cam, np.eye(4))
        vis = obs["visible"]
        labs_l.append(detector_labels(obs["uv_left"], vis, H, W))
        labs_r.append(detector_labels(obs["uv_right"], vis, H, W))
        imgs_l.append(il)
        imgs_r.append(ir)
        for (xl, yl), (xr, yr), v in zip(obs["uv_left"], obs["uv_right"], vis):
            if not v:
                continue
            if 0 <= xl < W and 0 <= yl < H and 0 <= xr < W and 0 <= yr < H:
                corr[b, (int(yl) // 8) * Wc + int(xl) // 8] = (int(yr) // 8) * Wc + int(xr) // 8
    return (np.stack(imgs_l), np.stack(imgs_r), np.stack(labs_l), np.stack(labs_r), corr)


def make_batch(cam: CameraConfig, batch: int, seed: int, device="cuda"):
    """:func:`make_batch_numpy` as tensors on ``device`` (labels and
    correspondences int64, for indexing)."""
    dev = resolve_device(device)
    il, ir, ll, lr_, corr = make_batch_numpy(cam, batch, seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)  # noqa: E731
    i = lambda a: torch.as_tensor(a, dtype=torch.int64).to(dev)  # noqa: E731
    return f(il), f(ir), i(ll), i(lr_), i(corr)


def _conv(x, p):
    """SAME conv of NCHW ``x`` with an HWIO leaf, f32, + bias."""
    k = p["w"].shape[0]
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=k // 2)


def forward(params, images):
    """images (B, H, W) → (65-way cell logits (B, H/8, W/8, 65), L2-normalized
    descriptors (B, H/8, W/8, 256)), f32 and differentiable in the leaves."""
    x = images[:, None]
    for block in (("conv1a", "conv1b"), ("conv2a", "conv2b"), ("conv3a", "conv3b")):
        for name in block:
            x = torch.relu(_conv(x, params[name]))
        x = F.max_pool2d(x, 2)
    for name in ("conv4a", "conv4b"):
        x = torch.relu(_conv(x, params[name]))
    logits = _conv(torch.relu(_conv(x, params["convPa"])), params["convPb"])
    desc = _conv(torch.relu(_conv(x, params["convDa"])), params["convDb"])
    desc = desc / torch.linalg.norm(desc, dim=1, keepdim=True).clamp_min(1e-12)
    return logits.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def _detector_loss(logits, labels):
    """Cross-entropy of the cell logits against rendered GT, keypoint cells
    weighted ×10 (most cells are empty)."""
    ce = -torch.log_softmax(logits, -1).gather(-1, labels[..., None])[..., 0]
    w = torch.where(labels < 64, 10.0, 1.0)
    return torch.sum(ce * w) / torch.sum(w)


def loss_fn(params, imgs_l, imgs_r, labs_l, labs_r, corr, lam: float = 1.0,
            mp: float = 1.0, mn: float = 0.2):
    """Detector cross-entropy of both eyes + ``lam`` × the descriptor hinge.
    Both eyes run as one batch of 2B images."""
    B = imgs_l.shape[0]
    logits, desc = forward(params, torch.cat([imgs_l, imgs_r], 0))
    det = _detector_loss(logits[:B], labs_l) + _detector_loss(logits[B:], labs_r)
    _, Hc, Wc, C = desc.shape
    dl = desc[:B].reshape(B, Hc * Wc, C)
    dr = desc[B:].reshape(B, Hc * Wc, C)
    has = (corr >= 0).float()
    corr_safe = corr.clamp_min(0)
    pos = dr.gather(1, corr_safe[..., None].expand(-1, -1, C))
    loss_pos = torch.relu(mp - (dl * pos).sum(-1)) * has
    # sampled negatives: the correspondence rolled by 7 cells
    neg = dr.gather(1, ((corr_safe + 7) % (Hc * Wc))[..., None].expand(-1, -1, C))
    loss_neg = torch.relu((dl * neg).sum(-1) - mn) * has
    denom = has.sum().clamp_min(1.0)
    return det + lam * (loss_pos.sum() + loss_neg.sum()) / denom


def train(cam: CameraConfig | None = None, steps: int = 300, batch: int = 4,
          lr: float = 1e-3, seed: int = 0, params=None, log_every: int = 50,
          verbose: bool = True, device="cuda", stats: dict | None = None):
    """Train SuperPoint on synthetic scenes (f32; inference runs the trained
    weights at bf16). Step s trains on ``make_batch(cam, batch, seed ·
    100003 + s)``, as in JAX. Returns the trained numpy pytree.

    The steps are :func:`~rspl_slam_tpu_torch.training.loop.deterministic`:
    at lr 1e-3 the atomics' rounding order, different in each run, grows
    over 120 steps into recalls of the trained detector from 0.13 to 0.40
    on the same seed (H100, chip_smoke.py's ``train_superpoint``)."""
    cam = cam or DEFAULT_CAMERA
    dev = resolve_device(device)
    if params is None:
        params = superpoint.init_params(seed)
    with deterministic():
        trained, hist = train_adam(
            params, lambda p, b: loss_fn(p, *b),
            lambda s: make_batch(cam, batch, seed * 100003 + s, dev),
            steps, lr, dev, log_every, verbose, stats)
    if stats is not None:
        stats["loss"] = hist
    return trained


def save_params(params, path: str):
    """The flat ``name/leaf`` ``.npz`` that the JAX package's
    ``load_params`` reads."""
    flat = {f"{name}/{leaf}": v for name, p in to_numpy_tree(params).items()
            for leaf, v in p.items()}
    np.savez_compressed(path, **flat)


def load_params(path: str):
    """The pytree of :func:`save_params`, as numpy."""
    data = np.load(path)
    params: dict = {}
    for k in data.files:
        name, leaf = k.split("/")
        params.setdefault(name, {})[leaf] = np.asarray(data[k])
    return params
