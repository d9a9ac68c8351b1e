"""SuperPoint keypoint detector + descriptor (port of models/superpoint.py).

The encoder and heads of the public SuperPoint, batched over images:

    conv1a/1b(64) → pool → conv2a/2b(64) → pool → conv3a/3b(128) → pool →
    conv4a/4b(128); heads convPa(256)→convPb(65), convDa(256)→convDb(256).

conv1a runs in plain torch and conv1b + the first pool in the K1 kernel
(ops/conv_stem_cuda.py) — the split of the JAX package's Pallas stem.
conv2a…convDa are ``F.conv2d`` in the compute dtype (channels-last on the
card); the 1×1 heads take compute-dtype operands with f32 results, like
the JAX ``_conv`` with ``preferred_element_type=f32``. Public layouts are
the JAX ones: probs (B, Hc, Wc, 64), desc (B, C, Hc, Wc), features
(B, K, ·).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from rspl_slam_tpu_torch.config import SuperPointConfig
from rspl_slam_tpu_torch.ops import conv_stem_cuda
from rspl_slam_tpu_torch.ops.keypoints import (_cells_to_pixels, sample_descriptors,
                                               simple_nms, simple_nms_cell, top_k_keypoints,
                                               top_k_keypoints_cell)

__all__ = ["LAYERS", "init_params", "load_torch_weights", "SuperPoint", "dense_heads",
           "Features", "extract"]

LAYERS = [
    # name, in_ch, out_ch, kernel
    ("conv1a", 1, 64, 3),
    ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3),
    ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3),
    ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3),
    ("conv4b", 128, 128, 3),
    ("convPa", 128, 256, 3),
    ("convPb", 256, 65, 1),
    ("convDa", 128, 256, 3),
    ("convDb", 256, 256, 1),
]


def init_params(seed: int = 0) -> dict:
    """He-initialized parameters in the JAX layout {name: {w (kh, kw, cin,
    cout), b}} as numpy (drawn with numpy, so not the JAX package's
    numbers for the same seed)."""
    rng = np.random.default_rng(seed)
    return {
        name: {"w": (rng.standard_normal((k, k, cin, cout))
                     * np.sqrt(2.0 / (cin * k * k))).astype(np.float32),
               "b": np.zeros((cout,), np.float32)}
        for name, cin, cout, k in LAYERS
    }



def _state_dict(path: str) -> dict:
    """A checkpoint's tensors as numpy: a state dict, or one nested under
    ``state_dict``; ``weights_only`` loading (no pickled code runs)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.numpy() if torch.is_tensor(v) else v for k, v in sd.items()}


def load_torch_weights(path: str) -> dict:
    """The public SuperPoint ``.pth`` (OIHW convs) → the JAX pytree layout
    (HWIO) as numpy."""
    sd = _state_dict(path)
    return {name: {"w": np.ascontiguousarray(np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0))),
                   "b": sd[f"{name}.bias"]}
            for name, _, _, _ in LAYERS}

class SuperPoint(nn.Module):
    """Holds the weights as buffers: 3×3 convs in HWIO (the JAX layout and
    the plain stem's; K1 takes conv1b packed, see ``_stem_w``) and OIHW for
    ``F.conv2d``; 1×1 heads as (cin, cout)."""

    def __init__(self, params: dict):
        super().__init__()
        for name, _, _, k in LAYERS:
            w = torch.as_tensor(np.asarray(params[name]["w"]), dtype=torch.float32)
            b = torch.as_tensor(np.asarray(params[name]["b"]), dtype=torch.float32)
            if k == 1:
                self.register_buffer(f"{name}_w", w[0, 0].contiguous())
            else:
                self.register_buffer(f"{name}_w", w.permute(3, 2, 0, 1).contiguous())
                self.register_buffer(f"{name}_hwio", w.contiguous())
            self.register_buffer(f"{name}_b", b)
        self._cast: dict = {}

    def _wb(self, name: str, dtype):
        """Weights cast to ``dtype`` (channels-last on the card), cached."""
        w = getattr(self, f"{name}_w")
        key = (name, dtype, w.device)
        if key not in self._cast:
            wc = w.to(dtype)
            if w.is_cuda:
                wc = wc.contiguous(memory_format=torch.channels_last)
            self._cast[key] = (wc, getattr(self, f"{name}_b").to(dtype))
        return self._cast[key]

    def _stem_w(self):
        """conv1b's weights as K1 takes them: packed once on the card
        (``conv_stem_cuda.pack_weights``), HWIO on the CPU."""
        w = self.conv1b_hwio
        if not w.is_cuda:
            return w
        key = ("conv1b", "k1", w.device)
        if key not in self._cast:
            self._cast[key] = conv_stem_cuda.pack_weights(w)
        return self._cast[key]

    def _conv(self, x, name, dtype):
        w, b = self._wb(name, dtype)
        return torch.relu(F.conv2d(x, w, b, padding=1))

    def _head(self, x, name, dtype):
        """1×1 conv: ``dtype`` operands, f32 products and sum, NHWC out."""
        w = getattr(self, f"{name}_w").to(dtype).float()
        return x.float().permute(0, 2, 3, 1) @ w + getattr(self, f"{name}_b")

    def forward_cell(self, images, dtype=torch.bfloat16):
        """images (B, H, W) in [0, 1] → (probs (B, H/8, W/8, 64) f32 with
        channel c = 8·dy + dx, desc (B, 256, H/8, W/8) f32 L2-normalized)."""
        x = conv_stem_cuda.superpoint_stem(
            self.conv1a_hwio, self.conv1a_b, self._stem_w(), self.conv1b_b,
            images, dtype)  # (B, H/2, W/2, 64) NHWC
        x = x.permute(0, 3, 1, 2)  # NCHW view (channels-last memory)
        for a, b in (("conv2a", "conv2b"), ("conv3a", "conv3b")):
            x = self._conv(self._conv(x, a, dtype), b, dtype)
            x = F.max_pool2d(x, 2)
        x = self._conv(self._conv(x, "conv4a", dtype), "conv4b", dtype)
        logits = self._head(self._conv(x, "convPa", dtype), "convPb", dtype)
        probs = torch.softmax(logits, dim=-1)[..., :64]
        desc = self._head(self._conv(x, "convDa", dtype), "convDb", dtype)
        desc = desc / torch.linalg.norm(desc, dim=-1, keepdim=True).clamp_min(1e-12)
        return probs, desc.permute(0, 3, 1, 2)


def dense_heads(sp: SuperPoint, images: torch.Tensor, compute_dtype=torch.bfloat16):
    """images (B, H, W) in [0, 1] → (scores (B, H, W), desc (B, 256, H/8,
    W/8)): :meth:`SuperPoint.forward_cell` (conv1b through K1 on the card)
    with its cell-layout probabilities pixel-shuffled to full resolution.
    H and W are multiples of 8."""
    probs, desc = sp.forward_cell(images, compute_dtype)
    return _cells_to_pixels(probs), desc


class Features:
    """Fixed-K feature bundle: xy (B, K, 2) px, score (B, K), desc (B, K, C)
    L2-normalized, valid (B, K) bool."""

    def __init__(self, xy, score, desc, valid):
        self.xy = xy
        self.score = score
        self.desc = desc
        self.valid = valid


@torch.no_grad()
def extract(sp: SuperPoint, images: torch.Tensor, cfg: SuperPointConfig,
            compute_dtype=torch.bfloat16) -> Features:
    """Dense heads → NMS → top-K → descriptor sampling, batched. The NMS
    and top-K run on the cell layout for ``nms_radius`` 3..8, where that
    selection is exact (as in the JAX package), and on the full-resolution
    score map of :func:`dense_heads` for other radii."""
    if 3 <= cfg.nms_radius <= 8:
        probs, desc_map = sp.forward_cell(images, compute_dtype)
        scores = simple_nms_cell(probs, cfg.nms_radius)
        topk = top_k_keypoints_cell
    else:
        scores, desc_map = dense_heads(sp, images, compute_dtype)
        scores = simple_nms(scores, cfg.nms_radius)
        topk = top_k_keypoints
    xy, sc, valid = topk(scores, cfg.max_keypoints, cfg.keypoint_threshold,
                         cfg.remove_borders)
    return Features(xy, sc, sample_descriptors(xy, desc_map, 8), valid)
