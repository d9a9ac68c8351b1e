"""RCF (Richer Convolutional Features) edge network (port of models/rcf.py).

The public RCF on VGG16: five conv stages; every conv of a stage feeds a
21-channel 1×1 side branch, the branch sum gets a 1×1 score, each stage
score is upsampled bilinearly to the input size, and a final 1×1 fuses the
five. ``pool4`` has stride 1 and ``conv5`` dilation 2, so stage 5 stays at
1/8 resolution. The input is grayscale in [0, 1], scaled to 0..255 and fed
as if replicated to 3 channels.

Numerics follow the JAX ``edge_logits``: trunk convs take compute-dtype
operands and write compute-dtype activations (bias added in that dtype);
the side branch and score of each conv fold into one C-vector with f32
results; the fuse takes compute-dtype operands with f32 results.

Stage 1 has two recipes, as in JAX. The K1 recipe (``_stem_pallas`` there)
runs conv1_1 as a c_in = 1 conv with channel-summed weights and conv1_2 +
the 2×2 pool + the full-resolution side score through K1's side-output mode
(``ops/conv_stem_cuda.conv3x3_relu_pool``; plain on CPU tensors). The other
recipe is the generic conv loop. ``use_pallas_stem=None`` takes K1 for
every CUDA tensor, which launches it or raises where K1's own limits (bf16,
64 stem channels, even H and W) do not hold; CPU tensors take the generic
loop, as JAX does off the TPU. Stages 2-5 run ``F.conv2d`` (the JAX package
runs them outside Pallas too).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from rspl_slam_tpu_torch.ops import conv_stem_cuda

__all__ = ["init_params", "edge_detector_params", "load_torch_weights", "RCF",
           "edge_logits", "edge_map"]

# (stage, convs): VGG16 channel layout
STAGES = [
    ("conv1", [(3, 64), (64, 64)]),
    ("conv2", [(64, 128), (128, 128)]),
    ("conv3", [(128, 256), (256, 256), (256, 256)]),
    ("conv4", [(256, 512), (512, 512), (512, 512)]),
    ("conv5", [(512, 512), (512, 512), (512, 512)]),
]
SIDE_CH = 21


def init_params(seed: int = 0, width_mult: float = 1.0) -> dict:
    """He-initialized parameters in the JAX layout {name: {w (kh, kw, cin,
    cout), b}} as numpy f32 (drawn with numpy, so not the JAX package's
    numbers for the same seed). ``width_mult`` scales every stage's
    channels (min 8), as in JAX."""
    rng = np.random.default_rng(seed)

    def scale(c):
        return c if width_mult == 1.0 else max(8, int(round(c * width_mult)))

    def conv(cin, cout, k):
        w = rng.standard_normal((k, k, cin, cout)) * np.sqrt(2.0 / (cin * k * k))
        return {"w": w.astype(np.float32), "b": np.zeros((cout,), np.float32)}

    params = {}
    for sname, convs in STAGES:
        for i, (cin, cout) in enumerate(convs):
            params[f"{sname}_{i + 1}"] = conv(cin if cin == 3 else scale(cin), scale(cout), 3)
            params[f"{sname}_{i + 1}_down"] = conv(scale(cout), SIDE_CH, 1)
        params[f"{sname}_score"] = conv(SIDE_CH, 1, 1)
    params["fuse"] = conv(5, 1, 1)
    return params


def edge_detector_params(width_mult: float = 1.0) -> dict:
    """Hand-set weights whose edge map sees intensity edges — test weights
    for end-to-end runs (random RCF weights do not see edges). conv1_1: 8
    signed central differences of the grey image (4 directions × 2 signs,
    so ReLU keeps |∂|); conv1_2: identity on those 8 channels; stage-1
    side: their sum × 0.1 through conv1_2's branch; fuse: stage 1 alone
    with bias −6. Every other side, score and fuse weight is zero; the
    trunk of stages 2-5 keeps ``init_params(0, width_mult)`` (it runs, but
    the logits do not see it), so every ``width_mult`` down to 0.125 (8
    stem channels) gives the same logits: CPU tests run narrow."""
    p = init_params(0, width_mult)
    for name, q in p.items():
        if name.endswith("_down") or name.endswith("_score") or name == "fuse":
            q["w"][:] = 0.0
            q["b"][:] = 0.0
    c1 = p["conv1_1"]["w"].shape[3]
    if c1 < 8:
        raise ValueError(f"edge_detector_params needs 8 stem channels, width_mult gives {c1}")
    w11 = np.zeros((3, 3, 3, c1), np.float32)
    taps = [((1, 2), (1, 0)), ((2, 1), (0, 1)), ((2, 2), (0, 0)), ((2, 0), (0, 2))]
    for k, (plus, minus) in enumerate(taps):
        for sign, c in ((1.0, 2 * k), (-1.0, 2 * k + 1)):
            w11[plus + (0, c)] = sign  # grey lives in input channel 0 alone
            w11[minus + (0, c)] = -sign
    p["conv1_1"] = {"w": w11, "b": np.zeros(c1, np.float32)}
    w12 = np.zeros((3, 3, c1, c1), np.float32)
    w12[1, 1, np.arange(8), np.arange(8)] = 1.0
    p["conv1_2"] = {"w": w12, "b": np.zeros(c1, np.float32)}
    p["conv1_2_down"]["w"][0, 0, :8, 0] = 1.0
    p["conv1_score"]["w"][0, 0, 0, 0] = 0.1
    p["fuse"]["w"][0, 0, 0, 0] = 1.0
    p["fuse"]["b"][0] = -6.0
    return p



def load_torch_weights(path: str) -> dict:
    """The public RCF checkpoint (conv1_1..conv5_3, ``*_down``,
    ``score_dsn*``, ``score_final``; a ``module.`` prefix and a nested
    ``state_dict`` accepted) → the JAX pytree layout as numpy."""
    from rspl_slam_tpu_torch.models.superpoint import _state_dict

    sd = {k.replace("module.", ""): v for k, v in _state_dict(path).items()}

    def conv(prefix):
        return {"w": np.ascontiguousarray(np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0))),
                "b": sd[f"{prefix}.bias"]}

    params = {}
    for si, (sname, convs) in enumerate(STAGES, start=1):
        for i in range(len(convs)):
            params[f"{sname}_{i + 1}"] = conv(f"conv{si}_{i + 1}")
            params[f"{sname}_{i + 1}_down"] = conv(f"conv{si}_{i + 1}_down")
        params[f"{sname}_score"] = conv(f"score_dsn{si}")
    params["fuse"] = conv("score_final")
    return params

class RCF(nn.Module):
    """Holds the weights as buffers: trunk convs OIHW for ``F.conv2d`` (stage
    1 also HWIO, for the K1 stem); each conv's side branch folded with its
    stage score into one (C,) vector (``<conv>_side``, f32) and each
    stage's bias into a scalar (``<stage>_bias``); the fuse as (5,) + (1,)."""

    def __init__(self, params: dict):
        super().__init__()
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
        for sname, convs in STAGES:
            ws = t(params[f"{sname}_score"]["w"])[0, 0, :, 0]  # (SIDE,)
            bias = t(params[f"{sname}_score"]["b"])
            for i in range(len(convs)):
                name = f"{sname}_{i + 1}"
                w = t(params[name]["w"])
                self.register_buffer(f"{name}_w", w.permute(3, 2, 0, 1).contiguous())
                if sname == "conv1":  # the K1 stem's layout
                    self.register_buffer(f"{name}_hwio", w.contiguous())
                self.register_buffer(f"{name}_b", t(params[name]["b"]))
                down = params[f"{name}_down"]
                self.register_buffer(f"{name}_side", t(down["w"])[0, 0] @ ws)
                bias = bias + t(down["b"]) @ ws
            self.register_buffer(f"{sname}_bias", bias)
        self.register_buffer("fuse_w", t(params["fuse"]["w"])[0, 0, :, 0].contiguous())
        self.register_buffer("fuse_b", t(params["fuse"]["b"]))
        self._cast: dict = {}

    def _wb(self, name: str, dtype):
        """Trunk weights and bias in ``dtype`` (channels-last on the card),
        cached."""
        w = getattr(self, f"{name}_w")
        key = (name, dtype, w.device)
        if key not in self._cast:
            wc = w.to(dtype)
            if w.is_cuda:
                wc = wc.contiguous(memory_format=torch.channels_last)
            self._cast[key] = (wc, getattr(self, f"{name}_b").to(dtype))
        return self._cast[key]

    def _stem_w(self):
        """conv1_2's weights as K1 takes them: packed once on the card,
        HWIO on the CPU."""
        w = self.conv1_2_hwio
        if not w.is_cuda:
            return w
        key = ("conv1_2", "k1", w.device)
        if key not in self._cast:
            self._cast[key] = conv_stem_cuda.pack_weights(w)
        return self._cast[key]


def _conv(rcf: RCF, x, name: str, dtype, dilation: int = 1):
    """Trunk conv + ReLU: ``dtype`` operands and output, the bias added in
    ``dtype`` after the conv's rounding, as JAX's ``_conv``."""
    w, b = rcf._wb(name, dtype)
    y = F.conv2d(x, w, None, padding=dilation, dilation=dilation)
    return torch.relu(y + b[None, :, None, None])


def _side(rcf: RCF, x, name: str, dtype):
    """One conv's folded side contribution: ``dtype`` operands, f32 sum."""
    return torch.einsum("bchw,c->bhw", x.float(), getattr(rcf, f"{name}_side").to(dtype).float())


def _pool2(x, stride: int):
    """2×2 max-pool with SAME padding of −inf (pads at the high end)."""
    if stride == 2:
        return F.max_pool2d(x, 2, 2, ceil_mode=True)
    return F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 2, 1)


def _upsample_bilinear(x, H: int, W: int):
    """(B, h, w) → (B, H, W) bilinear with half-pixel centres, as
    ``jax.image.resize`` upsamples."""
    if x.shape[-2:] == (H, W):
        return x
    return F.interpolate(x[:, None], size=(H, W), mode="bilinear",
                         align_corners=False)[:, 0]


def _stem_k1(rcf: RCF, x255, dtype):
    """Stage 1 through K1: conv1_1 as c_in = 1, conv1_2 + pool + side score
    in one launch. Returns (x NCHW view of NHWC memory, stage-1 score)."""
    w11 = rcf.conv1_1_hwio.sum(2, keepdim=True)  # the grey input, replicated
    x11 = conv_stem_cuda.conv1a(x255, w11, rcf.conv1_1_b, dtype)  # (B, H, W, 64)
    s1a = torch.einsum("bhwc,c->bhw", x11.float(), rcf.conv1_1_side.to(dtype).float())
    x, s1b = conv_stem_cuda.conv3x3_relu_pool(x11, rcf._stem_w(), rcf.conv1_2_b,
                                              rcf.conv1_2_side)
    return x.permute(0, 3, 1, 2), s1a + s1b + rcf.conv1_bias


@torch.no_grad()
def edge_logits(rcf: RCF, images: torch.Tensor, compute_dtype=torch.bfloat16,
                use_pallas_stem: bool | None = None) -> torch.Tensor:
    """images (B, H, W) grayscale in [0, 1] → fused edge logits (B, H, W) f32.
    ``use_pallas_stem=False`` asks for the generic stage 1 on any device."""
    B, H, W = images.shape
    if use_pallas_stem is None:
        use_pallas_stem = images.is_cuda
    x255 = images.float() * 255.0
    scores = []
    if use_pallas_stem:
        x, s1 = _stem_k1(rcf, x255, compute_dtype)
        scores.append(s1)
        stages = STAGES[1:]
    else:
        x = x255[:, None].expand(B, 3, H, W).to(compute_dtype)
        if images.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        stages = STAGES
    for sname, convs in stages:
        dil = 2 if sname == "conv5" else 1
        score = 0.0
        for i in range(len(convs)):
            name = f"{sname}_{i + 1}"
            x = _conv(rcf, x, name, compute_dtype, dil)
            score = score + _side(rcf, x, name, compute_dtype)
        scores.append(_upsample_bilinear(score + getattr(rcf, f"{sname}_bias"), H, W))
        if sname != "conv5":
            x = _pool2(x, 1 if sname == "conv4" else 2)
    side = torch.stack(scores, -1).to(compute_dtype).float()
    return side @ rcf.fuse_w.to(compute_dtype).float() + rcf.fuse_b


def edge_map(rcf: RCF, images: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """images (B, H, W) in [0, 1] → edge probability (B, H, W): the sigmoid
    of the fused logits."""
    return torch.sigmoid(edge_logits(rcf, images, compute_dtype))
