"""K2 wrapper: one whole SuperGlue GNN layer on the stacked (2B, K, C)
layout (port of ops/attention_pallas.py). CUDA tensors launch the three
kernels of ``csrc/superglue_layer.cu`` or raise; CPU tensors take
:func:`superglue_layer_plain`. f32 throughout, as the TPU kernel."""

from __future__ import annotations

import math

import torch

from rspl_slam_tpu_torch.ops import cuda_build

__all__ = ["pack_layer", "superglue_layer", "superglue_layer_plain"]

launches = 0  # wrapper calls that launched the kernels (one per GNN layer)

_KEYS = ("wqkv", "bqkv", "wm", "bm", "w1", "b1", "s1", "t1", "w2", "b2")


def pack_layer(layer: dict, device) -> dict:
    """JAX-layout layer params (q/k/v/merge {w (C, C), b}, mlp [{w, b,
    bn_scale, bn_shift}] × 2) → contiguous f32 tensors for the kernel:
    wqkv = [Wq | Wk | Wv] (C, 3C), the merge, the (2C, 2C) first MLP weight
    (rows [:C] act on x, [C:] on the message) and the second."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32).to(device).contiguous()

    m0, m1 = layer["mlp"]
    return {
        "wqkv": t(torch.cat([torch.as_tensor(layer[n]["w"]) for n in "qkv"], 1)),
        "bqkv": t(torch.cat([torch.as_tensor(layer[n]["b"]) for n in "qkv"], 0)),
        "wm": t(layer["merge"]["w"]), "bm": t(layer["merge"]["b"]),
        "w1": t(m0["w"]), "b1": t(m0["b"]),
        "s1": t(m0["bn_scale"]), "t1": t(m0["bn_shift"]),
        # the last MLP layer has no norm/activation (bn is identity there)
        "w2": t(m1["w"]), "b2": t(m1["b"]),
    }


def _flip(t):
    n = t.shape[0] // 2
    return torch.cat([t[n:], t[:n]], 0)


def superglue_layer_plain(x, masks, layer: dict, cross: bool, num_heads: int = 4):
    """x + MLP(concat[x, merge(attention(x → source))]); the source is the
    set itself (self layer) or the other half of the stack (cross)."""
    n2, K, C = x.shape
    dh = C // num_heads
    q, k, v = (x @ layer["wqkv"] + layer["bqkv"]).split(C, dim=-1)
    q = q.reshape(n2, K, num_heads, dh)
    k = k.reshape(n2, K, num_heads, dh)
    v = v.reshape(n2, K, num_heads, dh)
    m = masks
    if cross:
        k, v, m = _flip(k), _flip(v), _flip(masks)
    logits = torch.einsum("bqhd,bshd->bhqs", q, k) / math.sqrt(dh)
    logits = torch.where(m[:, None, None, :], logits, -1e9)
    p = torch.softmax(logits, dim=-1)
    msg = torch.einsum("bhqs,bshd->bqhd", p, v).reshape(n2, K, C)
    msg = msg @ layer["wm"] + layer["bm"]
    h = torch.relu((x @ layer["w1"][:C] + msg @ layer["w1"][C:] + layer["b1"])
                   * layer["s1"] + layer["t1"])
    return x + h @ layer["w2"] + layer["b2"]


def superglue_layer(x, masks, layer: dict, cross: bool, num_heads: int = 4):
    """One GNN layer for both sets. x (2B, K, C) f32, masks (2B, K) bool,
    ``layer`` from :func:`pack_layer`. The kernel takes C = 256, 4 heads."""
    global launches
    if x.device.type == "cpu":
        return superglue_layer_plain(x, masks, layer, cross, num_heads)
    n2, K, C = x.shape
    if C != 256 or num_heads != 4 or n2 % 2:
        raise ValueError(f"superglue_layer kernel takes (2B, K, 256) with 4 heads; "
                         f"got {tuple(x.shape)}, {num_heads} heads")
    cuda_build.require_cuda(x, "x", torch.float32)
    mk = masks.to(torch.float32).contiguous()
    cuda_build.require_cuda(mk, "masks", torch.float32, (n2, K))
    for key in _KEYS:
        cuda_build.require_cuda(layer[key], key, torch.float32)
    qkv = torch.empty((n2 * K, 3 * C), dtype=torch.float32, device=x.device)
    msg = torch.empty((n2 * K, C), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    cuda_build.launch("superglue_layer", "superglue_layer_launch", x, mk,
                      *(layer[k] for k in _KEYS), qkv, msg, out, n2, K,
                      int(bool(cross)), cuda_build.stream_of(x))
    launches += 1
    return out
