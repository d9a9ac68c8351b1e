"""K2 wrapper: one whole SuperGlue GNN layer on the stacked (2B, K, C)
layout (port of ops/attention_pallas.py). CPU tensors take
:func:`superglue_layer_plain`; CUDA tensors launch ``csrc/superglue_layer.cu``
or raise, in one of two modes:

- ``compute_dtype=torch.bfloat16`` (the main path; the JAX package's
  default): every matmul operand rounds to bf16 where
  models/superglue.py rounds it, products accumulate in f32; two launches
  on the tensor cores.
- ``compute_dtype=torch.float32``: f32 throughout, the function of the
  Pallas kernel ``attention_layer_fused``; three FMA launches.
"""

from __future__ import annotations

import math

import torch

from rspl_slam_tpu_torch.ops import cuda_build

__all__ = ["LAYER_KEYS", "MAX_K_BF16", "bf16_smem_bytes", "layer_scratch", "pack_layer",
           "pack_mma_b", "round_operand", "superglue_layer", "superglue_layer_plain",
           "unpack_mma_b"]

launches = 0  # layers run by the bf16 kernels (the main path)
f32_launches = 0  # layers run by the f32 kernels

# the layer tensors each mode's kernels read, in the launchers' order
LAYER_KEYS = {
    torch.float32: ("wqkv", "bqkv", "wm", "bm", "w1", "b1", "s1", "t1", "w2", "b2"),
    torch.bfloat16: ("wqkv_mma", "bqkv", "wm_mma", "bm", "w1_mma", "b1", "s1", "t1",
                     "w2_mma", "b2"),
}
ROWS = 32  # query rows per cluster of the bf16 kernel (csrc/superglue_layer.cu)


def bf16_smem_bytes(K: int) -> int:
    """Dynamic shared memory of the bf16 layer kernel at K keypoints: the
    message tile, then the larger of the attention buffers (Q, K/V, logits,
    source mask over S = K rounded up to 16) and the two MLP tiles — the
    layout of csrc/superglue_layer.cu."""
    s = -(-K // 16) * 16
    msg = ROWS * (256 + 8) * 2
    attn = ROWS * (64 + 8) * 2 + s * (64 + 8) * 2 + ROWS * (s + 4) * 4 + s * 4
    mlp = 2 * ROWS * (512 + 8) * 2
    return msg + max(attn, mlp)


MAX_K_BF16 = max(k for k in range(16, 2048, 16)
                 if bf16_smem_bytes(k) <= cuda_build.SMEM_LIMIT)


def round_operand(a, compute_dtype):
    """``a`` rounded to ``compute_dtype`` and back to f32. A bf16 operand
    multiplied in f32 gives exact products and f32 sums, which is JAX's
    ``preferred_element_type=float32``; a bf16 ``torch.matmul`` would round
    its output as well."""
    return a if compute_dtype == torch.float32 else a.to(compute_dtype).float()


def _mma_b_index(Kd: int, N: int, device):
    """(k, n) of every element of :func:`pack_mma_b`'s layout, each of
    shape (N/16, Kd/16, 32, 8)."""
    lane = torch.arange(32, device=device)
    e = torch.arange(8, device=device)
    g, t = lane // 4, lane % 4
    kk = 2 * t[:, None] + (e % 2)[None] + 8 * ((e % 4) // 2)[None]  # (32, 8)
    nn = 8 * (e // 4)[None] + g[:, None]
    shape = (N // 16, Kd // 16, 32, 8)
    k = 16 * torch.arange(Kd // 16, device=device)[None, :, None, None] + kk
    n = 16 * torch.arange(N // 16, device=device)[:, None, None, None] + nn
    return k.expand(shape), n.expand(shape)


def pack_mma_b(w: torch.Tensor) -> torch.Tensor:
    """A (Kd, N) weight (``x @ w``) → bf16 in the register order of
    ``mma.sync.m16n8k16``'s B operand: (N/16, Kd/16, 32 lanes, 8). Lane
    4g + t of n16 block j, k-step s holds, for its two n8 tiles, the
    elements (k, n) = (16s + 2t + {0, 1, 8, 9}, 16j + 8·tile + g): one
    16-byte load per lane and k-step feeds two MMAs."""
    Kd, N = w.shape
    if Kd % 16 or N % 16:
        raise ValueError(f"pack_mma_b takes multiples of 16, got {tuple(w.shape)}")
    k, n = _mma_b_index(Kd, N, w.device)
    return w.to(torch.bfloat16)[k, n].contiguous()


def unpack_mma_b(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_mma_b`: the (Kd, N) bf16 weight."""
    Kd, N = 16 * p.shape[1], 16 * p.shape[0]
    k, n = _mma_b_index(Kd, N, p.device)
    w = torch.empty((Kd, N), dtype=p.dtype, device=p.device)
    w[k, n] = p
    return w


def pack_layer(layer: dict, device) -> dict:
    """JAX-layout layer params (q/k/v/merge {w (C, C), b}, mlp [{w, b,
    bn_scale, bn_shift}] × 2) → contiguous tensors on ``device``: f32
    wqkv = [Wq | Wk | Wv] (C, 3C), the merge, the (2C, 2C) first MLP weight
    (rows [:C] act on x, [C:] on the message) and the second, with their
    biases and folded BN; and each weight once more in bf16, packed by
    :func:`pack_mma_b` for the tensor-core kernel (``*_mma``)."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32).to(device).contiguous()

    m0, m1 = layer["mlp"]
    p = {
        "wqkv": t(torch.cat([torch.as_tensor(layer[n]["w"]) for n in "qkv"], 1)),
        "bqkv": t(torch.cat([torch.as_tensor(layer[n]["b"]) for n in "qkv"], 0)),
        "wm": t(layer["merge"]["w"]), "bm": t(layer["merge"]["b"]),
        "w1": t(m0["w"]), "b1": t(m0["b"]),
        "s1": t(m0["bn_scale"]), "t1": t(m0["bn_shift"]),
        # the last MLP layer has no norm/activation (bn is identity there)
        "w2": t(m1["w"]), "b2": t(m1["b"]),
    }
    for w in ("wqkv", "wm", "w1", "w2"):
        p[f"{w}_mma"] = pack_mma_b(p[w])
    return p


def _flip(t):
    n = t.shape[0] // 2
    return torch.cat([t[n:], t[:n]], 0)


def superglue_layer_plain(x, masks, layer: dict, cross: bool, num_heads: int = 4,
                          compute_dtype=torch.float32):
    """x + MLP(concat[x, merge(attention(x → source))]); the source is the
    set itself (self layer) or the other half of the stack (cross). Under
    bf16 each matmul operand rounds to bf16 where the JAX package's
    ``_proj`` / ``_attend`` / ``_apply_mlp`` round it, and the products
    sum in f32 (bf16 values multiplied as f32: exact products, f32 sums)."""
    def r(a):
        return round_operand(a, compute_dtype)

    n2, K, C = x.shape
    dh = C // num_heads
    xr = r(x)
    q, k, v = (xr @ r(layer["wqkv"]) + layer["bqkv"]).split(C, dim=-1)
    q = q.reshape(n2, K, num_heads, dh)
    k = k.reshape(n2, K, num_heads, dh)
    v = v.reshape(n2, K, num_heads, dh)
    m = masks
    if cross:
        k, v, m = _flip(k), _flip(v), _flip(masks)
    logits = torch.einsum("bqhd,bshd->bhqs", r(q), r(k)) / math.sqrt(dh)
    logits = torch.where(m[:, None, None, :], logits, -1e9)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)  # jax.nn.softmax's normalization
    msg = torch.einsum("bhqs,bshd->bqhd", r(p), r(v)).reshape(n2, K, C)
    msg = r(msg) @ r(layer["wm"]) + layer["bm"]
    w1 = r(layer["w1"])
    h = torch.relu((xr @ w1[:C] + r(msg) @ w1[C:] + layer["b1"]) * layer["s1"] + layer["t1"])
    return x + (r(h) @ r(layer["w2"]) + layer["b2"])


def layer_scratch(x, masks, compute_dtype=torch.float32):
    """What every layer of one match shares on the card: the masks as f32
    and the kernels' scratch (QKV, and the f32 mode's message). Made once
    per ``match_pair``; None on the CPU."""
    if x.device.type == "cpu":
        return None
    n2, K, C = x.shape
    s = {"mask": masks.to(torch.float32).contiguous(),
         "qkv": torch.empty((n2 * K, 3 * C), dtype=compute_dtype, device=x.device)}
    if compute_dtype == torch.float32:
        s["msg"] = torch.empty((n2 * K, C), dtype=torch.float32, device=x.device)
    return s


def superglue_layer(x, masks, layer: dict, cross: bool, num_heads: int = 4,
                    compute_dtype=torch.float32, scratch: dict | None = None):
    """One GNN layer for both sets. x (2B, K, C) f32, masks (2B, K) bool,
    ``layer`` from :func:`pack_layer`, ``scratch`` from
    :func:`layer_scratch` (made here when None). The kernels take C = 256
    with 4 heads, and the bf16 mode K ≤ :data:`MAX_K_BF16`."""
    global launches, f32_launches
    if x.device.type == "cpu":
        return superglue_layer_plain(x, masks, layer, cross, num_heads, compute_dtype)
    n2, K, C = x.shape
    if C != 256 or num_heads != 4 or n2 % 2:
        raise ValueError(f"superglue_layer kernel takes (2B, K, 256) with 4 heads; "
                         f"got {tuple(x.shape)}, {num_heads} heads")
    if compute_dtype not in LAYER_KEYS:
        raise ValueError(f"superglue_layer kernel computes in float32 or bfloat16, "
                         f"not {compute_dtype}")
    bf16 = compute_dtype == torch.bfloat16
    if bf16 and K > MAX_K_BF16:
        raise ValueError(f"superglue_layer bf16 kernel: K = {K} exceeds {MAX_K_BF16} "
                         f"({cuda_build.SMEM_LIMIT} B of shared memory per CTA)")
    cuda_build.require_cuda(x, "x", torch.float32)
    if scratch is None:
        scratch = layer_scratch(x, masks, compute_dtype)
    cuda_build.require_cuda(scratch["mask"], "masks", torch.float32, (n2, K))
    cuda_build.require_cuda(scratch["qkv"], "qkv scratch", compute_dtype, (n2 * K, 3 * C))
    keys = LAYER_KEYS[compute_dtype]
    for key in keys:
        cuda_build.require_cuda(layer[key], key, torch.bfloat16 if key.endswith("_mma")
                                else torch.float32)
    out = torch.empty_like(x)
    if bf16:
        cuda_build.launch("superglue_layer", "superglue_layer_bf16_launch", x,
                          scratch["mask"], *(layer[k] for k in keys), scratch["qkv"], out,
                          n2, K, int(bool(cross)), cuda_build.stream_of(x))
        with cuda_build.count_lock:
            launches += 1
    else:
        cuda_build.require_cuda(scratch["msg"], "msg scratch", torch.float32, (n2 * K, C))
        cuda_build.launch("superglue_layer", "superglue_layer_launch", x, scratch["mask"],
                          *(layer[k] for k in keys), scratch["qkv"], scratch["msg"], out,
                          n2, K, int(bool(cross)), cuda_build.stream_of(x))
        with cuda_build.count_lock:
            f32_launches += 1
    return out
