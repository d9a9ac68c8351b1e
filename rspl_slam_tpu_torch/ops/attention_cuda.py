"""K2 wrapper: one whole SuperGlue GNN layer on the stacked (2B, K, C)
layout (port of ops/attention_pallas.py), and its two-set variant
:func:`superglue_layer_two_set`, where a query set (B, M, C) attends over
a source set (B, N, C) of another length (the unstacked path that
models/superglue.py takes when M != N). CPU tensors take the plain
versions (:func:`superglue_layer_plain`,
:func:`superglue_layer_two_set_plain`); CUDA tensors launch
``csrc/superglue_layer.cu`` or raise, in one of two modes:

- ``compute_dtype=torch.bfloat16`` (the main path; the JAX package's
  default): every matmul operand rounds to bf16 where
  models/superglue.py rounds it, products accumulate in f32; two launches
  on the tensor cores (either variant).
- ``compute_dtype=torch.float32``: f32 throughout, the function of the
  Pallas kernel ``attention_layer_fused``; every product on the tensor
  cores as 3xTF32 (each operand split into two TF32 halves by
  :func:`split_tf32`, three products summed in f32), two launches in
  either variant, K and V streamed through a ring of
  :data:`F32_CHUNK`-key chunks: any source length.

The bf16 mode has two attention kernels, chosen by the source length
(:func:`bf16_route`): up to :data:`MAX_K_BF16` the whole logit row sits in
shared memory (resident); past it, K and V stream through a ring of
shared-memory chunks in two passes, the logits and probabilities in
registers (streamed), for any keypoint budget.
"""

from __future__ import annotations

import math

import torch

from rspl_slam_tpu_torch.ops import cuda_build

__all__ = ["CHUNK", "F32_CHUNK", "F32_STAGES", "KEY_GROUPS", "LAYER_KEYS", "MAX_K_BF16",
           "STAGES", "bf16_route", "bf16_smem_bytes", "bf16_streamed_smem_bytes",
           "f32_smem_bytes", "layer_scratch", "pack_layer", "pack_mma_b", "pack_tf32_b",
           "round_operand", "split_tf32", "superglue_layer", "superglue_layer_plain",
           "superglue_layer_two_set", "superglue_layer_two_set_plain", "unpack_mma_b",
           "unpack_tf32_b"]

launches = 0  # layers run by the bf16 kernels (the main path)
f32_launches = 0  # layers run by the f32 kernels
two_set_launches = 0  # two-set layers (one set over another) run by the bf16 kernels
two_set_f32_launches = 0  # two-set layers run by the f32 kernels
streamed_launches = 0  # layers (stacked or two-set) run by the streamed bf16 kernel

# the layer tensors each mode's kernels read, in the launchers' order
LAYER_KEYS = {
    torch.float32: ("wqkv_tf32", "bqkv", "wm_tf32", "bm", "w1_tf32", "b1", "s1", "t1",
                    "w2_tf32", "b2"),
    torch.bfloat16: ("wqkv_mma", "bqkv", "wm_mma", "bm", "w1_mma", "b1", "s1", "t1",
                     "w2_mma", "b2"),
}
ROWS = 32  # query rows per cluster of either mode's layer kernel (csrc/superglue_layer.cu)


def bf16_smem_bytes(K: int) -> int:
    """Dynamic shared memory of the bf16 layer kernel at K source keypoints:
    the message tile, then the larger of the attention buffers (Q, K/V,
    logits, source mask over S = K rounded up to 16) and the two MLP tiles
    — the layout of csrc/superglue_layer.cu."""
    s = -(-K // 16) * 16
    msg = ROWS * (256 + 8) * 2
    attn = ROWS * (64 + 8) * 2 + s * (64 + 8) * 2 + ROWS * (s + 4) * 4 + s * 4
    mlp = 2 * ROWS * (512 + 8) * 2
    return msg + max(attn, mlp)


MAX_K_BF16 = max(k for k in range(16, 2048, 16)
                 if bf16_smem_bytes(k) <= cuda_build.SMEM_LIMIT)

CHUNK = 128  # source keys per chunk of the streamed bf16 kernel
STAGES = 2  # chunks in flight in its ring (the next lands while one computes)
KEY_GROUPS = 4  # warps per m16 query tile, each on CHUNK / KEY_GROUPS keys of every chunk


def bf16_streamed_smem_bytes() -> int:
    """Dynamic shared memory of the streamed bf16 layer kernel, whatever
    the source length: the message tile, then the larger of the attention
    buffers (Q, a ring of :data:`STAGES` chunks of K rows, V rows and the
    chunk's mask, the key groups' (max, sum) per row) and the two MLP
    tiles — the layout of csrc/superglue_layer.cu."""
    msg = ROWS * (256 + 8) * 2
    stage = 2 * CHUNK * (64 + 8) * 2 + CHUNK * 4
    attn = ROWS * (64 + 8) * 2 + STAGES * stage + KEY_GROUPS * ROWS * 2 * 4
    mlp = 2 * ROWS * (512 + 8) * 2
    return msg + max(attn, mlp)


def bf16_route(K: int) -> str:
    """The bf16 attention kernel for a source of K keys: "resident" (the
    whole logit row in shared memory) up to :data:`MAX_K_BF16`, else
    "streamed"."""
    return "resident" if K <= MAX_K_BF16 else "streamed"


F32_CHUNK = 64  # source keys per chunk of the f32 layer kernel
F32_STAGES = 2  # chunks in flight in its ring


def f32_smem_bytes() -> int:
    """Dynamic shared memory of the f32 layer kernel, whatever the source
    length: the f32 message tile (row stride 260), then the larger of the
    attention buffers (Q rows of the head, stride 68; a ring of
    :data:`F32_STAGES` chunks of K rows, V rows and the chunk's mask; the
    key groups' (max, sum) per row) and the two 512-wide MLP tiles (stride
    516) — the layout of csrc/superglue_layer.cu."""
    msg = ROWS * (256 + 4) * 4
    stage = 2 * F32_CHUNK * (64 + 4) * 4 + F32_CHUNK * 4
    attn = ROWS * (64 + 4) * 4 + F32_STAGES * stage + KEY_GROUPS * ROWS * 2 * 4
    mlp = 2 * ROWS * (512 + 4) * 4
    return msg + max(attn, mlp)


def split_tf32(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 ``a`` as the f32 kernels split an operand for 3xTF32:
    hi = tf32(a), lo = tf32(a - hi), each rounded to 10 mantissa bits to
    nearest with ties away from zero (``cvt.rna.tf32.f32``), as f32 values.
    hi + lo is within 2^-22 of a, relative; the kernels sum lo·hi + hi·lo +
    hi·hi in f32."""
    def rna(x):
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    a = a.float()
    hi = rna(a)
    return hi, rna(a - hi)


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


def _tf32_b_index(Kd: int, N: int, device):
    """(k, n) of every element of :func:`pack_tf32_b`'s layout, each of
    shape (N/16, Kd/8, 32, 4)."""
    lane = torch.arange(32, device=device)
    e = torch.arange(4, device=device)
    g, t = lane // 4, lane % 4
    kk = t[:, None] + 4 * (e % 2)[None]  # (32, 4)
    nn = g[:, None] + 8 * (e // 2)[None]
    shape = (N // 16, Kd // 8, 32, 4)
    k = 8 * torch.arange(Kd // 8, device=device)[None, :, None, None] + kk
    n = 16 * torch.arange(N // 16, device=device)[:, None, None, None] + nn
    return k.expand(shape), n.expand(shape)


def pack_tf32_b(w: torch.Tensor) -> torch.Tensor:
    """A (Kd, N) weight (``x @ w``) → f32 in the register order of
    ``mma.sync.m16n8k8``'s tf32 B operand: (N/16, Kd/8, 32 lanes, 4). Lane
    4g + t of n16 block j, k-step s holds (k, n) = (8s + t, 16j + g), (8s +
    t + 4, 16j + g), (8s + t, 16j + 8 + g), (8s + t + 4, 16j + 8 + g): one
    16-byte load per lane and k-step feeds two n8 tiles. The values stay
    f32; the kernels split them for 3xTF32 in registers."""
    Kd, N = w.shape
    if Kd % 8 or N % 16:
        raise ValueError(f"pack_tf32_b takes Kd % 8 == 0 and N % 16 == 0, got {tuple(w.shape)}")
    k, n = _tf32_b_index(Kd, N, w.device)
    return w.float()[k, n].contiguous()


def unpack_tf32_b(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_tf32_b`: the (Kd, N) f32 weight."""
    Kd, N = 8 * p.shape[1], 16 * p.shape[0]
    k, n = _tf32_b_index(Kd, N, p.device)
    w = torch.empty((Kd, N), dtype=p.dtype, device=p.device)
    w[k, n] = p
    return w


def pack_layer(layer: dict, device) -> dict:
    """JAX-layout layer params (q/k/v/merge {w (C, C), b}, mlp [{w, b,
    bn_scale, bn_shift}] × 2) → contiguous tensors on ``device``: f32
    wqkv = [Wq | Wk | Wv] (C, 3C), the merge, the (2C, 2C) first MLP weight
    (rows [:C] act on x, [C:] on the message) and the second, with their
    biases and folded BN; and each weight twice more in the kernels'
    register orders: bf16 by :func:`pack_mma_b` for the bf16 mode
    (``*_mma``), f32 by :func:`pack_tf32_b` for the f32 mode (``*_tf32``)."""
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
        p[f"{w}_tf32"] = pack_tf32_b(p[w])
    return p


def _flip(t):
    n = t.shape[0] // 2
    return torch.cat([t[n:], t[:n]], 0)


def _attend_mlp(x, xr, q, k, v, m, layer: dict, num_heads: int, r):
    """x + MLP(concat[x, merge(attention)]) for queries q (B, M, C) over
    keys and values k, v (B, N, C) under the source mask m (B, N); ``xr``
    is x with its operands rounded by ``r``."""
    B, M, C = x.shape
    dh = C // num_heads
    q = q.reshape(B, M, num_heads, dh)
    k = k.reshape(B, -1, num_heads, dh)
    v = v.reshape(B, -1, num_heads, dh)
    logits = torch.einsum("bqhd,bshd->bhqs", r(q), r(k)) / math.sqrt(dh)
    logits = torch.where(m[:, None, None, :], logits, -1e9)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)  # jax.nn.softmax's normalization
    msg = torch.einsum("bhqs,bshd->bqhd", r(p), r(v)).reshape(B, M, C)
    msg = r(msg) @ r(layer["wm"]) + layer["bm"]
    w1 = r(layer["w1"])
    h = torch.relu((xr @ w1[:C] + r(msg) @ w1[C:] + layer["b1"]) * layer["s1"] + layer["t1"])
    return x + (r(h) @ r(layer["w2"]) + layer["b2"])


def superglue_layer_plain(x, masks, layer: dict, cross: bool, num_heads: int = 4,
                          compute_dtype=torch.float32):
    """x + MLP(concat[x, merge(attention(x → source))]); the source is the
    set itself (self layer) or the other half of the stack (cross). Under
    bf16 each matmul operand rounds to bf16 where the JAX package's
    ``_proj`` / ``_attend`` / ``_apply_mlp`` round it, and the products
    sum in f32 (bf16 values multiplied as f32: exact products, f32 sums)."""
    def r(a):
        return round_operand(a, compute_dtype)

    C = x.shape[-1]
    xr = r(x)
    q, k, v = (xr @ r(layer["wqkv"]) + layer["bqkv"]).split(C, dim=-1)
    m = masks
    if cross:
        k, v, m = _flip(k), _flip(v), _flip(masks)
    return _attend_mlp(x, xr, q, k, v, m, layer, num_heads, r)


def superglue_layer_two_set_plain(x, source, src_mask, layer: dict, num_heads: int = 4,
                                  compute_dtype=torch.float32):
    """x (B, M, C) + MLP(concat[x, merge(attention(x → source))]) with the
    source (B, N, C) under ``src_mask`` (B, N): the JAX package's
    ``_attention`` and the caller's residual MLP on unstacked sets, with
    the operands rounded as :func:`superglue_layer_plain` rounds them."""
    def r(a):
        return round_operand(a, compute_dtype)

    C = x.shape[-1]
    xr = r(x)
    w = r(layer["wqkv"])
    q = xr @ w[:, :C] + layer["bqkv"][:C]
    k, v = (r(source) @ w[:, C:] + layer["bqkv"][C:]).split(C, dim=-1)
    return _attend_mlp(x, xr, q, k, v, src_mask, layer, num_heads, r)


def layer_scratch(x, masks, compute_dtype=torch.float32):
    """What every layer of one match shares on the card: the masks as f32
    (left out where ``masks`` is None) and the kernels' QKV scratch in the
    mode's dtype. Made once per ``match_pair``: for the stacked
    (2B, K, C) x, or for each set (B, K, C) of the two-set path, whose QKV
    rows take the set's Q columns where it queries and its K and V columns
    where it is the source. None on the CPU."""
    if x.device.type == "cpu":
        return None
    n2, K, C = x.shape
    s = {"qkv": torch.empty((n2 * K, 3 * C), dtype=compute_dtype, device=x.device)}
    if masks is not None:
        s["mask"] = masks.to(torch.float32).contiguous()
    return s


def _check_layer_args(what: str, x, layer: dict, num_heads: int, compute_dtype, K: int,
                      streamed: bool):
    """The checks both K2 wrappers make: C = 256 with 4 heads, a mode the
    kernels have, source length K within the chosen kernel's shared memory
    (the resident bf16 kernel's :data:`MAX_K_BF16`; the streamed bf16
    kernel and the f32 kernel take any K), x and the mode's layer tensors
    on the card."""
    C = x.shape[-1]
    if C != 256 or num_heads != 4:
        raise ValueError(f"{what} kernel takes C = 256 with 4 heads; "
                         f"got {tuple(x.shape)}, {num_heads} heads")
    if compute_dtype not in LAYER_KEYS:
        raise ValueError(f"{what} kernel computes in float32 or bfloat16, not {compute_dtype}")
    if compute_dtype == torch.bfloat16 and not streamed and K > MAX_K_BF16:
        raise ValueError(f"{what} resident bf16 kernel: K = {K} exceeds {MAX_K_BF16} "
                         f"({cuda_build.SMEM_LIMIT} B of shared memory per CTA)")
    cuda_build.require_cuda(x, "x", torch.float32)
    for key in LAYER_KEYS[compute_dtype]:
        cuda_build.require_cuda(layer[key], key, torch.bfloat16 if key.endswith("_mma")
                                else torch.float32)


def _streamed(compute_dtype, K: int) -> bool:
    """Whether a source of K keys takes the streamed bf16 kernel."""
    return compute_dtype == torch.bfloat16 and bf16_route(K) == "streamed"


def superglue_layer(x, masks, layer: dict, cross: bool, num_heads: int = 4,
                    compute_dtype=torch.float32, scratch: dict | None = None):
    """One GNN layer for both sets. x (2B, K, C) f32, masks (2B, K) bool,
    ``layer`` from :func:`pack_layer`, ``scratch`` from
    :func:`layer_scratch` (made here when None). The kernels take C = 256
    with 4 heads; the bf16 mode's attention kernel is :func:`bf16_route`'s,
    the f32 mode takes any K."""
    if x.device.type == "cpu":
        return superglue_layer_plain(x, masks, layer, cross, num_heads, compute_dtype)
    return _launch_layer(x, masks, layer, cross, num_heads, compute_dtype, scratch,
                         _streamed(compute_dtype, x.shape[1]))


def _launch_layer(x, masks, layer, cross, num_heads, compute_dtype, scratch, streamed: bool):
    """:func:`superglue_layer` on the card with the bf16 attention kernel
    named by ``streamed`` (the card checks run both kernels at one K)."""
    global launches, f32_launches, streamed_launches
    cuda_build.refuse_grad("superglue_layer", x, *layer.values())
    n2, K, C = x.shape
    if n2 % 2:
        raise ValueError(f"superglue_layer kernel takes (2B, K, 256); got {tuple(x.shape)}")
    _check_layer_args("superglue_layer", x, layer, num_heads, compute_dtype, K, streamed)
    bf16 = compute_dtype == torch.bfloat16
    if scratch is None:
        scratch = layer_scratch(x, masks, compute_dtype)
    cuda_build.require_cuda(scratch["mask"], "masks", torch.float32, (n2, K))
    cuda_build.require_cuda(scratch["qkv"], "qkv scratch", compute_dtype, (n2 * K, 3 * C))
    keys = LAYER_KEYS[compute_dtype]
    out = torch.empty_like(x)
    if bf16:
        cuda_build.launch("superglue_layer", "superglue_layer_bf16_launch", x,
                          scratch["mask"], *(layer[k] for k in keys), scratch["qkv"], out,
                          n2, K, int(bool(cross)), int(streamed), cuda_build.stream_of(x))
        with cuda_build.count_lock:
            if streamed:
                streamed_launches += 1
            else:
                launches += 1
    else:
        cuda_build.launch("superglue_layer", "superglue_layer_launch", x, scratch["mask"],
                          *(layer[k] for k in keys), scratch["qkv"], out,
                          n2, K, int(bool(cross)), cuda_build.stream_of(x))
        with cuda_build.count_lock:
            f32_launches += 1
    return out


def superglue_layer_two_set(x, source, src_mask, layer: dict, num_heads: int = 4,
                            compute_dtype=torch.float32, scratch=None):
    """One GNN layer of one set over another: x (B, M, C) f32 attends over
    ``source`` (B, N, C) f32 under ``src_mask`` (B, N) bool; returns x +
    MLP(concat[x, merge(attention)]). ``scratch`` is the pair (x's,
    source's) from :func:`layer_scratch`, the source's with its mask (the
    same dict twice when source is x; made here when None). The kernels
    take C = 256 with 4 heads; the bf16 mode's attention kernel follows
    the source length N as :func:`superglue_layer`'s does."""
    if x.device.type == "cpu":
        return superglue_layer_two_set_plain(x, source, src_mask, layer, num_heads,
                                             compute_dtype)
    return _launch_two_set(x, source, src_mask, layer, num_heads, compute_dtype, scratch,
                           _streamed(compute_dtype, source.shape[1]))


def _launch_two_set(x, source, src_mask, layer, num_heads, compute_dtype, scratch,
                    streamed: bool):
    """:func:`superglue_layer_two_set` on the card with the bf16 attention
    kernel named by ``streamed``."""
    global two_set_launches, two_set_f32_launches, streamed_launches
    cuda_build.refuse_grad("superglue_layer_two_set", x, source, *layer.values())
    B, M, C = x.shape
    N = source.shape[1]
    _check_layer_args("superglue_layer_two_set", x, layer, num_heads, compute_dtype, N,
                      streamed)
    cuda_build.require_cuda(source, "source", torch.float32, (B, N, C))
    if scratch is None:
        ss = layer_scratch(source, src_mask, compute_dtype)
        scratch = (ss if source is x else layer_scratch(x, None, compute_dtype), ss)
    sx, ss = scratch
    cuda_build.require_cuda(ss["mask"], "src_mask", torch.float32, (B, N))
    cuda_build.require_cuda(sx["qkv"], "x qkv scratch", compute_dtype, (B * M, 3 * C))
    cuda_build.require_cuda(ss["qkv"], "source qkv scratch", compute_dtype, (B * N, 3 * C))
    keys = LAYER_KEYS[compute_dtype]
    out = torch.empty_like(x)
    if compute_dtype == torch.bfloat16:
        cuda_build.launch("superglue_layer", "superglue_layer_two_set_bf16_launch", x, source,
                          ss["mask"], *(layer[k] for k in keys), sx["qkv"], ss["qkv"], out,
                          B, M, N, int(streamed), cuda_build.stream_of(x))
        with cuda_build.count_lock:
            if streamed:
                streamed_launches += 1
            else:
                two_set_launches += 1
    else:
        cuda_build.launch("superglue_layer", "superglue_layer_two_set_launch", x, source,
                          ss["mask"], *(layer[k] for k in keys), sx["qkv"], ss["qkv"],
                          out, B, M, N, cuda_build.stream_of(x))
        with cuda_build.count_lock:
            two_set_f32_launches += 1
    return out
