"""SuperGlue graph matcher (port of models/superglue.py).

Keypoint encoder MLP → 18 alternating self/cross GNN layers → final 1×1
projection → similarity / √C → masked log-Sinkhorn → mutual-max decode.
Every GNN layer goes through K2 (ops/attention_cuda.py) and the Sinkhorn
iterations through K3 (ops/sinkhorn_cuda.py); the encoder, the final
projection, the similarity product and building Z0 stay plain torch, as
they stay XLA in the JAX package. Sets of equal size M == N run stacked
as one (2B, K, C) batch, one K2 launch per layer; sets of unequal size
run unstacked as in the JAX package, two launches per layer of K2's
two-set variant (each set over its source), and K3 on the (M+1, N+1)
plan.

``compute_dtype`` is the JAX package's contract: under bf16 (its default)
every matmul operand rounds to bf16 where ``match_pair`` there rounds it
(encoder, q/k/v/merge, logits, probabilities and values, the MLP, the
final projection, the similarity) and every product sums in f32; biases,
BN, softmax, residuals and Sinkhorn stay f32. float32 rounds nowhere.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from rspl_slam_tpu_torch.config import SuperGlueConfig
from rspl_slam_tpu_torch.ops import attention_cuda, sinkhorn_cuda
from rspl_slam_tpu_torch.ops.attention_cuda import round_operand
from rspl_slam_tpu_torch.ops.matching import mutual_match_decode, normalize_keypoints

__all__ = ["init_params", "load_torch_weights", "SuperGlue", "MatchResult",
           "match_pair"]


def init_params(cfg: SuperGlueConfig, seed: int = 0) -> dict:
    """Random parameters in the JAX pytree layout (numpy), public shapes."""
    rng = np.random.default_rng(seed)
    d = cfg.descriptor_dim

    def dense(cin, cout, bn=False):
        p = {"w": (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32),
             "b": np.zeros((cout,), np.float32)}
        if bn:
            p["bn_scale"] = np.ones((cout,), np.float32)
            p["bn_shift"] = np.zeros((cout,), np.float32)
        return p

    chans = [3, *cfg.keypoint_encoder, d]
    return {
        "kenc": [dense(a, b, True) for a, b in zip(chans[:-1], chans[1:])],
        "gnn": [{**{n: dense(d, d) for n in ("q", "k", "v", "merge")},
                 "mlp": [dense(2 * d, 2 * d, True), dense(2 * d, d, True)]}
                for _ in range(cfg.num_gnn_layers)],
        "final_proj": dense(d, d),
        "bin_score": np.asarray(1.0, np.float32),
    }


def descriptor_matcher_params(cfg: SuperGlueConfig, seed: int = 0,
                              sharpness: float = 20.0,
                              bin_score: float = 12.0) -> dict:
    """Deterministic weights that make SuperGlue act as a descriptor matcher
    while every layer still does its full arithmetic: random q/k/v/merge
    and first MLP layers, each layer's last MLP layer zero (its update is
    0, so the descriptors pass through the GNN unchanged), the last
    keypoint-encoder layer zero, ``final_proj`` = √(sharpness·√C)·I so the
    similarity is ``sharpness``·cos, and a fixed dustbin score.

    Untrained SuperPoint descriptors are discriminative on their own, so a
    pipeline driven by these weights tracks for real — what an end-to-end
    check with random weights needs."""
    p = init_params(cfg, seed)
    d = cfg.descriptor_dim
    p["kenc"][-1]["w"][:] = 0.0
    for layer in p["gnn"]:
        layer["mlp"][1]["w"][:] = 0.0
    scale = np.sqrt(sharpness * np.sqrt(d))
    p["final_proj"]["w"] = (scale * np.eye(d)).astype(np.float32)
    p["bin_score"] = np.asarray(bin_score, np.float32)
    return p



def load_torch_weights(path: str, cfg: SuperGlueConfig | None = None) -> dict:
    """The public ``superglue_{indoor,outdoor}.pth`` → the JAX pytree layout
    as numpy. Conv1d(k=1) weights (cout, cin, 1) become (cin, cout);
    BatchNorm running statistics fold into scale and shift,
    y = γ·(x−μ)/√(σ²+ε) + β. The public model splits channels head_dim-major
    (``view(B, head_dim, heads, N)``), the pytree heads-major: q/k/v output
    channels and merge input channels are permuted at load time, as the
    JAX loader does."""
    from rspl_slam_tpu_torch.models.superpoint import _state_dict

    cfg = cfg or SuperGlueConfig()
    sd = _state_dict(path)

    def lin(prefix):
        w = sd[f"{prefix}.weight"]
        return {"w": np.ascontiguousarray(w.reshape(w.shape[0], w.shape[1]).T),
                "b": sd[f"{prefix}.bias"]}

    d = cfg.descriptor_dim
    head_perm = np.arange(d).reshape(d // cfg.num_heads, cfg.num_heads).T.ravel()

    def lin_qkv(prefix):
        p = lin(prefix)
        return {"w": p["w"][:, head_perm], "b": p["b"][head_perm]}

    def lin_merge(prefix):
        p = lin(prefix)
        return {"w": p["w"][head_perm, :], "b": p["b"]}

    def with_bn(p, prefix=None, eps=1e-5):
        if prefix is None:
            p["bn_scale"], p["bn_shift"] = np.ones_like(p["b"]), np.zeros_like(p["b"])
        else:
            scale = sd[f"{prefix}.weight"] / np.sqrt(sd[f"{prefix}.running_var"] + eps)
            p["bn_scale"] = scale
            p["bn_shift"] = sd[f"{prefix}.bias"] - sd[f"{prefix}.running_mean"] * scale
        return p

    # kenc.encoder: Sequential[Conv1d, BN, ReLU, ..., Conv1d]
    kenc, seq = [], 0
    n_mlp = len(cfg.keypoint_encoder) + 1
    for i in range(n_mlp):
        layer = lin(f"kenc.encoder.{seq}")
        if i < n_mlp - 1:
            kenc.append(with_bn(layer, f"kenc.encoder.{seq + 1}"))
            seq += 3  # Conv1d + BN + ReLU
        else:
            kenc.append(with_bn(layer))
    gnn = []
    for li in range(cfg.num_gnn_layers):
        base = f"gnn.layers.{li}"
        gnn.append({"q": lin_qkv(f"{base}.attn.proj.0"), "k": lin_qkv(f"{base}.attn.proj.1"),
                    "v": lin_qkv(f"{base}.attn.proj.2"),
                    "merge": lin_merge(f"{base}.attn.merge"),
                    "mlp": [with_bn(lin(f"{base}.mlp.0"), f"{base}.mlp.1"),
                            with_bn(lin(f"{base}.mlp.3"))]})
    return {"kenc": kenc, "gnn": gnn, "final_proj": lin("final_proj"),
            "bin_score": np.asarray(float(sd["bin_score"]), np.float32)}

class SuperGlue(nn.Module):
    """Weights on one device: the keypoint encoder, the GNN layers packed
    for K2, the final projection and the dustbin score."""

    def __init__(self, params: dict, cfg: SuperGlueConfig, device):
        super().__init__()
        self.cfg = cfg

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)

        self.kenc = [{k: t(v) for k, v in lin.items()} for lin in params["kenc"]]
        self.gnn = [attention_cuda.pack_layer(layer, device) for layer in params["gnn"]]
        self.final_w = t(params["final_proj"]["w"])
        self.final_b = t(params["final_proj"]["b"])
        self.bin_score = t(params["bin_score"])


def _apply_mlp(mlp, x, compute_dtype=torch.float32):
    """Linear → folded BN → ReLU chain; the last layer is linear."""
    for i, layer in enumerate(mlp):
        x = round_operand(x, compute_dtype) @ round_operand(layer["w"], compute_dtype) + layer["b"]
        if i < len(mlp) - 1:
            x = torch.relu(x * layer["bn_scale"] + layer["bn_shift"])
    return x


def _final_proj(sg: SuperGlue, x, compute_dtype):
    """The final 1×1 projection, rounded to ``compute_dtype`` as the
    similarity's operand."""
    r = round_operand
    return r(r(x, compute_dtype) @ r(sg.final_w, compute_dtype) + sg.final_b, compute_dtype)


class MatchResult:
    def __init__(self, indices0, indices1, mscores0, log_plan):
        self.indices0 = indices0  # (B, M) int32, −1 = unmatched
        self.indices1 = indices1  # (B, N)
        self.mscores0 = mscores0  # (B, M)
        self.log_plan = log_plan  # (B, M+1, N+1)


@torch.no_grad()
def match_pair(sg: SuperGlue, xy0, score0, desc0, mask0, xy1, score1, desc1,
               mask1, cfg: SuperGlueConfig | None = None,
               sinkhorn_iters: int | None = None,
               compute_dtype=torch.float32) -> MatchResult:
    """SuperGlue matching of batched padded keypoint sets (B, M) and
    (B, N), at ``compute_dtype`` (bfloat16 or float32; see the module
    notes)."""
    cfg = cfg or sg.cfg
    B, M, _ = desc0.shape
    N = desc1.shape[1]
    enc0 = torch.cat([normalize_keypoints(xy0, cfg.image_width, cfg.image_height),
                      score0[..., None]], -1)
    enc1 = torch.cat([normalize_keypoints(xy1, cfg.image_width, cfg.image_height),
                      score1[..., None]], -1)
    dt = compute_dtype
    if M == N:
        x = (torch.cat([desc0, desc1], 0).float()
             + _apply_mlp(sg.kenc, torch.cat([enc0, enc1], 0).float(), dt)).contiguous()
        masks = torch.cat([mask0, mask1], 0)
        scratch = attention_cuda.layer_scratch(x, masks, dt)  # shared by every layer
        for li, layer in enumerate(sg.gnn):
            x = attention_cuda.superglue_layer(x, masks, layer, cross=li % 2 == 1,
                                               num_heads=cfg.num_heads, compute_dtype=dt,
                                               scratch=scratch)
        md = _final_proj(sg, x, dt)
        md0, md1 = md[:B], md[B:]
    else:
        x0 = (desc0.float() + _apply_mlp(sg.kenc, enc0.float(), dt)).contiguous()
        x1 = (desc1.float() + _apply_mlp(sg.kenc, enc1.float(), dt)).contiguous()
        # each set's scratch serves every layer: its Q columns where it
        # queries, its K and V columns where it is the other's source
        s0 = attention_cuda.layer_scratch(x0, mask0, dt)
        s1 = attention_cuda.layer_scratch(x1, mask1, dt)
        for li, layer in enumerate(sg.gnn):
            cross = li % 2 == 1  # layers alternate self, cross, self, ...
            src0, m0, ss0 = (x1, mask1, s1) if cross else (x0, mask0, s0)
            src1, m1, ss1 = (x0, mask0, s0) if cross else (x1, mask1, s1)
            kw = dict(num_heads=cfg.num_heads, compute_dtype=dt)
            x0, x1 = (
                attention_cuda.superglue_layer_two_set(x0, src0, m0, layer,
                                                       scratch=(s0, ss0), **kw),
                attention_cuda.superglue_layer_two_set(x1, src1, m1, layer,
                                                       scratch=(s1, ss1), **kw))
        md0, md1 = _final_proj(sg, x0, dt), _final_proj(sg, x1, dt)
    sim = torch.einsum("bmc,bnc->bmn", md0, md1) / math.sqrt(cfg.descriptor_dim)
    iters = cfg.sinkhorn_iterations if sinkhorn_iters is None else sinkhorn_iters
    Z = sinkhorn_cuda.log_optimal_transport_masked(sim, mask0, mask1, sg.bin_score, iters)
    idx0, idx1, ms0 = mutual_match_decode(Z, mask0, mask1, cfg.match_threshold)
    return MatchResult(idx0, idx1, ms0, Z)
