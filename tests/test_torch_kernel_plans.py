"""The pure-Python parts of the port's K1, K2 and K3 kernels, on the CPU.

K3 (csrc/sinkhorn.cu) splits Z0 into row bands over a thread-block
cluster: ``cluster_plan`` sizes it, and each column sweep merges per-band
(max, sum) partials. K1 (csrc/conv_stem.cu) takes its weights packed once
by ``pack_weights``. K2's bf16 mode (csrc/superglue_layer.cu) holds a
whole logit row per query in shared memory, which bounds its K. The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py); these
tests hold the plan, the merge rule and the packing against the plain
versions, which tests/test_torch_kernels.py holds against the JAX package.
"""

import math

import numpy as np
import pytest
import torch

from rspl_slam_tpu_torch.ops import (attention_cuda, conv_stem_cuda, cuda_build, sinkhorn,
                                     sinkhorn_cuda)


@pytest.mark.parametrize("K", [300, 400, 500, 600])
def test_cluster_plan_is_portable_for_shipped_sizes(K):
    """Every shipped keypoint budget (K ≤ 600, OIVIO's the largest) takes a
    portable cluster of 8 whose bands cover Z0 within one CTA's shared
    memory."""
    M1 = N1 = K + 1
    plan = sinkhorn_cuda.cluster_plan(M1, N1)
    assert plan.cluster <= sinkhorn_cuda.PORTABLE_CLUSTER
    assert plan.smem <= cuda_build.SMEM_LIMIT
    assert plan.rows == math.ceil(M1 / plan.cluster)


def test_superglue_bf16_layer_takes_every_shipped_size():
    """K2's bf16 kernel keeps the whole logit row of 32 queries, K and V of
    one head and the MLP tiles in one CTA's shared memory: every shipped
    keypoint budget (K ≤ 600) fits, the largest K that fits is a multiple
    of 16, and the next one does not."""
    k = attention_cuda.MAX_K_BF16
    assert 600 <= k and k % 16 == 0
    assert attention_cuda.bf16_smem_bytes(600) <= cuda_build.SMEM_LIMIT
    assert attention_cuda.bf16_smem_bytes(k + 1) > cuda_build.SMEM_LIMIT


def test_cluster_plan_grows_then_refuses():
    """Past the portable size the plan takes a cluster of 16; past that it
    raises ValueError naming the limit."""
    assert sinkhorn_cuda.cluster_plan(701, 701).cluster == sinkhorn_cuda.MAX_CLUSTER
    with pytest.raises(ValueError, match="does not fit a cluster of 16"):
        sinkhorn_cuda.cluster_plan(1401, 1401)


def _banded_sinkhorn(Z0, log_mu, log_nu, iters, C):
    """The cluster kernel's algorithm in torch: rows in bands of ⌈M1/C⌉
    (the last bands may be short or empty), u from a local row sweep, v by
    merging per-band (max, sum) partials with the kernel's rule. An empty
    band's partial is (−inf, 0)."""
    B, M1, N1 = Z0.shape
    rows = -(-M1 // C)
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z0 + v[:, None, :], dim=2)
        a = Z0 + u[:, :, None]
        parts = []
        for r in range(C):
            band = a[:, r * rows:(r + 1) * rows]
            if band.shape[1] == 0:
                m = torch.full((B, N1), -math.inf)
                s = torch.zeros((B, N1))
            else:
                m = band.max(dim=1).values
                s = torch.exp(band - m[:, None, :]).sum(dim=1)
            parts.append((m, s))
        m_all = torch.stack([m for m, _ in parts]).max(dim=0).values
        s_all = sum(s * torch.exp(m - m_all) for m, s in parts)
        v = log_nu - (m_all + torch.log(s_all))
    return Z0 + u[:, :, None] + v[:, None, :]


@pytest.mark.parametrize("C", [1, 3, 8, 16])
@pytest.mark.parametrize("M,valid0", [(40, 10), (5, 5), (24, 21)],
                         ids=["masked-bands", "rows-below-cluster", "ragged-bands"])
def test_banded_column_merge_equals_plain_sweeps(C, M, valid0):
    """Per-band partials merged by the kernel's rule give the plain sweeps
    to 1e-5 on valid rows, columns and dustbins — with bands of only
    masked rows (valid0 = 10 of 40: at C = 8 the bands of rows 12-35 hold
    −1e9 only), with M1 < C (empty bands) and with C ∤ M1."""
    rng = np.random.default_rng(C * 100 + M)
    N, valid1 = 33, 29
    S = torch.from_numpy((3 * rng.standard_normal((2, M, N))).astype(np.float32))
    m0 = torch.arange(M)[None] < torch.tensor([[valid0], [M]])
    m1 = torch.arange(N)[None] < torch.tensor([[valid1], [N - 1]])
    Z0, mu, nu, _ = sinkhorn.build_problem(S, m0, m1, 0.7)
    got = _banded_sinkhorn(Z0, mu, nu, 50, C)
    ref = sinkhorn.sinkhorn_iterations_plain(Z0, mu, nu, 50)
    one = torch.ones((2, 1), dtype=torch.bool)
    sel = torch.cat([m0, one], 1)[:, :, None] & torch.cat([m1, one], 1)[:, None, :]
    assert torch.isfinite(got).all()
    assert (got - ref).abs()[sel].max() < 1e-5


def _unpack_weights(wp):
    """Inverse of ``pack_weights``: (8, 72, 8, 8) core-matrix order → HWIO."""
    return wp.permute(0, 2, 1, 3).reshape(64, 576).t().float().reshape(3, 3, 64, 64)


def test_pack_weights_round_trips_to_bf16_hwio():
    """K1's packed operand unpacks to the bf16-rounded HWIO weights exactly,
    and its GEMM matrix is the TPU stem's (C_out, (a·3 + b)·64 + c_in) one
    (``conv_stem_pallas.conv3x3_nhcw``'s ``wf``), in core-matrix order."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 3, 64, 64))
                         .astype(np.float32))
    wp = conv_stem_cuda.pack_weights(w)
    assert wp.dtype == torch.bfloat16 and tuple(wp.shape) == conv_stem_cuda.PACKED
    assert torch.equal(_unpack_weights(wp), w.to(torch.bfloat16).float())
    wf = np.transpose(w.numpy(), (3, 0, 1, 2)).reshape(64, 576)  # the TPU's im2col order
    n, k = np.meshgrid(np.arange(64), np.arange(576), indexing="ij")
    packed = wp.float().numpy()[n // 8, k // 8, n % 8, k % 8]
    np.testing.assert_array_equal(packed, torch.from_numpy(wf).to(torch.bfloat16).float().numpy())


def test_plain_stem_is_unchanged_by_the_packing():
    """The CPU path keeps HWIO weights: the plain conv through the unpacked
    weights equals the plain conv through the originals (both round the
    weights to bf16 for a bf16 input)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((1, 6, 10, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((0.06 * rng.standard_normal((3, 3, 64, 64))).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(64)).astype(np.float32))
    ref = conv_stem_cuda.conv3x3_relu_pool(x, w, b)
    got = conv_stem_cuda.conv3x3_relu_pool_plain(
        x, _unpack_weights(conv_stem_cuda.pack_weights(w)), b)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("K,route", [(300, "resident"), (600, "resident"), (752, "resident"),
                                     (753, "streamed"), (1024, "streamed"), (2048, "streamed")])
def test_superglue_bf16_route_follows_the_resident_ceiling(K, route):
    """K2's bf16 mode keeps the resident kernel (the whole logit row in
    shared memory) up to MAX_K_BF16 = 752 and streams K and V past it; the
    streamed kernel's shared memory is one size for every K, and fits."""
    assert attention_cuda.bf16_route(K) == route
    assert attention_cuda.bf16_streamed_smem_bytes() <= cuda_build.SMEM_LIMIT
    if route == "resident":
        assert attention_cuda.bf16_smem_bytes(K) <= cuda_build.SMEM_LIMIT


def test_superglue_f32_attention_ceiling():
    """The f32 mode's attention kernel holds 16 logit rows of K in shared
    memory: MAX_K_F32 is the largest K that fits (3308), above 2048."""
    k = attention_cuda.MAX_K_F32
    assert k >= 2048
    assert attention_cuda.f32_attn_smem_bytes(k) <= cuda_build.SMEM_LIMIT
    assert attention_cuda.f32_attn_smem_bytes(k + 1) > cuda_build.SMEM_LIMIT


@pytest.mark.parametrize("M1,N1,route", [(401, 401, "cluster"), (601, 601, "cluster"),
                                         (901, 901, "cluster"), (921, 921, "global"),
                                         (1025, 1025, "global"), (2049, 2049, "global"),
                                         (1025, 801, "cluster"), (1025, 1201, "global")])
def test_sinkhorn_route_takes_the_cluster_where_one_holds_z0(M1, N1, route):
    """K3 keeps the cluster kernel wherever a cluster of 8 or 16 holds Z0
    and takes the global-memory kernel past it (M1 = N1 = 921 is the first
    square plan past 16 CTAs)."""
    assert sinkhorn_cuda.sinkhorn_route(M1, N1) == route


def _chunked_sinkhorn(Z0, log_mu, log_nu, iters, col_rows):
    """The global-memory kernel's algorithm in torch: u by full row sweeps,
    v by merging the (max, sum) partials of chunks of ``col_rows`` rows
    (the last chunk short) with the kernel's rule."""
    B, M1, N1 = Z0.shape
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z0 + v[:, None, :], dim=2)
        a = Z0 + u[:, :, None]
        parts = [a[:, i:i + col_rows] for i in range(0, M1, col_rows)]
        ms = [p.max(dim=1).values for p in parts]
        ss = [torch.exp(p - m[:, None, :]).sum(dim=1) for p, m in zip(parts, ms)]
        m_all = torch.stack(ms).max(dim=0).values
        s_all = sum(s * torch.exp(m - m_all) for m, s in zip(ms, ss))
        v = log_nu - (m_all + torch.log(s_all))
    return Z0 + u[:, :, None] + v[:, None, :]


@pytest.mark.parametrize("M,col_rows", [(150, 64), (64, 64), (40, 7)],
                         ids=["ragged-chunks", "one-chunk", "many-chunks"])
def test_chunked_column_merge_equals_plain_sweeps(M, col_rows):
    """Per-chunk partials merged by the global-memory kernel's rule give the
    plain sweeps to 1e-5 on valid rows, columns and dustbins, with masked
    rows, a short last chunk, one chunk and many."""
    rng = np.random.default_rng(M)
    N = 45
    S = torch.from_numpy((3 * rng.standard_normal((2, M, N))).astype(np.float32))
    m0 = torch.arange(M)[None] < torch.tensor([[M - M // 5], [M]])
    m1 = torch.arange(N)[None] < torch.tensor([[N], [N - 4]])
    Z0, mu, nu, _ = sinkhorn.build_problem(S, m0, m1, 0.7)
    got = _chunked_sinkhorn(Z0, mu, nu, 50, col_rows)
    ref = sinkhorn.sinkhorn_iterations_plain(Z0, mu, nu, 50)
    one = torch.ones((2, 1), dtype=torch.bool)
    sel = torch.cat([m0, one], 1)[:, :, None] & torch.cat([m1, one], 1)[:, None, :]
    assert torch.isfinite(got).all()
    assert (got - ref).abs()[sel].max() < 1e-5


def _streamed_probabilities(logits, chunk):
    """The streamed K2 kernel's softmax in torch: pass 1 folds each chunk
    of keys into a running (max, sum of exp) per row, pass 2 writes each
    chunk's exp(l - max) / sum rounded to bf16."""
    m = torch.full(logits.shape[:-1], -math.inf)
    s = torch.zeros(logits.shape[:-1])
    for c0 in range(0, logits.shape[-1], chunk):
        lc = logits[..., c0:c0 + chunk]
        m_new = torch.maximum(m, lc.max(-1).values)
        s = s * torch.exp(m - m_new) + torch.exp(lc - m_new[..., None]).sum(-1)
        m = m_new
    return torch.cat([(torch.exp(logits[..., c0:c0 + chunk] - m[..., None]) / s[..., None])
                      .to(torch.bfloat16) for c0 in range(0, logits.shape[-1], chunk)], -1)


@pytest.mark.parametrize("K", [752, 1024, 1100])
def test_streamed_softmax_rounds_what_the_resident_one_rounds(K):
    """The online softmax of the streamed kernel gives the normalized
    probabilities of the resident kernel's two-pass softmax before the
    bf16 rounding, so after it they agree to one bf16 step (the running
    sum rounds in another order), with masked keys at -1e9 and padding
    keys at -inf; rows sum to 1 within bf16 rounding."""
    rng = np.random.default_rng(K)
    logits = torch.from_numpy((4 * rng.standard_normal((2, 4, 32, K))).astype(np.float32))
    logits[..., K - K // 7:] = -1e9
    pad = -(-K // 16) * 16
    logits = torch.cat([logits, torch.full(logits.shape[:-1] + (pad - K,), -math.inf)], -1)
    got = _streamed_probabilities(logits, attention_cuda.CHUNK).float()
    ref = torch.softmax(logits, -1).to(torch.bfloat16).float()
    assert (got - ref).abs().max() <= 2.0 ** -8 * ref.abs().max()
    assert (got[..., K:] == 0).all()
    assert (got.sum(-1) - 1).abs().max() < 0.02
