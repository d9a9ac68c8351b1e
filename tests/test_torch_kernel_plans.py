"""The pure-Python parts of the port's K1, K2 and K3 kernels, on the CPU.

K3 (csrc/sinkhorn.cu) splits Z0 into row bands over a thread-block
cluster: ``cluster_plan`` sizes it, and each column sweep merges per-band
(max, sum) partials; past a cluster of 16, ``grid_plan`` spreads the bands
over persistent clusters of 8 whose partials merge per cluster, then over
the clusters. K1 (csrc/conv_stem.cu) takes its weights packed once by
``pack_weights``. K2's bf16 mode (csrc/superglue_layer.cu) holds a whole
logit row per query in shared memory, which bounds its K; past it the
streamed kernel's softmax folds key groups of chunks. K2's f32 mode always
streams, and multiplies on the tensor cores as 3xTF32 (``split_tf32``).
The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py); these tests
hold the plans, the merge orders and the packing against the plain
versions, which tests/test_torch_kernels.py holds against the JAX package,
and the global K3 order against JAX's Sinkhorn too.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspl_slam_tpu.ops.sinkhorn import log_optimal_transport_masked as jax_ot
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


def test_superglue_f32_layer_plan_takes_any_k():
    """K2's f32 layer kernel streams K and V through a ring of F32_CHUNK-key
    chunks, so its shared memory (the mirror of csrc/superglue_layer.cu:
    the f32 message tile, then the larger of Q, the ring of K, V and mask
    chunks and the key groups' (max, sum), and the two 512-wide MLP tiles)
    is one size whatever K: 165,376 B, within a CTA's limit (one CTA per
    SM); the 8 warps' P V partials (16 × 64 f32 each, row stride 72) fit
    the drained ring, and each warp takes one n16 block of every chunk."""
    ac = attention_cuda
    assert ac.F32_CHUNK // ac.KEY_GROUPS == 16 and ac.KEY_GROUPS * ac.ROWS // 16 == 8
    smem = ac.f32_smem_bytes()
    assert smem == 165_376
    assert smem <= cuda_build.SMEM_LIMIT and 2 * (smem + 1024) > 233_472
    stage = 2 * ac.F32_CHUNK * (64 + 4) * 4 + ac.F32_CHUNK * 4
    assert 2 * ac.KEY_GROUPS * 16 * (64 + 8) * 4 <= ac.F32_STAGES * stage


def test_split_tf32_halves_hold_the_value():
    """The kernels' 3xTF32 split (cvt.rna twice): hi and lo are TF32 values
    (the low 13 bits clear), hi is a rounded to nearest with ties away from
    zero, and hi + lo lies within 2^-21 of a, relative, over 10 decades."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy((rng.standard_normal(200_000)
                          * 10.0 ** rng.uniform(-5, 5, 200_000)).astype(np.float32))
    hi, lo = attention_cuda.split_tf32(a)
    for h in (hi, lo):
        assert h.dtype == torch.float32 and not (h.view(torch.int32) & 0x1FFF).any()
    rel = (hi.double() + lo.double() - a.double()).abs() / a.double().abs()
    assert rel.max() <= 2.0 ** -21
    assert ((hi.double() - a.double()).abs() <= 2.0 ** -11 * a.double().abs()).all()
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11])
    assert attention_cuda.split_tf32(tie)[0].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                                          1 + 2 ** -9]


# the f32 layer's GEMM shapes: QKV over 800 rows, and W1 over a 32-row tile
@pytest.mark.parametrize("M,Kd,N", [(800, 256, 768), (32, 512, 512)])
def test_3xtf32_products_hold_f32_accuracy(M, Kd, N):
    """lo·hi + hi·lo + hi·hi of the split operands, summed in f32, lies
    within 1e-5 of the f64 product (relative to its largest entry), as a
    plain f32 product does; one TF32 product (hi·hi) does not: 3xTF32 is
    what keeps the f32 mode at f32 accuracy on the tensor cores."""
    rng = np.random.default_rng(M + N)
    a = torch.from_numpy(rng.standard_normal((M, Kd)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((Kd, N)) / np.sqrt(Kd)).astype(np.float32))
    ref = a.double() @ b.double()
    ah, al = attention_cuda.split_tf32(a)
    bh, bl = attention_cuda.split_tf32(b)
    scale = float(ref.abs().max())

    def err(c):
        return float((c.double() - ref).abs().max()) / scale

    assert err((al @ bh + ah @ bl) + ah @ bh) <= 1e-5
    assert err(a @ b) <= 1e-5
    assert err(ah @ bh) > 1e-5


def _streamed_f32_probabilities(logits, chunk, groups):
    """The f32 layer kernel's softmax in torch: key group q of every chunk
    (keys [q w, (q + 1) w) of it, w = chunk / groups) folds each chunk into
    a running (max, sum of exp) per row; the groups merge once, in order,
    by lse_merge's rule; then every key's exp(l - max) times the sum's f32
    reciprocal, in f32 (no rounding)."""
    w = chunk // groups
    states = []
    for q in range(groups):
        st = (torch.full(logits.shape[:-1], -math.inf), torch.zeros(logits.shape[:-1]))
        for c0 in range(0, logits.shape[-1], chunk):
            lc = logits[..., c0 + q * w:c0 + (q + 1) * w]
            m = torch.maximum(st[0], lc.max(-1).values)
            base = torch.where(m == -math.inf, torch.zeros_like(m), m)
            st = (m, st[1] * torch.exp(st[0] - base) + torch.exp(lc - base[..., None]).sum(-1))
        states.append(st)
    m = torch.stack([s[0] for s in states]).max(0).values
    s = sum(torch.where(sm == -math.inf, torch.zeros_like(ss), ss * torch.exp(sm - m))
            for sm, ss in states)
    return torch.exp(logits - m[..., None]) * (1.0 / s)[..., None]


@pytest.mark.parametrize("K", [400, 1024, 3309, 4096])
def test_streamed_f32_softmax_matches_the_division(K):
    """The f32 kernel's softmax (running (max, sum) per key group over
    chunks of F32_CHUNK keys, the four groups merged once, then a product
    by the sum's reciprocal) against the plain softmax's division, at the
    main path's K, past the old 3308-key ceiling and at 4096, with masked
    keys at -1e9 and the chunk's padding keys at -inf: each probability
    within 2e-6 of the plain one, relative (16 f32 steps: the sum of up to
    4096 terms rounds in another order, the reciprocal once more; 7.5e-7
    measured), padding exactly 0, rows summing to 1."""
    rng = np.random.default_rng(K)
    logits = torch.from_numpy((4 * rng.standard_normal((2, 4, 32, K))).astype(np.float32))
    logits[..., K - K // 7:] = -1e9
    pad = -(-K // attention_cuda.F32_CHUNK) * attention_cuda.F32_CHUNK
    logits = torch.cat([logits, torch.full(logits.shape[:-1] + (pad - K,), -math.inf)], -1)
    got = _streamed_f32_probabilities(logits, attention_cuda.F32_CHUNK,
                                      attention_cuda.KEY_GROUPS)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    ref = e / e.sum(-1, keepdim=True)  # superglue_layer_plain's softmax
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= 2e-6 * ref).all()
    assert (got[..., K:] == 0).all()
    assert (got.sum(-1) - 1).abs().max() < 1e-5


@pytest.mark.parametrize("M1,N1,route", [(401, 401, "cluster"), (601, 601, "cluster"),
                                         (901, 901, "cluster"), (921, 921, "global"),
                                         (1025, 1025, "global"), (2049, 2049, "global"),
                                         (1025, 801, "cluster"), (1025, 1201, "global")])
def test_sinkhorn_route_takes_the_cluster_where_one_holds_z0(M1, N1, route):
    """K3 keeps the cluster kernel wherever a cluster of 8 or 16 holds Z0
    and takes the global-memory kernel past it (M1 = N1 = 921 is the first
    square plan past 16 CTAs)."""
    assert sinkhorn_cuda.sinkhorn_route(M1, N1) == route


# the shapes the global-memory kernel takes on the card, and cluster counts
# an H100 may report (one CTA per SM in clusters of 8: 14-16 of 132 SMs)
GLOBAL_SHAPES = [(1, 921, 921), (1, 1025, 1025), (1, 2049, 2049), (4, 1025, 1025),
                 (1, 4097, 4097), (1, 1025, 1201), (2, 2049, 2049)]


@pytest.mark.parametrize("clusters", [14, 15, 16])
@pytest.mark.parametrize("B,M1,N1", GLOBAL_SHAPES)
def test_grid_plan_covers_every_row_once(B, M1, N1, clusters):
    """``grid_plan``: the groups take every batch element once, the bands of
    a group (clusters_per_group × 8 CTAs of ``rows``) cover every row of its
    element exactly once, shared memory stays within a CTA's limit, and the
    rows left in device memory are the overflow: the resident rows are as
    many as fit (one more would not), all of them where they fit."""
    plan = sinkhorn_cuda.grid_plan(B, M1, N1, clusters)
    C = sinkhorn_cuda.GLOBAL_CLUSTER
    assert plan.groups * plan.clusters_per_group <= clusters
    assert plan.clusters_per_group <= sinkhorn_cuda.MAX_GROUP_CLUSTERS
    assert sorted(b for g in range(plan.groups) for b in range(g, B, plan.groups)) == list(range(B))
    bands = plan.clusters_per_group * C
    hits = np.zeros(M1, int)
    for t in range(bands):
        hits[t * plan.rows:min(M1, (t + 1) * plan.rows)] += 1
    assert (hits == 1).all()
    assert (plan.rows - 1) * bands < M1 <= plan.rows * bands  # the fewest rows that cover
    assert plan.smem <= cuda_build.SMEM_LIMIT
    assert 0 <= plan.resident <= plan.rows
    if plan.resident < plan.rows:
        assert plan.smem + 4 * (-(-N1 // 4) * 4) > cuda_build.SMEM_LIMIT


def test_grid_plan_overflows_only_past_shared_memory():
    """One element at 1025² and 2049² stays wholly in shared memory; B = 2 at
    2049² and 4097² keep part of each band in device memory; a row too wide
    for v and the partials alone is refused."""
    resident = {shape: sinkhorn_cuda.grid_plan(*shape, 16) for shape in GLOBAL_SHAPES}
    for shape in [(1, 1025, 1025), (1, 2049, 2049), (4, 1025, 1025)]:
        assert resident[shape].resident == resident[shape].rows
    for shape in [(2, 2049, 2049), (1, 4097, 4097)]:
        assert resident[shape].resident < resident[shape].rows
    with pytest.raises(ValueError, match="leaves no shared memory"):
        sinkhorn_cuda.grid_plan(1, 1025, 20_000, 16)


def _max_sum(x, dim):
    """(max, sum of exp(x - max)) over ``dim``; (-inf, 0) where empty."""
    if x.shape[dim] == 0:
        shape = list(x.shape)
        del shape[dim]
        return torch.full(shape, -math.inf), torch.zeros(shape)
    m = x.max(dim=dim).values
    return m, torch.exp(x - m.unsqueeze(dim)).sum(dim=dim)


def _grid_sinkhorn(Z0, log_mu, log_nu, iters, plan):
    """The global-memory kernel's algorithm in torch: per batch element,
    u from each row's max, then the sum of exp; v from the (max, sum)
    partials of bands of ``plan.rows`` rows (empty bands give (-inf, 0)),
    merged per cluster of 8 by the max then the sum, then over the group's
    clusters the same way."""
    B, M1, N1 = Z0.shape
    C = sinkhorn_cuda.GLOBAL_CLUSTER
    cpg, rows = plan.clusters_per_group, plan.rows
    out = torch.empty_like(Z0)
    for b in range(B):
        z = Z0[b]
        u = torch.zeros(M1)
        v = torch.zeros(N1)
        for _ in range(iters):
            m, s = _max_sum(z + v[None, :], 1)
            u = log_mu[b] - (m + torch.log(s))
            a = z + u[:, None]
            bands = [_max_sum(a[t * rows:(t + 1) * rows], 0) for t in range(cpg * C)]
            clusters = []
            for k in range(cpg):
                ms = torch.stack([bands[k * C + q][0] for q in range(C)])
                ss = torch.stack([bands[k * C + q][1] for q in range(C)])
                m = ms.max(0).values
                base = torch.where(m == -math.inf, torch.zeros_like(m), m)
                clusters.append((m, (ss * torch.exp(ms - base)).sum(0)))
            ms = torch.stack([c[0] for c in clusters])
            ss = torch.stack([c[1] for c in clusters])
            m = ms.max(0).values
            v = log_nu[b] - (m + torch.log((ss * torch.exp(ms - m)).sum(0)))
        out[b] = z + u[:, None] + v[None, :]
    return out


def _sinkhorn_inputs(seed, B, M, N):
    """Scores ×3 with a masked tail of rows in element 0 and of columns in
    the last element."""
    rng = np.random.default_rng(seed)
    S = (3 * rng.standard_normal((B, M, N))).astype(np.float32)
    m0 = np.ones((B, M), bool)
    m1 = np.ones((B, N), bool)
    m0[0, M - M // 5:] = False
    m1[-1, N - 4:] = False
    return S, m0, m1


# (B, M, N, clusters): bands short at the end; one cluster; four clusters
# whose last is all empty bands; more clusters than a group takes (16); a
# batch over groups of clusters, rectangular; more batch elements than
# clusters (each group walks two)
GRID_CASES = {"ragged-chunks": (2, 150, 45, 3), "one-chunk": (1, 40, 33, 1),
              "many-chunks": (1, 70, 45, 4), "past-16-clusters": (1, 300, 50, 20),
              "rectangular-batch": (3, 64, 81, 5), "batch-past-clusters": (4, 30, 41, 2)}


@pytest.mark.parametrize("B,M,N,clusters", list(GRID_CASES.values()), ids=list(GRID_CASES))
def test_chunked_column_merge_equals_plain_sweeps(B, M, N, clusters):
    """The global-memory kernel's merge order (band partials, merged per
    cluster of 8, then over the clusters) gives the plain sweeps to 1e-5
    on valid rows, columns and dustbins, with masked rows, short and empty
    bands, a cluster of empty bands, a capped group and batch elements
    walked by one group."""
    S, m0, m1 = (torch.from_numpy(a) for a in _sinkhorn_inputs(M, B, M, N))
    Z0, mu, nu, _ = sinkhorn.build_problem(S, m0, m1, 0.7)
    got = _grid_sinkhorn(Z0, mu, nu, 50, sinkhorn_cuda.grid_plan(B, M + 1, N + 1, clusters))
    ref = sinkhorn.sinkhorn_iterations_plain(Z0, mu, nu, 50)
    one = torch.ones((B, 1), dtype=torch.bool)
    sel = torch.cat([m0, one], 1)[:, :, None] & torch.cat([m1, one], 1)[:, None, :]
    assert torch.isfinite(got).all()
    assert (got - ref).abs()[sel].max() < 1e-5


@pytest.mark.parametrize("case", ["ragged-chunks", "past-16-clusters", "batch-past-clusters"])
def test_grid_merge_order_matches_jax_sinkhorn(case):
    """The same merge order against JAX's ``log_optimal_transport_masked``
    (rspl_slam_tpu/ops/sinkhorn.py) at 100 iterations: max error < 1e-4 on
    valid rows, columns and dustbins, as the port's plain sweeps are held
    to it (tests/test_torch_kernels.py); two batch elements over groups,
    a capped group, more batch elements than clusters."""
    B, M, N, clusters = GRID_CASES[case]
    S, m0, m1 = _sinkhorn_inputs(B * M + N, B, M, N)
    Zx = np.asarray(jax_ot(jnp.asarray(S), jnp.asarray(m0), jnp.asarray(m1),
                           jnp.asarray(1.0), 100))
    Z0, mu, nu, norm = sinkhorn.build_problem(torch.from_numpy(S), torch.from_numpy(m0),
                                              torch.from_numpy(m1), 1.0)
    plan = sinkhorn_cuda.grid_plan(B, M + 1, N + 1, clusters)
    got = (_grid_sinkhorn(Z0, mu, nu, 100, plan) - norm[:, None, None]).numpy()
    sel = (np.concatenate([m0, np.ones((B, 1), bool)], 1)[:, :, None]
           & np.concatenate([m1, np.ones((B, 1), bool)], 1)[:, None, :])
    assert np.isfinite(got).all()
    assert np.abs(Zx - got)[sel].max() < 1e-4


def _streamed_probabilities(logits, chunk, groups):
    """The streamed K2 kernel's softmax in torch: key group q of every chunk
    (keys [q w, (q + 1) w) of it, w = chunk / groups) folds each chunk into
    a running (max, sum of exp) per row; the groups merge once, in order,
    by lse_merge's rule; then every key's exp(l - max) times the sum's f32
    reciprocal rounds to bf16."""
    w = chunk // groups
    states = []
    for q in range(groups):
        st = (torch.full(logits.shape[:-1], -math.inf), torch.zeros(logits.shape[:-1]))
        for c0 in range(0, logits.shape[-1], chunk):
            lc = logits[..., c0 + q * w:c0 + (q + 1) * w]
            if lc.shape[-1]:
                m = torch.maximum(st[0], lc.max(-1).values)
                base = torch.where(m == -math.inf, torch.zeros_like(m), m)
                st = (m, st[1] * torch.exp(st[0] - base)
                      + torch.exp(lc - base[..., None]).sum(-1))
        states.append(st)
    m = torch.stack([s[0] for s in states]).max(0).values
    s = sum(torch.where(sm == -math.inf, torch.zeros_like(ss), ss * torch.exp(sm - m))
            for sm, ss in states)
    return (torch.exp(logits - m[..., None]) * (1.0 / s)[..., None]).to(torch.bfloat16)


def test_streamed_kernel_tiles_fit_two_ctas_per_sm():
    """The streamed K2 kernel's tiles: each of a query tile's KEY_GROUPS
    warps takes two n16 key blocks of every CHUNK-key chunk; its shared
    memory (the mirror of csrc/superglue_layer.cu: message tile, Q, a ring
    of STAGES chunks of K, V and mask, the groups' (max, sum)) lets two CTAs
    share an SM (228 KB, 1 KB reserved per CTA), and the P V partials of
    the 8 warps (16 × 64 f32 each, row stride 72) fit the drained ring."""
    ac = attention_cuda
    assert ac.CHUNK // ac.KEY_GROUPS == 32 and ac.KEY_GROUPS * ac.ROWS // 16 == 8
    smem = ac.bf16_streamed_smem_bytes()
    assert smem == 97_280
    assert 2 * (smem + 1024) <= 233_472
    stage = 2 * ac.CHUNK * (64 + 8) * 2 + ac.CHUNK * 4
    assert 2 * ac.KEY_GROUPS * 16 * (64 + 8) * 4 <= ac.STAGES * stage


@pytest.mark.parametrize("K", [752, 1024, 1100])
def test_streamed_softmax_rounds_what_the_resident_one_rounds(K):
    """The streamed kernel's softmax (running (max, sum) per key group over
    chunks of 128, the four groups merged once, then a product by the sum's
    reciprocal) gives the normalized probabilities of the resident kernel's
    two-pass softmax (a division) before the bf16 rounding, so after it
    they agree to one bf16 step (the sum rounds in another order, the
    reciprocal once more), with masked keys at -1e9 and padding keys at
    -inf; rows sum to 1 within bf16 rounding."""
    rng = np.random.default_rng(K)
    logits = torch.from_numpy((4 * rng.standard_normal((2, 4, 32, K))).astype(np.float32))
    logits[..., K - K // 7:] = -1e9
    pad = -(-K // 16) * 16
    logits = torch.cat([logits, torch.full(logits.shape[:-1] + (pad - K,), -math.inf)], -1)
    got = _streamed_probabilities(logits, attention_cuda.CHUNK,
                                  attention_cuda.KEY_GROUPS).float()
    ref = torch.softmax(logits, -1).to(torch.bfloat16).float()
    assert (got - ref).abs().max() <= 2.0 ** -8 * ref.abs().max()
    assert (got[..., K:] == 0).all()
    assert (got.sum(-1) - 1).abs().max() < 0.02
