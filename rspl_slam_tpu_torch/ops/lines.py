"""2D line segments: Hough detection on the device, then merging, point
assignment and stereo/temporal matching on the host (port of ops/lines.py).

:func:`detect_line_segments` runs batched over edge maps (the stereo pair
in one call): top-E edge pixels → (angle × ρ) votes → 3×5 NMS peaks → per
peak two TLS refinements, the inlier pixels' occupied projection bins, gap
bridging and the longest runs → dedup → the longest segments. Every top-k
of the JAX function is a stable descending sort here, which keeps
``jax.lax.top_k``'s order among ties (lowest index first): saturated edge
maps are full of exact ties. The vote and occupancy one-hot contractions
become ``index_add_`` / ``scatter_add_``; the votes sum bf16-rounded
weights (as the bf16 one-hot einsum does), whose f32 sums are exact in any
order. The rest computes what XLA's CPU backend compiles the JAX function
to: its fused multiply-adds (``_fma``), its reciprocals of constant
divisors (``_recip``) and its order of summation (``_xla_sum``), so a
length or a covariance near a tie rounds as JAX's does.

The host stages are numpy copies of the JAX package's: ``merge_lines``
(MergeLines + MergeTwoLines), ``filter_short_lines``,
``assign_points_to_lines`` and ``match_lines``. ``merge_lines`` runs the
C++ copy of ``native.merge_lines`` on every device (host code); its numpy
body stays as the plain version (``force_numpy=True``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["detect_line_segments", "merge_two_lines", "merge_lines", "filter_short_lines",
           "assign_points_to_lines", "match_lines"]


@lru_cache(maxsize=None)
def _angle_table(T: int, device: torch.device):
    """cos θ_k, sin θ_k (f32, rounded from float64) with θ_k = k·f32(f32(π)
    · f32(1/T)): ``jnp.linspace(0, π, T, endpoint=False)`` as XLA folds its
    constants. Made once per device, the same on every device."""
    step = np.float32(np.float32(np.pi) * (np.float32(1.0) / np.float32(T)))
    thetas = (np.arange(T, dtype=np.float32) * step).astype(np.float64)
    return (torch.from_numpy(np.cos(thetas).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(thetas).astype(np.float32)).to(device))


def _fma(a, b, c):
    """a·b + c as XLA's fused multiply-add gives it (XLA contracts a
    product and the add that consumes it): the f64 product of two f32
    values is exact; the f64 sum rounds, and the cast to f32 rounds again.
    That is the fused result but where the f64 sum lands exactly halfway
    between two f32 values without the exact one doing so (a double
    rounding; of the order of 2^-29 of random operands). A Python number
    stands for its f32 constant."""
    def f64(v):
        return v.double() if torch.is_tensor(v) else float(np.float32(v))

    return (a.double() * f64(b) + f64(c)).float()


def _xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, kept as size 1, in the order XLA's CPU
    backend takes in the JAX version the tests run (its reduction emitter's
    windows: a detail of XLA that a later version may change): while more
    than 32 terms remain, windows of 32 (the last one padded with 0) are
    each summed in sequence; the rest is summed in sequence. Every partial
    is an f32 rounding of its own, so the card's sum is the CPU's bit for
    bit. On the card these are ~70 small launches per call (PERF.md §5)."""
    while x.shape[-1] > 32:
        x = F.pad(x, (0, -x.shape[-1] % 32)).unflatten(-1, (-1, 32))
        acc = x[..., 0] + 0.0  # 0 + x0: XLA's reduction starts from +0
        for j in range(1, 32):
            acc = acc + x[..., j]
        x = acc
    acc = x[..., :1] + 0.0
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j:j + 1]
    return acc


def _recip(c: float) -> float:
    """The f32 reciprocal of the f32 constant ``c``: XLA folds ``x / c``
    into ``x * (1 / c)``."""
    return float(np.float32(1.0) / np.float32(c))


def _top(x: torch.Tensor, k: int):
    """The ``k`` largest of each row, lowest index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def detect_line_segments(
    edge: torch.Tensor,  # (B, H, W) or (H, W) edge probability in [0, 1]
    edge_threshold: float = 0.25,
    max_segments: int = 64,
    num_angles: int = 120,
    num_rho: int = 240,
    max_edge_pixels: int = 4096,
    num_bins: int = 256,
    inlier_dist: float = 1.5,
    min_length: float = 10.0,
    max_gap_bins: int = 2,
    runs_per_peak: int = 2,
):
    """Returns (segments (B, S, 4) [x1, y1, x2, y2], valid (B, S), length
    (B, S)) with S = ``max_segments``, sorted by length descending (no
    batch dimension for a 2-D ``edge``). Up to ``runs_per_peak`` runs of
    occupied projection bins per Hough peak, gaps ≤ ``max_gap_bins``
    bridged."""
    squeeze = edge.dim() == 2
    if squeeze:
        edge = edge[None]
    B, H, W = edge.shape
    dev = edge.device
    f32 = torch.float32
    T, R, S, NB = num_angles, num_rho, max_segments, num_bins

    # --- top-E edge pixels -------------------------------------------------
    vals, idx = _top(edge.reshape(B, -1).to(f32), min(max_edge_pixels, H * W))
    emask = vals > edge_threshold
    ys = (idx // W).to(f32)
    xs = (idx % W).to(f32)
    w = torch.where(emask, vals, 0.0)
    E = vals.shape[1]

    # --- Hough votes -------------------------------------------------------
    cos_t, sin_t = _angle_table(T, dev)
    diag = float(np.hypot(H, W))
    rho_scale = (R - 1) / (2.0 * diag)
    rho_all = _fma(xs[:, None, :], cos_t[:, None], ys[:, None, :] * sin_t[:, None])
    rbin = ((rho_all + diag) * rho_scale).to(torch.int64).clamp(0, R - 1)  # (B, T, E)
    cell = (torch.arange(B, device=dev)[:, None, None] * T
            + torch.arange(T, device=dev)[:, None]) * R + rbin
    wb = w.to(torch.bfloat16).to(f32)[:, None, :].expand(B, T, E)
    votes = torch.zeros(B * T * R, dtype=f32, device=dev).index_add_(
        0, cell.reshape(-1), wb.reshape(-1)).view(B, T, R)

    # --- peak picking with 2D NMS -----------------------------------------
    pooled = F.max_pool2d(votes[:, None], (3, 5), stride=1, padding=(1, 2))[:, 0]
    peaks = torch.where(votes >= pooled, votes, 0.0)
    pvals, pidx = _top(peaks.reshape(B, -1), S)
    t_idx = pidx // R
    peak_ok = pvals > min_length * edge_threshold  # (B, S)

    # --- per-peak segment extraction, vectorised over (B, S, E) -----------
    bin_len = 2.0 * diag / NB
    c = cos_t[t_idx][..., None]  # (B, S, 1)
    s = sin_t[t_idx][..., None]
    rho = _fma((pidx % R).to(f32)[..., None], _recip(rho_scale), -diag)
    xs, ys, w, emask = xs[:, None], ys[:, None], w[:, None], emask[:, None]
    for refine_dist in (3.0 * inlier_dist, 1.5 * inlier_dist):
        dist = (_fma(xs, c, ys * s) - rho).abs()
        inl_w = torch.where(emask & (dist < refine_dist), w, 0.0)
        # the sums stacked, three at a time: one pass of _xla_sum's adds each
        wsum, mx, my = _xla_sum(torch.stack([inl_w, inl_w * xs, inl_w * ys]))
        wsum = wsum.clamp_min(1e-6)
        mx, my = mx / wsum, my / wsum
        cxx, cyy, cxy = _xla_sum(torch.stack([inl_w * (xs - mx) ** 2, inl_w * (ys - my) ** 2,
                                              inl_w * (xs - mx) * (ys - my)])) / wsum
        phi = 0.5 * torch.atan2(2.0 * cxy, cxx - cyy)  # principal direction
        c2, s2 = -torch.sin(phi), torch.cos(phi)  # normal = rot90(direction)
        enough = wsum > min_length * edge_threshold * 0.5
        rho = torch.where(enough, _fma(my, s2, mx * c2), rho)
        c = torch.where(enough, c2, c)
        s = torch.where(enough, s2, s)
    inl = emask & ((_fma(xs, c, ys * s) - rho).abs() < inlier_dist)
    proj = _fma(ys, c, -(xs * s))  # position along the line, in [−diag, diag]
    pbin = ((proj + diag) * _recip(bin_len)).to(torch.int64).clamp(0, NB - 1)
    occ = torch.zeros((B, S, NB), dtype=f32, device=dev).scatter_add_(
        2, pbin, inl.to(f32).expand(B, S, E)) > 0
    # bridge small gaps with zero-fill shifts (a roll would wrap around)
    no = torch.zeros_like(occ[..., :1])
    for _ in range(max_gap_bins):
        occ = occ | torch.cat([occ[..., 1:], no], -1) | torch.cat([no, occ[..., :-1]], -1)
    bins = torch.arange(NB, device=dev)
    c, s, rho = c[..., 0], s[..., 0], rho[..., 0]
    segs, valid, lengths = [], [], []
    for _ in range(runs_per_peak):
        # run[i] = i − (last unoccupied bin ≤ i)
        last_zero = torch.cummax(torch.where(occ, -1, bins), -1).values
        runs = torch.where(occ, bins - last_zero, 0)
        end_bin = runs.argmax(-1)  # the first maximum, as jnp.argmax
        start_bin = end_bin - runs.gather(-1, end_bin[..., None])[..., 0] + 1
        occ = occ & ~((bins >= start_bin[..., None]) & (bins <= end_bin[..., None]))
        # trim the dilation padding back off the run ends
        s0 = _fma((start_bin + max_gap_bins).to(f32), bin_len, -diag)
        s1 = _fma((end_bin - max_gap_bins).to(f32), bin_len, -diag)
        # endpoints ρ·n̂ + t·d̂ with n̂ = (c, s), d̂ = (−s, c)
        segs.append(torch.stack([_fma(rho, c, -(s0 * s)), _fma(rho, s, s0 * c),
                                 _fma(rho, c, -(s1 * s)), _fma(rho, s, s1 * c)], -1))
        length = s1 - s0
        valid.append(peak_ok & (length >= min_length))
        lengths.append(length)
    N = S * runs_per_peak  # candidate order: peak-major, then run
    segs = torch.stack(segs, 2).reshape(B, N, 4)
    valid = torch.stack(valid, 2).reshape(B, N)
    lengths = torch.stack(lengths, 2).reshape(B, N)

    # --- dedup: keep the first of each endpoint-coincident group ----------
    e0, e1 = segs[..., None, :2], segs[..., None, 2:]

    def pair_d(a, b):
        return torch.linalg.norm(a - b.transpose(1, 2), dim=-1)

    d_same = torch.maximum(pair_d(e0, e0), pair_d(e1, e1))
    d_flip = torch.maximum(pair_d(e0, e1), pair_d(e1, e0))
    close = torch.minimum(d_same, d_flip) < 3.0
    n = torch.arange(N, device=dev)
    dup = (close & valid[:, None, :] & (n[None, :] < n[:, None])).any(-1)
    keep = valid & ~dup
    _, order = _top(torch.where(keep, lengths, -1.0), S)
    out = (segs.gather(1, order[..., None].expand(B, S, 4)), keep.gather(1, order),
           lengths.gather(1, order))
    return tuple(t[0] for t in out) if squeeze else out


# ---------------------------------------------------------------------------
# Merging (host)
# ---------------------------------------------------------------------------


def merge_two_lines(a, b) -> np.ndarray:
    """Length-weighted merge of two segments [x1, y1, x2, y2]
    (MergeTwoLines, line_processor.cc:98-161) → (4,) float64: one row of
    :func:`_merge_two_lines_vec`."""
    return _merge_two_lines_vec(np.asarray(a, np.float64)[None, :4],
                                np.asarray(b, np.float64)[None, :4], np.ones(1, bool))[0]


def _merge_two_lines_vec(a: np.ndarray, b: np.ndarray,
                         active: np.ndarray) -> np.ndarray:
    """Length-weighted merge of segment pairs (MergeTwoLines), row by row:
    direction = length-weighted mean of the principal angles (with π wrap),
    endpoints = the extreme projections of all four endpoints. ``a``/``b``
    (M, 4) → merged (M, 4); rows where ``active`` is False pass ``a``
    through."""
    ax, ay, bx, by = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    cx, cy, dx, dy = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    dlix, dliy = bx - ax, by - ay
    dljx, dljy = dx - cx, dy - cy
    li = np.hypot(dlix, dliy)
    lj = np.hypot(dljx, dljy)
    denom = 2.0 * (li + lj)
    xg = (li * (ax + bx) + lj * (cx + dx)) / denom
    yg = (li * (ay + by) + lj * (cy + dy)) / denom
    with np.errstate(divide="ignore", invalid="ignore"):
        thi = np.where(dlix == 0.0, np.pi / 2,
                       np.arctan(dliy / np.where(dlix == 0.0, 1.0, dlix)))
        thj = np.where(dljx == 0.0, np.pi / 2,
                       np.arctan(dljy / np.where(dljx == 0.0, 1.0, dljx)))
        # π-wrap branch: thj − π·sign(thj) (thj ≠ 0 whenever it is taken)
        tmp = thj - np.pi * np.where(thj == 0.0, 1.0, np.sign(thj))
    thj_eff = np.where(np.abs(thi - thj) <= np.pi / 2, thj, tmp)
    th = (li * thi + lj * thj_eff) / (li + lj)
    ct, st = np.cos(th), np.sin(th)
    pa = (ay - yg) * st + (ax - xg) * ct
    pb = (by - yg) * st + (bx - xg) * ct
    pc = (cy - yg) * st + (cx - xg) * ct
    pd = (dy - yg) * st + (dx - xg) * ct
    lo = np.minimum(np.minimum(pa, pb), np.minimum(pc, pd))
    hi = np.maximum(np.maximum(pa, pb), np.maximum(pc, pd))
    merged = np.stack([lo * ct + xg, lo * st + yg, hi * ct + xg, hi * st + yg], -1)
    return np.where(active[:, None], merged, a)


def merge_lines(segs: np.ndarray, angle_thr: float = 0.1,
                distance_thr: float = 15.0, ep_thr: float = 30.0,
                force_numpy: bool = False) -> np.ndarray:
    """The reference's MergeLines, (N, 4) → (M, 4) float64:

    1. pairwise neighbours: principal-angle difference ≤ ``angle_thr``,
       midpoint-to-line distance ≤ ``distance_thr`` either way, and overlap
       or endpoint gap² < ``ep_thr``² along the dominant axis of the
       angle-earlier line;
    2. connected components (union-find);
    3. components > 2 re-split into longest-first seeds + their direct
       neighbours (in angle order);
    4. a sequential pairwise merge fold within each sub-cluster.

    The C++ merge of ``native.py`` runs unless ``force_numpy``; it raises
    where the library cannot be built."""
    N = len(segs)
    if N == 0:
        return segs
    if N == 1:
        return np.asarray(segs, np.float64).reshape(1, 4)
    if not force_numpy:
        from rspl_slam_tpu_torch import native

        return native.merge_lines(segs, angle_thr, distance_thr, ep_thr)
    S = np.asarray(segs, np.float64)
    dx = S[:, 2] - S[:, 0]
    dy = S[:, 3] - S[:, 1]
    # principal angle atan(dy/dx) ∈ (−π/2, π/2]
    with np.errstate(divide="ignore"):
        angles = np.where(dx == 0, np.pi / 2, np.arctan(dy / np.where(dx == 0, 1, dx)))
    lengths = np.hypot(dx, dy)
    pos = np.empty(N, np.int64)
    pos[np.argsort(angles, kind="stable")] = np.arange(N)

    # 1a: angle difference with π wrap
    dA = np.abs(angles[:, None] - angles[None, :])
    dA = np.minimum(dA, np.pi - dA)
    ok = dA <= angle_thr
    # 1b: midpoint-to-infinite-line distance, d[i, j] = mid_i to line_j
    mids = (S[:, :2] + S[:, 2:]) / 2
    A = dy
    B = -dx
    C = S[:, 2] * S[:, 1] - S[:, 0] * S[:, 3]
    D = np.maximum(np.hypot(A, B), 1e-9)
    d_mid = np.abs(
        mids[:, None, 0] * A[None, :] + mids[:, None, 1] * B[None, :] + C[None, :]
    ) / D[None, :]
    ok &= (d_mid <= distance_thr) | (d_mid.T <= distance_thr)
    # 1c: overlap / endpoint gap along the angle-earlier line's axis
    ends = S.reshape(N, 2, 2)

    def axis_cond(axis):
        swap = ends[:, 1, axis] < ends[:, 0, axis]
        P0 = np.where(swap[:, None], ends[:, 1], ends[:, 0])  # axis-min end
        P1 = np.where(swap[:, None], ends[:, 0], ends[:, 1])  # axis-max end
        i_first = P1[:, None, axis] <= P1[None, :, axis]
        fe = np.where(i_first[..., None], P1[:, None], P1[None, :])
        ss = np.where(i_first[..., None], P0[None, :], P0[:, None])
        overlap = fe[..., axis] >= ss[..., axis]
        gap2 = ((ss - fe) ** 2).sum(-1)
        return overlap | (gap2 < ep_thr * ep_thr)

    cond_x = axis_cond(0)
    cond_y = axis_cond(1)
    to_x = np.abs(angles) < np.pi / 4
    row_cond = np.where(to_x[:, None], cond_x, cond_y)
    earlier_i = pos[:, None] <= pos[None, :]
    ok &= np.where(earlier_i, row_cond, row_cond.T)
    np.fill_diagonal(ok, False)

    # 2: connected components, union-find over the edge list
    parent = list(range(N))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ei, ej = np.nonzero(np.triu(ok, 1))
    for a, b in zip(ei.tolist(), ej.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    comps: dict[int, list[int]] = {}
    for i in range(N):
        comps.setdefault(find(i), []).append(i)

    # 3: sub-cluster split
    subs: list[np.ndarray] = []
    for members in comps.values():
        cluster = np.asarray(members, np.int64)
        if len(cluster) <= 2:
            subs.append(cluster)
            continue
        cluster = cluster[np.argsort(-lengths[cluster], kind="stable")]
        clustered = set()
        for li in cluster:
            if li in clustered:
                continue
            nb = np.nonzero(ok[int(li)])[0]
            nb = nb[np.argsort(pos[nb], kind="stable")]  # fold in angle order
            clustered.update(nb.tolist())
            subs.append(np.concatenate([[li], nb]))
    # 4: fold every sub-cluster at once, padded to the longest
    M = len(subs)
    sizes = np.fromiter((len(s) for s in subs), np.int64, M)
    idx_pad = np.zeros((M, int(sizes.max())), np.int64)
    for r, s in enumerate(subs):
        idx_pad[r, : len(s)] = s
    cur = S[idx_pad[:, 0]]
    for k in range(1, idx_pad.shape[1]):
        cur = _merge_two_lines_vec(cur, S[idx_pad[:, k]], sizes > k)
    return cur


def filter_short_lines(segs: np.ndarray, min_length: float) -> np.ndarray:
    if len(segs) == 0:
        return segs
    lengths = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
    return segs[lengths >= min_length]


# ---------------------------------------------------------------------------
# Point-line association + matching (host)
# ---------------------------------------------------------------------------


def assign_points_to_lines(segs: np.ndarray, xy: np.ndarray,
                           point_valid: np.ndarray, max_dist: float = 6.0,
                           bbox_slack: float = 3.0) -> np.ndarray:
    """(L, 4) segments × (K, 2) keypoints → membership (L, K) bool:
    infinite-line distance < ``max_dist`` and inside the segment's bbox
    grown by ``bbox_slack``."""
    L = len(segs)
    K = len(xy)
    if L == 0:
        return np.zeros((0, K), bool)
    x1, y1, x2, y2 = segs[:, 0:1], segs[:, 1:2], segs[:, 2:3], segs[:, 3:4]
    A = y2 - y1
    B = x1 - x2
    C = x2 * y1 - x1 * y2
    D = np.maximum(np.hypot(A, B), 1e-9)
    px = xy[None, :, 0]
    py = xy[None, :, 1]
    dist = np.abs(A * px + B * py + C) / D  # (L, K)
    in_bbox = (
        (px >= np.minimum(x1, x2) - bbox_slack)
        & (px <= np.maximum(x1, x2) + bbox_slack)
        & (py >= np.minimum(y1, y2) - bbox_slack)
        & (py <= np.maximum(y1, y2) + bbox_slack)
    )
    return (dist < max_dist) & in_bbox & point_valid[None, :]


def match_lines(membership0: np.ndarray, membership1: np.ndarray,
                point_matches: np.ndarray) -> np.ndarray:
    """Vote-matrix line matching (MatchLines). membership0 (L0, K0),
    membership1 (L1, K1) bool; point_matches (K0,) indices into frame 1
    (−1 = unmatched). Returns (L0,) line matches into frame 1 or −1: mutual
    row/column argmax, votes ≥ 2, votes² / min(|pts₀|, |pts₁|) ≥ 0.8."""
    L0 = membership0.shape[0]
    L1 = membership1.shape[0]
    out = np.full(L0, -1, np.int64)
    if L0 == 0 or L1 == 0:
        return out
    matched = np.nonzero(point_matches >= 0)[0]
    votes = (membership0[:, matched].astype(np.int64)
             @ membership1[:, point_matches[matched]].astype(np.int64).T)
    n0 = membership0.sum(1)
    n1 = membership1.sum(1)
    row_argmax = votes.argmax(1)
    for j in range(L1):
        col = votes[:, j]
        i = int(col.argmax())
        v = int(col[i])
        if v < 2 or row_argmax[i] != j:
            continue
        denom = min(n0[i], n1[j])
        if denom == 0 or (v * v) / denom < 0.8:
            continue
        out[i] = j
    return out
