"""Match decode, keypoint normalization and epipolar match rejection (port
of ops/matching.py: ``normalize_keypoints``, ``mutual_match_decode``,
``match_distance``, ``cosine_mutual_match``, ``fundamental_ransac_inliers``)."""

from __future__ import annotations

import math

import torch

__all__ = ["normalize_keypoints", "mutual_match_decode", "match_distance",
           "cosine_mutual_match", "sample_hypotheses", "fundamental_ransac_inliers"]


def normalize_keypoints(xy: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(..., 2) pixels → (xy − (w/2, h/2)) / (0.7·max(w, h))."""
    scale = 0.7 * max(width, height)
    return torch.stack([(xy[..., 0] - width / 2.0) / scale,
                        (xy[..., 1] - height / 2.0) / scale], -1)


def mutual_match_decode(Z, mask0, mask1, threshold: float = 0.2):
    """Mutual row/col argmax of the log plan with exp-score > threshold.
    Returns (indices0 (B, M) int32, indices1 (B, N) int32, mscores0 (B, M)).
    ``argmax`` returns the first maximum in both frameworks."""
    S = Z[:, :-1, :-1]
    S = torch.where(mask0[:, :, None] & mask1[:, None, :], S, -1e9)
    max0 = S.argmax(2)
    max1 = S.argmax(1)
    m_idx = torch.arange(S.shape[1], device=S.device)[None]
    n_idx = torch.arange(S.shape[2], device=S.device)[None]
    mutual0 = torch.gather(max1, 1, max0) == m_idx
    mutual1 = torch.gather(max0, 1, max1) == n_idx
    sc0 = torch.exp(torch.gather(S, 2, max0[:, :, None])[..., 0])
    valid0 = mutual0 & (sc0 > threshold) & mask0
    valid1 = mutual1 & torch.gather(valid0, 1, max1) & mask1
    indices0 = torch.where(valid0, max0, -1).to(torch.int32)
    indices1 = torch.where(valid1, max1, -1).to(torch.int32)
    return indices0, indices1, torch.where(valid0, sc0, 0.0)


def match_distance(ms0: torch.Tensor, ms1: torch.Tensor) -> torch.Tensor:
    """DMatch-style distance 1 − (ms0 + ms1)/2 (point_matching.cc:24-32)."""
    return 1.0 - 0.5 * (ms0 + ms1)


def cosine_mutual_match(desc0, mask0, desc1, mask1, min_similarity: float = 0.7,
                        ratio: float = 0.95):
    """Masked mutual-NN cosine matching with a ratio test → indices0 int32."""
    sim = torch.einsum("bmc,bnc->bmn", desc0.float(), desc1.float())
    sim = torch.where(mask0[:, :, None] & mask1[:, None, :], sim, -2.0)
    best0 = sim.argmax(2)
    best1 = sim.argmax(1)
    m_idx = torch.arange(sim.shape[1], device=sim.device)[None]
    mutual = torch.gather(best1, 1, best0) == m_idx
    top = torch.gather(sim, 2, best0[:, :, None])[..., 0]
    sim2 = sim.scatter(2, best0[:, :, None], -2.0)
    second = sim2.amax(2)
    ok = mutual & mask0 & (top > min_similarity) & ((1.0 - top) < ratio * (1.0 - second))
    return torch.where(ok, best0, -1).to(torch.int32)


def sample_hypotheses(matched: torch.Tensor, generator: torch.Generator,
                      iters: int = 128) -> torch.Tensor:
    """(iters, 8) distinct matched row indices per hypothesis, by
    Gumbel-top-8 over the matched rows, as the JAX package draws them
    (``jax.random.gumbel`` per hypothesis key there, ``generator`` here:
    the streams differ, the law is the same). With fewer than 8 matched
    rows, unmatched ones fill the sample (their weight is 0)."""
    logits = torch.where(matched, 0.0, -1e9)
    e = torch.empty((iters, matched.shape[0]), device=matched.device).exponential_(
        generator=generator)
    return torch.topk(logits - torch.log(e), 8, dim=1).indices


def fundamental_ransac_inliers(xy0: torch.Tensor, xy1: torch.Tensor, matched: torch.Tensor,
                               generator: torch.Generator | None = None, iters: int = 128,
                               threshold_px: float = 3.0,
                               hypotheses: torch.Tensor | None = None) -> torch.Tensor:
    """Epipolar outlier rejection (≙ the reference's optional
    ``cv::findFundamentalMat(FM_RANSAC, 3, 0.99)``, point_matching.cc:35-45):
    ``iters`` 8-point hypotheses (``hypotheses``, (H, 8) row indices, or
    drawn by :func:`sample_hypotheses` from ``generator``), each a
    fundamental matrix by the normalized 8-point algorithm (the smallest
    eigenvector of AᵀWA by a batched 9×9 ``eigh``, rank 2 by a 3×3 SVD),
    scored by Sampson distance in one (H, K) matrix; the winner is refit on
    its consensus set. xy0 (K, 2), xy1 (K, 2) matched pixels, matched (K,)
    bool. Returns (K,) bool: matches within ``threshold_px`` of the refit
    model; with fewer than 8 matches, ``matched`` unchanged. On a CUDA
    device ``eigh`` and the SVD synchronize with the host."""
    if hypotheses is None:
        hypotheses = sample_hypotheses(matched, generator, iters)
    K = xy0.shape[0]
    xy0, xy1 = xy0.float(), xy1.float()
    m = matched.float()
    n = m.sum().clamp_min(1.0)

    def norm_T(xy):
        """Hartley normalization from the matched set's statistics."""
        c = (xy * m[:, None]).sum(0) / n
        d = torch.sqrt((((xy - c) ** 2).sum(-1) * m).sum() / n)
        s = math.sqrt(2.0) / d.clamp_min(1e-6)
        zero, one = torch.zeros_like(s), torch.ones_like(s)
        T = torch.stack([torch.stack([s, zero, -s * c[0]]), torch.stack([zero, s, -s * c[1]]),
                         torch.stack([zero, zero, one])])
        return T, (xy - c) * s

    T0, q0 = norm_T(xy0)
    T1, q1 = norm_T(xy1)
    x0, y0, x1, y1 = q0[:, 0], q0[:, 1], q1[:, 0], q1[:, 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     torch.ones_like(x0)], -1)  # (K, 9)

    def solve_f(w):
        """min ‖diag(w)·A·f‖ for a batch of row weights (B, K): the
        eigenvector of AᵀWA of the smallest eigenvalue, rank-2-projected,
        denormalized to pixels."""
        M = torch.einsum("ki,bk,kj->bij", A, w, A)
        f = torch.linalg.eigh(M).eigenvectors[..., 0]
        U, S, Vh = torch.linalg.svd(f.reshape(-1, 3, 3))
        S = S * torch.tensor([1.0, 1.0, 0.0], device=S.device)
        return T1.T @ ((U * S[:, None, :]) @ Vh) @ T0

    w = torch.zeros((hypotheses.shape[0], K), device=xy0.device).scatter(
        1, hypotheses, 1.0) * m
    Fs = solve_f(w)  # (H, 3, 3)
    h0 = torch.cat([xy0, torch.ones_like(xy0[:, :1])], -1)
    h1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], -1)

    def sampson(F):
        Fx0 = h0 @ F.mT  # (B, K, 3) = F·x0
        Ftx1 = h1 @ F  # Fᵀ·x1
        e = (h1 * Fx0).sum(-1)
        denom = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
        return e * e / denom.clamp_min(1e-12)

    inl = (sampson(Fs) < threshold_px ** 2) & matched[None]
    best = inl.sum(-1).argmax()
    ok = (sampson(solve_f(inl[best][None].float()))[0] < threshold_px ** 2) & matched
    return torch.where(matched.sum() >= 8, ok, matched)
