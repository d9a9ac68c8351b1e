"""Match decode + keypoint normalization (port of ops/matching.py:
``normalize_keypoints``, ``mutual_match_decode``, ``cosine_mutual_match``).
The epipolar RANSAC filter is not ported (ROADMAP)."""

from __future__ import annotations

import torch

__all__ = ["normalize_keypoints", "mutual_match_decode", "cosine_mutual_match"]


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
