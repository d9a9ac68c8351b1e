"""Masked log-domain Sinkhorn optimal transport (port of ops/sinkhorn.py,
plain PyTorch). :func:`build_problem` assembles the augmented coupling
matrix and log marginals that the K3 kernel (ops/sinkhorn_cuda.py)
iterates on."""

from __future__ import annotations

import torch

__all__ = ["build_problem", "sinkhorn_iterations_plain",
           "log_optimal_transport_masked"]

_NEG = -1e9


def build_problem(scores, mask0, mask1, bin_score):
    """Returns (Z0 (B, M+1, N+1), log_mu (B, M+1), log_nu (B, N+1),
    norm (B,)): invalid slots carry −1e9 in couplings and marginals; each
    valid keypoint has mass 1/(M+N) with M, N the valid counts."""
    B, M, N = scores.shape
    f = scores.dtype
    ms = mask0.to(f).sum(-1)
    ns = mask1.to(f).sum(-1)
    bs = torch.as_tensor(bin_score, dtype=f, device=scores.device)  # on-device in the matcher
    couplings = torch.where(mask0[:, :, None] & mask1[:, None, :], scores, _NEG)
    bins0 = torch.where(mask0, bs, _NEG)[:, :, None]
    bins1 = torch.where(mask1, bs, _NEG)[:, None, :]
    alpha = bs.expand(B, 1, 1)
    Z0 = torch.cat([torch.cat([couplings, bins0], -1),
                    torch.cat([bins1, alpha], -1)], 1)
    norm = -torch.log(ms + ns)
    log_mu = torch.cat([torch.where(mask0, norm[:, None], _NEG),
                        (torch.log(ns) + norm)[:, None]], -1)
    log_nu = torch.cat([torch.where(mask1, norm[:, None], _NEG),
                        (torch.log(ms) + norm)[:, None]], -1)
    return Z0.contiguous(), log_mu.contiguous(), log_nu.contiguous(), norm


def sinkhorn_iterations_plain(Z0, log_mu, log_nu, iters: int):
    """``iters`` u/v log-sum-exp sweeps from zero; returns Z0 + u + v."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z0 + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z0 + u[:, :, None], dim=1)
    return Z0 + u[:, :, None] + v[:, None, :]


def log_optimal_transport_masked(scores, mask0, mask1, bin_score,
                                 iters: int = 100):
    """(B, M+1, N+1) log transport plan incl. dustbins, scaled by M+N."""
    Z0, log_mu, log_nu, norm = build_problem(scores, mask0, mask1, bin_score)
    return sinkhorn_iterations_plain(Z0, log_mu, log_nu, iters) - norm[:, None, None]
