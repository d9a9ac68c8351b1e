"""The trainers' shared Adam loop.

``torch.optim.Adam(lr)`` computes optax's ``adam(lr)`` (b1 0.9, b2 0.999,
eps 1e-8, eps_root 0) term for term: both divide the bias-corrected first
moment by the square root of the bias-corrected second plus eps. A leaf
that takes no part in the loss gets no gradient and stays as it was, as
under optax with its zero gradient.
"""

from __future__ import annotations

import contextlib
import time

import torch

from rspl_slam_tpu_torch.models.weights import to_numpy_tree, to_tensor_tree, tree_leaves

__all__ = ["deterministic", "no_tf32", "train_adam"]


@contextlib.contextmanager
def no_tf32():
    """f32 products stay f32 (cuDNN convolutions take TF32 by default on
    the card); the previous settings come back on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def deterministic():
    """Every step gives the same bits in every run on the same card:
    cuDNN's deterministic convolution
    algorithms (its default backward ones add with atomics) and PyTorch's
    deterministic implementations (``gather``'s backward then adds without
    atomics); an op that has none raises. The previous settings come back
    on exit."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:]


def train_adam(params, loss_fn, next_batch, steps: int, lr: float, device,
               log_every: int, verbose: bool, stats: dict | None = None):
    """``steps`` Adam steps from ``params`` (a numpy or tensor pytree) on
    ``loss_fn(tree, batch)``, with ``next_batch(step)`` giving each step's
    batch on ``device``. Returns (trained numpy pytree, loss history).

    ``stats``, when given, collects per step ``data_ms`` (host: making and
    uploading the batch) and ``step_ms`` (forward, backward and update up
    to reading the loss, which waits for the device)."""
    tree = to_tensor_tree(params, device, requires_grad=True)
    opt = torch.optim.Adam(tree_leaves(tree), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    history = []
    with no_tf32():
        for s in range(steps):
            t0 = time.perf_counter()
            batch = next_batch(s)
            t1 = time.perf_counter()
            loss = loss_fn(tree, batch)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            history.append(float(loss.detach()))
            if stats is not None:
                stats.setdefault("data_ms", []).append((t1 - t0) * 1e3)
                stats.setdefault("step_ms", []).append((time.perf_counter() - t1) * 1e3)
            if verbose and (s % log_every == 0 or s == steps - 1):
                print(f"step {s}: loss {history[-1]:.4f}", flush=True)
    return to_numpy_tree(tree), history
