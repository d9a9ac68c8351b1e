"""Multi-process initialization and mesh helpers (port of
parallel/multihost.py), over ``torch.distributed``.

Every rank runs the same program. Launch the ranks with ``torchrun``
(``torchrun --nproc-per-node 2 script.py``), which sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``, or set those
variables yourself, or pass ``init_method`` / ``world_size`` / ``rank``
explicitly; then call :func:`initialize`. Without any of them
:func:`initialize` is a no-op and the program is one process, so the same
entry point works everywhere.

Backend: NCCL when every rank on the host has a card of its own; gloo when
the ranks share a card (NCCL refuses two ranks on one device) or run on the
CPU. Under gloo the collectives stage CUDA tensors through pinned host
memory (``mesh.Mesh.all_gather``); the solve itself stays on the card.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from rspl_slam_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["initialize", "choose_backend", "rank_device", "global_mesh", "is_multihost",
           "local_batch_slice"]


def _env_int(name: str):
    return int(os.environ[name]) if name in os.environ else None


def rank_device(device="cuda") -> torch.device:
    """This rank's device: on the card, ``cuda:LOCAL_RANK`` where the host
    has a card per local rank, else the first card (shared); the CPU as
    asked."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = _env_int("LOCAL_RANK") or 0
    n = torch.cuda.device_count()
    return torch.device("cuda", local if local < n else 0)


def choose_backend(device, local_world_size: int) -> str:
    """``"nccl"`` when the ranks run on cards and each of the host's
    ``local_world_size`` ranks has one of its own; ``"gloo"`` otherwise."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= local_world_size):
        return "nccl"
    return "gloo"


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device="cuda", backend: str | None = None,
               timeout_s: float = 300.0) -> str | None:
    """Initialize ``torch.distributed`` when a multi-process launch is
    configured, through the arguments or the ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` variables; a no-op (returns
    None) otherwise or when already initialized. Returns the backend, which
    :func:`choose_backend` picks unless given. A collective that waits
    longer than ``timeout_s`` for a rank raises rather than hanging."""
    if dist.is_initialized():
        return dist.get_backend()
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None and world_size is None:
        return None  # one process
    if world_size is None or rank is None:
        raise ValueError("a multi-process launch needs both the world size and this "
                         "process's rank (WORLD_SIZE and RANK)")
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    backend = backend or choose_backend(device, local_world)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def is_multihost() -> bool:
    """True when more than one process takes part."""
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(n_model: int = 1, device="cuda") -> Mesh:
    """The ``data`` mesh over every rank of the launch, on this rank's
    device (:func:`rank_device`)."""
    return make_mesh(n_model=n_model, device=rank_device(device))


def local_batch_slice(global_batch: int) -> slice:
    """Which block of a leading axis of ``global_batch`` this process
    produces (each process feeds its own sequences or windows), with the
    JAX package's arithmetic: ``global_batch // world`` each, in rank
    order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // world
    return slice(i * per, (i + 1) * per)
