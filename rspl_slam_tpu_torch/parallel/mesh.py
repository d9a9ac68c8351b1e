"""The port's device mesh (port of parallel/mesh.py): a ``data`` axis of
ranks over ``torch.distributed``, and the collectives the solvers run over
it.

The JAX package's mesh is a grid of devices with the axes ``data``
(frames, windows, sequences: the embarrassingly parallel work, and the
landmark shards of one BA problem) and ``model`` (reserved for sharding the
matcher). Here one rank is one process with one device; a :class:`Mesh`
holds the process group of its ranks (None for a single process), the
``data`` axis size, this rank and this rank's device. The ``model`` axis
stays reserved: a size above 1 raises.

The JAX package's ``data_sharding`` / ``replicated`` become this port's
idiom: :meth:`Mesh.data_slice` is the rank's block of a leading axis, and
a replicated value is every rank's own copy (no wrapper). A mesh without a
process group is this process alone: a ``data`` axis of size 1.

The collectives keep their results equal on every rank, bit for bit:
:meth:`Mesh.all_gather` returns every rank's tensor in rank order, and
:meth:`Mesh.sum_f64` adds the ranks' parts in f64 in rank order on every
rank (no reduction tree whose order could differ between ranks or runs),
recording how many floats each call passed in :attr:`Mesh.traffic`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """A ``data`` axis over the ranks of a ``torch.distributed`` process
    ``group`` (None: this process alone, an axis of size 1), this process's
    ``rank`` on it, and its ``device``. ``traffic`` lists (tag, floats) for
    every :meth:`sum_f64` call."""

    def __init__(self, group=None, device="cuda"):
        self.group = group
        self.size = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.device = torch.device(device)
        self.traffic: list[tuple[str, int]] = []

    @property
    def shape(self) -> dict:
        return {"data": self.size, "model": 1}

    @property
    def distributed(self) -> bool:
        """True when the axis spans more than this process."""
        return self.size > 1

    def data_slice(self, n: int) -> slice:
        """This rank's block of a leading axis of ``n`` (divisible by the
        axis size)."""
        if n % self.size:
            raise ValueError(f"leading axis {n} does not divide over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def _stage(self, t: torch.Tensor) -> bool:
        """Whether ``t`` goes through host memory for the collective: gloo
        moves CPU tensors only, so a CUDA tensor under gloo is staged."""
        return t.is_cuda and dist.get_backend(self.group) == dist.Backend.GLOO

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (equal shapes and dtypes) in rank order, on
        ``t``'s device. Under gloo a CUDA tensor goes through pinned host
        memory (one copy down, one up)."""
        if not self.distributed:
            return [t]
        src = t.contiguous()
        if self._stage(src):
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src)
            parts = [torch.empty_like(host) for _ in range(self.size)]
            dist.all_gather(parts, host, group=self.group)
            return [p.to(t.device) for p in parts]
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return parts

    def sum_f64(self, tag: str, *tensors: torch.Tensor) -> list[torch.Tensor]:
        """Σ over ranks of each tensor: the tensors packed into one f64
        vector, every rank's vector gathered, added in rank order in f64,
        and each sum rounded once to its tensor's dtype. Records the floats
        this rank passed under ``tag``."""
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
        self.traffic.append((tag, flat.numel()))
        parts = self.all_gather(flat)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        out, o = [], 0
        for t in tensors:
            out.append(acc[o: o + t.numel()].view(t.shape).to(t.dtype))
            o += t.numel()
        return out


def make_mesh(n_data: int | None = None, n_model: int = 1, device="cuda") -> Mesh:
    """The mesh of this process: with ``torch.distributed`` initialized,
    the ``data`` axis is the world's ranks (``n_data``, if given, must equal
    the world size); without it, this process alone (``n_data`` None or
    1). ``n_model`` above 1 raises (the axis is reserved)."""
    if n_model != 1:
        raise NotImplementedError(
            "the mesh's model axis is reserved, as in the JAX package: only n_model=1 "
            "(ROADMAP.md, §1 item 6)")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_data is not None and n_data != world:
            raise ValueError(f"n_data={n_data} differs from the process group's "
                             f"{world} ranks")
        return Mesh(dist.group.WORLD, device)
    if n_data not in (None, 1):
        raise ValueError(f"n_data={n_data} needs a process group of {n_data} ranks "
                         "(parallel.multihost.initialize); this process is one rank")
    return Mesh(None, device)
