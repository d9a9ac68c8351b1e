"""Distributed and batched bundle adjustment (port of parallel/dist_ba.py).

Two scaling patterns, as in the JAX package:

1. :func:`batched_windows_ba`: W independent BA windows of one capacity in
   ONE batched solve (``torch.func.vmap`` over the LM schedule: every
   operation of an LM step runs once for all W windows), each window with
   its own λ and accept/reject. On a distributed mesh each rank solves its
   block of the windows and one all-gather returns every window to every
   rank.

2. :func:`sharded_constraints_ba`: ONE large problem over the mesh's ranks,
   the full ``optimize_local_map`` schedule (Huber IRLS, LM accept/reject,
   10 → chi² gate → 5, points and lines). The JAX package shards the
   constraints by index, so every device touches every landmark and one psum
   per LM step moves F·42 + P·(12 + 18F) + L·(20 + 24F) + 1 floats. The port
   shards BY LANDMARK (``backend/local_ba.landmark_partition``): a rank holds
   its landmarks' constraints, their blocks and back-substitution stay local,
   and only the rank's parts of the reduced camera system S, of g̃ and of the
   cost cross ranks: :func:`expected_collective_floats` per LM step, whatever
   P and L. The same function up to summation order.
"""

from __future__ import annotations

import numpy as np
import torch

from rspl_slam_tpu_torch.backend import local_ba
from rspl_slam_tpu_torch.backend.local_ba import BAProblem, BAResult, SegmentPlan
from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
from rspl_slam_tpu_torch.parallel.mesh import Mesh

__all__ = ["batched_windows_ba", "sharded_constraints_ba", "pad_constraints",
           "collective_traffic", "expected_collective_floats", "upload_windows",
           "fetch_windows"]

_CONSTRAINT_FIELDS = ("p_pose", "p_point", "p_meas", "p_stereo", "p_valid", "l_pose",
                      "l_line", "l_eps", "l_eps_r", "l_stereo", "l_valid")


def _pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    r = (-x.shape[0]) % n
    return x if r == 0 else np.concatenate([x, np.zeros((r,) + x.shape[1:], x.dtype)])


def pad_constraints(prob: BAProblem, ndev: int) -> BAProblem:
    """Pad the constraint arrays of a problem of numpy arrays to multiples
    of ``ndev`` with invalid slots (index 0, valid=False), as the JAX
    package pads them. The port's sharded solve does not need it (it shards
    by landmark); a padded problem solves to the same result."""
    return prob._replace(**{f: _pad_rows(np.asarray(getattr(prob, f)), ndev)
                            for f in _CONSTRAINT_FIELDS})


def sharded_constraints_ba(K: CameraIntrinsics, prob: BAProblem, mesh: Mesh,
                           **kw) -> BAResult:
    """``optimize_local_map`` on ``prob`` (numpy or tensors, the same on
    every rank) sharded over the mesh's ranks by landmark: the landmarks are
    partitioned on the host, balancing constraint counts
    (``local_ba.landmark_partition``), each rank solves its share against
    the summed camera system, and every rank returns the whole result, on
    the mesh's device. ``kw`` forwards the chi² thresholds and iteration
    counts. On a mesh of one process this is the unsharded solve."""
    return local_ba.optimize_local_map(K, prob, axis_name=mesh, **kw)


def expected_collective_floats(F: int, P: int = 0, L: int = 0) -> int:
    """Floats each rank passes per LM step of :func:`sharded_constraints_ba`:

      S (F·6 × F·6) + g̃ (F·6) + cost   = 36F² + 6F + 1   (the assembly)
      the candidate's cost               = 1

    independent of P and L. The JAX package's psum carries the landmark
    blocks too (F·42 + P·(12 + 18F) + L·(20 + 24F) + 1), because it shards
    constraints by index and every device holds a part of every landmark's
    blocks; sharding by landmark keeps them whole on one rank, so only the
    pose system crosses, at F² rather than P·F. (They are f64 here: the sum
    is formed in f64 and rounded once.)"""
    return 36 * F * F + 6 * F + 2


def collective_traffic(K: CameraIntrinsics, prob: BAProblem, mesh: Mesh, **kw) -> dict:
    """Run :func:`sharded_constraints_ba` and report what its collectives
    passed, as the reduce hook (``Mesh.sum_f64``) counted it: every call
    (tag, floats), the LM steps, and the floats of one step (assembly +
    candidate), beside the result."""
    mesh.traffic.clear()
    result = sharded_constraints_ba(K, prob, mesh, **kw)
    calls = list(mesh.traffic)
    steps = sum(tag == "assembly" for tag, _ in calls)
    per = {t: {n for tag, n in calls if tag == t} for t in ("assembly", "candidate")}
    per_step = (sum(max(v) for v in per.values() if v)
                if all(len(v) == 1 for v in per.values()) else None)
    return {"calls": calls, "lm_steps": steps, "floats_per_step": per_step,
            "floats_total": sum(n for _, n in calls),
            "bytes_total": 8 * sum(n for _, n in calls), "result": result}


def upload_windows(probs, device) -> BAProblem:
    """W problems of one capacity (numpy or tensors) → one BAProblem with a
    leading W axis on ``device``, through one host→device copy
    (``local_ba.upload_arrays``). Each window's :class:`SegmentPlan` is
    padded to the batch's widest segment with the index of its zero row (a
    zero adds nothing to an f64 sum)."""
    host = [local_ba._host_problem(p) for p in probs]
    shapes = [tuple(np.shape(a) for a in h) for h in host]
    if any(s != shapes[0] for s in shapes):
        raise ValueError("batched windows must share one capacity (equal field shapes)")
    plans = [local_ba.segment_plan(h) for h in host]
    Cp, Cl = len(host[0].p_valid), len(host[0].l_valid)
    tables = []
    for col, pad in zip(zip(*plans), (Cp, Cl, Cp, Cl, Cp, Cl)):  # SegmentPlan order
        M = max(t.shape[1] for t in col)
        tables.append(np.stack([np.pad(t, ((0, 0), (0, M - t.shape[1])), constant_values=pad)
                                for t in col]))
    fields = [np.stack([h[i] for h in host]) for i in range(local_ba._N_FIELDS)]
    out = local_ba.upload_arrays(fields + tables, device)
    return BAProblem(*out[:len(fields)], plan=SegmentPlan(*out[len(fields):]))


@torch.no_grad()
def batched_windows_ba(K: CameraIntrinsics, probs, mesh: Mesh | None = None,
                       device=None, chi2_mono: float = 50.0, chi2_stereo: float = 75.0,
                       chi2_mono_line: float = 50.0, chi2_stereo_line: float = 75.0,
                       iters1: int = 10, iters2: int = 5) -> BAResult:
    """Optimize W BA windows of one capacity in one batched solve: ``probs``
    is a list of W problems (numpy or tensors); the result's fields carry a
    leading W axis. Each window keeps its own λ and accept/reject; the chi²
    thresholds and iteration counts are ``optimize_local_map``'s. With a
    distributed ``mesh`` (W divisible by its size) each rank solves its
    block of the windows and every rank returns all W. Runs on ``device`` (default: the
    mesh's, else the first problem's tensors', else the card)."""
    probs = list(probs)
    if device is None:
        device = (mesh.device if mesh is not None
                  else probs[0].Tcw.device if torch.is_tensor(probs[0].Tcw) else "cuda")
    W = len(probs)
    sl = mesh.data_slice(W) if mesh is not None else slice(0, W)
    chi2 = (chi2_mono, chi2_stereo, chi2_mono_line, chi2_stereo_line)
    res = torch.func.vmap(lambda p: local_ba._solve(K, p, chi2, iters1, iters2))(
        upload_windows(probs[sl], device))
    if mesh is None or not mesh.distributed:
        return res
    full = torch.cat(mesh.all_gather(_pack_windows(res)))
    F, P, L = res.Tcw.shape[1], res.points.shape[1], res.lines.shape[1]
    Cp, Cl = res.p_inlier.shape[1], res.l_inlier.shape[1]
    o = np.cumsum([0, 16 * F, 3 * P, 6 * L, Cp, Cl, 1])
    return BAResult(Tcw=full[:, o[0]:o[1]].view(W, F, 4, 4),
                    points=full[:, o[1]:o[2]].view(W, P, 3),
                    lines=full[:, o[2]:o[3]].view(W, L, 6),
                    p_inlier=full[:, o[3]:o[4]] > 0.5, l_inlier=full[:, o[4]:o[5]] > 0.5,
                    cost=full[:, o[5]])


def _pack_windows(res: BAResult) -> torch.Tensor:
    """(W, ·) rows, one per window: [Tcw, points, lines, inliers, cost] in
    f32, the layout ``local_ba.unpack_result`` reads."""
    W = res.Tcw.shape[0]
    return torch.cat([f.reshape(W, -1).to(torch.float32)
                      for f in (res.Tcw, res.points, res.lines, res.p_inlier,
                                res.l_inlier, res.cost[:, None])], 1)


def fetch_windows(res: BAResult) -> list[BAResult]:
    """A batched device result → one BAResult of numpy arrays per window,
    through one device→host copy."""
    rows = _pack_windows(res).cpu().numpy()
    dims = (res.Tcw.shape[1], res.points.shape[1], res.lines.shape[1],
            res.p_inlier.shape[1], res.l_inlier.shape[1])
    return [local_ba.unpack_result(row, dims) for row in rows]
