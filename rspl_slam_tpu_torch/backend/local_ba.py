"""Local bundle adjustment (port of backend/local_ba.py): Levenberg–Marquardt
with an explicit Schur-complement reduction over the marginalized landmarks.

The semantics are the JAX package's (after the reference's
LocalmapOptimization, g2o_optimization.cc:21-252):

- vertices: poses as Tcw (fixed flags honored), points marginalized, lines
  marginalized with the 4-DoF orthonormal update;
- constraints: mono point (2-d), stereo point (3-d), mono line (2-d, info
  0.1·I), stereo line (4-d, info 0.1·I), Huber δ = √(class chi² threshold);
- schedule: 10 LM iterations → chi²/depth gate → robust kernels dropped →
  5 iterations → final inlier flags;
- f32 throughout, as the JAX package runs it (x64 off), with its f32
  guards: step clips (poses ±10, points ±50, lines ±10), no candidate with
  a non-finite cost or step is accepted, chi² ceiling 1e12, cheirality
  violations priced at the gate, λ ∈ [1e-8, 1e8], +1e-8·I on every damped
  block.

Where the design differs from the JAX package:

- every per-constraint sum is a gather of each segment's rows followed by
  a sum over them in f64, rounded once to f32, in an order fixed per
  window, where JAX runs a one-hot matmul (f64 accumulation lands on
  JAX's f32 path where f32 sums in another order left it; PERF.md §6):
  a window's constraint indices do not change between iterations,
  so ``upload_problem`` lays each index vector out once on the host
  (:class:`SegmentPlan`: per segment its valid rows in ascending order,
  padded with a zero row) and rides it on the problem's one copy. The W
  tensors (P, F, 6, 3) and (L, F, 6, 4) are summed over the flat index
  landmark·F + pose. Invalid rows (weight 0) are left out of the sums. So
  the same window gives the same bits on every run, on the card as on
  the CPU (an ``index_add_`` adds CUDA atomics in no fixed order);
- the line Jacobians are analytic (the derivative of the orthonormal chart
  and of the left pose perturbation at zero) where JAX runs ``jacfwd``;
- nothing in the LM loop synchronizes the host: accept/reject, λ and the
  carried cost stay tensors updated with ``torch.where``. The problem goes
  up in one host→device copy (``upload_problem``) and the result comes back
  in one (``fetch_result``, or ``fetch_result_async`` into pinned memory).

Distributed BA (``axis_name``: a ``parallel.mesh.Mesh``) shards the
problem BY LANDMARK, where the JAX package shards
its constraints by index: each rank holds every pose, its own points and
lines (:func:`landmark_partition`, balanced on constraint counts) and the
constraints on them, so the landmark blocks (Hxx, gx, Wx, Hll, gl, Wl), their
inverses and the back-substitution stay on the rank. Per LM step only the
rank's part of the reduced camera system S (F·6 × F·6), of g̃ (F·6) and of
the cost cross ranks, summed in f64 in rank order (``Mesh.sum_f64``), and
the candidate's cost; damping is linear in H, so each rank damps its own
Hpp part and the 1e-8·I is added once after the sum. One all-gather at the
end puts the points, lines and inlier flags back in the problem's order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rspl_slam_tpu_torch.backend import residuals as res
from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
from rspl_slam_tpu_torch.geometry import linalg as glin
from rspl_slam_tpu_torch.geometry import plucker, se3

__all__ = ["BAProblem", "BAResult", "SegmentPlan", "optimize_local_map", "upload_problem",
           "segment_plan", "fetch_result", "fetch_result_async", "unpack_result",
           "robust_objective", "landmark_partition", "upload_arrays",
           "reduced_camera_system"]


class SegmentPlan(NamedTuple):
    """Each segment sum's rows, fixed for a window: row s of a table lists
    the constraint rows of segment s in ascending order, padded with the
    constraint count (the index of an appended zero row)."""

    p_pose: torch.Tensor  # (F, M) point constraints of each pose
    l_pose: torch.Tensor  # (F, M) line constraints of each pose
    p_point: torch.Tensor  # (P, M) constraints of each point
    l_line: torch.Tensor  # (L, M) constraints of each line
    p_cross: torch.Tensor  # (P·F, M) point constraints of each (point, pose)
    l_cross: torch.Tensor  # (L·F, M) line constraints of each (line, pose)


class BAProblem(NamedTuple):
    """Fixed-shape BA window. All index arrays point into the window-local
    pose/point/line slots; invalid entries have index 0 and valid=False."""

    Tcw: torch.Tensor  # (F, 4, 4) camera-from-world
    pose_fixed: torch.Tensor  # (F,) bool (includes padding slots)
    points: torch.Tensor  # (P, 3)
    lines: torch.Tensor  # (L, 6) Plücker (world)
    p_pose: torch.Tensor  # (Cp,) int
    p_point: torch.Tensor  # (Cp,) int
    p_meas: torch.Tensor  # (Cp, 3) [uL, vL, uR]
    p_stereo: torch.Tensor  # (Cp,) bool
    p_valid: torch.Tensor  # (Cp,) bool
    l_pose: torch.Tensor  # (Cl,) int
    l_line: torch.Tensor  # (Cl,) int
    l_eps: torch.Tensor  # (Cl, 2, 2) observed left endpoints
    l_eps_r: torch.Tensor  # (Cl, 2, 2) observed right endpoints
    l_stereo: torch.Tensor  # (Cl,) bool
    l_valid: torch.Tensor  # (Cl,) bool
    plan: SegmentPlan | None = None  # set by upload_problem


_N_FIELDS = 15  # the problem's arrays (every field but ``plan``)


class BAResult(NamedTuple):
    Tcw: torch.Tensor  # (F, 4, 4)
    points: torch.Tensor  # (P, 3)
    lines: torch.Tensor  # (L, 6)
    p_inlier: torch.Tensor  # (Cp,) bool
    l_inlier: torch.Tensor  # (Cl,) bool
    cost: torch.Tensor  # () final robust cost


_LINE_INFO = 0.1  # line information scale (g2o_optimization.cc:138, 162)


def _rows_by_segment(idx: np.ndarray, keep: np.ndarray, n: int) -> np.ndarray:
    """(n, M) table of the kept rows of each segment of ``idx``, ascending
    (a stable sort), padded with ``len(idx)``."""
    rows = np.nonzero(keep)[0]
    seg = idx[rows]
    order = np.argsort(seg, kind="stable")
    rows, seg = rows[order], seg[order]
    counts = np.bincount(seg, minlength=n)
    starts = np.cumsum(counts) - counts
    table = np.full((n, max(int(counts.max(initial=0)), 1)), len(idx), np.int64)
    table[seg, np.arange(len(rows)) - starts[seg]] = rows
    return table


def segment_plan(prob) -> SegmentPlan:
    """The :class:`SegmentPlan` of a problem of numpy arrays (on the
    host)."""
    F, P, L = len(prob.Tcw), len(prob.points), len(prob.lines)
    pv, lv = np.asarray(prob.p_valid, bool), np.asarray(prob.l_valid, bool)
    pp, px = np.asarray(prob.p_pose, np.int64), np.asarray(prob.p_point, np.int64)
    lp, ll = np.asarray(prob.l_pose, np.int64), np.asarray(prob.l_line, np.int64)
    return SegmentPlan(
        p_pose=_rows_by_segment(pp, pv, F), l_pose=_rows_by_segment(lp, lv, F),
        p_point=_rows_by_segment(px, pv, P), l_line=_rows_by_segment(ll, lv, L),
        p_cross=_rows_by_segment(px * F + pp, pv, P * F),
        l_cross=_rows_by_segment(ll * F + lp, lv, L * F))


def upload_problem(prob, device) -> BAProblem:
    """A BAProblem of numpy arrays → tensors on ``device`` (floats f32,
    indices int64, flags bool) with its :class:`SegmentPlan`, through ONE
    host→device copy (:func:`upload_arrays`)."""
    arrs = [np.asarray(a) for a in tuple(prob)[:_N_FIELDS]]
    plan = segment_plan(BAProblem(*arrs))
    out = upload_arrays(arrs + list(plan), device)
    return BAProblem(*out[:_N_FIELDS], plan=SegmentPlan(*out[_N_FIELDS:]))


def upload_arrays(arrs, device) -> list[torch.Tensor]:
    """Numpy arrays → tensors on ``device`` (floats f32, indices int64,
    flags bool) through ONE host→device copy: every array is packed into
    one f32 buffer (indices below 2^24 are exact in f32); on a CUDA device
    the buffer is pinned and copied ``non_blocking`` on the current stream,
    so the upload never waits for the device."""
    if max(max(a.shape, default=0) for a in arrs) >= 1 << 24:
        raise ValueError("BA window slots must stay below 2^24 (f32-packed indices)")
    buf = torch.from_numpy(np.concatenate([a.astype(np.float32).ravel() for a in arrs]))
    device = torch.device(device)
    buf = (buf.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
           else buf.to(device))
    out, o = [], 0
    for a in arrs:
        t = buf[o: o + a.size].view(a.shape)
        o += a.size
        if a.dtype == np.bool_:
            t = t > 0.5
        elif np.issubdtype(a.dtype, np.integer):
            t = t.long()
        out.append(t)
    return out


def _segment_sum(rows, terms):
    """Σ of ``terms`` rows into segments by a :class:`SegmentPlan` table:
    each segment's rows gathered, then summed over in f64 in a fixed order
    and rounded once to the terms' type."""
    padded = torch.cat([terms, terms.new_zeros((1,) + terms.shape[1:])])
    return padded[rows].sum(1, dtype=torch.float64).to(terms.dtype)


def _point_terms(K, Tcw_all, points, prob: BAProblem):
    """Residuals + Jacobians of every point constraint: r (Cp, 3), z (Cp,),
    Jp (Cp, 3, 6), Jx (Cp, 3, 3)."""
    T = Tcw_all[prob.p_pose]
    X = points[prob.p_point][:, None]
    st = prob.p_stereo[:, None]
    r, z = res.point_residual(K, T, X, prob.p_meas[:, None], st)
    Jp = res.point_pose_jacobian(K, T, X, st)
    Jx = res.point_landmark_jacobian(K, T, X, st)
    return r[:, 0], z[:, 0], Jp[:, 0], Jx[:, 0]


def _baseline_cross(x, b: float):
    """(−b, 0, 0) × x for x (..., 3) or column-wise for (..., 3, D): the
    moment the right camera (displaced by the baseline) adds."""
    x0, x1, x2 = x[..., 0, :], x[..., 1, :], x[..., 2, :]
    return torch.stack([torch.zeros_like(x0), b * x2, -b * x1], -2)


def _line_terms(K, Tcw_all, lines, prob: BAProblem):
    """Residuals + Jacobians of every line constraint: r (Cl, 4), Jp
    (Cl, 4, 6) with respect to the left pose perturbation, Jl (Cl, 4, 4)
    with respect to the 4-DoF orthonormal delta at zero (the chart of
    VertexLine3D::oplusImpl), both analytic: U ← U·exp([δθ]×) moves
    n = w1·u1 and d = w2·u2 by U·(δθ × e_i), W ← W·rot2(δφ) by (−w2, w1)·δφ;
    exp(ξ)·T moves the camera-frame line by n' = n + ω×n + v×d,
    d' = d + ω×d."""
    T = Tcw_all[prob.l_pose]
    U, W = plucker.orthonormal_from_plucker(lines[prob.l_line])
    u1, u2, u3 = U[..., 0], U[..., 1], U[..., 2]
    w1, w2 = W[..., 0, 0, None], W[..., 1, 0, None]
    zero = torch.zeros_like(u1)
    # ∂(n, d)/∂(δθ, δφ) in the world frame, (Cl, 3, 4) each
    dn = torch.stack([zero, -w1 * u3, w1 * u2, -w2 * u1], -1)
    dd = torch.stack([w2 * u3, zero, -w2 * u1, w1 * u2], -1)
    Lc = plucker.transform(T, torch.cat([w1 * u1, w2 * u2], -1))  # δ = 0 point
    nc, dc = Lc[..., :3], Lc[..., 3:]
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rdd = R @ dd
    hat_d = se3.hat(dc)
    # ∂n_cam, ∂d_cam over (ξ, δ): (Cl, 3, 10)
    Jn = torch.cat([-se3.hat(nc), -hat_d, R @ dn + se3.hat(t) @ Rdd], -1)
    Jd = torch.cat([-hat_d, torch.zeros_like(hat_d), Rdd], -1)
    b = K.bf / K.fx
    rows, rs = [], []
    for n, J, eps in ((nc, Jn, prob.l_eps),
                      (nc + _baseline_cross(dc[..., None], b)[..., 0],
                       Jn + _baseline_cross(Jd, b), prob.l_eps_r)):
        a, bb = K.fy * n[..., 0], K.fx * n[..., 1]
        c = -K.cx * K.fy * n[..., 0] - K.fx * K.cy * n[..., 1] + K.fx * K.fy * n[..., 2]
        q = a * a + bb * bb
        s = torch.sqrt(q.clamp_min(1e-12))[..., None]  # (Cl, 1)
        u, v = eps[..., 0], eps[..., 1]  # (Cl, 2) per endpoint
        e = a[..., None] * u + bb[..., None] * v + c[..., None]
        rs.append(e / s)
        # ∂dist/∂(a, b, c), then through (a, b, c) = K_line · n
        k = e * (q > 1e-12).to(e.dtype)[..., None] / (s * s * s)
        ga = u / s - k * a[..., None]
        gb = v / s - k * bb[..., None]
        gc = 1.0 / s.expand_as(ga)
        gn = torch.stack([K.fy * (ga - K.cx * gc), K.fx * (gb - K.cy * gc),
                          K.fx * K.fy * gc], -1)  # (Cl, 2, 3)
        rows.append(gn @ J)
    st = prob.l_stereo.to(lines.dtype)[:, None]
    r = torch.cat([rs[0], rs[1] * st], -1)
    J = torch.cat([rows[0], rows[1] * st[..., None]], -2)
    return r, J[..., :6], J[..., 6:]


def _robust_weights(r, info, delta, active):
    """Per-constraint IRLS weight: info · huber'(chi2) · active."""
    chi2 = info * (r * r).sum(-1)
    w = res.huber_weight(chi2, delta)
    return torch.where(active, info * w, 0.0), chi2


def _damped(H, lam):
    """H + λ·diag(H) + 1e-8·I on a batch of square blocks."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + torch.diag_embed(lam * torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-8 * eye


def _finite_or_zero(inv):
    """A landmark block whose closed-form inverse is not finite drops out of
    the reduction (inverse 0). A mono point microns in front of a camera
    has Hxx ~ 1e13, whose 3×3 determinant overflows f32 in terms of both
    signs: IEEE arithmetic makes it NaN, and the NaN would reach every
    step of the window, so that the finite check rejected them all; the
    JAX package's compiled (XLA) inverse evaluates that determinant to ±inf
    and the inverse to 0. The port keeps the JAX package's result."""
    return torch.where(torch.isfinite(inv), inv, 0.0)


def _device_plan(prob):
    """The plan of a problem built without :func:`upload_problem`, on its
    device (its indices go down to the host once)."""
    return SegmentPlan(*[torch.as_tensor(t, device=prob.Tcw.device)
                         for t in segment_plan(_host_problem(prob))])


def _block_diagonal(blocks):
    """(F, 6, 6) blocks → the (F, 6, F, 6) block-diagonal matrix."""
    F = blocks.shape[0]
    eye = torch.eye(F, dtype=blocks.dtype, device=blocks.device)
    return blocks[:, :, None, :] * eye[:, None, :, None]


def _all_sum(mesh, tag, x):
    """``x`` summed over the mesh's ranks (itself without a mesh)."""
    return x if mesh is None else mesh.sum_f64(tag, x)[0]


def _build_and_solve(K, Tcw, points, lines, prob, p_active, l_active,
                     use_huber, deltas, lam, mesh=None):
    """One LM step: assemble the Schur-reduced camera system, solve it and
    back-substitute. Returns (dp (F, 6), dx (P, 3), dl (L, 4), cost).
    With ``mesh``, ``prob`` holds this rank's landmarks: its parts of S, g̃
    and the cost are summed over the ranks before the solve."""
    S, gtilde, cost, back = _reduced_system(K, Tcw, points, lines, prob, p_active, l_active,
                                            use_huber, deltas, lam, mesh)
    F, dtype = Tcw.shape[0], Tcw.dtype
    Hxx_inv, Hll_inv, Wx, Wl, gx, gl = back

    # --- fixed poses: identity rows/cols, zero rhs --------------------------
    free = (~prob.pose_fixed).to(dtype)
    S = S * (free[:, None, None, None] * free[None, None, :, None])
    S = S + _block_diagonal((1.0 - free)[:, None, None]
                            * torch.eye(6, dtype=dtype, device=S.device))
    gtilde = gtilde * free[:, None]
    dp = -glin.solve_spd(S.reshape(F * 6, F * 6), gtilde.reshape(F * 6)).reshape(F, 6)
    dp = dp * free[:, None]

    # --- back-substitute landmarks: δx = −Hxx⁻¹ (gx + Wxᵀ δp) ---------------
    dx = -(Hxx_inv @ (gx + torch.einsum("pfij,fi->pj", Wx, dp))[..., None])[..., 0]
    dl = -(Hll_inv @ (gl + torch.einsum("lfij,fi->lj", Wl, dp))[..., None])[..., 0]
    return dp, dx, dl, cost


def _reduced_system(K, Tcw, points, lines, prob, p_active, l_active, use_huber, deltas,
                    lam, mesh=None):
    """The damped Schur-reduced camera system of one LM step, before the
    fixed poses are pinned: (S (F, 6, F, 6), g̃ (F, 6), cost, the landmark
    blocks back-substitution needs). With ``mesh``, S, g̃ and the cost are
    the sums over the ranks."""
    F, P, L = Tcw.shape[0], points.shape[0], lines.shape[0]
    dtype = Tcw.dtype
    d_p, d_sp, d_l, d_sl = deltas

    rp, z, Jp_p, Jx = _point_terms(K, Tcw, points, prob)
    rl, Jp_l, Jl = _line_terms(K, Tcw, lines, prob)

    p_ok = p_active & (z > 1e-6)
    delta_p = torch.where(prob.p_stereo, d_sp, d_p)
    wp, chi2_p = _robust_weights(rp, 1.0, delta_p if use_huber else 1e9, p_ok)
    delta_l = torch.where(prob.l_stereo, d_sl, d_l)
    wl, chi2_l = _robust_weights(rl, _LINE_INFO, delta_l if use_huber else 1e9, l_active)

    # --- assemble blocks (fixed-order segment sums over the constraints) ---
    plan = prob.plan
    JpW_p = Jp_p * wp[:, None, None]
    JpW_l = Jp_l * wl[:, None, None]
    Hpp = (_segment_sum(plan.p_pose, JpW_p.mT @ Jp_p)
           + _segment_sum(plan.l_pose, JpW_l.mT @ Jp_l))
    gp = (_segment_sum(plan.p_pose, (JpW_p.mT @ rp[..., None])[..., 0])
          + _segment_sum(plan.l_pose, (JpW_l.mT @ rl[..., None])[..., 0]))
    JxW = Jx * wp[:, None, None]
    Hxx = _segment_sum(plan.p_point, JxW.mT @ Jx)
    gx = _segment_sum(plan.p_point, (JxW.mT @ rp[..., None])[..., 0])
    JlW = Jl * wl[:, None, None]
    Hll = _segment_sum(plan.l_line, JlW.mT @ Jl)
    gl = _segment_sum(plan.l_line, (JlW.mT @ rl[..., None])[..., 0])
    # cross terms: W tensors (landmark, pose, 6, dl) over landmark·F + pose
    Wx = _segment_sum(plan.p_cross, JpW_p.mT @ Jx).view(P, F, 6, 3)
    Wl = _segment_sum(plan.l_cross, JpW_l.mT @ Jl).view(L, F, 6, 4)

    # --- damp landmark blocks and invert (closed-form 3×3 / 4×4) -----------
    Hxx_inv = _finite_or_zero(glin.inv3(_damped(Hxx, lam)))
    Hll_inv = _finite_or_zero(glin.inv4_spd(_damped(Hll, lam)))

    # --- Schur complement over points and lines -----------------------------
    # S = Hpp_blockdiag − Σ_x Wx Hxx⁻¹ Wxᵀ − Σ_l Wl Hll⁻¹ Wlᵀ  (F, 6, F, 6)
    WxD = Wx @ Hxx_inv[:, None]
    WlD = Wl @ Hll_inv[:, None]
    if mesh is None:
        Hpp_d = _damped(Hpp, lam)
    else:  # λ·diag is linear in H: each rank damps its part, 1e-8·I comes once
        Hpp_d = Hpp + torch.diag_embed(lam * torch.diagonal(Hpp, dim1=-2, dim2=-1))
    S = (_block_diagonal(Hpp_d)
         - torch.einsum("pfik,pgjk->figj", WxD, Wx)
         - torch.einsum("lfik,lgjk->figj", WlD, Wl))
    # reduced gradient: g̃p = gp − Wx Hxx⁻¹ gx − Wl Hll⁻¹ gl
    gtilde = (gp - torch.einsum("pfik,pk->fi", WxD, gx)
              - torch.einsum("lfik,lk->fi", WlD, gl))
    cost = ((_huber_rho(chi2_p, delta_p) * p_ok).sum()
            + (_huber_rho(chi2_l, delta_l) * l_active).sum())
    if mesh is not None:
        S, gtilde, cost = mesh.sum_f64("assembly", S, gtilde, cost)
        S = S + _block_diagonal(1e-8 * torch.eye(6, dtype=dtype, device=S.device).expand(F, 6, 6))
    return S, gtilde, cost, (Hxx_inv, Hll_inv, Wx, Wl, gx, gl)


def _huber_rho(chi2, delta):
    """Huber cost ρ(s) with threshold δ (g2o RobustKernelHuber::robustify)."""
    e = torch.sqrt(chi2.clamp_min(1e-12))
    return torch.where(e <= delta, chi2, 2.0 * delta * e - delta * delta)


def _total_cost(K, Tcw, points, lines, prob, p_active, l_active, deltas, use_huber):
    """Robust cost + per-constraint chi² and depth: (cost, chi2_p, chi2_l, z)."""
    d_p, d_sp, d_l, d_sl = deltas
    rp, z = res.point_residual(K, Tcw[prob.p_pose], points[prob.p_point][:, None],
                               prob.p_meas[:, None], prob.p_stereo[:, None])
    rp, z = rp[:, 0], z[:, 0]
    # finite ceiling: an f32-overflowed chi² (inf) would propagate NaN
    # through masked sums (inf·0 = NaN) and poison the LM accept test
    chi2_p = (rp * rp).sum(-1).clamp(max=1e12)
    rl = res.line_residual(K, Tcw[prob.l_pose], lines[prob.l_line][:, None],
                           prob.l_eps[:, None], prob.l_eps_r[:, None],
                           prob.l_stereo[:, None])[:, 0]
    chi2_l = (_LINE_INFO * (rl * rl).sum(-1)).clamp(max=1e12)
    delta_p = torch.where(prob.p_stereo, d_sp, d_p)
    delta_l = torch.where(prob.l_stereo, d_sl, d_l)
    ok_p = p_active & (z > 1e-6)
    cp = _huber_rho(chi2_p, delta_p) if use_huber else chi2_p
    cl = _huber_rho(chi2_l, delta_l) if use_huber else chi2_l
    # cheirality violations (active constraint, non-positive depth) cost
    # their chi² gate value rather than dropping out: a candidate that throws
    # ALL its points behind the camera would otherwise mask to cost 0 and be
    # accepted; where() (not multiply) keeps inf·0 from minting NaN
    bad_p = (p_active & ~ok_p).to(Tcw.dtype)
    cost = (torch.where(ok_p, cp, 0.0).sum() + torch.where(l_active, cl, 0.0).sum()
            + (bad_p * delta_p * delta_p).sum())
    return cost, chi2_p, chi2_l, z


def _lm_phase(K, state, prob, p_active, l_active, deltas, use_huber, iters, mesh=None):
    Tcw, points, lines, lam = state
    # cost of the incoming state, carried across iterations so each LM step
    # evaluates the objective once (at the candidate)
    cost, *_ = _total_cost(K, Tcw, points, lines, prob, p_active, l_active,
                           deltas, use_huber)
    cost = _all_sum(mesh, "cost", cost)
    for _ in range(iters):
        dp, dx, dl, _ = _build_and_solve(K, Tcw, points, lines, prob, p_active,
                                         l_active, use_huber, deltas, lam, mesh)
        # f32 trust region: a near-singular Schur solve can emit a huge (or
        # non-finite) step whose candidate still masks to a finite cost;
        # clamp steps to generous physical bounds and never accept a
        # non-finite candidate
        dp = dp.clamp(-10.0, 10.0)
        dx = dx.clamp(-50.0, 50.0)
        dl = dl.clamp(-10.0, 10.0)
        Tcw_new = se3.exp_se3(dp) @ Tcw
        points_new = points + dx
        lines_new = plucker.orthonormal_update(lines, dl)
        cost_new, *_ = _total_cost(K, Tcw_new, points_new, lines_new, prob, p_active,
                                   l_active, deltas, use_huber)
        if mesh is not None:
            # a rank whose landmark step is not finite makes the summed
            # candidate cost NaN, so every rank rejects the step
            ok = torch.isfinite(torch.cat([dx.reshape(-1), dl.reshape(-1)])).all()
            cost_new = _all_sum(mesh, "candidate", torch.where(ok, cost_new, torch.nan))
        finite = torch.isfinite(torch.cat([cost_new[None], dp.reshape(-1),
                                           dx.reshape(-1), dl.reshape(-1)])).all()
        accept = (cost_new < cost) & finite
        Tcw = torch.where(accept, Tcw_new, Tcw)
        points = torch.where(accept, points_new, points)
        lines = torch.where(accept, lines_new, lines)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-8, 1e8)
    return Tcw, points, lines


@torch.no_grad()
def optimize_local_map(K: CameraIntrinsics, prob: BAProblem,
                       chi2_mono: float = 50.0, chi2_stereo: float = 75.0,
                       chi2_mono_line: float = 50.0, chi2_stereo_line: float = 75.0,
                       iters1: int = 10, iters2: int = 5,
                       axis_name=None) -> BAResult:
    """Full local BA with the reference's 10 → gate → 5 schedule, on the
    device of ``prob``'s tensors, queued without a host synchronization.

    ``axis_name`` (a ``parallel.mesh.Mesh``) solves the same problem
    sharded by landmark over the mesh's ranks (module docstring): every
    rank passes the whole problem (numpy or tensors) and gets the whole
    result on the mesh's device; its indices and values go to the host
    once for :func:`landmark_partition`. A mesh of one process solves
    there, unsharded. Anything else, a name such as ``"data"`` included,
    raises ValueError: a process group's mesh is ``make_mesh()`` after
    ``parallel.multihost.initialize``."""
    chi2 = (chi2_mono, chi2_stereo, chi2_mono_line, chi2_stereo_line)
    if axis_name is not None:
        from rspl_slam_tpu_torch.parallel.mesh import Mesh

        if not isinstance(axis_name, Mesh):
            raise ValueError(
                f"axis_name takes a rspl_slam_tpu_torch.parallel.mesh.Mesh (make_mesh() "
                f"after parallel.multihost.initialize()), got {axis_name!r}")
        if axis_name.distributed:
            return _solve_sharded(K, prob, axis_name, chi2, iters1, iters2)
        if not torch.is_tensor(prob.Tcw):
            prob = upload_problem(prob, axis_name.device)
    if prob.plan is None:
        prob = prob._replace(plan=_device_plan(prob))
    return _solve(K, prob, chi2, iters1, iters2)


def _solve(K, prob, chi2, iters1, iters2, mesh=None) -> BAResult:
    """The two-phase schedule; with ``mesh``, on this rank's landmarks."""
    chi2_mono, chi2_stereo, chi2_mono_line, chi2_stereo_line = chi2
    deltas = tuple(math.sqrt(c) for c in chi2)
    thr_p = torch.where(prob.p_stereo, chi2_stereo, chi2_mono)
    thr_l = torch.where(prob.l_stereo, chi2_stereo_line, chi2_mono_line)
    lam0 = torch.full((), 1e-4, dtype=prob.Tcw.dtype, device=prob.Tcw.device)
    # phase 1: robust kernels on, all valid constraints active
    Tcw, points, lines = _lm_phase(K, (prob.Tcw, prob.points, prob.lines, lam0), prob,
                                   prob.p_valid, prob.l_valid, deltas, True, iters1, mesh)
    # gate (chi² + positive depth), kernels dropped
    _, chi2_p, chi2_l, z = _total_cost(K, Tcw, points, lines, prob, prob.p_valid,
                                       prob.l_valid, deltas, False)
    p_active = prob.p_valid & (chi2_p <= thr_p) & (z > 1e-6)
    l_active = prob.l_valid & (chi2_l <= thr_l)
    # phase 2: plain quadratic on inliers
    Tcw, points, lines = _lm_phase(K, (Tcw, points, lines, lam0), prob, p_active,
                                   l_active, deltas, False, iters2, mesh)
    # final inlier flags
    cost, chi2_p, chi2_l, z = _total_cost(K, Tcw, points, lines, prob, p_active,
                                          l_active, deltas, False)
    return BAResult(Tcw=Tcw, points=points, lines=lines,
                    p_inlier=prob.p_valid & (chi2_p <= thr_p) & (z > 1e-6),
                    l_inlier=prob.l_valid & (chi2_l <= thr_l),
                    cost=_all_sum(mesh, "cost", cost))


@torch.no_grad()
def reduced_camera_system(K: CameraIntrinsics, prob: BAProblem, mesh=None, dtype=None,
                          chi2_mono: float = 50.0, chi2_stereo: float = 75.0,
                          chi2_mono_line: float = 50.0, chi2_stereo_line: float = 75.0):
    """The first LM step's damped reduced camera system at ``prob``'s own
    state (Huber on every valid constraint, λ = 1e-4), fixed poses not yet
    pinned: (S (F·6, F·6), g̃ (F·6,), cost), assembled in ``dtype`` (default
    the problem's). With a distributed ``mesh`` (``prob`` numpy or tensors,
    the same on every rank) each rank assembles the part of its landmarks,
    as the sharded solve does, and every rank gets the sums on the mesh's
    device: what the sharded and the single solve agree on up to summation
    order, before the LM's accept decisions and the chi² gate can carry a
    rounding difference further."""
    deltas = tuple(math.sqrt(c) for c in (chi2_mono, chi2_stereo, chi2_mono_line,
                                          chi2_stereo_line))
    if mesh is not None and not mesh.distributed:
        mesh = None
    if mesh is not None:
        host = _host_problem(prob)
        pts, lns = landmark_partition(host, mesh.size)[mesh.rank]
        prob = upload_problem(_shard_problem(host, pts, lns)[0], mesh.device)
    elif prob.plan is None:
        prob = prob._replace(plan=_device_plan(prob))
    if dtype is not None:
        prob = prob._replace(**{f: v.to(dtype) for f, v in zip(BAProblem._fields, prob)
                                if torch.is_tensor(v) and v.is_floating_point()})
    lam = torch.full((), 1e-4, dtype=prob.Tcw.dtype, device=prob.Tcw.device)
    S, gtilde, cost, _ = _reduced_system(K, prob.Tcw, prob.points, prob.lines, prob,
                                         prob.p_valid, prob.l_valid, True, deltas, lam, mesh)
    F = prob.Tcw.shape[0]
    return S.reshape(F * 6, F * 6), gtilde.reshape(F * 6), cost


def _host_problem(prob) -> BAProblem:
    """A problem's fields as numpy arrays (one copy each from a device)."""
    return BAProblem(*[a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
                       for a in tuple(prob)[:_N_FIELDS]])


def landmark_partition(prob, world: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Each rank's (point slots, line slots), ascending: every landmark goes
    whole to one rank, the landmarks taken by falling count of valid
    constraints, each to the rank with the fewest constraints so far (the
    lowest rank on a tie). The same problem gives every rank the same
    partition."""
    prob = _host_problem(prob)
    P, L = len(prob.points), len(prob.lines)
    counts = np.concatenate([
        np.bincount(np.asarray(prob.p_point, np.int64)[np.asarray(prob.p_valid, bool)],
                    minlength=P),
        np.bincount(np.asarray(prob.l_line, np.int64)[np.asarray(prob.l_valid, bool)],
                    minlength=L)])
    load = np.zeros(world, np.int64)
    owner = np.empty(P + L, np.int64)
    for i in np.argsort(-counts, kind="stable"):
        r = int(np.argmin(load))
        owner[i] = r
        load[r] += counts[i]
    return [(np.nonzero(owner[:P] == r)[0], np.nonzero(owner[P:] == r)[0])
            for r in range(world)]


def _shard_problem(prob, points: np.ndarray, lines: np.ndarray):
    """The sub-problem of the landmark slots ``points`` / ``lines``: every
    pose, those landmarks renumbered in the given order, and the
    constraints on them (invalid rows with the landmark they point at), in
    their original order. Returns (BAProblem of numpy arrays, point rows,
    line rows)."""
    prob = _host_problem(prob)
    pmap = np.full(len(prob.points), -1, np.int64)
    pmap[points] = np.arange(len(points))
    lmap = np.full(len(prob.lines), -1, np.int64)
    lmap[lines] = np.arange(len(lines))
    p_idx = pmap[np.asarray(prob.p_point, np.int64)]
    l_idx = lmap[np.asarray(prob.l_line, np.int64)]
    p_rows, l_rows = np.nonzero(p_idx >= 0)[0], np.nonzero(l_idx >= 0)[0]
    sub = prob._replace(
        points=prob.points[points], lines=prob.lines[lines],
        p_pose=prob.p_pose[p_rows], p_point=p_idx[p_rows], p_meas=prob.p_meas[p_rows],
        p_stereo=prob.p_stereo[p_rows], p_valid=prob.p_valid[p_rows],
        l_pose=prob.l_pose[l_rows], l_line=l_idx[l_rows], l_eps=prob.l_eps[l_rows],
        l_eps_r=prob.l_eps_r[l_rows], l_stereo=prob.l_stereo[l_rows],
        l_valid=prob.l_valid[l_rows])
    return sub, p_rows, l_rows


def _solve_sharded(K, prob, mesh, chi2, iters1, iters2) -> BAResult:
    """This rank's landmarks solved against every rank's (S, g̃ and the
    costs summed over the mesh), then one all-gather of the packed points,
    lines and inlier flags, scattered back into the problem's order, on
    the mesh's device."""
    host = _host_problem(prob)
    device = mesh.device
    slots = landmark_partition(host, mesh.size)
    parts = [_shard_problem(host, pts, lns) for pts, lns in slots]
    res = _solve(K, upload_problem(parts[mesh.rank][0], device), chi2, iters1, iters2, mesh)
    dt = res.points.dtype
    packed = torch.cat([res.points.reshape(-1), res.lines.reshape(-1).to(dt),
                        res.p_inlier.to(dt), res.l_inlier.to(dt)])
    sizes = [3 * len(s.points) + 6 * len(s.lines) + len(pr) + len(lr) for s, pr, lr in parts]
    width = max(sizes)
    packed = torch.cat([packed, packed.new_zeros(width - packed.numel())])
    gathered = mesh.all_gather(packed)
    P, L = len(host.points), len(host.lines)
    points = torch.empty((P, 3), dtype=res.points.dtype, device=device)
    lines = torch.empty((L, 6), dtype=res.lines.dtype, device=device)
    p_inl = torch.empty(len(host.p_valid), dtype=torch.bool, device=device)
    l_inl = torch.empty(len(host.l_valid), dtype=torch.bool, device=device)
    for (_, p_rows, l_rows), (pts, lns), buf in zip(parts, slots, gathered):
        p_n, l_n = len(pts), len(lns)
        o = np.cumsum([0, 3 * p_n, 6 * l_n, len(p_rows), len(l_rows)])
        idx = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        points[idx(pts)] = buf[o[0]: o[1]].view(p_n, 3).to(points.dtype)
        lines[idx(lns)] = buf[o[1]: o[2]].view(l_n, 6).to(lines.dtype)
        p_inl[idx(p_rows)] = buf[o[2]: o[3]] > 0.5
        l_inl[idx(l_rows)] = buf[o[3]: o[4]] > 0.5
    return BAResult(Tcw=res.Tcw, points=points, lines=lines, p_inlier=p_inl,
                    l_inlier=l_inl, cost=res.cost)


@torch.no_grad()
def robust_objective(K: CameraIntrinsics, prob: BAProblem, result: BAResult | None = None,
                     chi2_mono: float = 50.0, chi2_stereo: float = 75.0,
                     chi2_mono_line: float = 50.0, chi2_stereo_line: float = 75.0):
    """Phase 1's objective (Huber, every valid constraint, cheirality
    violations at the gate) at the problem's own state or, with
    ``result``, at the solved one: a 0-d tensor, no host synchronization."""
    deltas = tuple(math.sqrt(c) for c in (chi2_mono, chi2_stereo, chi2_mono_line,
                                          chi2_stereo_line))
    state = prob if result is None else result
    return _total_cost(K, state.Tcw, state.points, state.lines, prob, prob.p_valid,
                       prob.l_valid, deltas, True)[0]


def _pack_result(r: BAResult) -> torch.Tensor:
    """The whole result as one f32 vector: one device→host copy."""
    f = torch.float32
    return torch.cat([r.Tcw.reshape(-1).to(f), r.points.reshape(-1).to(f),
                      r.lines.reshape(-1).to(f), r.p_inlier.to(f), r.l_inlier.to(f),
                      r.cost.reshape(1).to(f)])


def _dims(r: BAResult):
    return (r.Tcw.shape[0], r.points.shape[0], r.lines.shape[0],
            r.p_inlier.shape[0], r.l_inlier.shape[0])


def unpack_result(buf: np.ndarray, dims) -> BAResult:
    """A packed result (numpy f32) → a BAResult of numpy arrays."""
    F, P, L, Cp, Cl = dims
    sizes = np.cumsum([16 * F, 3 * P, 6 * L, Cp, Cl])
    Tcw, points, lines, p_inl, l_inl, cost = np.split(buf, sizes)
    return BAResult(Tcw=Tcw.reshape(F, 4, 4), points=points.reshape(P, 3),
                    lines=lines.reshape(L, 6), p_inlier=p_inl > 0.5,
                    l_inlier=l_inl > 0.5, cost=cost[0])


def fetch_result(r: BAResult) -> BAResult:
    """A device BAResult as numpy, through one device→host copy."""
    if isinstance(r.Tcw, np.ndarray):
        return r  # already host-side
    return unpack_result(_pack_result(r).cpu().numpy(), _dims(r))


def fetch_result_async(r: BAResult):
    """Issue the one packed device→host copy of a CUDA BAResult on the
    current stream, into pinned host memory, without waiting. Returns
    (host buffer, dims): pass ``buffer.numpy()`` and ``dims`` to
    :func:`unpack_result` once the stream has passed this point (an event
    recorded after the call)."""
    packed = _pack_result(r)
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    return host, _dims(r)
