"""Trace local BA's LM iteration by iteration on the BA slice's first window,
in the JAX package (f32), the port (f32) and the port in f64, on the CPU,
and print one JSON line: per iteration each solver's current cost,
candidate cost and accept decision, and the first step's distance to the
f64 step.

    JAX_PLATFORMS=cpu python tests/torch_ba_lm_trace.py [--window 0] [--iters 8]

The window is the one ``tests/test_torch_ba.py``'s ``_capture_windows``
captures from the JAX system in ``test_slam_slice_with_ba_matches_jax``
(async mode): 6 rendered 320×240 frames with 12 dark segments, 2 GNN
layers, f32, every tracked frame a keyframe, RCF at full size. The three
solvers run the same schedule (phase 1: Huber on, λ from 1e-4, the step
clamps of ``_lm_phase``) from the same state.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch
    from test_torch_ba import _capture_windows
    from test_torch_common import (edge_weights, frontend_pair, lines_cfg, rendered_sequence,
                                   to_jax_cfg)

    from rspl_slam_tpu.backend import local_ba as jlb
    from rspl_slam_tpu.geometry import plucker as jplk
    from rspl_slam_tpu.geometry import se3 as jse3
    from rspl_slam_tpu.slam import SLAMSystem as JSLAM
    from rspl_slam_tpu_torch.backend import local_ba as tlb
    from rspl_slam_tpu_torch.geometry import plucker as tplk
    from rspl_slam_tpu_torch.geometry import se3 as tse3

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    cfg = lines_cfg(at_detection_scale=False, max_num_match=400)
    frames, _ = rendered_sequence(cfg, 6, num_lines=12)
    jfe, _ = frontend_pair(cfg, edge_weights())
    js = JSLAM(to_jax_cfg(cfg), jfe)
    wins = []
    _capture_windows(js, wins)
    for i, f in enumerate(frames):
        js.add_frame_features(i, 0.05 * i, copy.deepcopy(jfe.extract_pair(*f)))
    js.flush_ba()
    pj = {k: np.asarray(v) for k, v in wins[args.window][0]._asdict().items()}

    K = js.K
    deltas = tuple(math.sqrt(c) for c in (50.0, 75.0, 50.0, 75.0))
    probj = jlb.BAProblem(**{k: jnp.asarray(v) for k, v in pj.items()})
    p32 = tlb.upload_problem(jlb.BAProblem(**pj), "cpu")
    p64 = p32._replace(**{f: getattr(p32, f).double() for f in
                          ("Tcw", "points", "lines", "p_meas", "l_eps", "l_eps_r")})
    jsolve = jax.jit(lambda T, X, L, prob, lam: jlb._build_and_solve(
        K, T, X, L, prob, prob.p_valid, prob.l_valid, True, deltas, lam))
    jcost = jax.jit(lambda T, X, L, prob: jlb._total_cost(
        K, T, X, L, prob, prob.p_valid, prob.l_valid, deltas, True)[0])

    def jstep(T, X, L, lam):
        dp, dx, dl, _ = jsolve(T, X, L, probj, lam)
        dp, dx, dl = jnp.clip(dp, -10, 10), jnp.clip(dx, -50, 50), jnp.clip(dl, -10, 10)
        Tn = jax.vmap(lambda d, t: jse3.exp_se3(d) @ t)(dp, T)
        Ln = jax.vmap(jplk.orthonormal_update)(L, dl)
        return Tn, X + dx, Ln, jcost(Tn, X + dx, Ln, probj), np.asarray(dp)

    def tstep(prob):
        def step(T, X, L, lam):
            dp, dx, dl, _ = tlb._build_and_solve(K, T, X, L, prob, prob.p_valid, prob.l_valid,
                                                 True, deltas, lam)
            dp, dx, dl = dp.clamp(-10, 10), dx.clamp(-50, 50), dl.clamp(-10, 10)
            Tn, Ln = tse3.exp_se3(dp) @ T, tplk.orthonormal_update(L, dl)
            c = tlb._total_cost(K, Tn, X + dx, Ln, prob, prob.p_valid, prob.l_valid,
                                deltas, True)[0]
            return Tn, X + dx, Ln, c, dp.numpy()
        return step

    def trace(step, T, X, L, cost, lam):
        rows, first_dp = [], None
        for _ in range(args.iters):
            Tn, Xn, Ln, cn, dp = step(T, X, L, lam)
            first_dp = dp if first_dp is None else first_dp
            accept = bool(cn < cost)
            rows.append([float(cost), float(cn), accept])
            if accept:
                T, X, L, cost = Tn, Xn, Ln, cn
            lam = lam * 0.5 if accept else lam * 4.0
        return rows, first_dp

    f32 = jnp.float32
    Tj, Xj, Lj = (probj.Tcw.astype(f32), probj.points.astype(f32), probj.lines.astype(f32))
    runs = {"jax_f32": trace(jstep, Tj, Xj, Lj, jcost(Tj, Xj, Lj, probj), f32(1e-4))}
    for name, p in (("port_f32", p32), ("port_f64", p64)):
        c0 = tlb._total_cost(K, p.Tcw, p.points, p.lines, p, p.p_valid, p.l_valid, deltas,
                             True)[0]
        runs[name] = trace(tstep(p), p.Tcw, p.points, p.lines, c0,
                           torch.tensor(1e-4, dtype=p.Tcw.dtype))
    ref = runs["port_f64"][1]
    out = {"window": args.window, "F": len(pj["Tcw"]),
           "point_constraints": int(pj["p_valid"].sum()),
           "line_constraints": int(pj["l_valid"].sum()),
           "first_step_rel_to_f64": {k: float(np.abs(v[1] - ref).max() / np.abs(ref).max())
                                     for k, v in runs.items() if k != "port_f64"},
           "iterations": {k: v[0] for k, v in runs.items()}}
    split = [next((i for i, (a, b) in enumerate(zip(runs[k][0], runs["port_f64"][0]))
                   if a[2] != b[2]), None) for k in ("jax_f32", "port_f32")]
    out["first_decision_off_f64"] = dict(zip(("jax_f32", "port_f32"), split))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
