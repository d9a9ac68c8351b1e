"""Run the port's slice and the JAX package's SLAMSystem side by side on
the CPU, on the scene and weights ``chip_smoke.py`` drives on the card,
and print one JSON line with what they agree on.

    JAX_PLATFORMS=cpu python tests/torch_slice_reference.py [--width 376 --height 240]

Both run f32 at the given size (multiples of 8) with the EuRoC
intrinsics scaled by width/752, K = 400, 18 GNN layers, 100 Sinkhorn
iterations, lines and BA off, 30 frames. The JAX run's ATE, with margin, is the end-to-end ATE
bound of ``chip_smoke.py``. The line also reports how far the random
SuperPoint's keypoints sit from the rendered blobs and how many temporal
matches do not move between frames, which bounds what the ATE can show.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=376)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch
    from test_torch_common import matcher_weights, rendered_sequence, small_system_cfg, to_jax_cfg

    from rspl_slam_tpu.frontend.frontends import NeuralFrontend as JFE
    from rspl_slam_tpu.slam import SLAMSystem as JSLAM
    from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error, synthetic
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend as TFE
    from rspl_slam_tpu_torch.slam import INIT_POSE, SLAMSystem

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    cfg = small_system_cfg(width=args.width, height=args.height, layers=18)
    frames, traj = rendered_sequence(cfg, args.frames)
    sp, sg = matcher_weights(cfg)
    tfe = TFE(cfg, sp_params=sp, sg_params=sg, compute_dtype=torch.float32, device="cpu")
    jfe = JFE(to_jax_cfg(cfg), sp_params=sp, sg_params=sg, compute_dtype=jnp.float32)
    runs = {"torch": SLAMSystem(cfg, tfe, enable_ba=False),
            "jax": JSLAM(to_jax_cfg(cfg), jfe, enable_ba=False)}
    ts = np.arange(args.frames) * 0.05
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    out = {"image": [cfg.camera.image_width, cfg.camera.image_height],
           "frames": args.frames}
    for name, slam in runs.items():
        recs = [slam.add_frame(i, ts[i], *frames[i]) for i in range(args.frames)]
        est = np.stack([r.Twc for r in recs])
        out[name] = {
            "initialized": bool(slam.initialized),
            "keyframes": int(slam.map.n_kf),
            "inliers": [int(r.num_inliers) for r in recs],
            "ate_rmse_m": float(absolute_trajectory_error(
                ts, est[:, :3, 3], ts, gt[:, :3, 3])["rmse"]),
        }
    out["same_inliers_frames"] = int(sum(
        a == b for a, b in zip(out["torch"]["inliers"], out["jax"]["inliers"])))

    # where the random SuperPoint's keypoints sit, and how temporal matches move
    scene = synthetic.make_scene(num_points=600, num_lines=0, seed=1,
                                 extent=(6.0, 4.0, 6.0), on_line_frac=0.0)
    f0, f3 = tfe.extract_pair(*frames[0]), tfe.extract_pair(*frames[3])
    i0 = tfe.match(f3, f0)
    m = np.nonzero(i0 >= 0)[0]
    obs = synthetic.observe_points(scene, cfg.camera, traj[3])
    d = np.linalg.norm(f3.xy[m][:, None] - obs["uv_left"][None], axis=-1)
    d[:, ~obs["visible"]] = np.inf
    out["matched_kpt_to_blob_px_median"] = float(np.median(d.min(1)))
    out["static_match_share_frame0_to_3"] = float(
        (np.linalg.norm(f3.xy[m] - f0.xy[i0[m]], axis=-1) < 0.5).mean())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
