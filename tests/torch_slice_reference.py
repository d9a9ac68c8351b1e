"""Run the port's slice and the JAX package's SLAMSystem side by side on
the CPU, on the scene and weights ``chip_smoke.py`` drives on the card,
and print one JSON line with what they agree on.

    JAX_PLATFORMS=cpu python tests/torch_slice_reference.py [--width 376 --height 240] \
        [--lines] [--ba] [--lazy]
    JAX_PLATFORMS=cpu python tests/torch_slice_reference.py --synth [--frames 100]

Both run f32 at the given size (multiples of 8) with the EuRoC
intrinsics scaled by width/752, K = 400, 18 GNN layers, 100 Sinkhorn
iterations, 30 frames; lines off, or with ``--lines`` on, on the
scene of ``chip_smoke.py``'s lines phase (12 dark segments) with
``models.rcf.edge_detector_params`` as RCF weights; BA off, or with
``--ba`` the default local BA (async, after every keyframe). With lines and
BA on both run RCF at full size (``rcf_at_detection_scale=False``): the
JAX package's default eager path misreads its segments (ROADMAP.md §3),
which BA would turn into pose errors. ``--lazy`` runs the lazy-right
production path of ``chip_smoke.py``'s ``end_to_end_lazy`` phase: lines and
BA on, RCF at the detection scale (the route of the combined frame step),
the frames quantized to 8 bits. The JAX run's ATE, with margin, is
the matching end-to-end ATE bound of ``chip_smoke.py``. The line also
reports how far the random SuperPoint's keypoints sit from the rendered
blobs and how many temporal matches do not move between frames, which
bounds what the ATE can show.

``--synth`` instead runs both command lines' ``synth`` (the oracle
frontend on the unfused tracking path, lines on) on the CPU and prints
their ATE lines: the JAX one, with margin, is ``chip_smoke.py``'s
``cli_synth`` bound.
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
    ap.add_argument("--lines", action="store_true")
    ap.add_argument("--ba", action="store_true")
    ap.add_argument("--lazy", action="store_true")
    ap.add_argument("--synth", action="store_true")
    args = ap.parse_args()
    if args.synth:
        return synth_reference(args.frames)
    if args.lazy:
        args.lines = args.ba = True

    import jax
    import jax.numpy as jnp
    import torch
    from test_torch_common import matcher_weights, rendered_sequence, small_system_cfg, to_jax_cfg

    from rspl_slam_tpu.frontend.frontends import NeuralFrontend as JFE
    from rspl_slam_tpu.slam import SLAMSystem as JSLAM
    from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error, synthetic
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend as TFE
    from rspl_slam_tpu_torch.models import rcf
    from rspl_slam_tpu_torch.slam import INIT_POSE, SLAMSystem

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    cfg = small_system_cfg(width=args.width, height=args.height, layers=18)
    num_lines = 12 if args.lines else 0
    cfg = dataclasses.replace(cfg, use_lines=args.lines)
    if args.lazy:
        cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, lazy_right_extraction=True))
    elif args.ba and args.lines:
        cfg = dataclasses.replace(cfg, line_detector=dataclasses.replace(
            cfg.line_detector, rcf_at_detection_scale=False))
    frames, traj = rendered_sequence(cfg, args.frames, num_lines=num_lines)
    if args.lazy:
        frames = [tuple((np.clip(im, 0, 1) * 255).astype(np.uint8) for im in f)
                  for f in frames]
    sp, sg = matcher_weights(cfg)
    rp = rcf.edge_detector_params() if args.lines else None
    tfe = TFE(cfg, sp_params=sp, sg_params=sg, rcf_params=rp, compute_dtype=torch.float32,
              device="cpu")
    jfe = JFE(to_jax_cfg(cfg), sp_params=sp, sg_params=sg, rcf_params=rp,
              compute_dtype=jnp.float32)
    runs = {"torch": SLAMSystem(cfg, tfe, enable_ba=args.ba),
            "jax": JSLAM(to_jax_cfg(cfg), jfe, enable_ba=args.ba)}
    ts = np.arange(args.frames) * 0.05
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    out = {"image": [cfg.camera.image_width, cfg.camera.image_height],
           "frames": args.frames, "ba": args.ba, "lazy": args.lazy}
    for name, slam in runs.items():
        recs = [slam.add_frame(i, ts[i], *frames[i]) for i in range(args.frames)]
        slam.flush_ba()
        est = np.stack([r.Twc for r in recs])
        kf_times, kf_poses = slam.map.keyframe_trajectory()
        out[name] = {
            "initialized": bool(slam.initialized),
            "keyframes": int(slam.map.n_kf),
            "inliers": [int(r.num_inliers) for r in recs],
            "ate_rmse_m": float(absolute_trajectory_error(
                ts, est[:, :3, 3], ts, gt[:, :3, 3])["rmse"]),
            "keyframe_ate_rmse_m": float(absolute_trajectory_error(
                kf_times, kf_poses[:, :3, 3], ts, gt[:, :3, 3])["rmse"])
            if len(kf_times) > 2 else None,
        }
        if args.lines:
            m = slam.map
            out[name].update(
                lines_per_keyframe=m.kf_line_valid[: m.n_kf].sum(1).tolist(),
                maplines=int(m.n_ln),
                maplines_with_endpoints=int(m.ln_has_endpoints[: m.n_ln].sum()))
    out["same_inliers_frames"] = int(sum(
        a == b for a, b in zip(out["torch"]["inliers"], out["jax"]["inliers"])))

    # where the random SuperPoint's keypoints sit, and how temporal matches move
    scene = synthetic.make_scene(num_points=600, num_lines=num_lines, seed=1,
                                 extent=(6.0, 4.0, 6.0), on_line_frac=0.0)
    tfe.lazy_right = False  # the eager pair gives every field at once
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


def synth_reference(frames: int) -> int:
    """Both CLIs' ``synth --frames N`` (seed 0) on the CPU, one JSON line."""
    import contextlib
    import io
    import re

    import jax

    from rspl_slam_tpu import cli as jcli
    from rspl_slam_tpu_torch import cli as tcli

    jax.config.update("jax_platforms", "cpu")
    out = {"frames": frames}
    for name, cli, extra in (("torch", tcli, ["--device", "cpu"]), ("jax", jcli, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["synth", "--frames", str(frames), *extra])
        text = buf.getvalue()
        out[name] = {"ate": json.loads(re.search(r"^ATE: (.*)$", text, re.M).group(1)),
                     "map": re.search(r"^keyframes=.*$", text, re.M).group(0)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
