"""Run the port's slice and the JAX package's SLAMSystem side by side on
the CPU, on the scene and weights ``chip_smoke.py`` drives on the card,
and print one JSON line with what they agree on.

    JAX_PLATFORMS=cpu python tests/torch_slice_reference.py [--width 376 --height 240] \
        [--lines] [--ba] [--lazy]
    JAX_PLATFORMS=cpu python tests/torch_slice_reference.py --synth [--frames 100]
    JAX_PLATFORMS=cpu python tests/torch_slice_reference.py --config configs/oivio.yaml

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

``--config configs/<name>.yaml`` runs the configuration ``chip_smoke.py``'s
``configs`` phase drives on the card, at half its size: the file's
algorithm section (its K, keyframe and χ² settings) and its camera scaled
by ½ with its distortion model and rectification (``chip_smoke.scale_camera``),
lines and BA on (RCF at full size, as ``--ba --lines``), 18 GNN layers, on
``chip_smoke.config_scene`` (the lines scene shrunk into the camera's
depth range) rendered rectified and turned into the raw 8-bit frames the
camera would take (``chip_smoke.raw_frames``), so both frontends rectify
with the file's maps. The JAX run's ATE × 1.6 is that configuration's
bound in ``chip_smoke.py`` (``CONFIG_JAX_ATE``).

``--synth`` instead runs both command lines' ``synth`` (the oracle
frontend on the unfused tracking path, lines on) on the CPU and prints
their ATE lines: the JAX one, with margin, is ``chip_smoke.py``'s
``cli_synth`` bound.

The global layer's references run the JAX package alone, on the scenes
``chip_smoke.py`` builds (its ``loop_sequence`` and ``planted_matches``),
at the given size with 18 GNN layers, lines and BA on (RCF at full size),
the circle's frames quantized to 8 bits:

    JAX_PLATFORMS=cpu python tests/torch_slice_reference.py --loop
    JAX_PLATFORMS=cpu python tests/torch_slice_reference.py --reloc
    JAX_PLATFORMS=cpu python tests/torch_slice_reference.py --epipolar

``--loop``: ``end_to_end_loop``'s circle (loop closure and
``track_local_map`` on): the keyframes, the accepted loops with each Z's
error against the true relative pose, the keyframe ATE before and after
the closing ``run_pose_graph`` + ``run_global_ba``; with ``--with-port``
the port's run on the CPU under the same config beside it. ``--reloc``: the ``reloc``
phase's two kidnaps, the oracle one of ``tests/test_relocalization.py``
and the neural one (part of the circle, black frames, early poses): the
relocalizations and the position errors after them, and the neural
system's re-anchoring route forced on one wake-up frame
(``chip_smoke.reanchor``). ``--epipolar``: the
BA path's 30 frames (float, as that path runs them) with
``match_outlier_rejection`` (ATE), and the
filter alone on ``planted_matches`` (the share of inliers and outliers it
keeps).

    python tests/torch_slice_reference.py --grid

prints where random SuperPoint puts its keypoints on the loop scene's
first two frames (the port's frontend, f32): the share at the commonest
position inside their 8×8 cell, and the matches' displacement and the
stereo disparities against the rendered blobs'.
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
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--reloc", action="store_true")
    ap.add_argument("--epipolar", action="store_true")
    ap.add_argument("--with-port", dest="with_port", action="store_true")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--config", default=None)
    args = ap.parse_args()
    if args.synth:
        return synth_reference(args.frames)
    if args.grid:
        return grid_reference(args.width, args.height)
    if args.loop or args.reloc or args.epipolar:
        return global_reference(args)
    if args.lazy or args.config:
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
    if args.config:
        import chip_smoke
        from rspl_slam_tpu_torch.config import load_system_config

        path = os.path.join(os.path.dirname(HERE), args.config)
        full = load_system_config(path, path)
        cam = chip_smoke.scale_camera(full.camera, 0.5)
        cfg = dataclasses.replace(full, camera=cam, superglue=dataclasses.replace(
            full.superglue, image_width=cam.image_width, image_height=cam.image_height))
    num_lines = 12 if args.lines else 0
    cfg = dataclasses.replace(cfg, use_lines=args.lines)
    if args.lazy:
        cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, lazy_right_extraction=True))
    elif args.ba and args.lines:
        cfg = dataclasses.replace(cfg, line_detector=dataclasses.replace(
            cfg.line_detector, rcf_at_detection_scale=False))
    if args.config:
        frames, traj, scene_scale = chip_smoke.config_scene(cfg.camera, args.frames)
        frames = chip_smoke.raw_frames(cfg.camera, frames)
    else:
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
    if args.config:
        out.update(config=args.config, scene_scale=scene_scale,
                   max_keypoints=cfg.superpoint.max_keypoints)
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

    if args.config:  # the scene and frames differ from the rest's
        print(json.dumps(out))
        return 0
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


def _jax_system(width, height, **pipeline):
    """The JAX package's SLAMSystem pieces at ``width``×``height``: config
    (18 layers, lines and BA on, RCF at full size), f32 frontend with the
    smoke's weights."""
    import jax.numpy as jnp
    from test_torch_common import matcher_weights, small_system_cfg, to_jax_cfg

    from rspl_slam_tpu.frontend.frontends import NeuralFrontend as JFE
    from rspl_slam_tpu_torch.models import rcf

    cfg = small_system_cfg(width=width, height=height, layers=18)
    cfg = dataclasses.replace(
        cfg, use_lines=True, pipeline=dataclasses.replace(cfg.pipeline, **pipeline),
        line_detector=dataclasses.replace(cfg.line_detector, rcf_at_detection_scale=False))
    sp, sg = matcher_weights(cfg)
    jfe = JFE(to_jax_cfg(cfg), sp_params=sp, sg_params=sg,
              rcf_params=rcf.edge_detector_params(), compute_dtype=jnp.float32)
    return cfg, to_jax_cfg(cfg), jfe


def _u8(pair):
    return tuple((np.clip(im, 0, 1) * 255).astype(np.uint8) for im in pair)


def _port_system(cfg, **kw):
    """The port's SLAMSystem on the CPU (f32) with the smoke's weights."""
    import torch
    from test_torch_common import matcher_weights

    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend as TFE
    from rspl_slam_tpu_torch.models import rcf
    from rspl_slam_tpu_torch.slam import SLAMSystem

    torch.set_num_threads(4)
    sp, sg = matcher_weights(cfg)
    return SLAMSystem(cfg, TFE(cfg, sp_params=sp, sg_params=sg,
                               rcf_params=rcf.edge_detector_params(),
                               compute_dtype=torch.float32, device="cpu"), **kw)


def global_reference(args) -> int:
    """The JAX package's numbers for the smoke's global-layer phases."""
    import time

    import jax
    import jax.numpy as jnp

    from test_torch_common import rendered_sequence

    import chip_smoke
    from rspl_slam_tpu.ops.matching import fundamental_ransac_inliers
    from rspl_slam_tpu.slam import SLAMSystem as JSLAM
    from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error, synthetic
    from rspl_slam_tpu_torch.slam import INIT_POSE

    jax.config.update("jax_platforms", "cpu")
    out = {"image": [args.width, args.height]}
    t0 = time.perf_counter()
    if args.loop or args.reloc:
        cfg, jcfg, jfe = _jax_system(args.width, args.height,
                                     track_local_map=bool(args.loop))
        scene, traj = chip_smoke.loop_sequence()
        gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    if args.loop:
        n = chip_smoke.LOOP_FRAMES
        frames = [_u8(synthetic.render_images(scene, cfg.camera, traj[i], seed=i))
                  for i in range(n)]
        ts = np.arange(n) * 0.05
        out["loop"] = {"frames": n, "min_gap": chip_smoke.LOOP_MIN_GAP}
        systems = {"jax": JSLAM(jcfg, jfe, enable_loop_closure=True)}
        if args.with_port:
            systems["torch"] = _port_system(cfg, enable_loop_closure=True)
        for name, slam in systems.items():
            slam.loop_detector.min_gap = chip_smoke.LOOP_MIN_GAP
            for i in range(n):
                slam.add_frame(i, 0.05 * i, *frames[i])
            slam.flush_ba()
            m = slam.map

            def kf_ate():
                kt, kp = m.keyframe_trajectory()
                return float(absolute_trajectory_error(kt, kp[:, :3, 3], ts,
                                                       gt[:n, :3, 3])["rmse"])

            loops = [dict(i=lc.i, j=lc.j, inliers=lc.n_inliers,
                          **chip_smoke.loop_z_error(lc, m.kf_frame_id, gt))
                     for lc in slam.loop_constraints]
            before = kf_ate()
            pg = slam.run_pose_graph()
            gba = slam.run_global_ba()
            out["loop"][name] = {
                "keyframes": int(m.n_kf), "keyframe_frames": m.kf_frame_id[: m.n_kf].tolist(),
                "loops": loops, "keyframe_ate_rmse_m": before,
                "keyframe_ate_after_global_m": kf_ate(), "pose_graph_cost": pg,
                "global_ba_cost": gba, "reloc_count": slam.reloc_count}
    if args.reloc:
        slam = JSLAM(jcfg, jfe, enable_relocalization=True)

        def frame(i):
            return _u8(synthetic.render_images(scene, cfg.camera, traj[i], seed=i))

        errs = chip_smoke.run_reloc(slam, frame, (args.height, args.width), gt)
        # the re-anchoring route forced on one wake-up frame
        reanchor = chip_smoke.reanchor(slam, jfe.extract_pair(*frame(chip_smoke.RELOC_REANCHOR)),
                                       chip_smoke.RELOC_REANCHOR, gt)
        from test_torch_loop_closure import _kidnap

        oracle, oerrs = _kidnap("jax")
        out["reloc"] = {"oracle": {"reloc_count": oracle.reloc_count, "errors_m": oerrs,
                                   "keyframes": int(oracle.map.n_kf)},
                        "neural": {"reloc_count": slam.reloc_count, "errors_m": errs,
                                   "keyframes": int(slam.map.n_kf), "reanchor": reanchor}}
    if args.epipolar:
        cfg, jcfg, jfe = _jax_system(args.width, args.height, match_outlier_rejection=True)
        frames, traj = rendered_sequence(cfg, args.frames, num_lines=12)
        slam = JSLAM(jcfg, jfe)
        recs = [slam.add_frame(i, 0.05 * i, *frames[i]) for i in range(args.frames)]
        slam.flush_ba()
        ts = np.arange(args.frames) * 0.05
        gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
        est = np.stack([r.Twc for r in recs])
        kt, kp = slam.map.keyframe_trajectory()
        kept = []
        for seed in range(5):
            p0, p1, matched, bad = chip_smoke.planted_matches(seed)
            ok = np.asarray(fundamental_ransac_inliers(
                jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(matched), jax.random.PRNGKey(seed)))
            good = np.setdiff1d(np.nonzero(matched)[0], bad)
            kept.append([float(ok[good].mean()), int(ok[bad].sum())])
        out["epipolar"] = {
            "frames": args.frames, "keyframes": int(slam.map.n_kf),
            "inliers": [int(r.num_inliers) for r in recs],
            "ate_rmse_m": float(absolute_trajectory_error(ts, est[:, :3, 3], ts,
                                                          gt[:, :3, 3])["rmse"]),
            "keyframe_ate_rmse_m": float(absolute_trajectory_error(kt, kp[:, :3, 3], ts,
                                                                   gt[:, :3, 3])["rmse"]),
            "planted_kept_inlier_share_and_outliers": kept}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


def grid_reference(width, height) -> int:
    """Where random SuperPoint puts its keypoints, on the first two frames
    of ``chip_smoke.loop_sequence`` through the port's frontend (f32, the
    CPU): the share of keypoints at the commonest position inside their
    8×8 cell, and the temporal matches' displacement and the stereo
    disparities against the rendered blobs' (nearest blob), as medians."""
    import torch
    from test_torch_common import matcher_weights, small_system_cfg

    import chip_smoke
    from rspl_slam_tpu_torch.evaluation import synthetic
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend

    cfg = small_system_cfg(width=width, height=height)
    sp, sg = matcher_weights(cfg)
    fe = NeuralFrontend(cfg, sp_params=sp, sg_params=sg, compute_dtype=torch.float32,
                        device="cpu")
    scene, traj = chip_smoke.loop_sequence()
    feats = [fe.extract_pair(*_u8(synthetic.render_images(scene, cfg.camera, traj[i], seed=i)))
             for i in (0, 1)]
    obs = [synthetic.observe_points(scene, cfg.camera, traj[i]) for i in (0, 1)]
    f0, f1 = feats
    xy = f1.xy[f1.valid].astype(int)
    cell = (xy[:, 0] % 8) * 8 + xy[:, 1] % 8
    both = np.nonzero(obs[0]["visible"] & obs[1]["visible"])[0]

    def nearest(p):
        return both[np.linalg.norm(p[:, None] - obs[1]["uv_left"][both][None], axis=-1).argmin(1)]

    i0 = fe.match(f1, f0)
    m = i0 >= 0
    nb = nearest(f1.xy[m])
    st = f1.valid & (f1.meas[:, 2] > 0)
    ns = nearest(f1.xy[st])
    print(json.dumps({
        "image": [width, height], "keypoints": int(f1.valid.sum()),
        "share_at_commonest_cell_position": float(np.bincount(cell).max() / len(cell)),
        "match_dx_median_px": float(np.median(f1.xy[m, 0] - f0.xy[i0[m], 0])),
        "blob_dx_median_px": float(np.median(obs[1]["uv_left"][nb, 0] - obs[0]["uv_left"][nb, 0])),
        "disparity_median_px": float(np.median(f1.xy[st, 0] - f1.meas[st, 2])),
        "blob_disparity_median_px": float(np.median(obs[1]["uv_left"][ns, 0]
                                                    - obs[1]["uv_right"][ns, 0]))}))
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
